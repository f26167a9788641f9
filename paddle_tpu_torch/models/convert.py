"""Carry a JAX model's parameters across into the port.

The reference exports its parameters as numpy arrays
(``{name: np.asarray(p) for name, p in model.named_parameters()}``);
:func:`params_from_numpy` loads them into the port model of the same
config, name for name, layout for layout.  A JAX bf16 array exports as an
``ml_dtypes.bfloat16`` numpy array, which ``torch.from_numpy`` refuses, so
such arrays go through float32 first -- exact, since every bf16 value is
an f32 value -- and are then cast to the parameter's dtype.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_numpy"]


def _to_tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, order="C"))   # writable copy


def params_from_numpy(model: nn.Module, arrays: Dict[str, np.ndarray]
                      ) -> nn.Module:
    """Copy ``arrays`` into ``model``'s parameters in place; every
    parameter must be given, with its exact shape, and no extra name is
    accepted.  Returns ``model``."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    unexpected = sorted(set(arrays) - set(params))
    if missing or unexpected:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    with torch.no_grad():
        for name, p in params.items():
            t = _to_tensor(arrays[name])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(t.to(device=p.device, dtype=p.dtype))
    return model
