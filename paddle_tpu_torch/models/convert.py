"""Carry a JAX model's parameters across into the port.

The reference exports its parameters as numpy arrays
(``{name: np.asarray(p) for name, p in model.named_parameters()}``);
:func:`params_from_numpy` loads them into the port model of the same
config, name for name, layout for layout -- and a weight-only quantized
model's buffers as well (``named_buffers()``: the int8 codes in
``...weight``, the f32 ``...weight_scale``; a ``None`` bias is skipped),
bit for bit into a port model that ``nn.quant.quantize_linears`` turned
into the same algo.  A JAX bf16 array exports as an
``ml_dtypes.bfloat16`` numpy array, which ``torch.from_numpy`` refuses, so
such arrays go through float32 first -- exact, since every bf16 value is
an f32 value -- and are then cast to the parameter's dtype.

:func:`train_state_from_numpy` carries a JAX ``TrainStep`` state across
the same way: the parameters, and the optimizer's ``step``, ``master``,
``moment1`` and ``moment2``, copied in place into a port state made by
``TrainStep.init_state``, so both sides start a step from the same state.

Adapters cross as numpy: ``serving.LoRAPool.load`` takes the per-layer
``{proj: (A, B)}`` numpy packs that either package's ``random_adapter``
returns, so one adapter loads into a JAX pool and a port pool alike.
:func:`lora_pool_from_numpy` copies a whole JAX pool -- its f32 host
mirror (alpha/r already folded into B) and its name -> slot registry --
into a port pool of the same geometry, so both engines serve identical
stacks.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["lora_pool_from_numpy", "params_from_numpy",
           "train_state_from_numpy"]


def _to_tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, order="C"))   # writable copy


def params_from_numpy(model: nn.Module, arrays: Dict[str, np.ndarray]
                      ) -> nn.Module:
    """Copy ``arrays`` into ``model``'s parameters and buffers in place;
    every one must be given, with its exact shape and its kind (integer
    codes into integer buffers, floats into floats), and no extra name is
    accepted.  ``None`` entries (a quantized layer's absent bias) are
    skipped.  Returns ``model``."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    given = {k for k, v in arrays.items() if v is not None}
    missing = sorted(set(targets) - given)
    unexpected = sorted(given - set(targets))
    if missing or unexpected:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    with torch.no_grad():
        for name, p in targets.items():
            t = _to_tensor(arrays[name])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                 f"{tuple(p.shape)}")
            if t.is_floating_point() != p.is_floating_point():
                raise ValueError(f"{name}: {t.dtype} values for a "
                                 f"{p.dtype} tensor")
            p.copy_(t.to(device=p.device, dtype=p.dtype))
    return model


def _copy_dict(dst: Dict[str, torch.Tensor], src: Dict, what: str) -> None:
    if set(dst) != set(src):
        raise KeyError(f"{what}: names differ: missing "
                       f"{sorted(set(dst) - set(src))}, unexpected "
                       f"{sorted(set(src) - set(dst))}")
    for name, t in dst.items():
        a = src[name]
        if t is None or a is None:
            if (t is None) != (a is None):
                raise ValueError(f"{what}.{name}: present on one side only")
            continue
        v = _to_tensor(a)
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{what}.{name}: shape {tuple(v.shape)} != "
                             f"{tuple(t.shape)}")
        t.copy_(v.to(device=t.device, dtype=t.dtype))


def train_state_from_numpy(state: Dict, arrays: Dict) -> Dict:
    """Copy a JAX ``TrainStep`` state, exported as numpy (``{"params":
    {...}, "opt": {"step", "master", "moment1", "moment2"}, "step"}``),
    into the port ``state`` in place.  Every slot of the port's optimizer
    state must be given.  Returns ``state``."""
    with torch.no_grad():
        _copy_dict(state["params"], arrays["params"], "params")
        opt = state["opt"]
        for slot, val in opt.items():
            if isinstance(val, dict):
                _copy_dict(val, arrays["opt"][slot], slot)
        opt["step"] = int(np.asarray(arrays["opt"]["step"]))
        if "step" in arrays:
            state["step"] = int(np.asarray(arrays["step"]))
    return state


def lora_pool_from_numpy(pool, host, adapters: Dict[str, int]):
    """Copy a JAX ``LoRAPool``'s host mirror (``jpool._host``: per layer
    ``{proj: {"a": (N, d_in, r), "b": (N, r, d_out)}}`` f32 numpy) and
    registry (``jpool.adapters()``) into the port ``pool`` in place: the
    host mirror, the device stacks (slot by slot, same tensors) and the
    slots; refcounts start empty.  Returns ``pool``."""
    pool._restore(host, adapters)
    return pool
