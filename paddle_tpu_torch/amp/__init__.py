"""Automatic mixed precision (``paddle_tpu/amp/__init__.py`` counterpart).

Ported: ``decorate`` at O2 -- cast the model's parameters to the low
precision dtype (in place: the same ``nn.Parameter`` objects) and turn on
the optimizers' f32 master weights (``multi_precision``).  ``auto_cast``
(O1) and ``GradScaler`` are not ported yet (ROADMAP.md); bf16 needs no
loss scaling.
"""

from __future__ import annotations

import torch

__all__ = ["decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False):
    """O2 decoration: cast params to ``dtype``, enable master weights.
    ``master_grad=True`` also promotes low-precision gradients to f32
    before clipping and the update."""
    d = dtype if isinstance(dtype, torch.dtype) else _DTYPES[dtype]
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for m in model_list:
        m.to(d)
    if optimizers is None:
        return models if single else model_list
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    for o in opt_list:
        if master_weight is not False:
            o.multi_precision = True
        if master_grad:
            o.master_grad = True
    if single and opt_single:
        return models, optimizers
    return model_list, opt_list
