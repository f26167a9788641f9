"""Fused AdamW update: moments and parameter in one elementwise pass, in
place, over every eligible parameter of a step.

The kernel is ``paddle_tpu_torch/csrc/fused_adamw.cu`` (CUDA C++ for
sm_90a); it replaces the TPU kernel ``paddle_tpu/ops/pallas/fused_adamw.py``
``fused_adamw_update``, whose formula it keeps.  The TPU kernel runs once
per parameter; this one runs once per step over a table of all the
tensors (multi-tensor), with lr and the bias corrections c1, c2 as launch
arguments.  :func:`plain` is the same update of one tensor in plain
PyTorch: the CPU runs it, and the card holds the kernel against it.

Routing is the reference's :func:`eligible`: f32 (master or parameter)
tensors whose size is a multiple of 1024.  Everything is updated IN
PLACE: the f32 parameter (or master weight), both moments, and under
master weights the low-precision parameter, written from the same pass.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional, Sequence

import numpy as np
import torch

from ._build import Kernel, stream_of
from ._common import check, on_cuda

__all__ = ["CHUNK", "KERNEL", "bias_corrections", "eligible",
           "fused_adamw_update", "plain"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel("fused_adamw", "pt_fused_adamw",
                [_P, _I, ctypes.c_longlong] + [_F] * 8 + [_P])
CHUNK = 4096          # elements per block (csrc/fused_adamw.cu kChunk)
_ALIGN = 1024         # the reference's 8 x 128 lanes


def eligible(p: torch.Tensor) -> bool:
    """Tensors the kernel updates: f32, size a positive multiple of 1024
    (the reference's ``fused_adamw.eligible``)."""
    return (p.dtype == torch.float32 and p.numel() >= _ALIGN
            and p.numel() % _ALIGN == 0)


def bias_corrections(step: int, beta1: float, beta2: float):
    """``(1 / (1 - beta1**t), 1 / (1 - beta2**t))`` for ``t = step + 1``,
    in f32 as the reference computes them, from the host's step count."""
    t = np.float32(step + 1)
    one = np.float32(1.0)
    c1 = one / (one - np.float32(beta1) ** t)
    c2 = one / (one - np.float32(beta2) ** t)
    return float(c1), float(c2)


def plain(p, g, m, v, lr, c1, c2, *, beta1, beta2, eps, wd=0.0,
          low: Optional[torch.Tensor] = None):
    """One tensor's update in f32, in place on ``p``, ``m``, ``v`` (and
    ``low``, the rounded copy of ``p``, when given)."""
    g = g.float()
    m.copy_(beta1 * m + (1.0 - beta1) * g)
    v.copy_(beta2 * v + (1.0 - beta2) * g.square())
    update = (m * c1) / (torch.sqrt(v * c2) + eps)
    if wd:
        update = update + wd * p
    p.copy_(p - lr * update)
    if low is not None:
        low.copy_(p)


def _f32_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", float(x)))[0]


def fused_adamw_update(params: Sequence[torch.Tensor],
                       grads: Sequence[torch.Tensor],
                       moment1: Sequence[torch.Tensor],
                       moment2: Sequence[torch.Tensor], lr: float,
                       c1: float, c2: float, *, beta1: float, beta2: float,
                       eps: float, wds: Sequence[float],
                       lows: Optional[Sequence[Optional[torch.Tensor]]] = None
                       ) -> None:
    """Update every ``params[i]`` (f32, :func:`eligible`) with its grad
    (f32 or bf16) and moments, in place; ``lows[i]``, if not None, is the
    bf16 parameter that receives the rounded result.  CUDA tensors: ONE
    kernel launch for the whole list.  CPU tensors: :func:`plain` per
    tensor."""
    n = len(params)
    lows = list(lows) if lows is not None else [None] * n
    if not (len(grads) == len(moment1) == len(moment2) == len(wds)
            == len(lows) == n):
        raise ValueError("fused_adamw: list lengths differ")
    if n == 0:
        return
    op = "fused_adamw"
    tensors = [*params, *grads, *moment1, *moment2,
               *(t for t in lows if t is not None)]
    if not on_cuda(op, *tensors, kernel=KERNEL):
        for p, g, m, v, wd, low in zip(params, grads, moment1, moment2, wds,
                                       lows):
            plain(p, g, m, v, lr, c1, c2, beta1=beta1, beta2=beta2, eps=eps,
                  wd=wd, low=low)
        return
    rows, starts, chunks = [], [], 0
    for p, g, m, v, wd, low in zip(params, grads, moment1, moment2, wds,
                                   lows):
        check(op, eligible(p), f"parameter {tuple(p.shape)} {p.dtype} is "
              "not eligible (f32, size a multiple of 1024)")
        for name, t in (("p", p), ("m", m), ("v", v)):
            check(op, t.dtype == torch.float32 and t.numel() == p.numel()
                  and t.is_contiguous() and t.data_ptr() % 16 == 0,
                  f"{name} must be contiguous 16-byte aligned f32 of "
                  f"{p.numel()} elements")
        check(op, g.dtype in (torch.float32, torch.bfloat16)
              and g.numel() == p.numel() and g.is_contiguous()
              and g.data_ptr() % 16 == 0,
              "grad must be contiguous 16-byte aligned f32 or bf16")
        check(op, low is None or (low.dtype == torch.bfloat16
                                  and low.numel() == p.numel()
                                  and low.is_contiguous()
                                  and low.data_ptr() % 16 == 0),
              "low-precision parameter must be contiguous aligned bf16")
        rows += [p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 0 if low is None else low.data_ptr(), p.numel(),
                 _f32_bits(wd), int(g.dtype == torch.bfloat16)]
        starts.append(chunks)
        chunks += -(-p.numel() // CHUNK)
    starts.append(chunks)
    dev = params[0].device
    table = torch.tensor(rows + starts, dtype=torch.int64).pin_memory() \
        .to(dev, non_blocking=True)
    KERNEL.launch(table.data_ptr(), n, chunks, float(lr), float(c1),
                  float(c2), float(beta1), float(1.0 - beta1), float(beta2),
                  float(1.0 - beta2), float(eps), stream_of(params[0]))
