"""Grouped BGMV for batched multi-LoRA serving: ``x[b] @ A[idx[b]] @
B[idx[b]]`` per batch slot, in one launch.

The kernel is ``paddle_tpu_torch/csrc/lora_matmul.cu`` (CUDA C++ for
sm_90a); it replaces the TPU kernel ``paddle_tpu/ops/pallas/lora_matmul.py``
``grouped_bgmv``.  Its source note gives the bound and the design.
:func:`plain` is the same function in plain PyTorch, the twin of the JAX
``_lora_bgmv_ref``: each slot's adapter gathered by index, the shrink
accumulated in f32 and rounded to x.dtype, the expand accumulated in f32
and rounded.  Index 0 is the reserved no-op: its rows are exact zeros.

Layout: x (B, C, d_in) float; a (N, d_in, r); b (N, r, d_out); idx (B,)
int32 -> (B, C, d_out) in x.dtype.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, dtype_code, stream_of
from ._common import on_cuda

__all__ = ["KERNEL", "MAX_RANK", "grouped_bgmv", "plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("lora_matmul", "pt_grouped_bgmv", [_P] * 5 + [_I] * 7 + [_P])
MAX_RANK = 64
DTYPES = (torch.float32, torch.bfloat16)


def plain(x, a, b, idx):
    """Gather, shrink in f32, round to x.dtype, expand in f32, round."""
    dt = x.dtype
    ai = a.index_select(0, idx.long()).to(dt)          # (B, d_in, r)
    bi = b.index_select(0, idx.long()).to(dt)          # (B, r, d_out)
    h = torch.bmm(x.float(), ai.float()).to(dt)        # (B, C, r)
    return torch.bmm(h.float(), bi.float()).to(dt)


def grouped_bgmv(x, a, b, idx):
    """``x[s] @ a[idx[s]] @ b[idx[s]]`` per batch slot; ``idx == 0`` rows
    are exact zeros.  CUDA tensors launch the kernel (or raise), CPU
    tensors run :func:`plain`."""
    op = "grouped_bgmv"
    if x.ndim != 3 or a.ndim != 3 or b.ndim != 3:
        raise ValueError(f"x {tuple(x.shape)}, a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be 3-D")
    bsz, c, d_in = x.shape
    n, d_in2, r = a.shape
    n2, r2, d_out = b.shape
    if (n, r) != (n2, r2) or d_in != d_in2:
        raise ValueError(f"stack mismatch: x(..., {d_in}) a{tuple(a.shape)} "
                         f"b{tuple(b.shape)}")
    if tuple(idx.shape) != (bsz,):
        raise ValueError(f"idx {tuple(idx.shape)} != ({bsz},)")
    if not on_cuda(op, x, a, b, idx, kernel=KERNEL):
        return plain(x, a, b, idx)
    # plain ifs: the messages are formatted only on failure (the engine
    # makes 224 calls a step)
    if x.dtype not in DTYPES:
        raise ValueError(f"{op}: x is {x.dtype}; the kernel takes float32 "
                         "or bfloat16")
    if a.dtype != x.dtype or b.dtype != x.dtype:
        raise ValueError(f"{op}: stacks are {a.dtype}/{b.dtype}, x is "
                         f"{x.dtype}")
    if idx.dtype != torch.int32:
        raise ValueError(f"{op}: idx is {idx.dtype}, expected int32")
    for name, t in (("x", x), ("a", a), ("b", b), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"{op}: rank {r} not in [1, {MAX_RANK}]")
    out = torch.empty((bsz, c, d_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    KERNEL.launch(x.data_ptr(), a.data_ptr(), b.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), bsz, c, d_in, r, d_out, n,
                  dtype_code(x.dtype), stream_of(x))
    return out
