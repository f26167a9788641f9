"""Paged decode attention: one query token per slot attends its context
through the slot's block table, in one launch for the whole batch.

The kernel is ``paddle_tpu_torch/csrc/paged_attention.cu`` (CUDA C++ for
sm_90a); it replaces the TPU kernel
``paddle_tpu/ops/pallas/decode_attention.py`` ``paged_attention``.  Its
source note gives the bound and the design.  :func:`plain` is the same
function in plain PyTorch: ``ragged_attention.paged_gather_dense`` then
:func:`attend_dense_gqa`, the twins of the JAX ``_paged_gather_dense``
and ``_attend_dense_gqa``, with the TPU kernel's rule for an empty
context on top: a slot with ``lens == 0`` gives zeros (the dense
composition alone gives NaN there, a softmax over nothing).

Layouts: q (B, H, D); pools (NB, page, H_kv, D); tables (B, MB) int32;
lens (B,) int32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._build import Kernel, dtype_code, stream_of
from ._common import check, check_dense, on_cuda
from .ragged_attention import paged_gather_dense

__all__ = ["KERNEL", "attend_dense_gqa", "paged_attention", "plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("paged_attention", "pt_paged_attention",
                [_P] * 6 + [_I] * 7 + [ctypes.c_float, _I, _P])
_HEAD_DIMS = (32, 64, 96, 128)


def attend_dense_gqa(q, k, v, context_lens, scale: float):
    """q (B, H, D) attends positions ``[0, context_lens)`` of dense
    (B, S, H_kv, D) K/V.  GQA without repeating KV, f32 throughout; a row
    with no position gives NaN, as in the reference."""
    b, h, d = q.shape
    s, h_kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, h_kv, h // h_kv, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    mask = torch.arange(s, device=q.device)[None, :] < \
        context_lens.long()[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def plain(q, k_pool, v_pool, block_tables, lens,
          scale: Optional[float] = None):
    """The dense gather-then-attend version of the kernel; ``lens == 0``
    rows are zeros."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = paged_gather_dense(k_pool, v_pool, block_tables)
    out = attend_dense_gqa(q, k, v, lens, scale)
    return torch.where((lens > 0)[:, None, None], out, torch.zeros_like(out))


def paged_attention(q, k_pool, v_pool, block_tables, lens,
                    scale: Optional[float] = None):
    """q (B, H, D) over paged KV pools -> (B, H, D).  CUDA tensors launch
    the kernel, CPU tensors run :func:`plain`."""
    op = "paged_attention"
    if not on_cuda(op, q, k_pool, v_pool, block_tables, lens,
                   kernel=KERNEL):
        return plain(q, k_pool, v_pool, block_tables, lens, scale)
    b, h, d = q.shape
    nb, page, h_kv, d2 = k_pool.shape
    mb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    check_dense(op, q.dtype, q=q, k_pool=k_pool, v_pool=v_pool)
    check_dense(op, torch.int32, block_tables=block_tables, lens=lens)
    check(op, d2 == d and tuple(v_pool.shape) == tuple(k_pool.shape),
          "pool shape mismatch")
    check(op, d in _HEAD_DIMS, f"head_dim {d} not in {_HEAD_DIMS}")
    check(op, h % h_kv == 0, f"{h} q heads over {h_kv} kv heads")
    check(op, tuple(block_tables.shape) == (b, mb)
          and tuple(lens.shape) == (b,), "table/lens shape mismatch")
    out = torch.empty_like(q)
    if b == 0:
        return out
    KERNEL.launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                  b, h, nb, page, h_kv, d, mb, float(scale),
                  dtype_code(q.dtype), stream_of(q))
    return out
