"""Ragged paged attention: every slot's token span attends its causal
prefix through the slot's block table, in one launch for the whole
serving batch.

The kernel is ``paddle_tpu_torch/csrc/ragged_attention.cu`` (CUDA C++ for
sm_90a); it replaces the TPU kernel
``paddle_tpu/ops/pallas/ragged_attention.py`` ``ragged_paged_attention``.
Its source note gives the bound and the design.  :func:`plain` is the
same function in plain PyTorch: :func:`paged_gather_dense` then
:func:`ragged_attend_dense`, the twins of the JAX ``_paged_gather_dense``
and ``_ragged_attend_dense``.

Layouts: q (B, C, H, D); pools (NB, page, H_kv, D); tables (B, MB) int32;
starts/lens (B,) int32.  Rows ``j >= lens[b]`` are dead: the contract
leaves them unspecified, the kernel writes zeros there and the plain
version attends position 0, so compare live rows only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._build import Kernel, dtype_code, stream_of
from ._common import check, check_dense, on_cuda

__all__ = ["KERNEL", "paged_gather_dense", "plain", "ragged_attend_dense",
           "ragged_paged_attention", "span_write"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("ragged_attention", "pt_ragged_paged_attention",
                [_P] * 7 + [_I] * 8 + [ctypes.c_float, _I, _P])
# Hopper's shared memory a block may use (H100: 232,448 bytes)
_SMEM_LIMIT = 232448


def span_write(k_pool, v_pool, k, v, block_tables, span_starts, span_lens):
    """Write a token span ``k``/``v`` (B, C, H_kv, D) into the paged pools
    at positions ``[span_starts, span_starts + span_lens)`` of each slot.
    Rows ``>= span_lens`` (chunk padding, idle slots) are masked out
    before any index is formed, so neither they nor a sentinel table
    entry ever touch the pools.  In place; returns the pools.  (The
    ``nonzero()`` syncs the host with the card once per call.)"""
    s = k.shape[1]
    bs = k_pool.shape[1]
    mb = block_tables.shape[1]
    ar = torch.arange(s, device=k.device)
    pos = span_starts.long()[:, None] + ar[None, :]              # (B, C)
    live = ar[None, :] < span_lens.long()[:, None]
    bi, ci = live.nonzero(as_tuple=True)
    p = pos[bi, ci]
    blk = block_tables.long()[bi, torch.clamp(p // bs, max=mb - 1)]
    off = p % bs
    k_pool[blk, off] = k[bi, ci].to(k_pool.dtype)
    v_pool[blk, off] = v[bi, ci].to(v_pool.dtype)
    return k_pool, v_pool


def paged_gather_dense(k_cache, v_cache, block_tables, k_scale=None,
                       v_scale=None):
    """A batch's pages gathered into dense (B, MB*page, H_kv, D) K/V.
    Table entries are CLAMPED into [0, NB) first: the out-of-range
    sentinel that pads tables gathers a real page, which the causal mask
    never lets a live row see.  int8 pools dequantize through their
    per-(position, head) f32 scales."""
    nb, bs, h_kv, d = k_cache.shape
    b, mb = block_tables.shape
    idx = block_tables.long().clamp(0, nb - 1)
    k = k_cache[idx].reshape(b, mb * bs, h_kv, d)
    v = v_cache[idx].reshape(b, mb * bs, h_kv, d)
    if k_scale is not None:
        k = k.float() * k_scale[idx].reshape(b, mb * bs, h_kv)[..., None]
        v = v.float() * v_scale[idx].reshape(b, mb * bs, h_kv)[..., None]
    return k, v


def ragged_attend_dense(q, k, v, span_starts, scale: float):
    """Query row ``j`` of slot ``b`` (position ``span_starts[b] + j``)
    attends positions ``[0, span_starts[b] + j]`` of dense (B, S, H_kv, D)
    K/V.  GQA without repeating KV, f32 throughout."""
    b, c, h, d = q.shape
    s, h_kv = k.shape[1], k.shape[2]
    g = h // h_kv
    qg = q.reshape(b, c, h_kv, g, d).float()
    scores = torch.einsum("bckgd,bskd->bckgs", qg, k.float()) * scale
    pos = span_starts.long()[:, None] + torch.arange(c, device=q.device)
    # position 0 is always visible, so no row softmaxes an empty set
    mask = torch.arange(s, device=q.device)[None, None, :] <= pos[:, :, None]
    scores = scores.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bckgs,bskd->bckgd", probs, v.float())
    return out.reshape(b, c, h, d).to(q.dtype)


def plain(q, k_pool, v_pool, block_tables, starts, lens,
          scale: Optional[float] = None):
    """The dense gather-then-attend version of the kernel."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = paged_gather_dense(k_pool, v_pool, block_tables)
    return ragged_attend_dense(q, k, v, starts, scale)


def ragged_paged_attention(q, k_pool, v_pool, block_tables, starts, lens,
                           scale: Optional[float] = None):
    """q (B, C, H, D) spans over paged KV pools -> (B, C, H, D).  CUDA
    tensors launch the kernel, CPU tensors run :func:`plain`."""
    op = "ragged_paged_attention"
    if not on_cuda(op, q, k_pool, v_pool, block_tables, starts, lens,
                   kernel=KERNEL):
        return plain(q, k_pool, v_pool, block_tables, starts, lens, scale)
    b, c, h, d = q.shape
    nb, page, h_kv, d2 = k_pool.shape
    mb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    check_dense(op, q.dtype, q=q, k_pool=k_pool, v_pool=v_pool)
    check_dense(op, torch.int32, block_tables=block_tables, starts=starts,
                lens=lens)
    check(op, d2 == d and tuple(v_pool.shape) == tuple(k_pool.shape),
          "pool shape mismatch")
    check(op, h % h_kv == 0, f"{h} q heads over {h_kv} kv heads")
    check(op, tuple(block_tables.shape) == (b, mb)
          and tuple(starts.shape) == (b,) and tuple(lens.shape) == (b,),
          "table/starts/lens shape mismatch")
    smem = KERNEL.helper("pt_ragged_paged_attention_smem", [_I, _I],
                         ctypes.c_longlong)(page, d)
    check(op, smem <= _SMEM_LIMIT,
          f"page {page} x head_dim {d} needs {smem} bytes of shared memory")
    out = torch.empty_like(q)
    if b == 0 or c == 0:
        return out
    KERNEL.launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  block_tables.data_ptr(), starts.data_ptr(),
                  lens.data_ptr(), out.data_ptr(), b, c, h, nb, page, h_kv,
                  d, mb, float(scale), dtype_code(q.dtype), stream_of(q))
    return out
