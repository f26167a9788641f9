"""Paged decode attention: one query token per slot attends its context
through the slot's block table, in one launch for the whole batch.

The kernel is ``paddle_tpu_torch/csrc/paged_attention.cu`` (CUDA C++ for
sm_90a); it replaces the TPU kernel
``paddle_tpu/ops/pallas/decode_attention.py`` ``paged_attention``.  Its
source note gives the bound and the design: bf16 and f16 run on the
tensor cores, f32 runs SIMT products, the context cut into spans by
:mod:`.paged_plan` and the spans merged inside the same launch.  The
spans' f32 partials and counters are allocated once per (plan, device,
stream) and reused by every eager call (:func:`_launch_args`): the
kernel leaves the counters at zero.  A call under CUDA-graph capture
takes its own zeroed scratch instead, from the graph's private pool, so
the graph owns every buffer it reads.  :func:`plain` is the same function in
plain PyTorch: ``ragged_attention.paged_gather_dense`` then
:func:`attend_dense_gqa`, the twins of the JAX ``_paged_gather_dense``
and ``_attend_dense_gqa``, with the TPU kernel's rule for an empty
context on top: a slot with ``lens == 0`` gives zeros (the dense
composition alone gives NaN there, a softmax over nothing).

Layouts: q (B, H, D); pools (NB, page, H_kv, D); tables (B, MB) int32;
lens (B,) int32.

:func:`dense_attention` runs the same kernel over a dense (B, S, H_kv, D)
cache read as a pool of B pages of S positions (``generate()``'s decode
step): a view, nothing copied.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ._build import Kernel, dtype_code, stream_of
from ._common import check, check_dense, fp_pools, on_cuda
from .mlp_plan import sm_count
from .paged_plan import PagedPlan, paged_plan
from .ragged_attention import paged_gather_dense

__all__ = ["KERNEL", "attend_dense_gqa", "dense_attention",
           "paged_attention", "plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("paged_attention", "pt_paged_attention",
                [_P] * 9 + [_I] * 9 + [ctypes.c_float, _I, _P])
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


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


@functools.lru_cache(maxsize=32)
def _launch_args(plan: PagedPlan, device, stream: int) -> tuple:
    """The C entry point's (partials, (m, l), counters, splits, per) for
    launches under ``plan`` on ``stream`` of ``device``, and the
    scratch buffer behind the three addresses (None without spans to
    merge): zeroed once, then reused by every such launch -- each leaves
    its counters at zero again.  A buffer is freed with its cache entry;
    it is only ever used on its own stream, so the allocator reuses it in
    stream order."""
    head = (None, None, None)
    buf = None
    if plan.scratch_bytes:
        buf = torch.zeros(plan.scratch_bytes, dtype=torch.uint8,
                          device=device)
        part = buf.data_ptr()
        head = (part, part + plan.ml_offset, part + plan.counter_offset)
    return (*head, plan.splits, plan.per, buf)


def launch(q, k_pool, v_pool, block_tables, lens, scale: float,
           plan: PagedPlan):
    """One launch of the kernel on checked CUDA tensors under ``plan``
    (:func:`paged_attention` takes :func:`.paged_plan`'s; a timing tool
    may pass other spans)."""
    out = torch.empty_like(q)
    stream = stream_of(q)
    capturing = q.is_cuda and torch.cuda.is_current_stream_capturing()
    get = _launch_args.__wrapped__ if capturing else _launch_args
    *args, _ = get(plan, q.device, stream)
    b, h, d = q.shape
    nb, page, h_kv, _ = k_pool.shape
    KERNEL.launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                  *args[:3], b, h, nb, page, h_kv, d, plan.mb, *args[3:],
                  float(scale), dtype_code(q.dtype, _DTYPES), stream)
    return out


def paged_attention(q, k_pool, v_pool, block_tables, lens,
                    scale: Optional[float] = None):
    """q (B, H, D) over paged KV pools -> (B, H, D).  CUDA tensors launch
    the kernel (f32, bf16 or f16; head dims 32, 64, 96, 128), CPU tensors
    run :func:`plain`; int8 pools raise on either."""
    op = "paged_attention"
    fp_pools(op, k_pool, v_pool)
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
    check(op, d2 == d and v_pool.shape == k_pool.shape,
          "pool shape mismatch")
    check(op, block_tables.shape == (b, mb) and lens.shape == (b,),
          "table/lens shape mismatch")
    if b == 0:
        return torch.empty_like(q)
    plan = paged_plan(b, h, h_kv, d, page, mb, q.dtype, sm_count(q.device))
    return launch(q, k_pool, v_pool, block_tables, lens, scale, plan)


def dense_attention(q, k_cache, v_cache, lens,
                    scale: Optional[float] = None):
    """q (B, H, D) attends positions ``[0, lens)`` of dense (B, S, H_kv, D)
    caches -> (B, H, D) in q's dtype.  CUDA tensors launch the paged
    kernel with the caches as the pools (page = S, table
    ``arange(B)[:, None]``, made per call so that a captured graph owns
    it) and q cast to the caches' dtype, the one dtype the kernel reads;
    a cache the kernel cannot take raises.  CPU tensors run
    :func:`attend_dense_gqa` (NaN where ``lens == 0``; the kernel gives
    zeros there).  int8 caches raise on either."""
    fp_pools("paged_attention", k_cache, v_cache)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not on_cuda("paged_attention", q, k_cache, v_cache, lens,
                   kernel=KERNEL):
        return attend_dense_gqa(q, k_cache, v_cache, lens, scale)
    table = torch.arange(q.shape[0], dtype=torch.int32,
                         device=q.device)[:, None]
    out = paged_attention(q.to(k_cache.dtype), k_cache, v_cache, table,
                          lens, scale)
    return out.to(q.dtype)
