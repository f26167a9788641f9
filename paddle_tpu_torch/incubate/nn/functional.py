"""``paddle_tpu.incubate.nn.functional`` counterpart: the fused entry
points of the serving path, with the reference's signatures.

``fused_rms_rope_qkv``, ``fused_swiglu_mlp`` and ``ragged_paged_attend``
launch their hand-written kernels (``ops/cuda``) on CUDA tensors and run
the plain versions on CPU tensors.  The ``_..._ref``/``_paged_*`` names
are the plain versions under the reference's names.  ``_paged_span_write``
and ``paged_copy_blocks`` are plain indexed tensor code here as in the
reference, where they are not Pallas kernels either.

Forward only: gradients belong to the training slice.

Out-of-range block ids.  The serving scheduler makes dead slots and
warmup inert by pointing block tables at the sentinel id ``num_blocks``.
JAX drops out-of-range scatters and clamps gathers; PyTorch raises (and a
CUDA device-side assert kills the process).  So the span write and the
page copy mask dead entries out before indexing, and the gather clamps.
Unlike the reference, both writes update the pools IN PLACE (the engine
owns exactly one copy of its pools) and return the same tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...ops.cuda import fused_mlp as _fm
from ...ops.cuda import fused_norm_qkv as _fq
from ...ops.cuda import ragged_attention as _ra

__all__ = ["fused_rms_rope_qkv", "fused_swiglu_mlp", "paged_copy_blocks",
           "ragged_paged_attend"]

_fused_swiglu_mlp_ref = _fm.plain
_fused_rms_rope_qkv_ref = _fq.plain
_paged_gather_dense = _ra.paged_gather_dense
_ragged_attend_dense = _ra.ragged_attend_dense


def fused_swiglu_mlp(x, w_gate, w_up, w_down):
    """``silu(x @ Wg) * (x @ Wu) @ Wd`` in one kernel.  x: (T, H);
    returns (T, H) in x.dtype."""
    dt = x.dtype
    return _fm.fused_swiglu_mlp(x, w_gate.to(dt), w_up.to(dt),
                                w_down.to(dt))


def fused_rms_rope_qkv(x, norm_weight, w_q, w_k, w_v, cos, sin,
                       head_dim: int, eps: float = 1e-5):
    """rms_norm -> q/k/v projections -> rotate-half rope on q/k in one
    kernel.  x: (T, H); norm_weight: (H,); w_q: (H, Nq); w_k/w_v:
    (H, Nk); cos/sin: (T, head_dim).  Returns ``(q, k, v)`` in x.dtype."""
    dt = x.dtype
    return _fq.fused_rms_rope_qkv(x, norm_weight.to(dt), w_q.to(dt),
                                  w_k.to(dt), w_v.to(dt), cos.to(dt),
                                  sin.to(dt), head_dim, eps)


def _paged_span_write(cache, k, v, block_tables, span_starts, span_lens):
    """Write a token span ``k``/``v`` (B, C, H_kv, D) into the paged pools
    at positions ``[span_starts, span_starts + span_lens)`` of each slot.
    Rows ``>= span_lens`` (chunk padding, idle slots) are masked out
    before any index is formed, so neither they nor a sentinel table
    entry ever touch the pools.  In place; returns ``cache``.  (The
    ``nonzero()`` syncs the host with the card once per call.)"""
    if len(cache) != 2:
        raise NotImplementedError(
            "int8 paged pools are not ported yet (ROADMAP.md)")
    kc, vc = cache
    s = k.shape[1]
    bs = kc.shape[1]
    mb = block_tables.shape[1]
    ar = torch.arange(s, device=k.device)
    pos = span_starts.long()[:, None] + ar[None, :]              # (B, C)
    live = ar[None, :] < span_lens.long()[:, None]
    bi, ci = live.nonzero(as_tuple=True)
    p = pos[bi, ci]
    blk = block_tables.long()[bi, torch.clamp(p // bs, max=mb - 1)]
    off = p % bs
    kc[blk, off] = k[bi, ci].to(kc.dtype)
    vc[blk, off] = v[bi, ci].to(vc.dtype)
    return cache


def ragged_paged_attend(cache, q, new_k, new_v, block_tables, span_starts,
                        span_lens, scale: Optional[float] = None):
    """ONE serving step for a ragged batch of token spans: the span's k/v
    is written at ``[start, start + len)`` of each slot, then query row
    ``j`` attends pool positions ``[0, start + j]``.  ``q``/``new_k``/
    ``new_v`` are (B, C, H|H_kv, D); ``cache`` is the layer's (k, v) pool
    pair (NB, page, H_kv, D).  Returns ``(out (B, C, H, D), cache)``."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    cache = _paged_span_write(cache, new_k, new_v, block_tables,
                              span_starts, span_lens)
    kc, vc = cache
    out = _ra.ragged_paged_attention(q, kc, vc, block_tables, span_starts,
                                     span_lens, scale=scale)
    return out, cache


def paged_copy_blocks(cache, src_blocks, dst_blocks):
    """Copy whole pages ``src_blocks[i] -> dst_blocks[i]`` inside every
    pool of ``cache`` (the device half of copy-on-write).  Entries whose
    destination is out of range (the ``num_blocks`` padding sentinel) are
    dropped before indexing.  In place; returns ``cache``."""
    nb = cache[0].shape[0]
    dst = dst_blocks.long()
    keep = (dst >= 0) & (dst < nb)
    src = src_blocks.long()[keep].clamp(0, nb - 1)
    dst = dst[keep]
    for a in cache:
        a[dst] = a[src]
    return cache
