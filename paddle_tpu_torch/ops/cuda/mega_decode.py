"""Decode megakernel: one decoder layer's ragged attention block --
RMSNorm -> Q/K/V -> RoPE -> attention over the paged prefix and the
span -> O-projection + residual -- in one launch.

The kernel is ``paddle_tpu_torch/csrc/mega_decode.cu`` (CUDA C++ for
sm_90a, a cooperative launch in grid-synchronised phases: in bf16 norm,
Q/K/V and O-projection tiles on wgmma with their split sums, in f32 three
SIMT phases); it replaces the TPU kernel
``paddle_tpu/ops/pallas/mega_decode.py`` ``mega_decode``.  Its source note
gives the bound and the design; :mod:`.mega_plan` its splits and scratch.
It returns the span's k/v and never writes the pools: the caller writes
them with the shared span write, as the reference's ``mega_decode_layer``
does.  :func:`plain` is the same function in plain PyTorch: the
reference's composition (``_mega_decode_layer_ref``: the plain QKV, the
span write, the plain ragged attention, the O projection accumulated in
f32) run on copies of the pools.

:func:`supported` is the card's gate, written for Hopper rather than
copied from the TPU's VMEM budget: it raises, naming the condition, for
what the kernel does not take.  Dead rows (``j >= lens[b]``) are
unspecified by the contract; the kernel gives them ``x`` itself and the
plain version attends them, so compare live rows only.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import fused_norm_qkv as _fq
from . import ragged_attention as _ra
from ._build import Kernel, dtype_code, stream_of
from ._common import check, check_dense, dot_f32, fp_pools, on_cuda
from .mega_plan import check_plan, mega_plan
from .mlp_plan import sm_count

__all__ = ["KERNEL", "HEAD_DIMS", "grid_blocks", "mega_decode", "plain",
           "supported"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("mega_decode", "pt_mega_decode",
                [_P] * 20 + [_I] * 12 + [ctypes.c_float] * 2 + [_I, _P])
HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
# Hopper's shared memory a block may use (H100: 232,448 bytes)
_SMEM_LIMIT = 232448
_ROWS = 64      # attention q rows per work item, at most (kRT in the source)


def _attn_smem(rows: int, page: int, d: int) -> int:
    return 4 * (rows * (d + 1) + rows * d + page * (d + 1) + page * d
                + rows * page + 3 * rows)


@functools.lru_cache(maxsize=64)
def grid_blocks(b: int, c: int, h: int, nq: int, nk: int, page: int,
                h_kv: int, d: int, qkv_splits: int, o_splits: int,
                code: int) -> int:
    """The cooperative grid the kernel launches for this geometry and
    plan (``pt_mega_decode_grid``: co-resident blocks, capped at the
    largest phase's work items; 0 when none fits)."""
    return KERNEL.helper("pt_mega_decode_grid", [_I] * 11, _I)(
        b, c, h, nq, nk, page, h_kv, d, qkv_splits, o_splits, code)


def plain(x, norm_weight, w_q, w_k, w_v, w_o, cos, sin, k_pool, v_pool,
          block_tables, starts, lens, head_dim: int, eps: float = 1e-5,
          scale: Optional[float] = None):
    """The composition on copies of the pools: returns ``(x + o_proj(attn),
    span_k, span_v)`` as the kernel does, the pools unchanged."""
    b, c, h = x.shape
    t, dt = b * c, x.dtype
    q, k, v = _fq.plain(x.reshape(t, h), norm_weight, w_q, w_k, w_v,
                        cos.reshape(t, head_dim), sin.reshape(t, head_dim),
                        head_dim, eps)
    nkh = k.shape[-1] // head_dim
    kc, vc = _ra.span_write(k_pool.clone(), v_pool.clone(),
                            k.reshape(b, c, nkh, head_dim),
                            v.reshape(b, c, nkh, head_dim), block_tables,
                            starts, lens)
    attn = _ra.plain(q.reshape(b, c, -1, head_dim), kc, vc, block_tables,
                     starts, lens, scale)
    y = dot_f32(attn.reshape(t, -1), w_o.to(dt)).to(dt)
    return x + y.reshape(b, c, h), k.reshape(b, c, -1), v.reshape(b, c, -1)


def supported(x, w_q, w_k, w_o, head_dim: int, k_pool, v_pool) -> bool:
    """The card's gate: True, or ValueError naming what the kernel does
    not take -- an f32/bf16 span batch (B, C, H) with H a multiple of
    64, weights and pools of its dtype, head_dim in 64/128/256, GQA
    groups that divide, pools (NB, page, H_kv, head_dim), attention
    shared memory within the block's limit, and a cooperative grid of at
    least one co-resident block."""
    op = "mega_decode"
    check(op, x.ndim == 3 and w_q.ndim == 2 and w_k.ndim == 2
          and w_o.ndim == 2, "x must be (B, C, H) and weights 2-D")
    b, c, h = x.shape
    nq, nk = w_q.shape[1], w_k.shape[1]
    check(op, x.dtype in DTYPES,
          f"x is {x.dtype}; the kernel takes float32 or bfloat16")
    for name, t in (("w_q", w_q), ("w_k", w_k), ("w_o", w_o),
                    ("k_pool", k_pool), ("v_pool", v_pool)):
        check(op, t.dtype == x.dtype, f"{name} is {t.dtype}, x is {x.dtype}")
    check(op, head_dim in HEAD_DIMS,
          f"head_dim {head_dim} not in {HEAD_DIMS}")
    check(op, h % 64 == 0, f"hidden {h} not a multiple of 64")
    check(op, nq % head_dim == 0 and nk % head_dim == 0 and nk > 0,
          f"widths {nq}, {nk} not multiples of head_dim {head_dim}")
    h_kv = nk // head_dim
    check(op, (nq // head_dim) % h_kv == 0,
          f"{nq // head_dim} q heads do not divide over {h_kv} kv heads")
    check(op, tuple(w_q.shape) == (h, nq) and tuple(w_k.shape) == (h, nk)
          and tuple(w_o.shape) == (nq, h), "weight shape mismatch")
    check(op, k_pool.ndim == 4 and tuple(k_pool.shape[2:]) == (h_kv, head_dim)
          and tuple(v_pool.shape) == tuple(k_pool.shape),
          f"pools {tuple(k_pool.shape)} are not (NB, page, {h_kv}, "
          f"{head_dim})")
    page = k_pool.shape[1]
    rows = min(_ROWS, c * (nq // nk))
    smem = _attn_smem(rows, page, head_dim)
    check(op, smem <= _SMEM_LIMIT,
          f"page {page} x head_dim {head_dim} needs {smem} bytes of shared "
          "memory")
    plan = mega_plan(max(1, b * c), h, nq, nk, head_dim, x.dtype,
                     sm_count(x.device))
    grid = grid_blocks(b, c, h, nq, nk, page, h_kv, head_dim,
                       plan.qkv_splits, plan.o_splits, dtype_code(x.dtype))
    check(op, grid >= 1, "no block of this geometry is co-resident on the "
          "card (the cooperative launch needs one)")
    return True


def mega_decode(x, norm_weight, w_q, w_k, w_v, w_o, cos, sin, k_pool,
                v_pool, block_tables, starts, lens, head_dim: int,
                eps: float = 1e-5, scale: Optional[float] = None):
    """x (B, C, H) residual stream (un-normed); norm_weight (H,); w_q
    (H, Nq); w_k/w_v (H, Nk); w_o (Nq, H); cos/sin (B, C, head_dim);
    pools (NB, page, H_kv, D); tables (B, MB), starts/lens (B,) int32 ->
    ``(x + o_proj(attention) (B, C, H), span_k (B, C, Nk), span_v (B, C,
    Nk))`` in x.dtype.  CUDA tensors launch the kernel (or raise), CPU
    tensors run :func:`plain`; int8 pools raise on either."""
    op = "mega_decode"
    fp_pools(op, k_pool, v_pool)
    if not on_cuda(op, x, norm_weight, w_q, w_k, w_v, w_o, cos, sin, k_pool,
                   v_pool, block_tables, starts, lens, kernel=KERNEL):
        return plain(x, norm_weight, w_q, w_k, w_v, w_o, cos, sin, k_pool,
                     v_pool, block_tables, starts, lens, head_dim, eps,
                     scale)
    supported(x, w_q, w_k, w_o, head_dim, k_pool, v_pool)
    b, c, h = x.shape
    nq, nk = w_q.shape[1], w_k.shape[1]
    nb, page, h_kv, d = k_pool.shape
    mb = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    check_dense(op, x.dtype, x=x, norm_weight=norm_weight, w_q=w_q,
                w_k=w_k, w_v=w_v, w_o=w_o, cos=cos, sin=sin, k_pool=k_pool,
                v_pool=v_pool)
    check_dense(op, torch.int32, block_tables=block_tables, starts=starts,
                lens=lens)
    check(op, tuple(norm_weight.shape) == (h,)
          and tuple(w_v.shape) == (h, nk)
          and tuple(cos.shape) == (b, c, head_dim)
          and tuple(sin.shape) == (b, c, head_dim)
          and tuple(block_tables.shape) == (b, mb)
          and tuple(starts.shape) == (b,) and tuple(lens.shape) == (b,),
          "norm/rope/table/starts/lens shape mismatch")
    dev, dt = x.device, x.dtype
    out = torch.empty((b, c, h), dtype=dt, device=dev)
    span_k = torch.empty((b, c, nk), dtype=dt, device=dev)
    span_v = torch.empty((b, c, nk), dtype=dt, device=dev)
    if b * c == 0:
        return out, span_k, span_v
    plan = mega_plan(b * c, h, nq, nk, head_dim, dt, sm_count(dev))
    check_plan(op, plan)
    q_scr = torch.empty((b * c, nq), dtype=dt, device=dev)
    att_scr = torch.empty((b * c, nq), dtype=dt, device=dev)
    nx = partial = None
    if plan.scratch_bytes:
        scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8,
                              device=dev)
        nx = scratch.data_ptr()
        partial = nx + plan.partial_offset
    KERNEL.launch(x.data_ptr(), norm_weight.data_ptr(), w_q.data_ptr(),
                  w_k.data_ptr(), w_v.data_ptr(), w_o.data_ptr(),
                  cos.data_ptr(), sin.data_ptr(), k_pool.data_ptr(),
                  v_pool.data_ptr(), block_tables.data_ptr(),
                  starts.data_ptr(), lens.data_ptr(), out.data_ptr(),
                  span_k.data_ptr(), span_v.data_ptr(), q_scr.data_ptr(),
                  att_scr.data_ptr(), nx, partial, b, c, h, nq, nk, nb,
                  page, h_kv, d, mb, plan.qkv_splits, plan.o_splits,
                  float(eps), float(scale), dtype_code(dt), stream_of(x))
    return out, span_k, span_v
