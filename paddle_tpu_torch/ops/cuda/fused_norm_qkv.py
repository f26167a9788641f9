"""Fused RMSNorm -> Q/K/V projections -> rotate-half RoPE.

The kernel is ``paddle_tpu_torch/csrc/fused_norm_qkv.cu`` (CUDA C++ for
sm_90a); it replaces the TPU kernel
``paddle_tpu/ops/pallas/fused_norm_qkv.py`` ``fused_rms_rope_qkv``.  Its
source note gives the bound and the design.  In bf16 one call is a norm
kernel that writes ``nx`` (the contract's normed, rounded x) to a (T, H)
bf16 scratch, then a wgmma GEMM over 128 x 128 tiles of [q | k | v] with
RoPE applied in registers; where those tiles are too few to fill the card
the contraction is split and a third kernel adds the f32 partials in a
fixed order before the roundings and RoPE.  :mod:`.qkv_plan` chooses the
split; the wrapper allocates nx and the partials from the plan as one
scratch tensor.  f32 runs one SIMT kernel and needs no scratch.
:func:`plain` is the same function in plain PyTorch, the twin of the JAX
``_fused_rms_rope_qkv_ref``: the CPU runs it, and the card holds the
kernel against it.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, dtype_code, stream_of
from ._common import check, check_dense, dot_f32, on_cuda
from .mlp_plan import sm_count
from .qkv_plan import check_plan, qkv_plan

__all__ = ["KERNEL", "fused_rms_rope_qkv", "plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("fused_norm_qkv", "pt_fused_rms_rope_qkv",
                [_P] * 12 + [_I] * 5 + [ctypes.c_float, _I, _I, _P])


def plain(x, norm_weight, w_q, w_k, w_v, cos, sin, head_dim: int,
          eps: float = 1e-5):
    """RMSNorm in f32 rounded to x.dtype, projections accumulated in f32,
    q and k rounded to x.dtype before rotate-half RoPE in f32."""
    dt = x.dtype
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    nx = (xf * torch.rsqrt(ms + eps) * norm_weight.float()).to(dt)

    def proj(w):
        return dot_f32(nx, w.to(dt))

    def rope(y):
        t, n = y.shape
        yh = y.to(dt).float().reshape(t, n // head_dim, head_dim)
        half = head_dim // 2
        rot = torch.cat([-yh[..., half:], yh[..., :half]], dim=-1)
        c = cos.float()[:, None, :]
        s = sin.float()[:, None, :]
        return (yh * c + rot * s).reshape(t, n)

    return (rope(proj(w_q)).to(dt), rope(proj(w_k)).to(dt),
            proj(w_v).to(dt))


def fused_rms_rope_qkv(x, norm_weight, w_q, w_k, w_v, cos, sin,
                       head_dim: int, eps: float = 1e-5):
    """x (T, H); norm_weight (H,); w_q (H, Nq); w_k/w_v (H, Nk);
    cos/sin (T, head_dim) -> (q (T, Nq), k (T, Nk), v (T, Nk)) in
    x.dtype, RoPE applied to q and k.  CUDA tensors launch the kernel,
    CPU tensors run :func:`plain`."""
    op = "fused_rms_rope_qkv"
    if not on_cuda(op, x, norm_weight, w_q, w_k, w_v, cos, sin,
                   kernel=KERNEL):
        return plain(x, norm_weight, w_q, w_k, w_v, cos, sin, head_dim, eps)
    t, h = x.shape
    nq, nk = w_q.shape[1], w_k.shape[1]
    check_dense(op, x.dtype, x=x, norm_weight=norm_weight, w_q=w_q,
                w_k=w_k, w_v=w_v, cos=cos, sin=sin)
    check(op, head_dim in (64, 128), f"head_dim {head_dim} not in (64, 128)")
    check(op, h % 32 == 0, f"hidden {h} not a multiple of 32")
    check(op, nq % head_dim == 0 and nk % head_dim == 0,
          f"widths {nq}, {nk} not multiples of head_dim {head_dim}")
    check(op, tuple(norm_weight.shape) == (h,)
          and tuple(w_q.shape) == (h, nq) and tuple(w_k.shape) == (h, nk)
          and tuple(w_v.shape) == (h, nk)
          and tuple(cos.shape) == (t, head_dim)
          and tuple(sin.shape) == (t, head_dim), "shape mismatch")
    code = dtype_code(x.dtype)
    q = torch.empty((t, nq), dtype=x.dtype, device=x.device)
    k = torch.empty((t, nk), dtype=x.dtype, device=x.device)
    v = torch.empty((t, nk), dtype=x.dtype, device=x.device)
    if t == 0:
        return q, k, v
    plan = qkv_plan(t, h, nq, nk, head_dim, x.dtype, sm_count(x.device))
    check_plan(op, plan)
    scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8,
                          device=x.device) if plan.scratch_bytes else None
    base = None if scratch is None else scratch.data_ptr()
    KERNEL.launch(x.data_ptr(), norm_weight.data_ptr(), w_q.data_ptr(),
                  w_k.data_ptr(), w_v.data_ptr(), cos.data_ptr(),
                  sin.data_ptr(), base if plan.nx_bytes else None,
                  base + plan.partial_offset if plan.splits > 1 else None,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), t, h, nq, nk,
                  head_dim, float(eps), code, plan.splits, stream_of(x))
    return q, k, v
