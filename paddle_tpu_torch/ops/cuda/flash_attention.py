"""Flash attention, forward and backward, over the (B, S, H, D) layout.

The kernels are ``paddle_tpu_torch/csrc/flash_attention.cu`` (CUDA C++
for sm_90a); they replace the TPU kernels
``paddle_tpu/ops/pallas/flash_attention.py`` ``_flash_fwd`` and
``_flash_bwd``.  The source note gives the bound and the design: the
forward, and a split backward (a dK/dV kernel that sums the GQA group in
the block, then a dQ kernel).  :func:`plain` and :func:`plain_bwd` are the
same functions in plain PyTorch, dense, with the same rounding points: the
CPU runs them, and the card holds the kernels against them.

Contracts kept from the reference:
- causal masking is bottom-right aligned (row i sees key j iff
  j <= i + Sk - Sq) and needs Sq <= Sk (both wrappers raise otherwise,
  on every device, as the reference's public entries do);
- any head_dim up to 256, the reference's gate; the kernels take f32,
  bf16 and f16 storage and raise on a card tensor of another type;
- GQA reads kv head ``h // (H // Hkv)``; K and V are never repeated;
- the softmax statistic is the base-2 ``lse = log2(sum(exp2(s)))`` per
  row, (B, H, Sq) in f32, which ``flash_attention_with_lse`` returns and
  context-parallel attention merges;
- the lse cotangent folds into the backward as
  ``delta' = rowsum(dO * O) - dlse * log2(e)``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._build import Kernel, dtype_code, stream_of
from ._common import check, check_dense, on_cuda

__all__ = ["BWD", "FWD", "flash_attention", "flash_attention_with_lse",
           "flash_bwd", "flash_fwd", "plain", "plain_bwd", "supported"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD = Kernel("flash_attention", "pt_flash_fwd",
             [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P])
BWD = Kernel("flash_attention", "pt_flash_bwd",
             [_P] * 9 + [_I] * 6 + [_F, _F, _I, _I, _P])
LOG2E = math.log2(math.e)
NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _scores(q, k, scale, causal):
    """Base-2 scores (B, Hkv, G, Sq, Sk) in f32, masked entries NEG_INF."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (scale * LOG2E)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        keep = torch.arange(sk, device=q.device)[None, :] <= rows
        s = s.masked_fill(~keep, NEG_INF)
    return s


def plain(q, k, v, causal: bool = False, scale: Optional[float] = None):
    """Dense twin of the forward kernel: ``(out (B, Sq, H, D) in q.dtype,
    lse (B, H, Sq) f32)``; p is rounded to v.dtype before ``p v``."""
    b, sq, h, d = q.shape
    scale = _scale(q, scale)
    s = _scores(q, k, scale, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    out = (o / l.permute(0, 3, 1, 2, 4)).reshape(b, sq, h, d).to(q.dtype)
    return out, (m + torch.log2(l)).reshape(b, h, sq)


def _delta(out, dout, dlse):
    # out promotes to f32 inside the product (exact): no f32 copy of it
    delta = (dout.float() * out).sum(-1).transpose(1, 2)  # (B,H,Sq)
    if dlse is not None:
        delta = delta - dlse.float() * LOG2E
    return delta.contiguous()


def plain_bwd(q, k, v, out, lse, dout, causal: bool = False,
              scale: Optional[float] = None, dlse=None):
    """Dense twin of the backward kernels: ``(dq, dk, dv)`` from the saved
    ``out`` and ``lse``; p and ds are rounded to the storage type before
    their products, and dk/dv sum over the GQA group in f32."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = _scale(q, scale)
    delta = _delta(out, dout, dlse).reshape(b, hkv, g, sq, 1)
    s = _scores(q, k, scale, causal)
    p = torch.exp2(s - lse.reshape(b, hkv, g, sq, 1))
    if causal:
        p = p.masked_fill(s == NEG_INF, 0.0)
    dog = dout.reshape(b, sq, hkv, g, d).float()
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - delta) * scale
    dt = q.dtype
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(dt).float(), dog)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds.to(dt).float(),
                      q.reshape(b, sq, hkv, g, d).float())
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds.to(dt).float(), k.float())
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _reject_causal_overhang(q, k, causal):
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(
            f"causal flash attention requires sq <= sk, got sq={q.shape[1]} "
            f"sk={k.shape[1]}: rows with no visible key have undefined "
            "attention (use the plain composition)")


def _check(op, q, k, v):
    check(op, q.dtype in _DTYPES,
          f"the kernels take float32, bfloat16 or float16, got {q.dtype}")
    check_dense(op, q.dtype, q=q, k=k, v=v)
    b, sq, h, d = q.shape
    check(op, k.ndim == 4 and tuple(v.shape) == tuple(k.shape)
          and k.shape[0] == b and k.shape[3] == d, "q/k/v shape mismatch")
    check(op, h % k.shape[2] == 0, f"{h} q heads over {k.shape[2]} kv heads")
    check(op, 0 < d <= MAX_HEAD_DIM, f"head_dim {d} not in "
          f"(0, {MAX_HEAD_DIM}]")
    check(op, b > 0 and sq > 0 and k.shape[1] > 0, "empty input")


def flash_fwd(q, k, v, scale: float, causal: bool):
    """``(out, lse)``: CUDA tensors launch the forward kernel, CPU tensors
    run :func:`plain`."""
    op = "flash_attention"
    _reject_causal_overhang(q, k, causal)
    if not on_cuda(op, q, k, v, kernel=FWD):
        return plain(q, k, v, causal, scale)
    _check(op, q, k, v)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               lse.data_ptr(), b, sq, k.shape[1], h, k.shape[2], d,
               float(scale * LOG2E), int(bool(causal)),
               dtype_code(q.dtype, _DTYPES), stream_of(q))
    return out, lse


def flash_bwd(q, k, v, out, lse, dout, scale: float, causal: bool,
              dlse=None):
    """``(dq, dk, dv)``: CUDA tensors launch the dK/dV and dQ kernels
    (one counted launch), CPU tensors run :func:`plain_bwd`.  delta is a
    PyTorch reduction, as the reference leaves it to XLA."""
    op = "flash_attention_bwd"
    _reject_causal_overhang(q, k, causal)
    if not on_cuda(op, q, k, v, out, lse, dout, kernel=BWD):
        return plain_bwd(q, k, v, out, lse, dout, causal, scale, dlse)
    dout = dout.contiguous()
    _check(op, q, k, v)
    check_dense(op, q.dtype, out=out, dout=dout)
    check_dense(op, torch.float32, lse=lse)
    delta = _delta(out, dout, dlse)
    b, sq, h, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    BWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
               lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
               dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1], h,
               k.shape[2], d, float(scale), float(scale * LOG2E),
               int(bool(causal)), dtype_code(q.dtype, _DTYPES), stream_of(q))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, saved (q, k, v, out, lse), backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout, ctx.scale,
                               ctx.causal, dlse)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None):
    """Like :func:`flash_attention`, and also the base-2 per-row ``lse``
    (B, H, Sq).  Differentiable in both outputs."""
    return _FlashAttention.apply(q, k, v, _scale(q, scale), bool(causal))


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """[b, s, h, d] in and out; kv heads may divide q heads (GQA)."""
    return _FlashAttention.apply(q, k, v, _scale(q, scale), bool(causal))[0]


def supported(q, k, v, causal: bool = False) -> bool:
    """The reference's gate, and only it: 4-D, h % hkv == 0, d <= 256,
    both sequences >= 8, no causal sq > sk."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        return False
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if causal and sq > sk:
        return False
    return h % hkv == 0 and d <= MAX_HEAD_DIM and sq >= 8 and sk >= 8
