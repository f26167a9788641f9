"""Fused GELU MLP, ``gelu(x @ W1 + b1) @ W2 + b2`` (GPT's 4h FFN).

The kernel is ``paddle_tpu_torch/csrc/fused_gelu_mlp.cu`` (CUDA C++ for
sm_90a); it replaces the TPU kernel ``paddle_tpu/ops/pallas/fused_mlp.py``
``fused_gelu_mlp``.  Its source note gives the bound and the design:
blocks split the F axis and write f32 partials, which a second pass sums
in a fixed order before adding b2 once.  :func:`plain` is the same
function in plain PyTorch, the twin of the JAX ``_fused_gelu_mlp_ref``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import Kernel, dtype_code, stream_of
from ._common import check, check_dense, dot_f32, on_cuda

__all__ = ["KERNEL", "fused_gelu_mlp", "plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("fused_gelu_mlp", "pt_fused_gelu_mlp",
                [_P] * 7 + [_I] * 4 + [_P])


def plain(x, w1, b1, w2, b2):
    """x @ W1 accumulated in f32 plus b1 in f32, the erf GELU in f32
    rounded to x.dtype, h @ W2 accumulated in f32 plus b2 in f32, rounded
    once."""
    dt = x.dtype
    h = F.gelu(dot_f32(x, w1.to(dt)) + b1.float()).to(dt)
    return (dot_f32(h, w2.to(dt)) + b2.float()).to(dt)


def fused_gelu_mlp(x, w1, b1, w2, b2):
    """x (T, H); w1 (H, F); b1 (F,); w2 (F, H); b2 (H,) -> (T, H) in
    x.dtype.  CUDA tensors launch the kernel (the biases widened to f32,
    exactly) or raise, naming the shape or dtype it cannot take (H and F
    multiples of 128, f32 or bf16); CPU tensors run :func:`plain`."""
    op = "fused_gelu_mlp"
    if not on_cuda(op, x, w1, b1, w2, b2, kernel=KERNEL):
        return plain(x, w1, b1, w2, b2)
    check(op, x.ndim == 2 and w1.ndim == 2 and w2.ndim == 2,
          "x, w1 and w2 must be 2-D")
    code = dtype_code(x.dtype)
    t, h = x.shape
    f = w1.shape[1]
    check_dense(op, x.dtype, x=x, w1=w1, w2=w2)
    check(op, h % 128 == 0 and f % 128 == 0,
          f"hidden {h} and ffn {f} must be multiples of 128")
    check(op, tuple(w1.shape) == (h, f) and tuple(w2.shape) == (f, h)
          and tuple(b1.shape) == (f,) and tuple(b2.shape) == (h,),
          "shape mismatch")
    b1f = b1.float().contiguous()
    b2f = b2.float().contiguous()
    out = torch.empty((t, h), dtype=x.dtype, device=x.device)
    if t == 0:
        return out
    n = KERNEL.helper("pt_fused_gelu_mlp_scratch", [_I, _I, _I],
                      ctypes.c_longlong)(t, h, f)
    partial = torch.empty((n,), dtype=torch.float32, device=x.device)
    KERNEL.launch(x.data_ptr(), w1.data_ptr(), b1f.data_ptr(),
                  w2.data_ptr(), b2f.data_ptr(), partial.data_ptr(),
                  out.data_ptr(), t, h, f, code, stream_of(x))
    return out
