"""Fused GELU MLP, ``gelu(x @ W1 + b1) @ W2 + b2`` (GPT's 4h FFN).

The kernel is ``paddle_tpu_torch/csrc/fused_gelu_mlp.cu`` (CUDA C++ for
sm_90a); it replaces the TPU kernel ``paddle_tpu/ops/pallas/fused_mlp.py``
``fused_gelu_mlp``.  Its source note gives the bound and the design: an
up GEMM (wgmma, 128-row tiles, 3-stage cp.async ring) writes
``h = gelu(x @ W1 + b1)`` in x's dtype, and a down GEMM adds ``h @ W2``
and b2, splitting its contraction only where its tiles are too few to
fill the card (:mod:`.mlp_plan`; b2 then joins in the fixed-order split
sum).  The wrapper allocates ``h`` and the partials from the plan.
:func:`plain` is the same function in plain PyTorch, the twin of the JAX
``_fused_gelu_mlp_ref``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import Kernel, dtype_code, stream_of
from ._common import check, check_dense, dot_f32, on_cuda
from .mlp_plan import check_plan, mlp_plan, sm_count

__all__ = ["KERNEL", "fused_gelu_mlp", "plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("fused_gelu_mlp", "pt_fused_gelu_mlp",
                [_P] * 8 + [_I] * 7 + [_P])


def plain(x, w1, b1, w2, b2):
    """x @ W1 accumulated in f32 plus b1 in f32, the erf GELU in f32
    rounded to x.dtype, h @ W2 accumulated in f32 plus b2 in f32, rounded
    once."""
    dt = x.dtype
    h = F.gelu(dot_f32(x, w1.to(dt)) + b1.float()).to(dt)
    return (dot_f32(h, w2.to(dt)) + b2.float()).to(dt)


def fused_gelu_mlp(x, w1, b1, w2, b2):
    """x (T, H); w1 (H, F); b1 (F,); w2 (F, H); b2 (H,) -> (T, H) in
    x.dtype.  CUDA tensors launch the kernel (biases of x.dtype as they
    are, others widened to f32, exactly; the kernel widens them where it
    adds them) or raise, naming the shape or dtype it cannot take (H and
    F multiples of 128, f32 or bf16); CPU tensors run :func:`plain`."""
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
    if b1.dtype == b2.dtype == x.dtype:
        b1c, b2c, bias_code = b1.contiguous(), b2.contiguous(), code
    else:
        b1c, b2c = b1.float().contiguous(), b2.float().contiguous()
        bias_code = dtype_code(torch.float32)
    out = torch.empty((t, h), dtype=x.dtype, device=x.device)
    if t == 0:
        return out
    plan = mlp_plan(t, h, f, x.dtype, "gelu", sm_count(x.device))
    check_plan(op, plan)
    scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8,
                          device=x.device)
    base = scratch.data_ptr()
    KERNEL.launch(x.data_ptr(), w1.data_ptr(), b1c.data_ptr(),
                  w2.data_ptr(), b2c.data_ptr(), base,
                  base + plan.partial_offset if plan.splits > 1 else None,
                  out.data_ptr(), t, h, f, code, bias_code, plan.up_bn,
                  plan.splits, stream_of(x))
    return out
