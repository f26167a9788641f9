"""Fused SwiGLU MLP, ``(silu(x @ Wg) * (x @ Wu)) @ Wd``.

The kernel is ``paddle_tpu_torch/csrc/fused_mlp.cu`` (CUDA C++ for
sm_90a); it replaces the TPU kernel ``paddle_tpu/ops/pallas/fused_mlp.py``
``fused_swiglu_mlp``.  Its source note gives the bound and the design: an
up GEMM (wgmma, 128 x 64 tiles of g and u, a 3-stage cp.async ring)
writes ``h = silu(g) * u`` in x's dtype, and a down GEMM (128 x 128
tiles) multiplies it by Wd, splitting its contraction only where its
tiles are too few to fill the card (:mod:`.mlp_plan`).  The wrapper
allocates ``h`` and the split partials from the plan, as one scratch
tensor.  :func:`plain` is the same function in plain PyTorch, the twin
of the JAX ``_fused_swiglu_mlp_ref``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import Kernel, dtype_code, stream_of
from ._common import check, check_dense, dot_f32, on_cuda
from .mlp_plan import check_plan, mlp_plan, sm_count

__all__ = ["KERNEL", "fused_swiglu_mlp", "plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("fused_mlp", "pt_fused_swiglu_mlp",
                [_P] * 7 + [_I] * 6 + [_P])


def plain(x, w_gate, w_up, w_down):
    """Gate and up accumulated in f32, ``silu(g) * u`` rounded to
    x.dtype, down projection accumulated in f32 and rounded once."""
    dt = x.dtype
    g = dot_f32(x, w_gate.to(dt))
    u = dot_f32(x, w_up.to(dt))
    h = (F.silu(g) * u).to(dt)
    return dot_f32(h, w_down.to(dt)).to(dt)


def fused_swiglu_mlp(x, w_gate, w_up, w_down):
    """x (T, H); w_gate/w_up (H, I); w_down (I, H) -> (T, H) in x.dtype.
    CUDA tensors launch the kernel, CPU tensors run :func:`plain`."""
    op = "fused_swiglu_mlp"
    if not on_cuda(op, x, w_gate, w_up, w_down, kernel=KERNEL):
        return plain(x, w_gate, w_up, w_down)
    t, h = x.shape
    inter = w_gate.shape[1]
    check_dense(op, x.dtype, x=x, w_gate=w_gate, w_up=w_up, w_down=w_down)
    check(op, h % 128 == 0 and inter % 128 == 0,
          f"hidden {h} and intermediate {inter} must be multiples of 128")
    check(op, tuple(w_gate.shape) == (h, inter)
          and tuple(w_up.shape) == (h, inter)
          and tuple(w_down.shape) == (inter, h), "shape mismatch")
    out = torch.empty((t, h), dtype=x.dtype, device=x.device)
    if t == 0:
        return out
    plan = mlp_plan(t, h, inter, x.dtype, "swiglu", sm_count(x.device))
    check_plan(op, plan)
    scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8,
                          device=x.device)
    base = scratch.data_ptr()
    KERNEL.launch(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                  w_down.data_ptr(), base,
                  base + plan.partial_offset if plan.splits > 1 else None,
                  out.data_ptr(), t, h, inter, dtype_code(x.dtype),
                  plan.up_bn, plan.splits, stream_of(x))
    return out
