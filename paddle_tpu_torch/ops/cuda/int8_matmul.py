"""Weight-only int8 matmul, ``x @ w.astype(x.dtype) * scale``.

The kernel is ``paddle_tpu_torch/csrc/int8_matmul.cu`` (CUDA C++ for
sm_90a); it replaces the TPU kernel ``paddle_tpu/ops/pallas/int8_matmul.py``
``int8_matmul`` (both of its grid forms).  The device memory carries the
raw int8 codes; each block widens its weight tile in shared memory.  bf16
and f16 x run a wgmma GEMM over 128 x 128 tiles (``csrc/dequant_gemm.cuh``),
f32 x a SIMT GEMM over 64 x 64 tiles (``csrc/dequant_matmul.cuh``).  Where
the output tiles are too few to fill the card the contraction is split
into f32 partials that a second kernel adds in a fixed order, then
scales and rounds once: :mod:`.int8_plan` chooses the split, the wrapper
allocates the partials from the plan and passes its split count to the C
entry point.  :func:`plain` is the same function in plain PyTorch, the
twin of the composition in ``paddle_tpu/nn/quant.py``
``weight_only_linear``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, dtype_code, stream_of
from ._common import check, dot_f32, on_cuda
from .int8_plan import check_plan, int8_plan
from .mlp_plan import sm_count

__all__ = ["KERNEL", "DTYPES", "int8_matmul", "plain", "check_quant"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("int8_matmul", "pt_int8_matmul", [_P] * 5 + [_I] * 5 + [_P])
# the types x may have on the card
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODE = {d: dtype_code(d, DTYPES) for d in DTYPES}


def plain(x, w, scale):
    """Products of x and the widened weight accumulated in f32, the
    per-column scale applied in f32, one rounding to x.dtype."""
    return (dot_f32(x, w.to(x.dtype)) * scale.float()).to(x.dtype)


def check_quant(op: str, x, w, scale) -> int:
    """Check a dequant matmul's card tensors (the int8 and the int4
    kernels take the same); returns the C entry points' dtype code.  The
    messages are built only for a check that fails: the wrappers run this
    on every call."""
    if x.dtype not in DTYPES:
        check(op, False, f"x is {x.dtype}; the kernel takes float32, "
              "bfloat16 or float16")
    if w.dtype != torch.int8:
        check(op, False, f"weight is {w.dtype}, expected int8")
    if scale.dtype != torch.float32:
        check(op, False, f"scale is {scale.dtype}, expected float32")
    for name, t in (("x", x), ("weight", w), ("scale", scale)):
        if not t.is_contiguous():
            check(op, False, f"{name} is not contiguous")
    return _DTYPE_CODE[x.dtype]


def int8_matmul(x, w, scale):
    """x (M, K) float; w (K, N) int8; scale (N,) f32 -> (M, N) in x.dtype.
    CUDA tensors launch the kernel, CPU tensors run :func:`plain`."""
    op = "int8_matmul"
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} must "
                         "be 2-D")
    k, (k2, n) = x.shape[1], w.shape
    if k != k2:
        raise ValueError(f"x K={k} vs weight rows {k2}")
    if tuple(scale.shape) != (n,):
        raise ValueError(f"scale {tuple(scale.shape)} != ({n},)")
    if not on_cuda(op, x, w, scale, kernel=KERNEL):
        return plain(x, w, scale)
    code = check_quant(op, x, w, scale)
    m = x.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    plan = int8_plan(m, k, n, x.dtype, sm_count(x.device))
    check_plan(op, plan)
    partial = torch.empty((plan.partial_bytes // 4,), dtype=torch.float32,
                          device=x.device) if plan.splits > 1 else None
    KERNEL.launch(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), None if partial is None
                  else partial.data_ptr(), m, k, n, code, plan.splits,
                  stream_of(x))
    return out
