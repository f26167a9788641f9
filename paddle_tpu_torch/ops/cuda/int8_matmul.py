"""Weight-only int8 matmul, ``x @ w.astype(x.dtype) * scale``.

The kernel is ``paddle_tpu_torch/csrc/int8_matmul.cu`` (CUDA C++ for
sm_90a, the shared body in ``csrc/dequant_matmul.cuh``); it replaces the
TPU kernel ``paddle_tpu/ops/pallas/int8_matmul.py`` ``int8_matmul`` (both
of its grid forms).  The device memory carries the raw int8 bytes; each
block widens its weight tile in shared memory.  Where the output has too
few tiles to fill the card, K is split across blocks into f32 partials
that a second pass adds in a fixed order (the scratch is allocated
here).  :func:`plain` is the same function in plain PyTorch, the twin of
the composition in ``paddle_tpu/nn/quant.py`` ``weight_only_linear``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, dtype_code, stream_of
from ._common import check, dot_f32, on_cuda

__all__ = ["KERNEL", "int8_matmul", "plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("int8_matmul", "pt_int8_matmul", [_P] * 5 + [_I] * 4 + [_P])
# the types x may have on the card
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def plain(x, w, scale):
    """Products of x and the widened weight accumulated in f32, the
    per-column scale applied in f32, one rounding to x.dtype."""
    return (dot_f32(x, w.to(x.dtype)) * scale.float()).to(x.dtype)


def launch(kernel: Kernel, op: str, x, w, scale, k: int, n: int):
    """Check a dequant matmul's card tensors and launch ``kernel`` (the
    int8 or the int4 entry point, which take the same arguments);
    returns the (M, N) output in x.dtype."""
    check(op, x.dtype in DTYPES, f"x is {x.dtype}; the kernel takes "
          "float32, bfloat16 or float16")
    check(op, w.dtype == torch.int8, f"weight is {w.dtype}, expected int8")
    check(op, scale.dtype == torch.float32,
          f"scale is {scale.dtype}, expected float32")
    for name, t in (("x", x), ("weight", w), ("scale", scale)):
        check(op, t.is_contiguous(), f"{name} is not contiguous")
    m = x.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    code = dtype_code(x.dtype, DTYPES)
    elems = kernel.helper(kernel.symbol + "_scratch", [_I] * 4,
                          ctypes.c_longlong)(m, k, n, code)
    partial = torch.empty((elems,), dtype=torch.float32,
                          device=x.device) if elems else None
    kernel.launch(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), None if partial is None
                  else partial.data_ptr(), m, k, n, code, stream_of(x))
    return out


def int8_matmul(x, w, scale):
    """x (M, K) float; w (K, N) int8; scale (N,) f32 -> (M, N) in x.dtype.
    CUDA tensors launch the kernel, CPU tensors run :func:`plain`."""
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} must "
                         "be 2-D")
    k, (k2, n) = x.shape[1], w.shape
    if k != k2:
        raise ValueError(f"x K={k} vs weight rows {k2}")
    if tuple(scale.shape) != (n,):
        raise ValueError(f"scale {tuple(scale.shape)} != ({n},)")
    if not on_cuda("int8_matmul", x, w, scale, kernel=KERNEL):
        return plain(x, w, scale)
    return launch(KERNEL, "int8_matmul", x, w, scale, k, n)
