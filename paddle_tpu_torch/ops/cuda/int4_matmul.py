"""Weight-only int4 matmul, ``x @ unpack(packed).astype(x.dtype) * scale``.

The kernel is ``paddle_tpu_torch/csrc/int4_matmul.cu`` (CUDA C++ for
sm_90a, the shared body in ``csrc/dequant_matmul.cuh``); it replaces the
TPU kernel ``paddle_tpu/ops/pallas/int4_matmul.py`` ``int4_matmul`` (both
of its grid forms).  The device memory carries the packed nibbles; each
block unpacks its tile into the interleaved K rows in shared memory and
runs one product (the TPU kernel's parity split of the contraction is an
MXU layout choice, not part of the contract).

The byte layout (``_pack_int4`` in ``paddle_tpu/nn/quant.py``): row 2i
of the (K, N) weight is the low nibble and row 2i+1 the high nibble of
packed row i, each sign-extended.  :func:`unpack_int4` decodes it; it is
``nn.quant._unpack_int4``.  :func:`plain` is the same function in plain
PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, stream_of
from ._common import dot_f32, on_cuda
from .int8_matmul import check_quant

__all__ = ["KERNEL", "int4_matmul", "plain", "unpack_int4"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("int4_matmul", "pt_int4_matmul", [_P] * 5 + [_I] * 4 + [_P])


def unpack_int4(packed):
    """(K/2, N) int8 -> (K, N) int8: arithmetic shifts restore the sign
    of each nibble, row 2i from the low one, 2i+1 from the high one."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)
    n2, out = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * n2, out)


def plain(x, packed, scale):
    """Unpack, then the int8 composition: products accumulated in f32,
    the per-column scale in f32, one rounding to x.dtype."""
    w = unpack_int4(packed).to(x.dtype)
    return (dot_f32(x, w) * scale.float()).to(x.dtype)


def int4_matmul(x, packed, scale):
    """x (M, K) float; packed (K/2, N) int8; scale (N,) f32 -> (M, N) in
    x.dtype.  CUDA tensors launch the kernel, CPU tensors run
    :func:`plain`."""
    if x.ndim != 2 or packed.ndim != 2:
        raise ValueError(f"x {tuple(x.shape)} and packed "
                         f"{tuple(packed.shape)} must be 2-D")
    k, (k2, n) = x.shape[1], packed.shape
    if k != 2 * k2:
        raise ValueError(f"x K={k} vs packed rows {k2} (need K = 2*rows)")
    if tuple(scale.shape) != (n,):
        raise ValueError(f"scale {tuple(scale.shape)} != ({n},)")
    if not on_cuda("int4_matmul", x, packed, scale, kernel=KERNEL):
        return plain(x, packed, scale)
    code = check_quant("int4_matmul", x, packed, scale)
    m = x.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    elems = KERNEL.helper(KERNEL.symbol + "_scratch", [_I] * 4,
                          ctypes.c_longlong)(m, k, n, code)
    partial = torch.empty((elems,), dtype=torch.float32,
                          device=x.device) if elems else None
    KERNEL.launch(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), None if partial is None
                  else partial.data_ptr(), m, k, n, code, stream_of(x))
    return out
