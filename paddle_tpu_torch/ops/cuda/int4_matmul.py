"""Weight-only int4 matmul, ``x @ unpack(packed).astype(x.dtype) * scale``.

The kernel is ``paddle_tpu_torch/csrc/int4_matmul.cu`` (CUDA C++ for
sm_90a); it replaces the TPU kernel ``paddle_tpu/ops/pallas/int4_matmul.py``
``int4_matmul`` (both of its grid forms).  The device memory carries the
packed nibbles.  bf16 and f16 x run a wgmma GEMM with the operands
swapped (``csrc/dequant_swap.cuh``): each packed byte widens in registers
into one register of the weight's A fragment, x is the B operand with n =
the M tile; f32 x runs a SIMT GEMM (``csrc/dequant_matmul.cuh``).
:mod:`.int4_plan` chooses the tiles and the contraction split; the
wrapper allocates the partials from it and passes it to the C entry
point.  A 16-bit x whose rows are not 16-byte aligned, or K % 8 != 0, is
copied into a zero-padded buffer with an aligned row stride first (the
edge shapes only; the serving path's x never is).

The byte layout (``_pack_int4`` in ``paddle_tpu/nn/quant.py``): row 2i
of the (K, N) weight is the low nibble and row 2i+1 the high nibble of
packed row i, each sign-extended.  :func:`unpack_int4` decodes it; it is
``nn.quant._unpack_int4``.  :func:`plain` is the same function in plain
PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import Kernel, stream_of
from ._common import dot_f32, on_cuda
from .int4_plan import check_plan, int4_plan
from .int8_matmul import check_quant
from .mlp_plan import sm_count

__all__ = ["KERNEL", "int4_matmul", "plain", "unpack_int4"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("int4_matmul", "pt_int4_matmul", [_P] * 5 + [_I] * 8 + [_P])


@functools.lru_cache(maxsize=512)
def _checked_plan(m, k, n, dtype, sms):
    """The plan, checked once per shape: the wrapper runs on every call."""
    plan = int4_plan(m, k, n, dtype, sms)
    check_plan("int4_matmul", plan)
    return plan


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
    plan = _checked_plan(m, k, n, x.dtype, sm_count(x.device))
    ldx = k
    if x.dtype != torch.float32 and (k % 8 or x.data_ptr() % 16):
        ldx = -(-k // 8) * 8
        xp = x.new_zeros((m, ldx))
        xp[:, :k] = x
        x = xp
    partial = torch.empty((plan.partial_bytes // 4,), dtype=torch.float32,
                          device=x.device) if plan.splits > 1 else None
    KERNEL.launch(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), None if partial is None
                  else partial.data_ptr(), m, k, n, ldx, code, plan.bm,
                  plan.bn, plan.splits, stream_of(x))
    return out
