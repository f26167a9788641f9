"""Weight-only quantization for serving (``paddle_tpu/nn/quant.py``
counterpart; the reference's ``paddle.nn.quant``).

Weights are stored int8, or int4 packed two nibbles per byte along the
contraction axis, with f32 scales per output column (or per (group,
column) for ``group_size > 0``).  Names, outputs and byte layouts are
the reference's, so codes, scales and packed bytes agree bit for bit and
a quantized checkpoint moves between the packages unchanged
(``models.params_from_numpy``).

``weight_only_linear`` routes as the reference does: per-column scales
at serving token counts (at most 256 rows) go to the dequant matmul
kernels (``ops/cuda/int8_matmul.py``, ``int4_matmul.py``: the kernel on
CUDA tensors, the plain version on CPU tensors); grouped scales or more
rows run the reference's composition over the widened weight.
``QuantizedLinear`` keeps the codes, the scales and the bias as buffers,
and ``quantize_linears`` swaps a model's ``nn.layers.Linear``s for it in
place.  Not ported (ROADMAP.md): ``llm_int8_linear`` and the
column/row-parallel variants (the port has no meshes yet).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops.cuda import int4_matmul as _i4
from ..ops.cuda import int8_matmul as _i8
from ..ops.cuda._common import dot_f32
from ..ops.cuda.int4_matmul import unpack_int4 as _unpack_int4
from .layers import Linear

__all__ = ["QuantizedLinear", "quantize_linears", "weight_dequantize",
           "weight_only_linear", "weight_quantize"]

_QMAX = {"weight_only_int8": 127.0, "weight_only_int4": 7.0,
         "llm.int8": 127.0}
# the kernels serve per-column scales at decode/serving token counts
KERNEL_MAX_TOKENS = 256


def _check_algo(algo: str) -> None:
    if algo not in _QMAX:
        raise ValueError(f"unsupported algo {algo!r}; one of {list(_QMAX)}")


def _kernel_eligible(weight_scale, n_tokens: int) -> bool:
    """One definition of when the int8/int4 kernels serve: per-column
    scales and at most ``KERNEL_MAX_TOKENS`` rows (the reference's
    gate)."""
    return weight_scale.ndim == 1 and n_tokens <= KERNEL_MAX_TOKENS


def _n_tokens(x) -> int:
    n = 1
    for d in x.shape[:-1]:
        n *= d
    return n


def _pack_int4(q):
    """(in, out) int4-valued int8 -> (in//2, out) int8, two nibbles per
    byte: row 2i in the low nibble, row 2i+1 in the high nibble.  Packing
    along the contraction axis keeps out-channel scales per-column."""
    if q.shape[0] % 2:
        raise ValueError("int4 packing needs an even in_features "
                         f"(got {q.shape[0]})")
    lo = torch.bitwise_and(q[0::2], 0x0F)
    hi = torch.bitwise_left_shift(q[1::2], 4)
    return torch.bitwise_or(lo, hi).to(torch.int8)


@torch.no_grad()
def weight_quantize(x, algo: str = "weight_only_int8", group_size: int = -1):
    """Quantize an (in_features, out_features) weight for weight-only
    serving.  Returns ``(quantized weight, scale)`` on x's device:

    - int8: weight (in, out) int8, scale (out,) f32
    - int4: weight (in//2, out) int8 (packed nibbles), scale (out,) f32
    - group_size > 0: scale (in//group_size, out) f32 (per-group absmax)

    Absmax over qmax, rounded half to even, clipped: IEEE f32 division on
    the CPU and the card alike (the divisor is a tensor, never a scalar
    that a backend may turn into a reciprocal multiply), so the codes and
    scales are the same bits everywhere."""
    _check_algo(algo)
    xf = torch.as_tensor(x).detach().float()
    if xf.ndim != 2:
        raise ValueError(f"weight must be 2-D (in, out); got "
                         f"{tuple(xf.shape)}")
    qmax = _QMAX[algo]
    if group_size and group_size > 0:
        n_in, n_out = xf.shape
        if n_in % group_size:
            raise ValueError(f"in_features {n_in} not divisible by "
                             f"group_size {group_size}")
        g = xf.reshape(n_in // group_size, group_size, n_out)
        amax = g.abs().amax(dim=1)
        scale = amax / torch.full_like(amax, qmax) + 1e-12
        q = torch.round(g / scale[:, None, :]).reshape(n_in, n_out)
    else:
        amax = xf.abs().amax(dim=0)
        scale = amax / torch.full_like(amax, qmax) + 1e-12
        q = torch.round(xf / scale)
    q = torch.clamp(q, -qmax, qmax).to(torch.int8)
    if algo == "weight_only_int4":
        q = _pack_int4(q)
    return q, scale


def weight_dequantize(x, scale, algo: str = "weight_only_int8",
                      group_size: int = -1, out_dtype=torch.float32):
    """Reconstruct the float weight (the reference's weight_dequantize)."""
    _check_algo(algo)
    q = _unpack_int4(x) if algo == "weight_only_int4" else x
    qf = q.to(out_dtype)
    if scale.ndim == 2:  # groupwise
        n_in, n_out = qf.shape
        gs = group_size if group_size and group_size > 0 \
            else n_in // scale.shape[0]
        return (qf.reshape(-1, gs, n_out)
                * scale[:, None, :].to(out_dtype)).reshape(n_in, n_out)
    return qf * scale.to(out_dtype)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype: str = "int8", group_size: int = -1):
    """y = x @ dequant(weight) + bias, with the weight stored int8/int4.

    Per-column scales at most ``KERNEL_MAX_TOKENS`` rows: the int8/int4
    matmul kernel over x as (rows, K).  Otherwise the reference's
    composition: grouped scales dequantize the weight into x's dtype and
    multiply; per-column scales multiply by the widened weight with f32
    accumulation, then scale and round once."""
    int4 = weight_dtype in ("int4", "weight_only_int4")
    algo = "weight_only_int4" if int4 else "weight_only_int8"
    if weight_scale is None:
        raise ValueError("weight_scale is required (from weight_quantize)")
    if _kernel_eligible(weight_scale, _n_tokens(x)):
        fn = _i4.int4_matmul if int4 else _i8.int8_matmul
        lead = x.shape[:-1]
        y = fn(x.reshape(-1, x.shape[-1]), weight, weight_scale)
        y = y.reshape(*lead, y.shape[-1])
    elif weight_scale.ndim == 2:
        y = x @ weight_dequantize(weight, weight_scale, algo=algo,
                                  group_size=group_size, out_dtype=x.dtype)
    else:
        q = _unpack_int4(weight) if int4 else weight
        y = (dot_f32(x, q.to(x.dtype)) * weight_scale).to(x.dtype)
    if bias is not None:
        y = y + bias
    return y


class QuantizedLinear(nn.Module):
    """Weight-only replacement for an ``nn.layers.Linear`` at serving
    time, made by :func:`quantize_linears`.  The codes (``weight``), the
    scales (``weight_scale``) and the bias live in buffers on the
    Linear's device, not in trainable parameters: weight-only
    quantization is a serving transform."""

    def __init__(self, linear, algo: str = "weight_only_int8",
                 group_size: int = -1):
        super().__init__()
        self.in_features, self.out_features = linear.weight.shape
        self.algo = algo
        self.group_size = group_size
        qw, scale = weight_quantize(linear.weight, algo=algo,
                                    group_size=group_size)
        self.register_buffer("weight", qw)
        self.register_buffer("weight_scale", scale)
        bias = getattr(linear, "bias", None)
        self.register_buffer(
            "bias", None if bias is None else bias.detach().clone())
        self._wdtype = "int4" if algo == "weight_only_int4" else "int8"

    def forward(self, x):
        return weight_only_linear(x, self.weight, bias=self.bias,
                                  weight_scale=self.weight_scale,
                                  weight_dtype=self._wdtype,
                                  group_size=self.group_size)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, algo={self.algo}")


def quantize_linears(model: nn.Module, algo: str = "weight_only_int8",
                     group_size: int = -1,
                     predicate: Optional[Callable] = None) -> int:
    """Swap every ``nn.layers.Linear`` under ``model`` for a
    :class:`QuantizedLinear` in place, returning the swap count (15 on
    ``tiny``, 225 on llama2-7b).  ``predicate(name, layer) -> bool``
    filters (e.g. skip ``lm_head`` for quality).  Each float weight is
    released as its layer is swapped."""
    _check_algo(algo)
    count = 0
    for parent in list(model.modules()):
        for name, sub in list(parent.named_children()):
            if type(sub) is Linear and (predicate is None
                                        or predicate(name, sub)):
                setattr(parent, name, QuantizedLinear(
                    sub, algo=algo, group_size=group_size))
                count += 1
    return count
