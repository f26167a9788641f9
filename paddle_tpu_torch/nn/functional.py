"""The on-path parts of ``paddle_tpu.nn.functional``, in PyTorch.

Same names, signatures and numerics as the reference: ``rms_norm`` in f32
with the output cast to the input dtype, ``rope_cos_sin`` cast to the
activation dtype, rotate-half ``apply_rotary_pos_emb``, and the plain
``swiglu``/``linear``/``embedding``.  Weight layouts are the reference's:
a linear weight is (in_features, out_features)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["apply_rotary_pos_emb", "embedding", "linear", "rms_norm",
           "rope_cos_sin", "silu", "swiglu"]


def silu(x):
    return F.silu(x)


def swiglu(x, y=None):
    """``silu(x) * y``; with ``y`` None, ``x`` is split in halves."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return silu(x) * y


def linear(x, weight, bias=None):
    """``x @ weight (+ bias)`` with weight (in_features, out_features)."""
    y = x @ weight.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def embedding(ids, weight, padding_idx: Optional[int] = None):
    out = weight[ids.long()]
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return out


def rms_norm(x, weight=None, epsilon: float = 1e-6):
    """f32 math, output cast to x.dtype (reference RmsNormKernel)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def rope_cos_sin(seq_len: int, head_dim: int, base: float = 10000.0,
                 dtype=torch.float32, position_ids=None, device=None):
    """(cos, sin) tables of shape (..., seq_len, head_dim) in ``dtype``;
    ``position_ids`` (e.g. (B, S) per-slot positions) replaces
    ``arange(seq_len)``."""
    if position_ids is not None:
        device = position_ids.device
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2,
                                            dtype=torch.float32,
                                            device=device) / head_dim))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device) \
        if position_ids is None else position_ids.float()
    freqs = pos[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """q/k: (batch, seq, heads, head_dim); cos/sin (seq, head_dim) or
    (batch, seq, head_dim).  Rotate-half (NeoX) pairing."""
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif cos.ndim == 3:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    q_out = q * cos + _rotate_half(q) * sin
    k_out = k * cos + _rotate_half(k) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
