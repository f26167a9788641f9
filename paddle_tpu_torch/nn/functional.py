"""The on-path parts of ``paddle_tpu.nn.functional``, in PyTorch.

Same names, signatures and numerics as the reference: ``rms_norm`` in f32
with the output cast to the input dtype, ``rope_cos_sin`` cast to the
activation dtype, rotate-half ``apply_rotary_pos_emb``, the plain
``swiglu``/``linear``/``embedding``/``softmax``, ``cross_entropy`` in
f32, and ``scaled_dot_product_attention``, which takes the flash-attention
kernels (``ops/cuda/flash_attention.py``) for no mask and no dropout
where their gate admits the shapes, and the plain ``_xla_attention``
composition otherwise.  Weight layouts are the reference's: a linear
weight is (in_features, out_features); attention is [batch, seq, heads,
head_dim]."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.cuda import flash_attention as _fa

__all__ = ["apply_rotary_pos_emb", "cross_entropy", "embedding",
           "flash_attention", "linear", "rms_norm", "rope_cos_sin",
           "scaled_dot_product_attention", "silu", "softmax", "swiglu"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


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


def softmax(x, axis=-1, dtype=None):
    if dtype is not None:
        x = x.to(_DTYPES.get(dtype, dtype))
    return torch.softmax(x, dim=axis)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None):
    """[batch, seq, num_heads, head_dim] in and out.  No mask and no
    dropout: the flash-attention kernels where ``supported`` admits the
    shapes (the card's kernels on CUDA tensors, their plain versions on
    CPU tensors); the plain composition otherwise."""
    if attn_mask is None and dropout_p == 0.0 and _fa.supported(
            query, key, value, causal=is_causal):
        return _fa.flash_attention(query, key, value, causal=is_causal,
                                   scale=scale)
    return _xla_attention(query, key, value, attn_mask, dropout_p,
                          is_causal, training, scale)


def _xla_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                   is_causal=False, training=True, scale=None):
    """The reference's plain composition: logits in f32, softmax, the
    probabilities cast to the query dtype before ``p v``."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError("attention dropout is not ported yet "
                                  "(ROADMAP.md)")
    b, sq, h, d = query.shape
    sk, kh = key.shape[1], key.shape[2]
    if kh != h:  # grouped-query attention: repeat kv heads
        key = key.repeat_interleave(h // kh, dim=2)
        value = value.repeat_interleave(h // kh, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", query, key) * scale
    logits = logits.float()
    if is_causal:
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=query.device).tril(sk - sq)
        logits = logits.masked_fill(~causal, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1).to(query.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, value)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, training=True):
    """paddle.nn.functional.flash_attention parity: ``(out, None)``."""
    out = scaled_dot_product_attention(query, key, value, dropout_p=dropout,
                                       is_causal=causal, training=training)
    return out, None


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  label_smoothing=0.0):
    """Softmax cross entropy in f32 (the reference's numerics): hard
    labels with ``ignore_index`` (weighted mean over the valid labels),
    label smoothing, class weights, or soft labels."""
    logp = torch.log_softmax(input.float(), dim=axis)
    if soft_label:
        if weight is not None:
            logp = logp * weight
        loss = -(label * logp).sum(dim=axis)
    else:
        num_classes = input.shape[axis]
        lab = label.squeeze(axis) if label.ndim == input.ndim else label
        idx = torch.remainder(lab.long(), num_classes)
        nll = -torch.gather(logp, axis, idx.unsqueeze(axis)).squeeze(axis)
        if label_smoothing > 0.0:
            smooth = -logp.mean(dim=axis)
            nll = (1 - label_smoothing) * nll + label_smoothing * smooth
        valid = lab != ignore_index
        w = torch.ones_like(nll)
        if weight is not None:
            w = torch.as_tensor(weight, dtype=torch.float32,
                                device=nll.device)[idx]
        nll = torch.where(valid, nll * w, torch.zeros_like(nll))
        if reduction == "mean":
            denom = torch.where(valid, w, torch.zeros_like(w)).sum()
            return nll.sum() / torch.clamp(denom, min=1e-12)
        loss = nll
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
