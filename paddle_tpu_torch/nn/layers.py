"""``Linear``, ``Embedding`` and ``LayerNorm`` with the reference's weight
layouts: a Linear weight is (in_features, out_features), as in
``paddle_tpu/distributed/mp_layers.py``, with an optional zero-initialised
bias of (out_features,); an Embedding weight is (vocab, hidden); a
LayerNorm has a weight of ones and a bias of zeros.  Parameters are made
on an explicit device and dtype and drawn from an explicit
``torch.Generator``; they are trainable (serving runs under
``torch.no_grad()``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import functional as F

__all__ = ["Embedding", "LayerNorm", "Linear"]


def _normal(shape, std, device, dtype, generator):
    w = torch.empty(shape, device=device, dtype=dtype)
    with torch.no_grad():
        w.normal_(0.0, std, generator=generator)
    return nn.Parameter(w)


class Linear(nn.Module):
    """``x @ weight (+ bias)``; ``bias=True`` adds a zero-initialised
    ``bias`` parameter, as the reference's Column/RowParallelLinear with
    ``has_bias=True`` do."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = False, std: float = 0.02, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _normal((in_features, out_features), std, device,
                              dtype, generator)
        self.bias = nn.Parameter(torch.zeros(
            out_features, device=device, dtype=dtype)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 std: float = 0.02, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _normal((num_embeddings, embedding_dim), std, device,
                              dtype, generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class LayerNorm(nn.Module):
    """Layer normalisation over the last axis (``F.layer_norm``)."""

    def __init__(self, hidden_size: int, *, epsilon: float = 1e-5,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(hidden_size, device=device,
                                             dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, None, self.weight, self.bias, self.epsilon)
