"""``Linear`` and ``Embedding`` with the reference's weight layouts: a
Linear weight is (in_features, out_features), as in
``paddle_tpu/distributed/mp_layers.py``; an Embedding weight is
(vocab, hidden).  Parameters are made on an explicit device and dtype and
drawn from an explicit ``torch.Generator``; they are trainable (serving
runs under ``torch.no_grad()``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import functional as F

__all__ = ["Embedding", "Linear"]


def _normal(shape, std, device, dtype, generator):
    w = torch.empty(shape, device=device, dtype=dtype)
    with torch.no_grad():
        w.normal_(0.0, std, generator=generator)
    return nn.Parameter(w)


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, *,
                 std: float = 0.02, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _normal((in_features, out_features), std, device,
                              dtype, generator)

    def forward(self, x):
        return F.linear(x, self.weight)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 std: float = 0.02, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _normal((num_embeddings, embedding_dim), std, device,
                              dtype, generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)
