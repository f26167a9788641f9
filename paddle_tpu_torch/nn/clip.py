"""Gradient clipping (``paddle_tpu/nn/clip.py`` counterpart).

Clips map a ``{name: grad}`` dict to a new one, as in the reference.  The
global norm and the scale stay 0-d tensors on the grads' device, so
clipping never waits on the card.  A scaled grad is computed in f32 and
rounded once to the grad's dtype, as the reference's ``(g * scale)
.astype(g.dtype)`` does.  Mesh axes (``sum_axes``) are not ported.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue"]


class ClipGradBase:
    def __call__(self, grads: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, grads):
        return {k: g.clamp(self.min, self.max) for k, g in grads.items()}


class ClipGradByNorm(ClipGradBase):
    """Per-tensor norm clip."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        out = {}
        for k, g in grads.items():
            n = g.float().square().sum().sqrt()
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                max=1.0)
            out[k] = (g.float() * scale).to(g.dtype)
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm=1.0, group_name="default_group"):
        self.clip_norm = clip_norm

    def global_norm(self, grads) -> torch.Tensor:
        sq = None
        for g in grads.values():
            s = g.float().square().sum()
            sq = s if sq is None else sq + s
        if sq is None:
            return torch.zeros(())
        return sq.sqrt()

    def __call__(self, grads):
        if not grads:
            return {}
        norm = self.global_norm(grads)
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}
