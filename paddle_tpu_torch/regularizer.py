"""``paddle.regularizer`` parity: L1Decay / L2Decay.

Reference: python/paddle/regularizer.py — regularizer objects passed as
``weight_decay=`` to optimizers (or per-param via ParamAttr.regularizer).

Mapping: L2Decay(c) is exactly the optimizers' scalar weight_decay
(decoupled for AdamW, coupled-into-grad for the rest, matching the
reference's per-optimizer behaviour). L1Decay(c) adds ``c * sign(w)`` to
the gradient before the update rule in the optimizer's
update.
"""

from __future__ import annotations

__all__ = ["L1Decay", "L2Decay", "WeightDecayRegularizer"]


class WeightDecayRegularizer:
    coeff: float = 0.0

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"{type(self).__name__}({self.coeff})"


class L1Decay(WeightDecayRegularizer):
    """grad += coeff * sign(param)."""


class L2Decay(WeightDecayRegularizer):
    """Equivalent to scalar weight_decay=coeff."""
