"""LR schedulers (``paddle_tpu/optimizer/lr.py`` counterpart).

Ported: the ``LRScheduler`` base, whose ``lr_at(step)`` the optimizer
reads.  In the port the step count lives on the host, so ``lr_at``
returns a Python float (the f32 value the reference computes) and the
learning rate reaches a kernel as a launch argument with no sync.  The
concrete schedulers are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

__all__ = ["LRScheduler"]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.step()  # advance to epoch 0, paddle semantics

    # pure form: override this
    def lr_at(self, step) -> float:
        return float(np.float32(self.base_lr))

    # stateful parity API
    def step(self, epoch=None):
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1

    def get_lr(self):
        return float(self.lr_at(self.last_epoch))

    def state_dict(self):
        return {"last_epoch": self.last_epoch}

    def set_state_dict(self, d):
        self.last_epoch = d["last_epoch"]

    def __call__(self, step):
        return self.lr_at(step)
