"""``TrainStep`` (``paddle_tpu/jit/__init__.py`` counterpart), one device.

The reference compiles the whole step (forward, backward, clip,
optimizer) into one XLA program over a donated state.  PyTorch runs it
eagerly instead: ``loss_fn(model, batch)``, ``loss.backward()``, then the
optimizer's in-place ``apply``.  The names and the ``state``/``metrics``
contract are the reference's:

    step = TrainStep(model, causal_lm_loss, opt)
    state = step.init_state(seed=0)
    state, metrics = step(state, batch)     # metrics: "loss", "lr"

``state["params"]`` holds the model's own parameters (updated in place),
``state["opt"]`` the optimizer state (``step``, ``master``, ``moment1``,
``moment2``), ``state["step"]`` a host int and ``state["rng"]`` a seeded
``torch.Generator``.  ``metrics["loss"]`` is a 0-d tensor on the model's
device (reading it waits for the card); ``metrics["lr"]`` the learning
rate the update used.

Meshes, ZeRO, offload, gradient accumulation and the loss scaler raise
``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..optimizer import _lr_value

__all__ = ["TrainStep"]

_TODO = " is not ported yet (ROADMAP.md)"


class TrainStep:
    """Eager training step over one device, in-place state."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 scaler=None, mesh=None, batch_axes=("dp", "sharding"),
                 batch_spec=None, zero_stage: Optional[int] = None,
                 zero_axes=("dp", "sharding"),
                 extra_metrics: Optional[Callable] = None,
                 gradient_accumulation: Optional[bool] = None):
        if mesh is not None or batch_spec is not None:
            raise NotImplementedError("TrainStep over a mesh" + _TODO)
        if zero_stage:
            raise NotImplementedError("ZeRO sharding and offload" + _TODO)
        if gradient_accumulation:
            raise NotImplementedError("gradient accumulation" + _TODO)
        if scaler is not None and getattr(scaler, "enable", True):
            raise NotImplementedError("the loss scaler" + _TODO)
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.extra_metrics = extra_metrics

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        params = dict(self.model.named_parameters())
        return {"params": params, "opt": self.optimizer.init(params),
                "step": 0,
                "rng": torch.Generator(device=self._device()).manual_seed(
                    int(seed))}

    def _batch(self, batch):
        dev = self._device()
        out = {}
        for k, x in batch.items():
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            out[k] = x.to(dev) if isinstance(x, torch.Tensor) else x
        return out

    def __call__(self, state, batch, accumulate: Optional[bool] = None):
        if accumulate:
            raise NotImplementedError("gradient accumulation" + _TODO)
        params = state["params"]
        mine = dict(self.model.named_parameters())
        if params.keys() != mine.keys() or any(
                params[k] is not p for k, p in mine.items()):
            raise ValueError("state['params'] must be this model's own "
                             "parameters (from init_state)")
        batch = self._batch(batch)
        for p in params.values():
            p.grad = None
        loss = self.loss_fn(self.model, batch)
        loss.backward()
        # every trainable parameter gets a grad, as under jax.grad: one the
        # loss never reached is a zero
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items() if p.requires_grad}
        for p in params.values():
            p.grad = None
        lr = _lr_value(self.optimizer._learning_rate,
                       int(state["opt"]["step"]))
        self.optimizer.apply(grads, state["opt"], params)
        state["step"] = int(state["step"]) + 1
        metrics = {"loss": loss.detach(), "lr": lr}
        if self.extra_metrics is not None:
            metrics.update(self.extra_metrics(state, batch))
        return state, metrics
