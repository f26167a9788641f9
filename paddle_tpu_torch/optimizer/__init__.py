"""Optimizers (``paddle_tpu/optimizer/__init__.py`` counterpart).

Ported: the ``Optimizer`` base (master weights under ``multi_precision``,
``apply`` with ``grad_clip``, the decay mask, L1/L2 coefficients),
``Adam`` with its ``_adam_core``, and ``AdamW`` with ``use_fused``.  The
other optimizers are not ported yet (ROADMAP.md).

The reference's pure core ``init(params) -> state`` and
``apply(grads, state, params) -> (params, state)`` keeps its names and
state keys (``step``, ``master``, ``moment1``, ``moment2``), with two
PyTorch idioms:
- ``apply`` updates IN PLACE: the parameters, the f32 master weights and
  the moments are overwritten, and the same ``params``/``state`` come
  back;
- ``state["step"]`` is a Python int on the host, so the learning rate and
  the bias corrections are host floats that reach the fused kernel as
  launch arguments, with no sync.

``AdamW(use_fused=None)`` routes every :func:`fused_adamw.eligible`
tensor (f32 master or parameter, size a multiple of 1024) through ONE
launch of the fused multi-tensor kernel on the card (its plain version on
CPU tensors); ``use_fused=False`` pins the composition, as in the
reference.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..nn.clip import ClipGradBase
from ..ops.cuda import fused_adamw as _fadamw
from ..regularizer import L1Decay, L2Decay
from . import lr as lr_mod
from .lr import LRScheduler

__all__ = ["Adam", "AdamW", "LRScheduler", "Optimizer", "lr"]

lr = lr_mod


def _lr_value(lr, step: int) -> float:
    if isinstance(lr, LRScheduler):
        return lr.lr_at(step)
    return float(np.float32(lr))


def _bias_denom(beta: float, step: int) -> float:
    """``1 - beta**t`` for ``t = step + 1``, in f32 as the reference."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(step + 1))


class _Item(NamedTuple):
    """One parameter's share of an update."""
    name: str
    param: torch.Tensor       # the model's parameter (any float dtype)
    compute: torch.Tensor     # what the rule updates: master or param
    grad: torch.Tensor
    wd: float
    slots: Dict[str, torch.Tensor]


class Optimizer:
    """Base optimizer: the pure-core surface over in-place updates."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=0.0, grad_clip: Optional[ClipGradBase] = None,
                 multi_precision=False,
                 apply_decay_param_fun: Optional[Callable] = None):
        self._lr = learning_rate
        self.weight_decay = weight_decay or 0.0
        self._l1_coeff = 0.0
        if isinstance(self.weight_decay, L1Decay):
            self._l1_coeff = self.weight_decay.coeff
            self._wd_coeff = 0.0
        elif isinstance(self.weight_decay, L2Decay):
            self._wd_coeff = self.weight_decay.coeff
        else:
            self._wd_coeff = float(self.weight_decay)
        self.grad_clip = grad_clip
        self.multi_precision = multi_precision
        self.master_grad = False  # set by amp.decorate(master_grad=True)
        # ``parameters`` is accepted for the reference's signature; the
        # pure core takes the parameters by name in init/apply
        self.apply_decay_param_fun = apply_decay_param_fun

    # ---- pure core (in place) ---------------------------------------------

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        state = {"step": 0}
        if self.multi_precision:
            state["master"] = {
                k: (p.detach().float().clone()
                    if p.is_floating_point() and p.dtype != torch.float32
                    else None)
                for k, p in params.items()}
        state.update(self._init_slots(params))
        return state

    def _init_slots(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        return {}

    def _update_one(self, name, p, g, lr, slots, step, wd):
        """f32 ``p``/``g`` -> ``(new_p, new_slots)``, functional."""
        raise NotImplementedError

    def _decay_mask(self, params) -> Dict[str, bool]:
        if self.apply_decay_param_fun is None:
            return {k: True for k in params}
        return {k: bool(self.apply_decay_param_fun(k)) for k in params}

    def apply(self, grads: Dict[str, torch.Tensor], state: Dict,
              params: Dict[str, torch.Tensor]):
        """One update, in place.  ``grads`` may cover a subset of
        ``params`` (frozen ones are skipped).  Returns ``(params,
        state)``, the same objects."""
        if self.master_grad:
            grads = {k: g.float() if g.is_floating_point() else g
                     for k, g in grads.items()}
        if self.grad_clip is not None:
            grads = self.grad_clip(grads)
        step = int(state["step"])
        lr = _lr_value(self._lr, step)
        masters = state.get("master") or {}
        decay = self._decay_mask(params)
        items = []
        for name, g in grads.items():
            p = params[name]
            master = masters.get(name)
            compute = master if master is not None else p
            wd = self._wd_coeff if decay.get(name, True) else 0.0
            if self._l1_coeff and decay.get(name, True):
                # L1Decay: subgradient of coeff*|w| added to the grad
                g = g.float() + self._l1_coeff * torch.sign(compute.float())
            slots = {k: v[name] for k, v in state.items()
                     if isinstance(v, dict) and k != "master" and name in v}
            items.append(_Item(name, p, compute, g, wd, slots))
        with torch.no_grad():
            self._update(items, lr, step)
        state["step"] = step + 1
        return params, state

    def _update(self, items: List[_Item], lr: float, step: int) -> None:
        for it in items:
            new_p, new_slots = self._update_one(
                it.name, it.compute.float(), it.grad.float(), lr, it.slots,
                step, it.wd)
            it.compute.copy_(new_p)
            if it.compute is not it.param:      # master weights
                it.param.copy_(new_p)
            for k, v in new_slots.items():
                it.slots[k].copy_(v)

    # ---- paddle-style surface ---------------------------------------------

    def step(self):
        raise NotImplementedError(
            "the eager opt.step() surface is not ported yet (ROADMAP.md): "
            "use paddle_tpu_torch.jit.TrainStep")

    @property
    def _learning_rate(self):
        return self._lr


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.0,
                 grad_clip=None, multi_precision=False, lazy_mode=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        if lazy_mode:
            raise NotImplementedError("lazy_mode (sparse rows) is not "
                                      "ported yet (ROADMAP.md)")
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_mode = lazy_mode

    def _init_slots(self, params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"moment1": {k: zeros(p) for k, p in params.items()},
                "moment2": {k: zeros(p) for k, p in params.items()}}

    def _adam_core(self, p, g, lr, m, v, step, wd, decoupled):
        if wd and not decoupled:
            g = g + wd * p
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * g.square()
        mhat = m / _bias_denom(self.beta1, step)
        vhat = v / _bias_denom(self.beta2, step)
        update = mhat / (torch.sqrt(vhat) + self.epsilon)
        if wd and decoupled:
            update = update + wd * p
        return p - lr * update, m, v

    def _update_one(self, name, p, g, lr, slots, step, wd):
        new_p, m, v = self._adam_core(p, g, lr, slots["moment1"],
                                      slots["moment2"], step, wd,
                                      decoupled=False)
        return new_p, {"moment1": m, "moment2": v}


class AdamW(Adam):
    """Decoupled weight decay.

    ``use_fused``: ``None`` (auto) sends every eligible update through the
    fused multi-tensor kernel (``ops/cuda/fused_adamw.py``: one launch per
    step on the card, its plain version on CPU tensors); ``False`` pins
    the composition.  Both compute the reference's formula."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, multi_precision=False,
                 apply_decay_param_fun=None, lr_ratio=None, use_fused=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision)
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported yet")
        self.apply_decay_param_fun = apply_decay_param_fun
        self.use_fused = use_fused

    def _fusable(self, it: _Item) -> bool:
        if self.use_fused is False or not _fadamw.eligible(it.compute):
            return False
        # the kernel writes a bf16 parameter beside an f32 master
        return it.compute is it.param or it.param.dtype == torch.bfloat16

    def _update(self, items, lr, step):
        fused = [it for it in items if self._fusable(it)]
        if fused:
            c1, c2 = _fadamw.bias_corrections(step, self.beta1, self.beta2)
            grads = [it.grad if it.grad.dtype in (torch.float32,
                                                  torch.bfloat16)
                     else it.grad.float() for it in fused]
            _fadamw.fused_adamw_update(
                [it.compute for it in fused],
                [g.contiguous() for g in grads],
                [it.slots["moment1"] for it in fused],
                [it.slots["moment2"] for it in fused], lr, c1, c2,
                beta1=self.beta1, beta2=self.beta2, eps=self.epsilon,
                wds=[it.wd for it in fused],
                lows=[None if it.compute is it.param else it.param
                      for it in fused])
        rest = [it for it in items if not self._fusable(it)]
        super()._update(rest, lr, step)

    def _update_one(self, name, p, g, lr, slots, step, wd):
        new_p, m, v = self._adam_core(p, g, lr, slots["moment1"],
                                      slots["moment2"], step, wd,
                                      decoupled=True)
        return new_p, {"moment1": m, "moment2": v}
