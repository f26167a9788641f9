"""The port's training path held against the JAX package on the CPU: the
fused AdamW update, ``AdamW`` itself, the gradients of the two fused
autograd ops, the dense Llama loss, and ``TrainStep`` steps on ``tiny``
from the same carried state.  Inputs come from numpy seeds; each JAX
reference is built once per module.

Tolerances, f32 throughout:
- the update, moments and loss: rtol 1e-5 -- the same formula in another
  rounding order (the port's fused plain version multiplies by the bias
  corrections, the reference's composition divides);
- gradients: rtol/atol 1e-5 -- the same arithmetic in another summation
  order;
- parameters after ``TrainStep`` steps: an element may move by up to
  ``2 * lr * steps`` where Adam's normalised update flips sign on a
  gradient at the noise level; all but 0.1% of the elements must agree to
  1e-5 + 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as JOPT
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.llama import causal_lm_loss as j_causal_lm_loss
from paddle_tpu.models.llama import llama as jax_llama
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.ops.pallas import fused_adamw as JFA

from paddle_tpu_torch import amp as TAMP
from paddle_tpu_torch import optimizer as TOPT
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (causal_lm_loss, llama, params_from_numpy,
                                     train_state_from_numpy)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops.cuda import fused_adamw as TFA

F32 = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


# -- fused AdamW -------------------------------------------------------------

def test_fused_adamw_plain_matches_jax_kernel():
    rng = np.random.default_rng(0)
    n = (16, 256)
    p, g, m = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    v = rng.uniform(0, 1, size=n).astype(np.float32)
    c1, c2 = TFA.bias_corrections(4, 0.9, 0.999)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    jp, jm, jv = JFA.fused_adamw_update(
        *map(jnp.asarray, (p, g, m, v)), jnp.float32(LR), jnp.float32(c1),
        jnp.float32(c2), wd=0.1, interpret=True, **kw)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    low = torch.empty(n, dtype=torch.bfloat16)
    TFA.fused_adamw_update([tp], [torch.from_numpy(g)], [tm], [tv], LR, c1,
                           c2, wds=[0.1], lows=[low], **kw)
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_array_equal(_np(low), _np(tp.to(torch.bfloat16)))
    assert TFA.eligible(tp) and not TFA.eligible(torch.zeros(64))


@pytest.mark.parametrize("master", [False, True])
def test_adamw_composition_matches_jax(master):
    """``AdamW(use_fused=False)``: clip, decay mask, L2 decoupled decay,
    master weights, two steps."""
    rng = np.random.default_rng(1)
    shapes = {"w": (32, 64), "bias": (64,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    keep = lambda name: name != "bias"      # noqa: E731
    jopt = JOPT.AdamW(learning_rate=LR, weight_decay=0.1,
                      grad_clip=JClip(1.0), multi_precision=master,
                      apply_decay_param_fun=keep, use_fused=False)
    topt = TOPT.AdamW(learning_rate=LR, weight_decay=0.1,
                      grad_clip=ClipGradByGlobalNorm(1.0),
                      multi_precision=master, apply_decay_param_fun=keep,
                      use_fused=False)
    jdt = jnp.bfloat16 if master else jnp.float32
    tdt = torch.bfloat16 if master else torch.float32
    jp = {k: jnp.asarray(a, jdt) for k, a in params.items()}
    # the port's parameters get their own memory: in f32 both
    # ``jnp.asarray`` and ``torch.from_numpy(...).to(f32)`` may alias the
    # numpy arrays, and the port's in-place update would then reach the
    # JAX step's input before its asynchronous dispatch reads it
    tp = {k: torch.tensor(a).to(tdt) for k, a in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    japply = jax.jit(jopt.apply)
    for gr in grads:
        jp, js = japply({k: jnp.asarray(a, jdt) for k, a in gr.items()},
                        js, jp)
        topt.apply({k: torch.tensor(a).to(tdt) for k, a in gr.items()},
                   ts, tp)
    assert ts["step"] == int(js["step"]) == 2
    for slot in ("moment1", "moment2") + (("master",) if master else ()):
        for k in shapes:
            np.testing.assert_allclose(_np(ts[slot][k]), _np(js[slot][k]),
                                       **F32)
    for k in shapes:
        assert tp[k].dtype == tdt
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]),
                                   **(F32 if not master else
                                      dict(rtol=1e-2, atol=1e-2)))


# -- fused-op gradients --------------------------------------------------------

def test_fused_op_gradients_match_jax_vjp():
    rng = np.random.default_rng(2)
    t, h, i, nq, nk, hd = 12, 64, 128, 64, 32, 16
    x = rng.normal(size=(t, h)).astype(np.float32)
    wg, wu = (0.1 * rng.normal(size=(h, i))).astype(np.float32), \
        (0.1 * rng.normal(size=(h, i))).astype(np.float32)
    wd = (0.1 * rng.normal(size=(i, h))).astype(np.float32)
    ct = rng.normal(size=(t, h)).astype(np.float32)
    want = jax.jit(lambda c, *a: jax.vjp(JIF.fused_swiglu_mlp, *a)[1](c))(
        jnp.asarray(ct), *map(jnp.asarray, (x, wg, wu, wd)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, wg, wu, wd)]
    TIF.fused_swiglu_mlp(*ts).backward(torch.from_numpy(ct))
    for a, b in zip(ts, want):
        np.testing.assert_allclose(_np(a.grad), _np(b), rtol=1e-5,
                                   atol=1e-5)

    g = (1 + 0.1 * rng.normal(size=(h,))).astype(np.float32)
    wq = (0.1 * rng.normal(size=(h, nq))).astype(np.float32)
    wk, wv = ((0.1 * rng.normal(size=(h, nk))).astype(np.float32)
              for _ in range(2))
    ang = rng.uniform(0, 20, size=(t, hd // 2)).astype(np.float32)
    ang = np.concatenate([ang, ang], -1)
    args = (x, g, wq, wk, wv, np.cos(ang), np.sin(ang))
    cts = [rng.normal(size=(t, n)).astype(np.float32) for n in (nq, nk, nk)]
    want = jax.jit(lambda c, *a: jax.vjp(
        lambda *b: JIF.fused_rms_rope_qkv(*b, hd, 1e-5), *a)[1](c))(
        tuple(map(jnp.asarray, cts)), *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    outs = TIF.fused_rms_rope_qkv(*ts, hd, 1e-5)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cts])
    for a, b in zip(ts, want):
        np.testing.assert_allclose(_np(a.grad), _np(b), rtol=1e-5,
                                   atol=1e-5)


# -- TrainStep on tiny ---------------------------------------------------------

def _batch(seed, b=2, s=16, vocab=256):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    return {"input_ids": ids, "labels": labels}


def _numpy_state(state):
    """A JAX TrainStep state as numpy copies (the step donates buffers)."""
    return jax.tree.map(np.array, {k: v for k, v in state.items()
                                   if k != "rng"})


@pytest.fixture(scope="module")
def jax_run():
    """JAX ``TrainStep`` on ``tiny`` (f32, fused_ops="on", AdamW +
    ClipGradByGlobalNorm): one warm step, then the carried state, then 3
    steps with their losses and the final state."""
    pt.seed(0)
    jm = jax_llama("tiny", fused_ops="on")
    opt = JOPT.AdamW(learning_rate=LR, weight_decay=0.1,
                     grad_clip=JClip(1.0), parameters=jm.parameters())
    step = JTrainStep(jm, j_causal_lm_loss, opt)
    state = step.init_state(seed=0)
    state, _ = step(state, {k: jnp.asarray(v) for k, v in
                            _batch(0).items()})
    carried = _numpy_state(state)
    losses = []
    for i in range(3):
        state, met = step(state, {k: jnp.asarray(v) for k, v in
                                  _batch(1 + i).items()})
        losses.append(float(met["loss"]))
    return jm.cfg, carried, losses, _numpy_state(state)


def test_train_steps_match_jax(jax_run):
    cfg, carried, losses, final = jax_run
    model = params_from_numpy(
        llama(dataclasses.replace(cfg), device="cpu"), carried["params"])
    opt = TOPT.AdamW(learning_rate=LR, weight_decay=0.1,
                     grad_clip=ClipGradByGlobalNorm(1.0),
                     parameters=model.parameters())
    step = TrainStep(model, causal_lm_loss, opt)
    state = train_state_from_numpy(step.init_state(seed=0), carried)
    assert state["opt"]["step"] == 1
    got = []
    for i in range(3):
        state, met = step(state, _batch(1 + i))
        assert met["lr"] == np.float32(LR)
        got.append(float(met["loss"]))
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    assert state["opt"]["step"] == int(final["opt"]["step"]) == 4
    for slot in ("moment1", "moment2"):
        for k, t in state["opt"][slot].items():
            np.testing.assert_allclose(_np(t), final["opt"][slot][k],
                                       rtol=1e-5, atol=1e-9)
    for k, p in state["params"].items():
        want = final["params"][k]
        diff = np.abs(_np(p) - want)
        assert diff.max() <= 2 * LR * 3, (k, diff.max())
        off = diff > 1e-5 + 1e-5 * np.abs(want)
        assert off.mean() <= 1e-3, (k, off.mean())


def test_o2_master_weights_and_loss_falls():
    model = llama("tiny", device="cpu", seed=0)
    opt = TOPT.AdamW(learning_rate=3e-3, weight_decay=0.1,
                     grad_clip=ClipGradByGlobalNorm(1.0),
                     parameters=model.parameters())
    model, opt = TAMP.decorate(model, opt, level="O2", dtype="bfloat16")
    step = TrainStep(model, causal_lm_loss, opt)
    state = step.init_state(seed=0)
    batch = _batch(5)
    losses = []
    for _ in range(3):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    for k, p in state["params"].items():
        assert p.dtype == torch.bfloat16
        master = state["opt"]["master"][k]
        assert master.dtype == torch.float32
        np.testing.assert_array_equal(_np(p), _np(master.to(torch.bfloat16)))


def test_train_entry_points_need_a_card_or_cpu():
    """No card here: the model raises unless device="cpu"; the parts of
    TrainStep this slice leaves out raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama("tiny")
    model = llama("tiny", device="cpu")
    opt = TOPT.AdamW(parameters=model.parameters())
    for kw in ({"mesh": object()}, {"zero_stage": 2},
               {"gradient_accumulation": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TrainStep(model, causal_lm_loss, opt, **kw)


@pytest.mark.parametrize("dtype,tf32", [(torch.bfloat16, True),
                                        (torch.float32, False)])
def test_fused_backward_precision(monkeypatch, dtype, tf32):
    """The fused MLP's backward recomputes its plain version with TF32
    products for bf16 inputs and PyTorch's own setting for f32 ones, and
    restores the setting after."""
    seen = []
    plain = TIF._fm.plain

    def spy(*a):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return plain(*a)

    monkeypatch.setattr(TIF._fm, "plain", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(7)
    ts = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
          .requires_grad_(True) for s in ((4, 16), (16, 32), (16, 32),
                                          (32, 16))]
    TIF.fused_swiglu_mlp(*ts).sum().backward()
    assert seen == [False, tf32]        # the forward, then the recompute
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert all(t.grad is not None and t.grad.dtype == dtype for t in ts)
