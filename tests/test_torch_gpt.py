"""The port's GPT (paddle_tpu_torch.models.gpt) and its fused GELU MLP held
against the JAX package on the CPU.

The JAX ``gpt("tiny")`` initialises every bias to zero and every
LayerNorm to (1, 0), so the tests draw those from numpy and load the same
arrays into both models (``set_state_dict`` / ``params_from_numpy``).

Tolerances: model logits, losses and pools f32 rtol = atol = 1e-4 (the
same arithmetic in another summation order, through two layers); the
kernel's plain version f32 rtol 1e-5 / atol 2e-5, bf16 rtol = atol = 1e-2
(one bf16 unit of the output or of h, 2**-8 relative); its gradients f32
rtol 1e-4 / atol 1e-5.  Engine streams under the near-tie rule, driven
by the traffic of ``test_torch_serving.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import serving as jserving
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models.gpt import PRESETS as JAX_PRESETS
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import fused_mlp as JFM
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.models import gpt as torch_gpt
from paddle_tpu_torch.models import params_from_numpy
from paddle_tpu_torch.models.gpt import PRESETS as TORCH_PRESETS
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda import fused_gelu_mlp as TFG
from test_torch_serving import _drive, _jax_margins, _near_tie_equal

TOL = dict(rtol=1e-4, atol=1e-4)
F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
GEOM = dict(max_batch=4, max_seq_len=64, page_size=8, prefill_chunk=8)


def perturbed(jm, seed=0):
    """The JAX model's parameters with its zero biases and unit/zero
    LayerNorms replaced by draws from numpy, set into the JAX model too;
    returns the numpy arrays."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, v in jm.named_parameters():
        a = np.asarray(v)
        if k.endswith(".bias"):
            a = (0.05 * rng.normal(size=a.shape)).astype(np.float32)
        elif ".ln_" in k and k.endswith(".weight"):
            a = (1.0 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        arrays[k] = a
    jm.set_state_dict(arrays)
    return arrays


def model_pair(mode="on", seed=0, **overrides):
    pt.seed(seed)
    jm = jax_gpt("tiny", fused_ops=mode, **overrides)
    arrays = perturbed(jm, seed)
    tm = params_from_numpy(
        torch_gpt("tiny", device="cpu", fused_ops=mode, **overrides), arrays)
    return jm, tm


@pytest.fixture(scope="module")
def models_by_mode():
    return {mode: model_pair(mode) for mode in ("on", "off")}


def test_presets_and_parameter_names_match(models_by_mode):
    jm, tm = models_by_mode["on"]
    assert {k: dataclasses.asdict(v) for k, v in TORCH_PRESETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_PRESETS.items()}
    jshapes = {k: tuple(v.shape) for k, v in jm.named_parameters()}
    tshapes = {k: tuple(v.shape) for k, v in tm.named_parameters()}
    assert tshapes == jshapes
    assert "model.h.1.mlp.fc_out.bias" in tshapes


@pytest.mark.parametrize("fused_ops", ["on", "off"])
def test_dense_forward_matches_jax(models_by_mode, fused_ops):
    """The uncached forward: logits, and the masked-mean loss with -100
    labels, f32."""
    jm, tm = models_by_mode[fused_ops]
    rng = np.random.default_rng(7)
    ids = rng.integers(0, jm.cfg.vocab_size, size=(2, 12)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[0, -3:] = -100
    with torch.no_grad():
        tl = tm(torch.from_numpy(ids))
        tloss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jm(jnp.asarray(ids))),
                               **TOL)
    jloss = jm(jnp.asarray(ids), labels=jnp.asarray(labels))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_fused_mlp_gate_under_auto():
    """``"auto"`` resolves to ``"on"``: it takes the fused entry at every
    shape (on the CPU its plain version, at tiny's H = 64 too; on the
    card the kernel or an error), ``"off"`` never does."""
    for mode, fused in (("auto", True), ("on", True), ("off", False)):
        tm = torch_gpt("tiny", device="cpu", fused_ops=mode)
        before = TFG.KERNEL.plain_calls
        with torch.no_grad():
            tm(torch.zeros((1, 4), dtype=torch.int64))
        assert (TFG.KERNEL.plain_calls - before == 2) == fused, mode


def _engines_agree(jm, tm, geom, drive):
    jeng = jserving.Engine(jm, **geom)
    jeng.warmup()
    jout, prompts = drive(jeng)
    teng = tserving.Engine(tm, device="cpu", **geom)
    teng.warmup()
    tout, _ = drive(teng)
    assert sorted(tout) == sorted(jout) == sorted(prompts)
    verdicts = {rid: _near_tie_equal(jout[rid], tout[rid],
                                     _jax_margins(jm, prompts[rid],
                                                  jout[rid]))
                for rid in jout}
    exempt = [r for r, v in verdicts.items() if v == "exempt"]
    assert len(exempt) <= 1, f"exempted requests: {exempt}"
    assert teng.kv_blocks_used == 0 and jeng.kv_blocks_used == 0
    return jeng, teng, tout


def test_engine_matches_jax_engine(models_by_mode):
    jm, tm = models_by_mode["on"]
    jeng, teng, _ = _engines_agree(jm, tm, GEOM, _drive)
    js, ts = jeng.prefix_stats(), teng.prefix_stats()
    for key in ("hits", "misses", "registered_pages", "cow_copies"):
        assert ts[key] == js[key], key
    assert ts["hits"] > 0 and ts["cow_copies"] > 0
    launches = teng.launches_per_step()
    assert launches["fused_gelu_mlp"] == 2
    assert launches["ragged_paged_attention"] == 2
    assert launches["fused_swiglu_mlp"] == launches["fused_rms_rope_qkv"] \
        == 0


def test_learned_positions_clamp_at_the_end_of_the_table():
    """Engine(max_seq_len == max_position_embeddings) driven to the last
    position: the padding rows of the last spans run past the table and
    are clamped (JAX fills them with NaN); the streams still equal JAX's
    and every request reaches max_seq_len."""
    jm, tm = model_pair("on", seed=3, max_position_embeddings=32)
    geom = dict(max_batch=2, max_seq_len=32, page_size=8, prefill_chunk=8)

    def drive(eng):
        rng = np.random.default_rng(5)
        prompts = {"x": rng.integers(0, 256, size=21),
                   "y": rng.integers(0, 256, size=13)}
        eng.add_request(prompts["x"], max_new_tokens=11, request_id="x")
        eng.add_request(prompts["y"], max_new_tokens=19, request_id="y")
        return eng.run(), prompts

    _, _, tout = _engines_agree(jm, tm, geom, drive)
    assert len(tout["x"]) == 11 and len(tout["y"]) == 19
    table = tm.model.embed_positions.weight
    got = tm.model._embed(torch.zeros((1, 3), dtype=torch.int64),
                          torch.tensor([[30, 31, 38]]))
    want = tm.model.embed_tokens.weight[0] + table[31]
    assert torch.equal(got[0, 2], want) and torch.equal(got[0, 1], want)


def test_gpt_paths_not_ported_raise(models_by_mode):
    _, tm = models_by_mode["on"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_gpt("tiny", device="cpu", pipeline_stages=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_gpt("tiny", device="cpu", sequence_parallel=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_gpt("tiny", device="cpu", use_recompute=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserving.Engine(tm, device="cpu", weight_quant="int8", **GEOM)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserving.Engine(tm, device="cpu", lora=object(), **GEOM)
    ids = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.model(ids, caches=[None] * tm.cfg.num_hidden_layers)


@pytest.mark.parametrize("op", ["gelu", "gelu_tanh", "layer_norm",
                                "layer_norm_bf16", "linear_bias"])
def test_gelu_layer_norm_match_jax(op):
    rng = np.random.default_rng(6)
    x = (2.0 * rng.normal(size=(3, 5, 64))).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=(64,))).astype(np.float32)
    b = (0.1 * rng.normal(size=(64,))).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    tol = TOL
    if op == "gelu":
        got, want = TF.gelu(tx), JF.gelu(jx)
    elif op == "gelu_tanh":
        got, want = TF.gelu(tx, approximate=True), \
            JF.gelu(jx, approximate=True)
    elif op == "layer_norm":
        got = TF.layer_norm(tx, None, torch.from_numpy(w),
                            torch.from_numpy(b), 1e-5)
        want = JF.layer_norm(jx, None, jnp.asarray(w), jnp.asarray(b), 1e-5)
    elif op == "layer_norm_bf16":
        # bf16 activations, f32 weight and bias: normalised in f32, one
        # rounding at the end
        got = TF.layer_norm(tx.bfloat16(), (64,), torch.from_numpy(w),
                            torch.from_numpy(b))
        want = JF.layer_norm(jx.astype(jnp.bfloat16), (64,), jnp.asarray(w),
                             jnp.asarray(b))
        assert got.dtype == torch.bfloat16
        tol = BF16_TOL
    else:
        from paddle_tpu_torch.nn import Linear
        lin = Linear(64, 32, bias=True)
        assert torch.equal(lin.bias, torch.zeros(32))
        wl = rng.normal(size=(64, 32)).astype(np.float32)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(wl))
            lin.bias.copy_(torch.from_numpy(b[:32]))
            got = lin(tx)
        want = JF.linear(jx, jnp.asarray(wl), jnp.asarray(b[:32]))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **tol)


def _mlp_arrays(rng, t=24, h=128, f=256):
    return [rng.normal(size=(t, h)).astype(np.float32),
            (0.08 * rng.normal(size=(h, f))).astype(np.float32),
            (0.5 * rng.normal(size=(f,))).astype(np.float32),
            (0.08 * rng.normal(size=(f, h))).astype(np.float32),
            (0.5 * rng.normal(size=(h,))).astype(np.float32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gelu_mlp_plain_matches_jax(dtype):
    """The plain version against the reference composition and the
    interpret-mode Pallas kernel; biases stay f32, as the reference's
    kernel takes them."""
    jdt, tdt, tol = {"float32": (jnp.float32, torch.float32, F32_TOL),
                     "bfloat16": (jnp.bfloat16, torch.bfloat16,
                                  BF16_TOL)}[dtype]
    arrs = _mlp_arrays(np.random.default_rng(2))
    j = [jnp.asarray(a, jdt if a.ndim == 2 else jnp.float32) for a in arrs]
    t = [torch.from_numpy(a).to(tdt if a.ndim == 2 else torch.float32)
         for a in arrs]
    got = TFG.fused_gelu_mlp(*t)
    assert got.dtype == tdt
    entry = TIF.fused_gelu_mlp(*t)
    assert torch.equal(got, entry)
    for want in (JIF._fused_gelu_mlp_ref(*j),
                 JFM.fused_gelu_mlp(*j, interpret=True)):
        np.testing.assert_allclose(
            got.float().numpy(),
            np.asarray(jnp.asarray(want, jnp.float32)), **tol)


def test_fused_gelu_mlp_gradients_match_jax_vjp():
    arrs = _mlp_arrays(np.random.default_rng(4), t=8, h=128, f=256)
    ct = np.random.default_rng(5).normal(size=(8, 128)).astype(np.float32)
    _, vjp = jax.vjp(JIF._fused_gelu_mlp_ref, *map(jnp.asarray, arrs))
    want = vjp(jnp.asarray(ct))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    TIF.fused_gelu_mlp(*ts).backward(torch.from_numpy(ct))
    for name, tt, w in zip(("x", "w1", "b1", "w2", "b2"), ts, want):
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_gelu_mlp_wrapper_refuses_devices_without_a_kernel():
    m = torch.device("meta")
    e = torch.empty((8, 128), device=m)
    with pytest.raises(ValueError, match="no kernel for device"):
        TFG.fused_gelu_mlp(e, e.T, e[0], e, e[0])
