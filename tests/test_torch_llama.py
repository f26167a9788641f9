"""The port's Llama (paddle_tpu_torch.models) held against the JAX Llama on
the CPU: the same parameters, loaded through ``params_from_numpy``, and
one ragged serving step over the same pools must agree within 1e-4
(f32): hidden states on live rows, the last-row logits, and every written
pool page.  The step and the dense forward run under both
``fused_ops="on"`` (the fused entry points) and ``"off"`` (the unfused
projections), each against the JAX model of the same mode."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.models.llama import llama as jax_llama
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import params_from_numpy
from paddle_tpu_torch.models.llama import PRESETS as TORCH_PRESETS

from paddle_tpu.models.llama import PRESETS as JAX_PRESETS

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models_by_mode():
    """{fused_ops: (JAX model, port model)}, one seeded weight set."""
    out = {}
    for mode in ("on", "off"):
        pt.seed(0)
        jm = jax_llama("tiny", fused_ops=mode)
        arrays = {k: np.asarray(v) for k, v in jm.named_parameters()}
        out[mode] = (jm, params_from_numpy(
            torch_llama("tiny", device="cpu", fused_ops=mode), arrays))
    return out


@pytest.fixture(scope="module")
def models(models_by_mode):
    return models_by_mode["on"]


def test_presets_and_parameter_names_match(models):
    jm, tm = models
    assert {k: dataclasses.asdict(v) for k, v in TORCH_PRESETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_PRESETS.items()}
    jshapes = {k: tuple(v.shape) for k, v in jm.named_parameters()}
    tshapes = {k: tuple(v.shape) for k, v in tm.named_parameters()}
    assert tshapes == jshapes


@pytest.mark.parametrize("fused_ops", ["on", "off"])
def test_one_ragged_step_matches_jax(models_by_mode, fused_ops):
    jm, tm = models_by_mode[fused_ops]
    cfg = jm.cfg
    rng = np.random.default_rng(0)
    b, c, page, nb, mb = 4, 8, 8, 24, 6
    shape = (nb, page, cfg.num_key_value_heads, cfg.head_dim)
    pools = [(rng.normal(size=shape).astype(np.float32),
              rng.normal(size=shape).astype(np.float32))
             for _ in range(cfg.num_hidden_layers)]
    tokens = rng.integers(0, cfg.vocab_size, size=(b, c)).astype(np.int32)
    # mid-prompt chunk, decode token, idle slot, fresh first chunk
    starts = np.array([10, 29, 0, 0], np.int32)
    lens = np.array([6, 1, 0, 8], np.int32)
    tables = np.full((b, mb), nb, np.int32)
    perm = rng.permutation(nb)
    k = 0
    for i in range(b):
        n = -(-(starts[i] + lens[i]) // page)
        tables[i, :n] = perm[k:k + n]
        k += n

    jh, jc = jm.model(jnp.asarray(tokens),
                      caches=[(jnp.asarray(a), jnp.asarray(v))
                              for a, v in pools],
                      seq_lens=jnp.asarray(lens),
                      block_tables=jnp.asarray(tables),
                      span_starts=jnp.asarray(starts))
    tcaches = [(torch.from_numpy(a.copy()), torch.from_numpy(v.copy()))
               for a, v in pools]
    with torch.no_grad():
        th, tc = tm.model(torch.from_numpy(tokens), caches=tcaches,
                          seq_lens=torch.from_numpy(lens),
                          block_tables=torch.from_numpy(tables),
                          span_starts=torch.from_numpy(starts))
        last = np.clip(lens - 1, 0, c - 1)
        tl = tm.logits(th[torch.arange(b), torch.from_numpy(last).long()])
    jh = np.asarray(jh)
    jl = np.asarray(jm.logits(jnp.asarray(jh[np.arange(b), last])))
    for i in range(b):
        if lens[i]:
            np.testing.assert_allclose(th[i, :lens[i]].numpy(),
                                       jh[i, :lens[i]], **TOL)
            np.testing.assert_allclose(tl[i].numpy(), jl[i], **TOL)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_bf16_parameters_load_exactly():
    """A JAX bf16 export (ml_dtypes arrays) goes through f32 into a bf16
    port model without changing a bit."""
    pt.seed(1)
    jm = jax_llama("tiny", fused_ops="on")
    arrays = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
              for k, v in jm.named_parameters()}
    assert arrays["lm_head.weight"].dtype.name == "bfloat16"
    tm = params_from_numpy(torch_llama("tiny", device="cpu",
                                       dtype="bfloat16"), arrays)
    for name, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      arrays[name].astype(np.float32))


def test_paths_not_ported_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_llama("tiny", device="cpu", fuse_qkv_mlp=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_llama("tiny", device="cpu", use_recompute=True)
    tm = torch_llama("tiny", device="cpu", loss_seq_chunks=2)
    ids = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm(ids, labels=ids)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.generate(ids, max_new_tokens=2, num_beams=2)


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


@pytest.mark.parametrize("op", ["rms_norm", "rope_cos_sin", "rope_apply",
                                "swiglu", "linear", "embedding"])
def test_nn_functional_matches_jax(op):
    """The on-path ``nn.functional`` ops against the JAX package, f32."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as TF
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    pos = rng.integers(0, 500, size=(3, 5)).astype(np.int32)
    if op == "rms_norm":
        got = TF.rms_norm(torch.from_numpy(x), torch.from_numpy(w[:, 0]),
                          1e-5)
        want = JF.rms_norm(jnp.asarray(x), jnp.asarray(w[:, 0]), 1e-5)
    elif op == "rope_cos_sin":
        got = torch.stack(TF.rope_cos_sin(
            5, 64, position_ids=torch.from_numpy(pos)))
        want = jnp.stack(JF.rope_cos_sin(5, 64,
                                         position_ids=jnp.asarray(pos)))
    elif op == "rope_apply":
        q = x.reshape(3, 5, 2, 32)
        got = torch.stack(TF.apply_rotary_pos_emb(
            torch.from_numpy(q), torch.from_numpy(q[..., ::-1].copy()),
            *TF.rope_cos_sin(5, 32, position_ids=torch.from_numpy(pos))))
        want = jnp.stack(JF.apply_rotary_pos_emb(
            jnp.asarray(q), jnp.asarray(q[..., ::-1]),
            *JF.rope_cos_sin(5, 32, position_ids=jnp.asarray(pos))))
    elif op == "swiglu":
        got = TF.swiglu(torch.from_numpy(x))
        want = JF.swiglu(jnp.asarray(x))
    elif op == "linear":
        got = TF.linear(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(w[0]))
        want = JF.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(w[0]))
    else:
        ids = rng.integers(0, 64, size=(3, 5))
        got = TF.embedding(torch.from_numpy(ids), torch.from_numpy(w))
        want = JF.embedding(jnp.asarray(ids), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
