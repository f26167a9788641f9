"""The port's dense-cache ``generate()`` (paddle_tpu_torch.models.generation)
held against the JAX package's on the CPU, on the ``tiny`` Llama (GQA,
``fused_ops`` "on" and "off") and GPT, with the same weights loaded
through ``params_from_numpy``.

Greedy streams are compared token by token under the near-tie rule (a
first mismatch only where the JAX model's top-2 logit margin is below
1e-3, the rest of that row exempt); ``filter_logits`` must equal the JAX
one exactly (the same ``-inf`` mask and the same kept values); the
dense-cache write and attention pair within f32 rtol = atol = 1e-5.
Temperature draws are not bit-equal to jax's PRNG (ROADMAP.md), so
sampling is held to properties: reproducible after ``seed(s)``, other
streams under other seeds, ``top_k=1`` equal to greedy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models import generation as JG
from paddle_tpu.models.llama import llama as jax_llama
from paddle_tpu_torch import seed as torch_seed
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import params_from_numpy
from paddle_tpu_torch.nn.quant import quantize_linears
from paddle_tpu_torch.ops.cuda import paged_attention as TPA
from paddle_tpu_torch.ops.cuda import counts
from test_torch_gpt import model_pair as gpt_pair
from test_torch_serving import _near_tie_equal

PROMPT, NEW = 9, 12
FAMILIES = ("llama-on", "llama-off", "gpt")


def _llama_pair(mode):
    pt.seed(0)
    jm = jax_llama("tiny", fused_ops=mode)
    arrays = {k: np.asarray(v) for k, v in jm.named_parameters()}
    return jm, params_from_numpy(
        torch_llama("tiny", device="cpu", fused_ops=mode), arrays)


@pytest.fixture(scope="module")
def pairs():
    """{family: (JAX model, port model)}, one seeded weight set each."""
    return {"llama-on": _llama_pair("on"), "llama-off": _llama_pair("off"),
            "gpt": gpt_pair("on")}


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(0).integers(
        0, 256, size=(3, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_greedy(pairs, prompts):
    """One JAX greedy ``generate()`` per family."""
    return {fam: np.asarray(jm.generate(jnp.asarray(prompts),
                                        max_new_tokens=NEW))
            for fam, (jm, _) in pairs.items()}


def _margins(jm, out):
    """The JAX model's top-2 logit margin at each generated position of
    each row of ``out`` (B, PROMPT + NEW)."""
    lg = np.asarray(jm(jnp.asarray(out[:, :-1])))[:, PROMPT - 1:]
    top = np.sort(lg, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def _streams_match(jm, ref, got):
    assert ref.shape == got.shape
    if np.array_equal(ref, got):
        return
    np.testing.assert_array_equal(got[:, :PROMPT], ref[:, :PROMPT])
    margins = _margins(jm, ref)
    verdicts = [_near_tie_equal(list(r[PROMPT:]), list(g[PROMPT:]), m)
                for r, g, m in zip(ref, got, margins)]
    assert verdicts.count("exempt") <= 1, verdicts


@pytest.mark.parametrize("family", FAMILIES)
def test_cached_greedy_matches_jax(pairs, prompts, jax_greedy, family):
    jm, tm = pairs[family]
    got = tm.generate(torch.from_numpy(prompts), max_new_tokens=NEW)
    assert got.dtype == torch.int32
    _streams_match(jm, jax_greedy[family], got.numpy())


@pytest.mark.parametrize("family", FAMILIES)
def test_cached_equals_recompute(pairs, prompts, family):
    """Cached and recompute greedy are token-identical, with a repetition
    penalty and a forced EOS too."""
    _, tm = pairs[family]
    ids = torch.from_numpy(prompts)
    kw = dict(max_new_tokens=NEW, repetition_penalty=1.3, eos_token_id=7,
              pad_token_id=0)
    for opts in ({}, kw):
        opts = opts or {"max_new_tokens": NEW}
        assert torch.equal(tm.generate(ids, **opts),
                           tm.generate(ids, use_cache=False, **opts))


def test_penalty_and_eos_match_jax(pairs, prompts):
    """Greedy under a repetition penalty with EOS freezing, the EOS forced:
    the token the port's penalised stream of row 0 emits fifth is the EOS
    id, so row 0 emits the pad id after its first EOS."""
    jm, tm = pairs["llama-on"]
    ids = torch.from_numpy(prompts)
    pen = tm.generate(ids, max_new_tokens=NEW, repetition_penalty=1.3)
    kw = {"repetition_penalty": 1.3, "pad_token_id": 1,
          "eos_token_id": int(pen[0, PROMPT + 4])}
    ref = np.asarray(jm.generate(jnp.asarray(prompts), max_new_tokens=NEW,
                                 **kw))
    got = tm.generate(ids, max_new_tokens=NEW, **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    gen = list(got[0, PROMPT:])
    first = gen.index(kw["eos_token_id"])
    assert first <= 4 and set(gen[first + 1:]) == {1}, gen
    assert not np.array_equal(got, pen.numpy())


@pytest.mark.parametrize("seen", [False, True])
@pytest.mark.parametrize("penalty", [1.0, 1.3])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5])
@pytest.mark.parametrize("top_k", [0, 1, 5])
def test_filter_logits_matches_jax(top_k, top_p, temperature, penalty,
                                   seen):
    rng = np.random.default_rng(top_k * 7 + int(top_p * 10))
    lg = (3.0 * rng.normal(size=(4, 64))).astype(np.float32)
    cnt = rng.integers(0, 3, size=(4, 64)).astype(np.int32) if seen \
        else None
    want = np.asarray(JG.filter_logits(
        jnp.asarray(lg), top_k, top_p, penalty,
        None if cnt is None else jnp.asarray(cnt), temperature))
    got = TG.filter_logits(
        torch.from_numpy(lg), top_k, top_p, penalty,
        None if cnt is None else torch.from_numpy(cnt), temperature)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(want).any(axis=-1).all()


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4)])
def test_dense_cache_write_and_attend_match_jax(heads, q_dtype):
    """``prefill_write_cache`` then ``decode_attend_cache`` against the
    JAX pair, the slots at different lengths (one past the capacity:
    the write is dropped, as in the reference).  The caches are f32; a
    bf16 query and new k/v (a ``kv_cache_dtype`` wider than the model's)
    are written in the cache dtype and attended in f32, the output in
    bf16 (within one bf16 step, rtol = atol = 1e-2)."""
    h, hkv = heads
    b, s_max, d, s = 3, 12, 16, 5
    rng = np.random.default_rng(h + hkv)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    kc, vc = f(b, s_max, hkv, d), f(b, s_max, hkv, d)
    k, v = f(b, s, hkv, d), f(b, s, hkv, d)
    q, nk, nv = f(b, h, d), f(b, hkv, d), f(b, hkv, d)
    lens = np.array([5, 9, s_max], np.int32)
    jq = [jnp.asarray(a, q_dtype) for a in (q, nk, nv)]
    tq = [torch.from_numpy(a).to(getattr(torch, q_dtype))
          for a in (q, nk, nv)]
    jc = JIF.prefill_write_cache((jnp.asarray(kc), jnp.asarray(vc)),
                                 jnp.asarray(k), jnp.asarray(v))
    jout, jc = JIF.decode_attend_cache(jc, *jq, jnp.asarray(lens))
    tc = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    ptrs = [t.data_ptr() for t in tc]
    tc = TIF.prefill_write_cache(tc, torch.from_numpy(k),
                                 torch.from_numpy(v))
    tout, tc = TIF.decode_attend_cache(tc, *tq, torch.from_numpy(lens))
    assert [t.data_ptr() for t in tc] == ptrs
    for t, j in zip(tc, jc):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tout.dtype == tq[0].dtype
    tol = 1e-5 if q_dtype == "float32" else 1e-2
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_dense_attention_on_the_card_reads_the_cache_dtype(monkeypatch):
    """On a card the dense decode launches the paged kernel with q cast
    to the caches' dtype (the one dtype the kernel reads), a fresh
    ``arange(B)[:, None]`` table and the caches as the pools, and hands
    the output back in q's dtype."""
    calls = []
    monkeypatch.setattr(TPA, "on_cuda", lambda op, *ts, kernel=None: True)
    monkeypatch.setattr(TPA, "sm_count", lambda dev: 132)
    monkeypatch.setattr(TPA, "launch",
                        lambda q, kp, vp, tab, lens, scale, plan:
                        calls.append((q, kp, tab)) or torch.ones_like(q))
    b, s_max, hkv, d = 3, 32, 2, 64
    kc = torch.zeros((b, s_max, hkv, d), dtype=torch.float32)
    q = torch.zeros((b, 4, d), dtype=torch.bfloat16)
    out = TPA.dense_attention(q, kc, kc.clone(),
                              torch.ones((b,), dtype=torch.int32))
    (kq, kp, tab), = calls
    assert kq.dtype == torch.float32 and kp is kc
    assert tab.tolist() == [[0], [1], [2]] and tab.dtype == torch.int32
    assert out.dtype == torch.bfloat16 and bool((out == 1).all())


def test_sampling_reproducible_from_seed(pairs, prompts):
    _, tm = pairs["llama-on"]
    ids = torch.from_numpy(prompts)
    kw = dict(max_new_tokens=NEW, decode_strategy="sampling",
              temperature=0.9, top_p=0.95)
    torch_seed(3)
    a = tm.generate(ids, **kw)
    b = tm.generate(ids, **kw)
    torch_seed(3)
    assert torch.equal(tm.generate(ids, **kw), a)
    assert not torch.equal(a, b)
    torch_seed(4)
    assert not torch.equal(tm.generate(ids, **kw), a)
    greedy = tm.generate(ids, max_new_tokens=NEW)
    assert torch.equal(tm.generate(ids, top_k=1, **kw), greedy)


def test_decode_step_keeps_its_buffers(pairs, prompts):
    """The decode holder is memoized per (batch, capacity, dtype) on an
    unchanged model: its caches and static buffers keep their addresses
    across steps and across calls of one shape, whatever the sampling
    options; a new shape replaces it.  Each step runs each kernel's plain
    version once per layer (the card's launches per replay)."""
    _, tm = pairs["llama-on"]
    ids = torch.from_numpy(prompts)
    tm.generate(ids, max_new_tokens=NEW)
    holder = tm.decode_graph
    addrs = lambda: [t.data_ptr() for c in holder.caches for t in c] + \
        [t.data_ptr() for t in holder.graph.inputs.values()]
    before = addrs()
    layers = tm.cfg.num_hidden_layers
    lens = holder.graph.inputs["lens"]
    step_in = torch.from_numpy(prompts[:, 0]).long()
    c0 = counts("cpu")
    holder.step(step_in)
    c1 = counts("cpu")
    for name in ("fused_rms_rope_qkv", "fused_swiglu_mlp",
                 "paged_attention"):
        assert c1[name] - c0[name] == layers, name
    assert int(lens[0]) == PROMPT + NEW
    tm.generate(ids, max_new_tokens=NEW - 4, max_len=PROMPT + NEW,
                decode_strategy="sampling", top_k=5, top_p=0.9,
                repetition_penalty=1.2)
    assert tm.decode_graph is holder and addrs() == before
    assert (holder.captures, holder.replays) == (0, 0)
    tm.generate(ids[:2], max_new_tokens=NEW)
    assert tm.decode_graph is not holder
    assert tm.decode_graph.key == (2, PROMPT + NEW, torch.float32)


def _quantize(m):
    quantize_linears(m, algo="weight_only_int8")


def _to_bf16(m):
    m.to(torch.bfloat16)


def _swap_data(m):
    w = m.lm_head.weight
    w.data = w.data * 2


def _fused_off(m):
    m.cfg.fused_ops = "off"


@pytest.mark.parametrize("change", [_quantize, _to_bf16, _swap_data,
                                    _fused_off])
def test_decode_graph_rebuilt_when_the_model_changes(prompts, change):
    """A captured step has the weights' addresses and the path built in,
    so any change to the model behind an unchanged (batch, capacity,
    dtype) gives a new holder, never the stale one; the cached stream
    still equals the recompute stream of the changed model."""
    torch.manual_seed(0)
    # an override gives the model its own config, so _fused_off leaves
    # the shared preset alone
    tm = torch_llama("tiny", device="cpu", fused_ops="on")
    ids = torch.from_numpy(prompts)
    tm.generate(ids, max_new_tokens=4)
    holder = tm.decode_graph
    tm.generate(ids, max_new_tokens=4)
    assert tm.decode_graph is holder
    change(tm)
    got = tm.generate(ids, max_new_tokens=4)
    assert tm.decode_graph is not holder
    assert tm.decode_graph.key == holder.key
    if change is not _to_bf16:    # bf16 streams may part at near ties
        assert torch.equal(got, tm.generate(ids, max_new_tokens=4,
                                            use_cache=False))


@pytest.mark.parametrize("case", ["max_len", "bad_strategy", "beams_vs",
                                  "beam_one", "zero_new", "int8_recompute"])
def test_argument_errors_match_reference(pairs, prompts, case):
    jm, tm = pairs["llama-on"]
    ids = torch.from_numpy(prompts)
    if case == "zero_new":
        assert torch.equal(tm.generate(ids, max_new_tokens=0), ids)
        return
    kw = {"max_len": dict(max_new_tokens=4, max_len=PROMPT + 3),
          "bad_strategy": dict(decode_strategy="nucleus"),
          "beams_vs": dict(num_beams=2, decode_strategy="sampling"),
          "beam_one": dict(decode_strategy="beam_search"),
          "int8_recompute": dict(use_cache=False,
                                 kv_cache_dtype="int8")}[case]
    with pytest.raises(ValueError) as jerr:
        jm.generate(jnp.asarray(prompts), **kw)
    with pytest.raises(ValueError) as terr:
        tm.generate(ids, **kw)
    assert str(terr.value) == str(jerr.value)


def test_gpt_cache_past_positions_raises(pairs):
    jm, tm = pairs["gpt"]
    n = tm.cfg.max_position_embeddings + 1
    with pytest.raises(ValueError, match="max_position"):
        jm.model.init_cache(1, n)
    with pytest.raises(ValueError, match="max_position"):
        tm.model.init_cache(1, n)
    with pytest.raises(ValueError, match="max_position"):
        tm.generate(torch.zeros((1, 4), dtype=torch.int64),
                    max_new_tokens=4, max_len=n)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kw", [dict(num_beams=2),
                                dict(decode_strategy="beam_search",
                                     num_beams=3)])
def test_not_ported_options_raise(pairs, prompts, family, kw):
    _, tm = pairs[family]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.generate(torch.from_numpy(prompts), max_new_tokens=2, **kw)
