"""The port's multi-LoRA serving (``paddle_tpu_torch.serving.LoRAPool``,
``Engine(lora=)``) held against the JAX package on the CPU.

The plain grouped BGMV (what the CPU runs, and what the card's kernel is
held against) against the JAX Pallas kernel in interpret mode and
``_lora_bgmv_ref`` (tolerance f32 2e-5, bf16 2e-2: one bf16 unit of the
O(1) deltas; index-0 rows exactly 0); the pool's registry semantics as
``tests/test_lora.py`` pins them for the reference; the engine against
the JAX LoRA engine on the same numpy adapters; base requests bitwise
equal to a LoRA-less engine; adapters against merged-weight references;
prefix sharing within an adapter and never across adapters.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import serving as jserving
from paddle_tpu.incubate.nn.functional import _lora_bgmv_ref as jax_ref
from paddle_tpu.models.llama import llama as jax_llama
from paddle_tpu.ops.pallas.lora_matmul import grouped_bgmv as jax_bgmv
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import (llama as torch_llama,
                                     lora_pool_from_numpy, params_from_numpy)
from paddle_tpu_torch.ops.cuda import lora_matmul as TLM
from paddle_tpu_torch.serving import (AdapterInUse, LoRAPool, UnknownAdapter,
                                      merge_adapter, random_adapter)

TIE = 1e-3        # f32 logits of the two packages differ by ~1e-5
GEOM = dict(max_batch=4, max_seq_len=48, page_size=8, prefill_chunk=8)


# -- the grouped BGMV ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [8, 16])
def test_plain_bgmv_matches_jax(dtype, rank):
    rng = np.random.default_rng(3)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    bsz, c, h, o, n = 4, 16, 256, 384, 5
    x = jnp.asarray(rng.normal(size=(bsz, c, h)), jdt)
    a = jnp.asarray(rng.normal(size=(n, h, rank)) * 0.05, jdt).at[0].set(0)
    b = jnp.asarray(rng.normal(size=(n, rank, o)) * 0.05, jdt).at[0].set(0)
    idx = np.array([0, 3, 1, 3], np.int32)
    want = [np.asarray(f(x, a, b, jnp.asarray(idx)), np.float32)
            for f in (lambda *z: jax_bgmv(*z, interpret=True), jax_ref)]
    t = [torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt)
         for v in (x, a, b)]
    got = TLM.grouped_bgmv(*t, torch.from_numpy(idx)).float().numpy()
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)
    for w in want:
        np.testing.assert_allclose(got, w, **tol)
    assert (got[0] == 0.0).all()        # index 0: the exact no-op


def test_bgmv_validates_shapes_as_jax():
    x, a, b = torch.zeros((2, 4, 8)), torch.zeros((3, 8, 4)), \
        torch.zeros((3, 4, 6))
    with pytest.raises(ValueError, match="stack mismatch"):
        TLM.grouped_bgmv(x, a, torch.zeros((3, 5, 6)),
                         torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="idx"):
        TLM.grouped_bgmv(x, a, b, torch.zeros(3, dtype=torch.int32))


# -- the pool -----------------------------------------------------------------


@pytest.fixture(scope="module")
def arrays():
    pt.seed(0)
    jm = jax_llama("tiny")
    return jm, {k: np.asarray(v) for k, v in jm.named_parameters()}


def _port(arrays, fused_ops="off"):
    return params_from_numpy(
        torch_llama("tiny", device="cpu", fused_ops=fused_ops), arrays[1])


def _weights(model, seed=7, rank=8):
    return random_adapter(model, rank=rank, rng=np.random.default_rng(seed))


def test_pool_registry(arrays):
    """Slots, typed errors, pool full, reload in place, evict in use."""
    model = _port(arrays)
    pool = LoRAPool(model, max_adapters=2, rank=8)
    s1 = pool.load("a", _weights(model))
    s2 = pool.load("b", _weights(model, seed=8))
    assert {s1, s2} == {1, 2} and pool.adapters() == {"a": s1, "b": s2}
    with pytest.raises(UnknownAdapter, match="not loaded"):
        pool.slot_of("ghost")
    with pytest.raises(UnknownAdapter, match="not loaded"):
        pool.acquire("ghost", "rid-1")
    with pytest.raises(ValueError, match="full"):
        pool.load("c", _weights(model))
    assert pool.load("a", _weights(model, seed=9)) == s1
    pool.acquire("a", "req-x")
    pool.acquire("a", "req-x")          # id-keyed: idempotent
    assert pool.refcount("a") == 1
    with pytest.raises(AdapterInUse, match="live"):
        pool.evict("a")
    pool.release("a", "req-x")
    pool.evict("a")
    assert not pool.has("a") and pool.load("c", _weights(model)) == s1


def test_pool_rejects_bad_loads_and_leaks_nothing(arrays):
    model = _port(arrays)
    pool = LoRAPool(model, max_adapters=1, rank=8)
    bad = _weights(model)
    a, b = bad[1]["self_attn.q_proj"]            # layer 0 was valid
    bad[1]["self_attn.q_proj"] = (a[:, :4], b)
    with pytest.raises(ValueError, match="do not match"):
        pool.load("a", bad)
    assert pool.active_adapters == 0
    slot = pool.load("a", _weights(model, seed=9))  # the slot NOT leaked
    snap = pool.device_stacks()[0]["self_attn.q_proj"]["a"][slot].clone()
    with pytest.raises(ValueError, match="do not match"):
        pool.load("a", bad)                        # failed hot-reload
    assert torch.equal(pool.device_stacks()[0]["self_attn.q_proj"]["a"]
                       [slot], snap)
    short = _weights(model)
    short[0]["q_proj"] = short[0].pop("self_attn.q_proj")
    with pytest.raises(ValueError, match="unknown projection"):
        pool.load("b", short)


def test_pool_and_engine_vetoes(arrays):
    """A pool for another geometry, a quantized model, and LoRA with
    weight_quant are refused."""
    model = _port(arrays)
    pool = LoRAPool(model, max_adapters=1, rank=8)
    other = torch_llama("tiny", device="cpu", num_hidden_layers=1)
    with pytest.raises(ValueError, match="geometry"):
        tserving.Engine(other, device="cpu", lora=pool, **GEOM)
    with pytest.raises(ValueError, match="weight_quant"):
        tserving.Engine(model, device="cpu", lora=pool, weight_quant="int8",
                        **GEOM)
    from paddle_tpu_torch.nn.quant import quantize_linears
    quantize_linears(other, algo="weight_only_int8")
    with pytest.raises(ValueError, match="quantized"):
        LoRAPool(other, max_adapters=1, rank=8)


def test_stacks_are_written_in_place(arrays):
    """load/evict write slot rows into the stacks allocated at
    construction: addresses never change, evict zeroes the slot."""
    model = _port(arrays)
    pool = LoRAPool(model, max_adapters=2, rank=8)
    ptrs = [t.data_ptr() for p in pool.device_stacks() for ab in p.values()
            for t in ab.values()]
    w = _weights(model)
    slot = pool.load("a", w)
    stk = pool.device_stacks()[1]["mlp.down_proj"]
    np.testing.assert_array_equal(stk["a"][slot].numpy(),
                                  w[1]["mlp.down_proj"][0])
    pool.evict("a")
    pool.load("b", _weights(model, seed=3))
    pool.evict("b")
    assert [t.data_ptr() for p in pool.device_stacks() for ab in p.values()
            for t in ab.values()] == ptrs
    assert all(float(t.abs().sum()) == 0.0 for p in pool.device_stacks()
               for ab in p.values() for t in ab.values())


# -- the engine ---------------------------------------------------------------


def _prompts():
    r = np.random.default_rng(5)
    return {n: r.integers(0, 256, size=k) for n, k in
            (("p0", 5), ("p1", 17), ("p2", 9), ("p3", 26))}


MIX = {"p0": None, "p1": "ad0", "p2": "ad1", "p3": "ad0"}


def _drive(eng, mix=MIX):
    ps = _prompts()
    for rid, ad in mix.items():
        eng.add_request(ps[rid], max_new_tokens=6, request_id=rid,
                        adapter=ad)
    return eng.run()


@pytest.fixture(scope="module")
def adapters(arrays):
    """Two adapters as numpy, from the JAX package's random_adapter."""
    jm = arrays[0]
    return {f"ad{i}": jserving.random_adapter(
        jm, rank=8, rng=np.random.default_rng(20 + i)) for i in range(2)}


@pytest.fixture(scope="module")
def lora_engine_out(arrays, adapters):
    model = _port(arrays)
    pool = LoRAPool(model, max_adapters=2, rank=8)
    for name, w in adapters.items():
        pool.load(name, w)
    eng = tserving.Engine(model, device="cpu", lora=pool, **GEOM).warmup()
    eng.margins = {}
    out = _drive(eng)
    assert eng.kv_blocks_used == 0 and pool.stats()["live_refs"] == 0
    return eng, pool, out


def test_lora_engine_matches_jax_lora_engine(arrays, adapters,
                                             lora_engine_out):
    """Identical stacks on both sides (the same numpy adapters loaded
    into each pool, and the JAX pool's mirror carried across), the same
    mixed batch: equal greedy streams under the near-tie rule."""
    jm = arrays[0]
    jpool = jserving.LoRAPool(jm, max_adapters=2, rank=8)
    for name, w in adapters.items():
        jpool.load(name, w)
    jeng = jserving.Engine(jm, lora=jpool, **GEOM).warmup()
    jout = _drive(jeng)
    teng, tpool, tout = lora_engine_out
    carried = lora_pool_from_numpy(
        LoRAPool(_port(arrays), max_adapters=2, rank=8), jpool._host,
        jpool.adapters())
    assert carried.adapters() == tpool.adapters()
    for mine, theirs in zip(tpool.device_stacks(), carried.device_stacks()):
        for proj, ab in mine.items():
            for k in ("a", "b"):
                assert torch.equal(ab[k], theirs[proj][k]), (proj, k)
    exempt = 0
    for rid, ref in jout.items():
        m = teng.margins[rid]
        for i, (r, g) in enumerate(zip(ref, tout[rid])):
            if r != g:
                assert m[i] < TIE, (rid, i, m[i])
                exempt += 1
                break
        else:
            assert len(ref) == len(tout[rid])
    assert exempt <= 1 and sorted(tout) == sorted(jout)


def test_base_requests_bitwise_equal_to_lora_less_engine(arrays,
                                                         lora_engine_out):
    """Index 0 adds an exact 0.0: the base requests of the mixed batch
    equal a LoRA-less engine's on the same (unfused) path."""
    _, _, out = lora_engine_out
    eng = tserving.Engine(_port(arrays), device="cpu", **GEOM).warmup()
    plain = _drive(eng, {"p0": None})
    assert out["p0"] == plain["p0"]


def test_adapters_match_merged_weight_references(arrays, adapters,
                                                 lora_engine_out):
    """Each adapter's requests equal a LoRA-less engine on a model with
    the adapter merged in (``W + A @ B``), under the near-tie rule (the
    merged product rounds differently in f32)."""
    _, _, out = lora_engine_out
    for name, w in adapters.items():
        model = _port(arrays)
        assert merge_adapter(model, w) == 7 * 2
        eng = tserving.Engine(model, device="cpu", **GEOM).warmup()
        eng.margins = {}
        rids = {r: None for r, ad in MIX.items() if ad == name}
        ref = _drive(eng, rids)
        for rid in rids:
            for i, (r, g) in enumerate(zip(ref[rid], out[rid])):
                if r != g:
                    assert eng.margins[rid][i] < TIE, (name, rid, i)
                    break
            assert len(ref[rid]) == len(out[rid])
        assert any(out[r] != _drive(tserving.Engine(
            _port(arrays), device="cpu", **GEOM), {r: None})[r]
                   for r in rids), f"{name} changed no stream"


def test_prefix_sharing_within_an_adapter_never_across(arrays, adapters):
    """The same 16-token prompt under adapter 0 twice hits the cache; the
    same prompt under adapter 1 does not (the adapter salts the page
    digests), and each stream is its own adapter's."""
    model = _port(arrays)
    pool = LoRAPool(model, max_adapters=2, rank=8)
    for name, w in adapters.items():
        pool.load(name, w)
    eng = tserving.Engine(model, device="cpu", lora=pool, **GEOM).warmup()
    p = np.random.default_rng(9).integers(0, 256, size=16)
    outs, hits = {}, []
    for rid, ad in (("x0", "ad0"), ("x1", "ad0"), ("y1", "ad1")):
        h0 = eng.prefix_stats()["hits"]
        eng.add_request(p, max_new_tokens=5, request_id=rid, adapter=ad)
        outs.update(eng.run())
        hits.append(eng.prefix_stats()["hits"] - h0)
    assert hits[0] == 0 and hits[1] > 0 and hits[2] == 0, hits
    assert outs["x0"] == outs["x1"] and outs["y1"] != outs["x0"]
    assert eng.launches_per_step()["grouped_bgmv"] == 7 * 2


def test_adapter_lifecycle_through_the_engine(arrays, adapters):
    """An unknown adapter is refused at admission (typed) and pins
    nothing; a live request pins its adapter until it retires."""
    model = _port(arrays)
    pool = LoRAPool(model, max_adapters=2, rank=8)
    pool.load("ad0", adapters["ad0"])
    eng = tserving.Engine(model, device="cpu", lora=pool, **GEOM)
    with pytest.raises(UnknownAdapter):
        eng.add_request(np.arange(5), adapter="ghost")
    with pytest.raises(UnknownAdapter):
        tserving.Engine(_port(arrays), device="cpu", **GEOM).add_request(
            np.arange(5), adapter="ad0")
    with pytest.raises(ValueError):
        eng.add_request(np.arange(40), max_new_tokens=40, adapter="ad0")
    assert pool.refcount("ad0") == 0           # rejected: released
    eng.add_request(np.arange(7), max_new_tokens=3, request_id="r",
                    adapter="ad0")
    eng.step()
    with pytest.raises(AdapterInUse):
        pool.evict("ad0")
    eng.run()
    assert pool.refcount("ad0") == 0 and eng.lora_stats()["live_refs"] == 0
    pool.evict("ad0")
