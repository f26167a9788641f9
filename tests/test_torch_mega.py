"""The port's decode megakernel path (``fused_ops="mega"``) held against the
JAX package on the CPU.

The plain ``mega_decode`` (the composition on copies of the pools, which
the CPU runs for the kernel) against the JAX Pallas kernel in interpret
mode and against ``_mega_decode_layer_ref``, at
``tests/test_mega_decode.py``'s geometry and starts/lens cases; the layer
entry's pools; the engine against the JAX mega engine and against the
port's ``"on"`` engine; and the launches-per-step gauge.  Tolerances as
the reference's own tests: f32 2e-5, bf16 2e-2 (one bf16 unit of the
O(1) outputs), live rows only (dead rows are unspecified by the contract).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import serving as jserving
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models.llama import llama as jax_llama
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import mega_decode as JMD
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import params_from_numpy
from paddle_tpu_torch.ops.cuda import mega_decode as TMD

TIE = 1e-3        # f32 logits of the two packages differ by ~1e-5
GEOM = dict(max_batch=4, max_seq_len=64, page_size=8, prefill_chunk=8)
CASES = [([13, 0, 5], [1, 8, 0]),      # decode + full chunk + idle slot
         ([7, 21, 3], [3, 1, 5])]      # odd lens mid-chunk


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _case(dtype, starts, lens, b=3, c=8, h=32, nh=4, nkh=2, hd=16, page=8,
          nb=24, mb=6, seed=0):
    """One ragged layer case as numpy (f32 values, exact in bf16 where
    ``dtype`` is bf16): weights, per-slot rope tables at the span
    positions, random pools, a permuted block table."""
    r = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def arr(*shape, scale=0.1):
        a = jnp.asarray(r.normal(size=shape) * scale, jdt)
        return np.asarray(a.astype(jnp.float32))

    st = np.asarray(starts, np.int32)
    cos, sin = JF.rope_cos_sin(
        c, hd, dtype=jdt,
        position_ids=jnp.asarray(st)[:, None] + jnp.arange(c)[None, :])
    return dict(
        x=arr(b, c, h, scale=1.0), g=arr(h, scale=0.1) + 1.0,
        wq=arr(h, nh * hd), wk=arr(h, nkh * hd), wv=arr(h, nkh * hd),
        wo=arr(nh * hd, h),
        cos=np.asarray(cos.astype(jnp.float32)),
        sin=np.asarray(sin.astype(jnp.float32)),
        kp=arr(nb, page, nkh, hd, scale=0.5),
        vp=arr(nb, page, nkh, hd, scale=0.5),
        tables=r.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32),
        starts=st, lens=np.asarray(lens, np.int32), hd=hd)


_ORDER = ("x", "g", "wq", "wk", "wv", "wo", "cos", "sin")


def _jax_args(cs, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    fp = [jnp.asarray(cs[k], jdt) for k in _ORDER]
    pools = (jnp.asarray(cs["kp"], jdt), jnp.asarray(cs["vp"], jdt))
    ints = [jnp.asarray(cs[k]) for k in ("tables", "starts", "lens")]
    return fp, pools, ints


def _torch_args(cs, dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    fp = [torch.tensor(cs[k]).to(tdt) for k in _ORDER]
    pools = (torch.tensor(cs["kp"]).to(tdt), torch.tensor(cs["vp"]).to(tdt))
    ints = [torch.from_numpy(cs[k]) for k in ("tables", "starts", "lens")]
    return fp, pools, ints


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("starts,lens", CASES)
def test_plain_matches_jax_kernel_and_composition(dtype, starts, lens):
    """The port's plain megakernel (what the CPU runs; what the card's
    kernel is held against) against the JAX kernel in interpret mode and
    against the JAX composition: outputs on live rows, span k/v on every
    row."""
    cs = _case(dtype, starts, lens)
    jfp, jpools, jints = _jax_args(cs, dtype)
    tfp, tpools, tints = _torch_args(cs, dtype)
    hd = cs["hd"]
    jout, jk, jv = JMD.mega_decode(*jfp, *jpools, *jints, hd,
                                   interpret=True)
    jref, _ = JIF._mega_decode_layer_ref(*jfp, jpools, *jints, hd, 1e-5,
                                         None)
    kp0 = tpools[0].clone()
    tout, tk, tv = TMD.mega_decode(*tfp, *tpools, *tints, hd)
    assert torch.equal(tpools[0], kp0)          # the kernel writes no pool
    live = np.arange(cs["x"].shape[1])[None, :] < cs["lens"][:, None]
    for want in (jout, jref):
        np.testing.assert_allclose(_np(tout)[live], _np(want)[live],
                                   **_tol(dtype))
    np.testing.assert_allclose(_np(tk), _np(jk), **_tol(dtype))
    np.testing.assert_allclose(_np(tv), _np(jv), **_tol(dtype))


def test_layer_entry_matches_jax_and_writes_pools_as_jax():
    """``mega_decode_layer`` on the CPU: the output and the pools against
    JAX's entry (f32 2e-5: the two packages' f32 CPU products differ in
    the last bit, ~5e-7 here, so the span k/v written differ too); the
    span write itself bit for bit against JAX's from the same span k/v;
    and the layer entry bit for bit against the port's own composition
    ``_mega_decode_layer_ref``."""
    cs = _case("float32", *CASES[1])
    jfp, jpools, jints = _jax_args(cs, "float32")
    tfp, tpools, tints = _torch_args(cs, "float32")
    hd, b, c = cs["hd"], 3, 8
    jout, (jkc, jvc) = JIF.mega_decode_layer(*jfp, jpools, *jints, hd)
    tout, (tkc, tvc) = TIF.mega_decode_layer(*tfp, tpools, *tints, hd)
    live = np.arange(c)[None, :] < cs["lens"][:, None]
    np.testing.assert_allclose(_np(tout)[live], _np(jout)[live],
                               **_tol("float32"))
    np.testing.assert_allclose(_np(tkc), _np(jkc), **_tol("float32"))
    np.testing.assert_allclose(_np(tvc), _np(jvc), **_tol("float32"))
    # the span write, fed JAX's kernel span k/v on both sides: bit-equal
    _, jk, jv = JMD.mega_decode(*jfp, *jpools, *jints, hd, interpret=True)
    nkh = jk.shape[-1] // hd
    jkc2, jvc2 = JIF._paged_span_write(
        jpools, jk.reshape(b, c, nkh, hd), jv.reshape(b, c, nkh, hd),
        *jints)
    _, tpools2, _ = _torch_args(cs, "float32")
    tkc2, tvc2 = TIF._paged_span_write(
        tpools2, torch.tensor(_np(jk)).reshape(b, c, nkh, hd),
        torch.tensor(_np(jv)).reshape(b, c, nkh, hd), *tints)
    np.testing.assert_array_equal(tkc2.numpy(), _np(jkc2))
    np.testing.assert_array_equal(tvc2.numpy(), _np(jvc2))
    # the entry and the composition: the same arithmetic, bit for bit
    _, tpools3, _ = _torch_args(cs, "float32")
    rout, (rkc, rvc) = TIF._mega_decode_layer_ref(*tfp, tpools3, *tints, hd,
                                                  1e-5, None)
    assert torch.equal(rout, tout)
    assert torch.equal(rkc, tkc) and torch.equal(rvc, tvc)


def test_dead_slots_are_inert():
    """An all-idle batch with out-of-range tables (the engine's warmup):
    the pools stay bit-unchanged and the outputs are finite."""
    cs = _case("float32", [0, 0, 0], [0, 0, 0])
    cs["tables"][:] = cs["kp"].shape[0]
    tfp, tpools, tints = _torch_args(cs, "float32")
    before = [p.clone() for p in tpools]
    out, (kc, vc) = TIF.mega_decode_layer(*tfp, tpools, *tints, cs["hd"])
    assert torch.isfinite(out).all()
    assert torch.equal(kc, before[0]) and torch.equal(vc, before[1])


def test_card_gate_names_what_it_declines():
    """``supported`` raises, naming the condition, before anything is
    built (the checks that need no card)."""
    x = torch.zeros((2, 8, 256))
    wq, wk, wo = torch.zeros((256, 256)), torch.zeros((256, 128)), \
        torch.zeros((256, 256))
    pool = torch.zeros((8, 16, 2, 64))
    with pytest.raises(ValueError, match="head_dim 32"):
        TMD.supported(x, wq, wk, wo, 32, pool, pool)
    with pytest.raises(ValueError, match="float16"):
        TMD.supported(x.half(), wq, wk, wo, 64, pool, pool)
    with pytest.raises(ValueError, match="k_pool is torch.bfloat16"):
        TMD.supported(x, wq, wk, wo, 64, pool.bfloat16(), pool)
    with pytest.raises(ValueError, match="do not divide"):
        TMD.supported(x, wq, torch.zeros((256, 192)), wo, 64,
                      torch.zeros((8, 16, 3, 64)), torch.zeros((8, 16, 3,
                                                                64)))
    with pytest.raises(ValueError, match="multiple of 64"):
        TMD.supported(torch.zeros((2, 8, 96)), torch.zeros((96, 256)),
                      torch.zeros((96, 128)), torch.zeros((256, 96)), 64,
                      pool, pool)


# -- the engine ---------------------------------------------------------------


@pytest.fixture(scope="module")
def arrays():
    pt.seed(0)
    jm = jax_llama("tiny", fused_ops="mega")
    return jm, {k: np.asarray(v) for k, v in jm.named_parameters()}


def _port(arrays, fused_ops):
    return params_from_numpy(
        torch_llama("tiny", device="cpu", fused_ops=fused_ops), arrays)


def _drive(eng):
    """Staggered mixed-length greedy requests, then a shared page-aligned
    prefix after its first request finished (prefix hits), one prompt
    fully cached (copy-on-write)."""
    rng = np.random.default_rng(11)
    prompts = {"a": rng.integers(0, 256, size=5),
               "b": rng.integers(0, 256, size=19),
               "c": rng.integers(0, 256, size=30)}
    shared = rng.integers(0, 256, size=16)
    eng.add_request(prompts["a"], max_new_tokens=7, request_id="a")
    eng.add_request(prompts["b"], max_new_tokens=5, request_id="b")
    eng.step()
    eng.add_request(prompts["c"], max_new_tokens=6, request_id="c")
    prompts["p0"] = np.concatenate([shared, [1, 2, 3]])
    eng.add_request(prompts["p0"], max_new_tokens=6, request_id="p0")
    out = eng.run()
    prompts["p1"], prompts["p2"] = np.concatenate([shared, [4, 5]]), shared
    eng.add_request(prompts["p1"], max_new_tokens=5, request_id="p1")
    eng.add_request(prompts["p2"], max_new_tokens=5, request_id="p2")
    out.update(eng.run())
    return out, prompts


def _margins(jm, prompt, out):
    ids = np.concatenate([prompt, out[:-1]]).astype(np.int32)[None]
    lg = np.asarray(jm(jnp.asarray(ids)))[0, len(prompt) - 1:]
    top = np.sort(lg, axis=-1)[:, -2:]
    return top[:, 1] - top[:, 0]


@pytest.fixture(scope="module")
def port_engines(arrays):
    """The port's "mega" and "on" engines after the same traffic."""
    _, arr = arrays
    res = {}
    for mode in ("mega", "on"):
        eng = tserving.Engine(_port(arr, mode), device="cpu",
                              **GEOM).warmup()
        res[mode] = (eng, *_drive(eng))
    return res


def test_mega_engine_matches_jax_mega_engine(arrays, port_engines):
    jm, _ = arrays
    jeng = jserving.Engine(jm, **GEOM).warmup()
    jout, prompts = _drive(jeng)
    teng, tout, _ = port_engines["mega"]
    assert sorted(tout) == sorted(jout) == sorted(prompts)
    exempt = []
    for rid, ref in jout.items():
        for i, (r, g) in enumerate(zip(ref, tout[rid])):
            if r != g:
                # a JAX forward per prompt length costs a compile: the
                # margins are computed only where the streams differ
                m = _margins(jm, prompts[rid], ref)
                assert m[i] < TIE, (rid, i, r, g, m[i])
                exempt.append(rid)
                break
        else:
            assert len(ref) == len(tout[rid])
    assert len(exempt) <= 1, exempt
    js, ts = jeng.prefix_stats(), teng.prefix_stats()
    for key in ("hits", "misses", "registered_pages", "cow_copies"):
        assert ts[key] == js[key], key
    assert ts["hits"] > 0 and ts["cow_copies"] > 0
    assert teng.kv_blocks_used == 0 and jeng.kv_blocks_used == 0


def test_mega_engine_token_identical_to_on_engine(port_engines):
    """The CPU's mega path is the composition of the "on" path's plain
    ops, so the two engines agree token for token."""
    _, mout, _ = port_engines["mega"]
    _, oout, _ = port_engines["on"]
    assert mout == oout


def test_launches_per_step_drop_under_mega(port_engines):
    """The gauge (plain calls per step on the CPU): one megakernel call
    per layer replaces the QKV and ragged calls."""
    meng = port_engines["mega"][0]
    oeng = port_engines["on"][0]
    layers = meng.model.cfg.num_hidden_layers
    mega, on = meng.launches_per_step(), oeng.launches_per_step()
    assert mega["mega_decode"] == layers
    assert mega["fused_swiglu_mlp"] == layers
    assert mega["fused_rms_rope_qkv"] == mega["ragged_paged_attention"] == 0
    assert on["fused_rms_rope_qkv"] == on["ragged_paged_attention"] == layers
    assert on["mega_decode"] == 0
    assert sum(mega.values()) < sum(on.values())


def test_quantized_projections_step_aside_from_mega(arrays):
    """``weight_quant`` under "mega" takes the unfused branch (the
    reference's quantized-projection veto): no megakernel call."""
    _, arr = arrays
    eng = tserving.Engine(_port(arr, "mega"), device="cpu",
                          weight_quant="int8", **GEOM).warmup()
    eng.add_request(np.arange(11), max_new_tokens=3)
    eng.run()
    got = eng.launches_per_step()
    assert got["mega_decode"] == 0 and got["int8_matmul"] == 15
