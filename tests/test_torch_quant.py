"""Weight-only quantized serving in the port (paddle_tpu_torch.nn.quant,
ops.cuda.int8_matmul / int4_matmul, Engine(weight_quant=)) held against
the JAX package on the CPU.

- Codes, scales and packed bytes: bit for bit (IEEE f32 division and
  round-half-even on both sides).
- The kernels' plain versions against the JAX Pallas kernels in
  interpret mode: f32 rtol/atol 1e-5 (the same products in another
  summation order; the JAX int4 kernel also splits the sum by parity),
  bf16 2e-2 (one bf16 rounding of an f32 sum on a boundary moves the
  output by one unit, 2**-8 relative).
- Model logits and the Engine's greedy streams: f32, 1e-4, and the
  near-tie rule of tests/test_torch_serving.py (a stream may first differ
  only where the JAX model's top-2 logit margin is below 1e-3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import serving as jserving
from paddle_tpu.models.llama import llama as jax_llama
from paddle_tpu.nn import quant as JQ
from paddle_tpu.ops.pallas import int4_matmul as JI4
from paddle_tpu.ops.pallas import int8_matmul as JI8
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import params_from_numpy
from paddle_tpu_torch.nn import quant as TQ
from paddle_tpu_torch.ops.cuda import int4_matmul as TI4
from paddle_tpu_torch.ops.cuda import int8_matmul as TI8

ALGOS = {"int8": "weight_only_int8", "int4": "weight_only_int4"}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
TIE = 1e-3
GEOM = dict(max_batch=4, max_seq_len=64, page_size=8, prefill_chunk=8)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))                 # a writable copy
    return t if dtype is None else t.to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_arrays(jm):
    """A JAX model's parameters and buffers as numpy (None stays None)."""
    out = {k: np.asarray(v) for k, v in jm.named_parameters()}
    out.update({k: None if v is None else np.asarray(v)
                for k, v in jm.named_buffers()})
    return out


# -- (a) codes, scales and packed bytes --------------------------------------

@pytest.mark.parametrize("algo,group", [("weight_only_int8", -1),
                                        ("weight_only_int4", -1),
                                        ("weight_only_int4", 32),
                                        ("weight_only_int8", 64)])
def test_weight_quantize_matches_jax_bit_for_bit(algo, group):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((128, 96)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0                                     # an all-zero column
    w[5, 7] = 0.5                                     # a loud outlier
    jq, js = JQ.weight_quantize(jnp.asarray(w), algo=algo, group_size=group)
    tq, ts = TQ.weight_quantize(_t(w), algo=algo, group_size=group)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TQ.weight_dequantize(tq, ts, algo=algo, group_size=group).numpy(),
        np.asarray(JQ.weight_dequantize(jq, js, algo=algo,
                                        group_size=group)))


def test_int4_pack_and_unpack_match_jax_on_every_byte():
    every = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    unpacked = TQ._unpack_int4(_t(every))
    np.testing.assert_array_equal(unpacked.numpy(),
                                  np.asarray(JQ._unpack_int4(every)))
    assert int(unpacked.min()) == -8 and int(unpacked.max()) == 7
    # packing the nibbles gives the same bytes back, as in JAX
    np.testing.assert_array_equal(TQ._pack_int4(unpacked).numpy(), every)
    np.testing.assert_array_equal(
        np.asarray(JQ._pack_int4(jnp.asarray(unpacked.numpy()))), every)
    with pytest.raises(ValueError, match="even"):
        TQ._pack_int4(torch.zeros((3, 4), dtype=torch.int8))


# -- (b) the kernels' plain versions against the interpret-mode kernels ------

def _kernel_case(kind, rng, m, k, n):
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    q, s = JQ.weight_quantize(jnp.asarray(w), algo=ALGOS[kind])
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["1d", "2d"])
def test_kernel_plain_matches_interpret_kernel(kind, dtype, form):
    """Both grid forms of the TPU kernel: the K-blocked 2-D form runs
    once MAX_1D_K (int8) / MAX_1D_K2 (int4) is set below K.  The kernels
    are called unjitted (``__wrapped__``), so the limit is read on this
    call and no cached trace of another form is reused."""
    rng = np.random.default_rng(1)
    m, k, n = (5, 256, 384) if form == "1d" else (3, 512, 256)
    x, q, s = _kernel_case(kind, rng, m, k, n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx = jnp.asarray(x, jdt)
    mod, limit = (JI8, "MAX_1D_K") if kind == "int8" else (JI4, "MAX_1D_K2")
    old = getattr(mod, limit)
    try:
        if form == "2d":
            setattr(mod, limit, 64)
        if kind == "int8":
            want = JI8.int8_matmul.__wrapped__(
                jx, jnp.asarray(q), jnp.asarray(s), block_k=128,
                block_n=128, interpret=True)
        else:
            want = JI4.int4_matmul.__wrapped__(
                jx, jnp.asarray(q), jnp.asarray(s), block_k2=64,
                block_n=128, interpret=True)
    finally:
        setattr(mod, limit, old)
    fn = TI8.int8_matmul if kind == "int8" else TI4.int4_matmul
    got = fn(_t(x, tdt), _t(q), _t(s))
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_kernel_wrappers_validate_shapes_as_jax():
    x = torch.zeros((4, 128))
    with pytest.raises(ValueError, match="K=128"):
        TI8.int8_matmul(x, torch.zeros((64, 128), dtype=torch.int8),
                        torch.ones(128))
    with pytest.raises(ValueError, match="scale"):
        TI8.int8_matmul(x, torch.zeros((128, 128), dtype=torch.int8),
                        torch.ones(64))
    with pytest.raises(ValueError, match="K = 2"):
        TI4.int4_matmul(torch.zeros((1, 100)),
                        torch.zeros((8, 128), dtype=torch.int8),
                        torch.ones(128))
    with pytest.raises(ValueError, match="scale"):
        TI4.int4_matmul(torch.zeros((1, 16)),
                        torch.zeros((8, 128), dtype=torch.int8),
                        torch.ones(4))
    with pytest.raises(ValueError, match="device"):
        TI8.int8_matmul(x.to("meta"), torch.zeros((128, 8), dtype=torch.int8,
                                                  device="meta"),
                        torch.ones(8, device="meta"))


# -- (c) weight_only_linear ---------------------------------------------------

@pytest.mark.parametrize("case", ["int8", "int4", "int4_grouped", "bias",
                                  "3d", "over_256_tokens"])
def test_weight_only_linear_matches_jax(case):
    """The kernel route (per-column scales, <= 256 rows: the plain
    version on CPU tensors) and the composition (grouped scales, more
    rows) against the reference's composition on the CPU."""
    rng = np.random.default_rng(2)
    kind = "int4" if case.startswith("int4") else "int8"
    group = 32 if case == "int4_grouped" else -1
    lead = {"3d": (2, 3), "over_256_tokens": (300,)}.get(case, (6,))
    w = (rng.standard_normal((64, 96)) * 0.05).astype(np.float32)
    x = rng.standard_normal(lead + (64,)).astype(np.float32)
    bias = rng.standard_normal((96,)).astype(np.float32) \
        if case == "bias" else None
    jq, js = JQ.weight_quantize(jnp.asarray(w), algo=ALGOS[kind],
                                group_size=group)
    want = JQ.weight_only_linear(
        jnp.asarray(x), jq, bias=None if bias is None else jnp.asarray(bias),
        weight_scale=js, weight_dtype=kind, group_size=group)
    tq, ts = TQ.weight_quantize(_t(w), algo=ALGOS[kind], group_size=group)
    got = TQ.weight_only_linear(_t(x), tq,
                                bias=None if bias is None else _t(bias),
                                weight_scale=ts, weight_dtype=kind,
                                group_size=group)
    assert tuple(got.shape) == lead + (96,)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


# -- (d) quantize_linears on tiny ---------------------------------------------

@pytest.fixture(scope="module")
def float_arrays():
    pt.seed(0)
    jm = jax_llama("tiny", fused_ops="on")
    return {k: np.asarray(v) for k, v in jm.named_parameters()}


def _pair(float_arrays, kind, fused_ops="on"):
    """A fresh JAX tiny model and its port twin, same float weights."""
    pt.seed(0)
    jm = jax_llama("tiny", fused_ops=fused_ops)
    tm = params_from_numpy(torch_llama("tiny", device="cpu",
                                       fused_ops=fused_ops), float_arrays)
    return jm, tm


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantize_linears_matches_jax(float_arrays, kind):
    jm, tm = _pair(float_arrays, kind)
    assert JQ.quantize_linears(jm, algo=ALGOS[kind]) == 15
    assert TQ.quantize_linears(tm, algo=ALGOS[kind]) == 15
    assert not any(type(m).__name__ == "Linear" for m in tm.modules())
    jbuf = _jax_arrays(jm)
    for name, t in tm.named_buffers():
        np.testing.assert_array_equal(t.numpy(), jbuf[name], err_msg=name)
    ids = np.random.default_rng(3).integers(0, 256, size=(2, 12))
    with torch.no_grad():
        got = tm(_t(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm(jnp.asarray(ids))),
                               **MODEL_TOL)
    # a predicate keeps the LM head in float, as in the reference
    pt.seed(0)
    tm2 = torch_llama("tiny", device="cpu")
    assert TQ.quantize_linears(
        tm2, predicate=lambda name, _: name != "lm_head") == 14
    assert not hasattr(tm2.lm_head, "weight_scale")


# -- (e) the Engine ------------------------------------------------------------

def _drive(eng):
    """3 staggered greedy requests: a page-aligned two-page prefix and a
    plain prompt joining its running batch, then the prefix again after
    the first finished (a prefix hit)."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 256, size=16)
    prompts = {"s0": np.concatenate([shared, [1, 2, 3]]),
               "a": rng.integers(0, 256, size=13),
               "s1": np.concatenate([shared, [4, 5]])}
    eng.add_request(prompts["s0"], max_new_tokens=6, request_id="s0")
    eng.step()
    eng.step()
    eng.add_request(prompts["a"], max_new_tokens=5, request_id="a")
    out = eng.run()
    eng.add_request(prompts["s1"], max_new_tokens=6, request_id="s1")
    out.update(eng.run())
    return out, prompts


def _near_tie_equal(jm, prompt, ref, got):
    """True if equal; "exempt" if they first differ where the JAX
    model's top-2 logit margin is below TIE."""
    ids = np.concatenate([prompt, ref[:-1]]).astype(np.int32)[None]
    lg = np.asarray(jm(jnp.asarray(ids)))[0, len(prompt) - 1:]
    top = np.sort(lg, axis=-1)[:, -2:]
    margins = top[:, 1] - top[:, 0]
    for i, (r, g) in enumerate(zip(ref, got)):
        if r != g:
            assert margins[i] < TIE, (i, g, r, margins[i])
            return "exempt"
    assert len(ref) == len(got)
    return True


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_engine_weight_quant_matches_jax_engine(float_arrays, kind):
    jm, tm = _pair(float_arrays, kind)
    jeng = jserving.Engine(jm, weight_quant=kind, **GEOM).warmup()
    jout, prompts = _drive(jeng)
    teng = tserving.Engine(tm, device="cpu", weight_quant=kind,
                           **GEOM).warmup()
    tout, _ = _drive(teng)
    assert sum(hasattr(m, "weight_scale") for m in tm.modules()) == 15
    assert all(c.dtype == torch.float32 for kv in teng.kv.caches for c in kv)
    assert sorted(tout) == sorted(jout) == sorted(prompts)
    verdicts = {r: _near_tie_equal(jm, prompts[r], jout[r], tout[r])
                for r in jout}
    assert sum(v == "exempt" for v in verdicts.values()) <= 1, verdicts
    js, ts = jeng.prefix_stats(), teng.prefix_stats()
    for key in ("hits", "misses", "registered_pages", "cow_copies"):
        assert ts[key] == js[key], key
    assert ts["hits"] > 0
    assert teng.kv_blocks_used == 0 and jeng.kv_blocks_used == 0


def test_engine_rejects_bad_weight_quant_before_touching_the_model():
    tm = torch_llama("tiny", device="cpu")
    with pytest.raises(ValueError, match="algo"):
        tserving.Engine(tm, device="cpu", weight_quant="int3", **GEOM)
    with pytest.raises(ValueError, match="max_seq_len"):
        tserving.Engine(tm, device="cpu", weight_quant="int8",
                        **dict(GEOM, max_seq_len=4096))
    assert not any(hasattr(m, "weight_scale") for m in tm.modules())


# -- (f) quantized checkpoints -------------------------------------------------

@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_params_from_numpy_loads_quantized_buffers(float_arrays, kind):
    jm, _ = _pair(float_arrays, kind)
    JQ.quantize_linears(jm, algo=ALGOS[kind])
    arrays = _jax_arrays(jm)
    assert arrays["model.layers.0.self_attn.q_proj.bias"] is None
    assert arrays["model.layers.0.self_attn.q_proj.weight"].dtype == np.int8
    tm = torch_llama("tiny", device="cpu", seed=5)
    TQ.quantize_linears(tm, algo=ALGOS[kind])
    params_from_numpy(tm, arrays)
    for name, t in list(tm.named_parameters()) + list(tm.named_buffers()):
        np.testing.assert_array_equal(t.detach().numpy(), arrays[name],
                                      err_msg=name)
    # a float port model refuses quantized arrays (extra scale names)
    with pytest.raises(KeyError, match="weight_scale"):
        params_from_numpy(torch_llama("tiny", device="cpu"), arrays)
