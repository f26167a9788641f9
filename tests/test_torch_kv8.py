"""The port's int8 KV caches held against the JAX package on the CPU:
``quantize_kv``, the dense 4-tuple caches of ``generate()``, the paged
int8 pools of ``PagedKVCache`` and the serving ``Engine``, on the
``tiny`` configs (Llama's 4 q heads over 2 kv heads: GQA).

Tolerances.  ``quantize_kv`` is bit-equal to JAX: the int8 codes equal,
the f32 scales within 1 ulp (they come out equal).  Quantized writes
(values and scales) are compared bit for bit.  Attention outputs over the
same int8 pools, and teacher-forced logits, agree within f32 rtol = atol
= 1e-5 (``F32``; the two packages sum in different orders).  Greedy
streams are compared token by token under the near-tie rule (a first
mismatch only where the top-2 logit margin there is below ``TIE`` =
1e-3, the rest of that request exempt, at most one request exempt); the
margin is the port's at that step, where both sides have read the same
tokens.  The reference's own int8 tests (``tests/test_int8_kv_cache.py``,
the int8 cases of ``test_serving.py``, ``test_spec.py`` and
``test_lora.py``) have twins here with their bounds unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import serving as jserving
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models import generation as JG
from paddle_tpu.models.llama import llama as jax_llama
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import params_from_numpy
from paddle_tpu_torch.ops.cuda import counts
from paddle_tpu_torch.ops.cuda import mega_decode as TMD
from paddle_tpu_torch.ops.cuda import paged_attention as TPA
from paddle_tpu_torch.ops.cuda import ragged_attention as TRA
from paddle_tpu_torch.serving import (LoRAPool, PagedKVCache, SwapManager,
                                      merge_adapter)
from test_torch_gpt import model_pair as gpt_pair
from test_torch_serving import GEOM, TIE, _drive

F32 = dict(rtol=1e-5, atol=1e-5)
SPEC = dict(spec_decode=True, draft_depth=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """tiny's ops gain nothing from intra-op threads, and the test
    processes share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _llama_pair(mode="on", **overrides):
    pt.seed(0)
    jm = jax_llama("tiny", fused_ops=mode, **overrides)
    arrays = {k: np.asarray(v) for k, v in jm.named_parameters()}
    return jm, params_from_numpy(
        torch_llama("tiny", device="cpu", fused_ops=mode, **overrides),
        arrays)


@pytest.fixture(scope="module")
def llama_pair():
    return _llama_pair("on")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _bits_equal(got, want):
    """int8 codes equal; f32 scales equal to the bit."""
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _streams_agree(ref, got, margins):
    """``ref``/``got``: {rid: tokens}; ``margins``: the port's margins per
    rid.  Equal under the near-tie rule, at most one request exempt."""
    assert sorted(ref) == sorted(got)
    exempt = []
    for rid, r in ref.items():
        g = list(got[rid])
        for i, (a, b) in enumerate(zip(r, g)):
            if a != b:
                assert margins[rid][i] < TIE, (rid, i, margins[rid][i])
                exempt.append(rid)
                break
        else:
            assert len(r) == len(g), rid
    assert len(exempt) <= 1, exempt
    return exempt


# -- quantize_kv and the dense 4-tuple -----------------------------------------


@pytest.mark.parametrize("magnitude", [1e-3, 30.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype, magnitude):
    rng = np.random.default_rng(1)
    x = (magnitude * rng.standard_normal((3, 7, 2, 16))).astype(np.float32)
    x[0, 0, 0] = 0.0                                  # an all-zero head
    x[0, 1, 0, :4] = [0.5, -0.5, 1.5, 2.5]            # halves: to even
    x[0, 1, 0, 4] = 127.0
    t = torch.from_numpy(x)
    if dtype == "bfloat16":
        t = t.bfloat16()
    jq, js = JIF.quantize_kv(jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32))
    tq, ts = TIF.quantize_kv(t)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    ulps = np.abs(ts.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(js).view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()


def _dense_inputs(rng, b=3, s_max=24, h=4, hkv=2, d=16, plen=9):
    k, v = (rng.standard_normal((b, plen, hkv, d)).astype(np.float32)
            for _ in range(2))
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    nk, nv = (rng.standard_normal((b, hkv, d)).astype(np.float32)
              for _ in range(2))
    return k, v, q, nk, nv


@pytest.mark.parametrize("heads", [(4, 2), (4, 4)])
def test_dense_int8_write_and_decode_match_jax(heads):
    """``prefill_write_cache`` and ``read_cache_prefix`` of the 4-tuple,
    then one ``decode_attend_cache`` step at per-row positions: caches
    bit-equal to JAX's, the output within F32 (K dequantized in bf16, V
    in f32, on both sides)."""
    h, hkv = heads
    b, s_max, d, plen = 3, 24, 16, 9
    rng = np.random.default_rng(2)
    k, v, q, nk, nv = _dense_inputs(rng, b, s_max, h, hkv, d, plen)
    lens = np.array([9, 4, 23], np.int32)
    jc = JG.make_dense_caches(1, b, s_max, hkv, d, "int8")[0]
    tc = TG.make_dense_caches(1, b, s_max, hkv, d, "int8")[0]
    jc = JIF.prefill_write_cache(jc, jnp.asarray(k), jnp.asarray(v))
    tc = TIF.prefill_write_cache(tc, torch.from_numpy(k),
                                 torch.from_numpy(v))
    for g, w in zip(tc, jc):
        _bits_equal(g, w)
    for dt in (jnp.float32, jnp.bfloat16):
        tdt = torch.float32 if dt == jnp.float32 else torch.bfloat16
        for g, w in zip(TIF.read_cache_prefix(tc, 7, tdt),
                        JIF.read_cache_prefix(jc, 7, dt)):
            assert g.dtype == tdt
            np.testing.assert_array_equal(_np(g), _np(w.astype(jnp.float32)))
    jout, jc = JIF.decode_attend_cache(jc, jnp.asarray(q), jnp.asarray(nk),
                                       jnp.asarray(nv), jnp.asarray(lens))
    tout, tc = TIF.decode_attend_cache(tc, torch.from_numpy(q),
                                       torch.from_numpy(nk),
                                       torch.from_numpy(nv),
                                       torch.from_numpy(lens))
    assert len(tc) == 4
    for g, w in zip(tc, jc):
        _bits_equal(g, w)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32)


def test_quantized_mma_matches_fp_attention():
    """Twin of ``TestQuantizedMMA.test_matches_fp_attention``: the int8
    read of a cache tracks the fp read within 0.05, and equals JAX's int8
    read within F32."""
    rng = np.random.default_rng(3)
    b, s_max, h, d = 2, 32, 4, 16
    kc, vc = (rng.standard_normal((b, s_max, h, d)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    lens = np.array([20, 11], np.int32)
    t = [torch.from_numpy(a) for a in (q, kc, vc, lens)]
    ref, _, _ = TIF.masked_multihead_attention(t[0], t[1].clone(),
                                               t[2].clone(), t[3])
    kq, ks = TIF.quantize_kv(t[1])
    vq, vs = TIF.quantize_kv(t[2])
    out, *_ = TIF.masked_multihead_attention(t[0], kq, vq, t[3],
                                             k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=0.05)
    jkq, jks = JIF.quantize_kv(jnp.asarray(kc))
    jvq, jvs = JIF.quantize_kv(jnp.asarray(vc))
    jout, *_ = JIF.masked_multihead_attention(
        jnp.asarray(q), jkq, jvq, jnp.asarray(lens), k_scale=jks,
        v_scale=jvs)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)


def test_write_path_roundtrip():
    """Twin of ``test_write_path_roundtrip``: the written slot
    dequantizes back to the new k within int8 precision; a position past
    the cache drops its write, values and scales."""
    rng = np.random.default_rng(4)
    b, s_max, h, d = 2, 8, 2, 16
    kc, vc, ks, vs = TG.make_dense_caches(1, b, s_max, h, d, "int8")[0]
    nk, nv, q = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((b, h, d), (b, h, d), (b, h, d)))
    out, kc, vc, ks, vs = TIF.masked_multihead_attention(
        q, kc, vc, torch.tensor([3, 5]), nk, nv, k_scale=ks, v_scale=vs)
    got = kc[0, 3].float() * ks[0, 3][:, None]
    np.testing.assert_allclose(got.numpy(), nk[0].numpy(), atol=0.02)
    assert kc.dtype == torch.int8 and vs.dtype == torch.float32
    before = [t.clone() for t in (kc, vc, ks, vs)]
    TIF.masked_multihead_attention(q, kc, vc, torch.tensor([s_max, 5]),
                                   nk, nv, k_scale=ks, v_scale=vs)
    for a, a0 in zip((kc, vc, ks, vs), before):
        assert torch.equal(a[0], a0[0])            # past the cache: dropped


# -- paged int8 pools ----------------------------------------------------------


B, C, PAGE, MB, HKV, H, D = 3, 8, 4, 4, 2, 4, 16
NB = B * MB
OOB = NB


def _tables(pages):
    t = np.full((B, MB), OOB, np.int32)
    for b, n in enumerate(pages):
        t[b, :n] = np.arange(b * MB, b * MB + n)
    return t


# (live pages per slot, span starts, span lens)
CASES = {
    "warmup": ([0, 0, 0], [0, 0, 0], [0, 0, 0]),
    "dead_slot": ([2, 0, 3], [5, 0, 9], [1, 0, 1]),
    "chunk_padded": ([2, 1, 2], [0, 0, 3], [5, 1, 4]),
    "page_cross": ([3, 1, 1], [2, 1, 0], [8, 1, 2]),
    "sentinel_past_last_page": ([2, 2, 2], [5, 0, 7], [3, 8, 1]),
}


def _int8_pool_arrays(rng):
    """Random int8 values and positive f32 scales for (k, v, k_s, v_s)."""
    vals = [rng.integers(-127, 128, size=(NB, PAGE, HKV, D)).astype(np.int8)
            for _ in range(2)]
    scales = [rng.uniform(0.01, 0.1, size=(NB, PAGE, HKV)).astype(np.float32)
              for _ in range(2)]
    return vals + scales


def _torch_pools(arrays, spare):
    """The arrays in an ``int8_pools`` set with ``spare`` rows, or in
    plain tensors (no spare rows: the masked write) for ``spare=None``."""
    if spare is None:
        return tuple(torch.from_numpy(a.copy()) for a in arrays)
    pools = TRA.int8_pools(NB, PAGE, HKV, D, spare, "cpu")
    for t, a in zip(pools, arrays):
        t.copy_(torch.from_numpy(a))
    return pools


@pytest.mark.parametrize("spare", [B * C, None], ids=["sync_free", "masked"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_ragged_step_matches_jax(case, spare):
    """``ragged_paged_attend`` over the int8 4-tuple: the quantized span
    write (values and scales bit-equal to JAX's, dead rows and sentinel
    entries dropped) and the gather+dequant attention on live rows
    within F32, with the sync-free write and the masked one."""
    pages, starts, lens = CASES[case]
    rng = np.random.default_rng(9)
    arrays = _int8_pool_arrays(rng)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, C, HKV, D)).astype(np.float32)
            for _ in range(2))
    ints = [np.asarray(a, np.int32) for a in (_tables(pages), starts, lens)]
    pools = _torch_pools(arrays, spare)
    ptrs = [t.data_ptr() for t in pools]
    tout, tc = TIF.ragged_paged_attend(
        pools, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        *map(torch.from_numpy, ints))
    assert [t.data_ptr() for t in tc] == ptrs
    jout, jc = JIF.ragged_paged_attend(
        tuple(map(jnp.asarray, arrays)), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v), *map(jnp.asarray, ints))
    for g, w in zip(tc, jc):
        _bits_equal(g, w)
    live = np.arange(C)[None, :] < ints[2][:, None]
    np.testing.assert_allclose(tout.numpy()[live], np.asarray(jout)[live],
                               **F32)


def test_sentinel_rows_write_nothing_into_int8_pools():
    """A slot whose table row is all sentinel, with live span lengths,
    beside the warmup's all-dead slots: the pools' values and scales stay
    bit-unchanged; on the sync-free write the dead rows land only in
    their own spare rows (row b * C + j), and spare rows past B * C stay
    untouched; the masked write touches nothing."""
    rng = np.random.default_rng(10)
    arrays = _int8_pool_arrays(rng)
    tables = np.full((B, MB), OOB, np.int32)
    starts = np.array([0, 6, 3], np.int32)
    lens = np.array([0, 8, 2], np.int32)
    k, v = (torch.from_numpy(rng.standard_normal((B, C, HKV, D))
                             .astype(np.float32)) for _ in range(2))
    ints = [torch.from_numpy(a) for a in (tables, starts, lens)]
    extra = 5
    pools = _torch_pools(arrays, B * C + extra)
    for r in pools.rows:
        r[NB * PAGE:].fill_(7)
    TIF._paged_span_write(pools, k, v, *ints)
    srcs = TIF.quantize_kv(k) + TIF.quantize_kv(v)
    srcs = (srcs[0], srcs[2], srcs[1], srcs[3])
    for t, a, r, src in zip(pools, arrays, pools.rows, srcs):
        np.testing.assert_array_equal(t.numpy(), a)
        spare = r[NB * PAGE:NB * PAGE + B * C]
        assert torch.equal(spare, src.reshape(B * C, *src.shape[2:]))
        assert (r[NB * PAGE + B * C:] == 7).all()
    masked = _torch_pools(arrays, None)
    TIF._paged_span_write(masked, k, v, *ints)
    for t, a in zip(masked, arrays):
        np.testing.assert_array_equal(t.numpy(), a)


def test_int8_paged_decode_matches_jax():
    """``paged_decode_attend`` over the 4-tuple (the bucket path's decode):
    three live slots and a dead one whose sentinel table drops its write;
    pools bit-equal to JAX's, outputs within F32."""
    rng = np.random.default_rng(11)
    arrays = _int8_pool_arrays(rng)
    tables = _tables([3, 2, 4])
    tables = np.concatenate([tables, np.full((1, MB), OOB, np.int32)])
    write_pos = np.array([4, 7, 15, 0], np.int32)
    q = rng.standard_normal((4, H, D)).astype(np.float32)
    nk, nv = (rng.standard_normal((4, HKV, D)).astype(np.float32)
              for _ in range(2))
    tout, tc = TIF.paged_decode_attend(
        _torch_pools(arrays, None),
        *map(torch.from_numpy, (q, nk, nv, tables, write_pos)))
    jout, jc = JIF.paged_decode_attend(
        tuple(map(jnp.asarray, arrays)),
        *map(jnp.asarray, (q, nk, nv, tables, write_pos)))
    for g, w in zip(tc, jc):
        _bits_equal(g, w)
    changed = (tc[0].numpy() != arrays[0]).any(axis=(2, 3))
    assert changed.sum() == 3                    # the dead write dropped
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32)


def test_mega_layer_over_int8_pools_is_the_composition(llama_pair):
    """``mega_decode_layer`` over the 4-tuple is the reference's
    composition (its megakernel declines int8 pools): output and pools
    against JAX's ``mega_decode_layer``."""
    jm, tm = llama_pair
    cfg = tm.cfg
    hd = cfg.head_dim
    rng = np.random.default_rng(12)
    arrays = [a[..., :hd] if a.ndim == 4 else a
              for a in _int8_pool_arrays(rng)]
    pages, starts, lens = CASES["page_cross"]
    ints = [np.asarray(a, np.int32) for a in (_tables(pages), starts, lens)]
    x = rng.standard_normal((B, C, cfg.hidden_size)).astype(np.float32)
    pos = ints[1][:, None] + np.arange(C)[None]
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2) / hd))
    ang = pos[..., None] * inv
    ang = np.concatenate([ang, ang], -1).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    layer = dict(tm.named_parameters())
    names = ["model.layers.0.input_layernorm.weight"] + [
        f"model.layers.0.self_attn.{p}_proj.weight" for p in "qkvo"]
    ws = [layer[n].detach().numpy() for n in names]
    pools = tuple(torch.from_numpy(a.copy()) for a in arrays)
    tout, tc = TIF.mega_decode_layer(
        torch.from_numpy(x), *map(torch.from_numpy, ws),
        torch.from_numpy(cos), torch.from_numpy(sin), pools,
        *map(torch.from_numpy, ints), hd, cfg.rms_norm_eps)
    jout, jc = JIF.mega_decode_layer(
        jnp.asarray(x), *map(jnp.asarray, ws), jnp.asarray(cos),
        jnp.asarray(sin), tuple(map(jnp.asarray, arrays)),
        *map(jnp.asarray, ints), hd, cfg.rms_norm_eps)
    for g, w in zip(tc, jc):
        np.testing.assert_allclose(_np(g), _np(w), atol=1.0 if
                                   g.dtype == torch.int8 else 1e-6)
    live = np.arange(C)[None, :] < ints[2][:, None]
    np.testing.assert_allclose(tout.numpy()[live], np.asarray(jout)[live],
                               **F32)


@pytest.mark.parametrize("which", ["ragged", "paged", "dense", "mega"])
def test_kernel_wrappers_raise_on_int8_pools(which):
    """The attention kernels' wrappers never take int8 pools, on any
    device: the composition in ``incubate.nn.functional`` attends them."""
    pools = TRA.int8_pools(4, 4, 2, 16, 0, "cpu")
    kp, vp = pools[0], pools[1]
    i32 = torch.zeros((2,), dtype=torch.int32)
    tables = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="int8"):
        if which == "ragged":
            TRA.ragged_paged_attention(torch.zeros((2, 1, 4, 16)), kp, vp,
                                       tables, i32, i32)
        elif which == "paged":
            TPA.paged_attention(torch.zeros((2, 4, 16)), kp, vp, tables,
                                i32)
        elif which == "dense":
            TPA.dense_attention(torch.zeros((2, 4, 16)),
                                torch.zeros((2, 8, 2, 16), dtype=torch.int8),
                                torch.zeros((2, 8, 2, 16), dtype=torch.int8),
                                i32)
        else:
            x = torch.zeros((2, 1, 64))
            w = torch.zeros((64, 64))
            cs = torch.zeros((2, 1, 16))
            TMD.mega_decode(x, torch.ones(64), w, w[:, :32], w[:, :32], w,
                            cs, cs, kp, vp, tables, i32, i32, 16)


# -- PagedKVCache and the swap ---------------------------------------------------


@pytest.mark.parametrize("spelling", ["int8", "paddle.int8", np.int8,
                                      torch.int8],
                         ids=["str", "paddle", "numpy", "torch"])
def test_pool_shapes_and_int8(spelling):
    """Twin of ``test_pool_shapes_and_int8``, for every spelling of int8:
    the 4-tuple's shapes, and ``nbytes`` counting the scales: (D + 4) /
    (2 D) of bf16 pools' bytes."""
    kv = PagedKVCache(2, 4, 8, 2, 16, dtype=torch.bfloat16, device="cpu")
    kv8 = PagedKVCache(2, 4, 8, 2, 16, dtype=spelling, device="cpu",
                       spare_rows=3)
    assert kv8.quantized and not kv.quantized and len(kv8.caches[0]) == 4
    k, v, ks, vs = kv8.caches[0]
    assert k.shape == (4, 8, 2, 16) and k.dtype == torch.int8
    assert ks.shape == (4, 8, 2) and ks.dtype == torch.float32
    assert (ks == 1).all() and (k == 0).all()
    assert [r.shape[0] for r in kv8.caches[0].rows] == [4 * 8 + 3] * 4
    assert kv8.oob_block == 4
    assert kv8.nbytes() * 2 * 16 == kv.nbytes() * (16 + 4)


def test_swap_round_trips_values_and_scales():
    """The swap walks the 4-tuple: swap_out then swap_in into other
    blocks moves values AND scales, in place; the spare rows behind every
    pool and every other block untouched."""
    kv = PagedKVCache(2, 10, 4, 2, 8, dtype="int8", device="cpu",
                      spare_rows=6)
    g = torch.Generator().manual_seed(0)
    for pools in kv.caches:
        for r in pools.rows:
            if r.dtype == torch.int8:
                r.copy_(torch.randint(-127, 128, r.shape, generator=g))
            else:
                r.uniform_(0.01, 0.1, generator=g)
    ptrs = [t.data_ptr() for pools in kv.caches for t in pools]
    before = [tuple(r.clone() for r in pools.rows) for pools in kv.caches]
    sm = SwapManager(kv, chunk=2)
    src, dst = [3, 7, 1], [0, 9, 5]
    host = sm.swap_out(src)
    assert host.nbytes() == 3 * 2 * (2 * 4 * 2 * 8 + 2 * 4 * 2 * 4)
    sm.swap_in(dst, host)
    assert [t.data_ptr() for pools in kv.caches for t in pools] == ptrs
    keep = [b for b in range(10) if b not in dst]
    for pools, old in zip(kv.caches, before):
        for c, r, r0 in zip(pools, pools.rows, old):
            view0 = r0[:40].view(10, *c.shape[1:])
            assert torch.equal(c[dst], view0[src])
            assert torch.equal(c[keep], view0[keep])
            assert torch.equal(r[40:], r0[40:])           # spare rows


# -- generate() over int8 dense caches -----------------------------------------


@pytest.mark.parametrize("spelling", ["int8", "paddle.int8", np.int8,
                                      torch.int8],
                         ids=["str", "paddle", "numpy", "torch"])
def test_dtype_spelling_normalized(spelling):
    caches = TG.make_dense_caches(1, 1, 4, 2, 8, spelling)
    assert len(caches[0]) == 4, spelling
    assert TG._is_int8(spelling) and not TG._is_int8("float32")
    assert not TG._is_int8(None) and not TG._is_int8(torch.bfloat16)


def test_int8_cache_structure(llama_pair):
    caches = llama_pair[1].model.init_cache(2, 64, dtype="int8")
    assert len(caches) == 2 and len(caches[0]) == 4
    k, v, ks, vs = caches[0]
    assert k.dtype == torch.int8 and ks.shape == k.shape[:3]
    assert ks.dtype == torch.float32


def test_prefill_quantization_consistency(llama_pair):
    """Twin of ``test_prefill_quantization_consistency``: the prefill
    writes scales at the prompt's positions and nothing past them; the
    caches equal JAX's prefill, codes to the bit."""
    jm, tm = llama_pair
    ids = np.random.default_rng(1).integers(0, 256, (1, 12)).astype(np.int32)
    tc = tm.model.init_cache(1, 48, dtype="int8")
    with torch.no_grad():
        _, tc = tm.model(torch.from_numpy(ids).long(), caches=tc)
    k, v, ks, vs = tc[0]
    assert bool((ks[0, :12].abs() > 1e-9).all())
    assert int(k[0, 12:].abs().int().sum()) == 0
    jc = jm.model.init_cache(1, 48, dtype="int8")
    _, jc = jm.model(jnp.asarray(ids), caches=jc)
    for g, w in zip(tc[0], jc[0]):
        if g.dtype == torch.int8:   # a code may sit one unit off at a tie
            assert np.abs(g.numpy().astype(int)
                          - np.asarray(w).astype(int)).max() <= 1
            assert (g.numpy() != np.asarray(w)).mean() < 1e-3
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_recompute_fallback_rejects_int8(llama_pair):
    ids = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="recompute"):
        llama_pair[1].generate(ids, max_new_tokens=2, use_cache=False,
                               kv_cache_dtype="int8")


def _rollout(model, ids, toks, dtype):
    """Teacher-forced decode through the port ``model``: the prompt
    ``ids`` prefilled into dense caches of ``dtype``, then each of
    ``toks`` fed in turn; (T, B, V) logits."""
    b, p = ids.shape
    cap = p + toks.shape[1]
    caches = model.model.init_cache(b, cap, dtype=dtype)
    with torch.no_grad():
        _, caches = model.model(torch.from_numpy(ids).long(), caches=caches)
        lens = torch.full((b,), p, dtype=torch.int32)
        out = []
        for t in range(toks.shape[1]):
            h, caches = model.model(torch.from_numpy(toks[:, t:t + 1]).long(),
                                    caches=caches, seq_lens=lens)
            out.append(model.logits(h[:, -1]).numpy())
            lens = lens + 1
    return np.stack(out)


def test_logit_error_bound_teacher_forced(llama_pair):
    """Twin of ``test_logit_error_bound_teacher_forced``: over 16
    teacher-forced steps the int8 caches' logits stay within 0.25 (max)
    and 0.05 (mean) of the fp logits' scale (the dense int8 step itself
    is held to JAX's in ``test_dense_int8_write_and_decode_match_jax``
    and by the streams of ``test_int8_generate_matches_jax``)."""
    tm = llama_pair[1]
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 256, (2, 16)).astype(np.int32)
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    fp = _rollout(tm, ids, toks, "float32")
    q8 = _rollout(tm, ids, toks, "int8")
    scale = float(np.std(fp))
    assert np.abs(fp - q8).max() / scale < 0.25
    assert np.abs(fp - q8).mean() / scale < 0.05


def _generate_pair(jm, tm, ids, new):
    """(JAX, port) int8 greedy generate() outputs and the port's own
    fp one, as numpy (the int8 call last: its holder stays)."""
    jout = np.asarray(jm.generate(jnp.asarray(ids), max_new_tokens=new,
                                  kv_cache_dtype="int8"))
    tids = torch.from_numpy(ids)
    fp = tm.generate(tids, max_new_tokens=new).numpy()
    tout = tm.generate(tids, max_new_tokens=new,
                       kv_cache_dtype="int8").numpy()
    return jout, tout, fp


def _rows_agree(tm, ids, jout, tout):
    """Each row of the port's int8 stream equals JAX's under the
    near-tie rule (the port's teacher-forced int8 margin at the first
    difference)."""
    p = ids.shape[1]
    if np.array_equal(jout, tout):
        return 0
    lg = _rollout(tm, ids, jout[:, p:-1], "int8")       # (T - 1, B, V)
    first = tm.logits(tm.model(torch.from_numpy(ids).long())[:, -1])
    lg = np.concatenate([first.detach().numpy()[None], lg])
    top = np.sort(lg, axis=-1)[..., -2:]
    margins = top[..., 1] - top[..., 0]
    exempt = 0
    for row in range(ids.shape[0]):
        diff = np.nonzero(jout[row, p:] != tout[row, p:])[0]
        if diff.size:
            assert margins[diff[0], row] < TIE, (row, diff[0])
            exempt += 1
    assert exempt <= 1
    return exempt


@pytest.mark.parametrize("family", ["llama-on", "llama-off", "gpt"])
def test_int8_generate_matches_jax(family, llama_pair):
    """Greedy ``generate(kv_cache_dtype="int8")`` against JAX's, each
    family on ``tiny``, through the port's DecodeGraph over the 4-tuple
    caches."""
    jm, tm = {"gpt": lambda: gpt_pair("on"), "llama-on": lambda: llama_pair,
              "llama-off": lambda: _llama_pair("off")}[family]()
    ids = np.random.default_rng(5).integers(0, 256, (3, 9)).astype(np.int32)
    jout, tout, _ = _generate_pair(jm, tm, ids, 12)
    _rows_agree(tm, ids, jout, tout)
    holder = tm.decode_graph
    assert holder.key == (3, 21, torch.int8)
    assert all(len(c) == 4 for c in holder.caches)
    assert holder.captures == 0 and holder.graph.capture is False


def test_greedy_generation_tracks_fp_cache(llama_pair):
    """Twin of ``test_greedy_generation_tracks_fp_cache``: at least 75%
    of the int8 tokens equal the fp cache's; the int8 stream equals
    JAX's."""
    jm, tm = llama_pair
    ids = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int32)
    jout, tout, fp = _generate_pair(jm, tm, ids, 24)
    assert fp.shape == tout.shape
    assert np.mean(fp[:, 16:] == tout[:, 16:]) >= 0.75
    _rows_agree(tm, ids, jout, tout)


def test_gpt_int8_generation():
    """Twin of ``test_gpt_int8_generation`` (2 heads of 16): at least 70%
    of the int8 tokens equal the fp cache's; the stream equals JAX's."""
    jm, tm = gpt_pair("on", vocab_size=128, hidden_size=32,
                      num_hidden_layers=2, num_attention_heads=2,
                      max_position_embeddings=64)
    ids = np.random.default_rng(2).integers(0, 128, (2, 8)).astype(np.int32)
    jout, tout, fp = _generate_pair(jm, tm, ids, 12)
    assert np.mean(fp[:, 8:] == tout[:, 8:]) >= 0.7
    _rows_agree(tm, ids, jout, tout)


def test_decode_holder_keyed_by_cache_dtype(llama_pair):
    """One DecodeGraph per (batch, capacity, dtype): an int8 call after an
    fp one builds a new holder with 4-tuple caches, and a second int8
    call of the same shape reuses it."""
    tm = llama_pair[1]
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, 5)).astype(np.int64))
    tm.generate(ids, max_new_tokens=4)
    fp_holder = tm.decode_graph
    a = tm.generate(ids, max_new_tokens=4, kv_cache_dtype=torch.int8)
    holder = tm.decode_graph
    assert holder is not fp_holder and holder.key[2] == torch.int8
    b = tm.generate(ids, max_new_tokens=4, kv_cache_dtype="int8")
    assert tm.decode_graph is holder and torch.equal(a, b)


# -- the Engine over int8 pools ------------------------------------------------


def _engine(model, **kw):
    return tserving.Engine(model, device="cpu", kv_cache_dtype="int8",
                           **{**GEOM, **kw}).warmup()


@pytest.mark.parametrize("mode", ["on", "mega"])
def test_int8_engine_matches_jax_engine(mode, llama_pair):
    """The staggered traffic with a shared prefix (hits, copy-on-write)
    through the JAX and the port int8 engines: streams under the near-tie
    rule, prefix accounting equal, pools drained; on the port the step
    makes no ragged-attention or megakernel call (the composition
    attends the pools)."""
    jm, tm = llama_pair if mode == "on" else _llama_pair(mode)
    jeng = jserving.Engine(jm, kv_cache_dtype="int8", **GEOM).warmup()
    jout, _ = _drive(jeng)
    teng = _engine(tm)
    teng.margins = {}
    before = counts("cpu")
    tout, _ = _drive(teng)
    after = counts("cpu")
    _streams_agree(jout, tout, teng.margins)
    js, ts = jeng.prefix_stats(), teng.prefix_stats()
    for key in ("hits", "misses", "registered_pages", "cow_copies"):
        assert ts[key] == js[key], key
    assert ts["hits"] > 0 and ts["cow_copies"] > 0
    assert teng.kv_blocks_used == 0 and jeng.kv_blocks_used == 0
    steps = teng.steps
    assert after["ragged_paged_attention"] == \
        before["ragged_paged_attention"]
    assert after["mega_decode"] == before["mega_decode"]
    assert after["fused_rms_rope_qkv"] - before["fused_rms_rope_qkv"] == \
        2 * steps
    assert teng.launches_per_step()["fused_swiglu_mlp"] == 2


def test_int8_pools_serve(llama_pair):
    """Twin of ``test_int8_pools_serve``."""
    eng = _engine(llama_pair[1], max_batch=2, prefill_chunk=None)
    assert eng.kv.quantized
    rid = eng.add_request(np.random.default_rng(0).integers(0, 256, 7),
                          max_new_tokens=6)
    outs = eng.run()
    assert len(outs[rid]) == 6 and eng.kv_blocks_used == 0


def test_int8_pools_with_prefix_sharing(llama_pair):
    """Twin of ``test_int8_pools_with_prefix_sharing``: sharing and CoW
    over the 4-tuple copy values AND scales; the shared request equals
    the unshared one bit for bit."""
    eng = _engine(llama_pair[1], max_batch=2, prefill_chunk=None)
    p = np.random.default_rng(1).integers(0, 256, 16)
    r1 = eng.add_request(p, max_new_tokens=5)
    eng.run()
    r2 = eng.add_request(p, max_new_tokens=5)
    outs = eng.run()
    assert outs[r2] == eng.output_ids(r1)
    assert eng.prefix_stats()["hits"] == 2
    assert eng.prefix_stats()["cow_copies"] == 1
    assert eng.kv_blocks_used == 0


def test_warmup_and_idle_slots_leave_int8_pools_unchanged(llama_pair):
    eng = tserving.Engine(llama_pair[1], device="cpu", kv_cache_dtype="int8",
                          **GEOM)
    g = torch.Generator().manual_seed(0)
    for pools in eng.kv.caches:
        for t in pools:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g))
            else:
                t.uniform_(0.01, 0.1, generator=g)
    before = [tuple(t.clone() for t in pools) for pools in eng.kv.caches]
    eng.warmup()
    for pools, old in zip(eng.kv.caches, before):
        assert all(torch.equal(a, b) for a, b in zip(pools, old))
    eng.add_request(np.arange(11), max_new_tokens=3, request_id="x")
    eng.step()
    blocks = eng._states["x"].blocks
    others = [i for i in range(eng.kv.num_blocks) if i not in blocks]
    for pools, old in zip(eng.kv.caches, before):
        for a, b in zip(pools, old):
            assert torch.equal(a[others], b[others])
            assert not torch.equal(a[blocks], b[blocks])
    eng.run()
    assert eng.kv_blocks_used == 0


def _preempt_run(eng, prompts, preempt):
    rids = [eng.add_request(p, max_new_tokens=10, request_id=f"q{i}")
            for i, p in enumerate(prompts)]
    for _ in range(4):
        eng.step()
    if preempt:
        assert eng.preempt(rids[0])
    eng.run()
    return {r: eng.output_ids(r) for r in rids}


def test_preempt_int8_pools_round_trips_scales(llama_pair):
    """Twin of ``test_preempt_int8_pools_round_trips_scales``: the
    preempted request's stream equals the unpreempted int8 engine's (the
    swap carries values and scales), and the JAX int8 engine's under the
    same preemption."""
    jm, tm = llama_pair
    prompts = [np.random.default_rng(7).integers(0, 256, 13),
               np.random.default_rng(8).integers(0, 256, 6)]
    outs = []
    for preempt in (False, True):
        eng = _engine(tm, max_batch=2, prefill_chunk=None)
        eng.margins = {}
        outs.append(_preempt_run(eng, prompts, preempt))
        assert eng.kv_blocks_used == 0
    assert outs[0] == outs[1]
    assert eng._swap.pages_out > 0 and eng._swap.pages_in > 0
    jeng = jserving.Engine(jm, kv_cache_dtype="int8", max_batch=2,
                           max_seq_len=64, page_size=8).warmup()
    _streams_agree(_preempt_run(jeng, prompts, True), outs[1], eng.margins)


def test_identity_with_int8_pools(llama_pair):
    """Twin of ``test_spec.py`` ``test_identity_with_int8_pools``: the
    speculative int8 engine equals the spec-off int8 engine token for
    token and proposes drafts; and it equals the JAX speculative int8
    engine under the near-tie rule, drafts and acceptances counted
    alike."""
    jm, tm = llama_pair
    rng = np.random.default_rng(7)
    prompts = [np.tile(rng.integers(0, 256, 5), 3), rng.integers(0, 256, 3),
               rng.integers(0, 256, 17), np.tile(rng.integers(0, 256, 4), 4)]

    def serve(eng):
        rids = [eng.add_request(p, max_new_tokens=16, request_id=f"s{i}")
                for i, p in enumerate(prompts)]
        out = eng.run()
        return {r: out[r] for r in rids}

    base = serve(_engine(tm))
    eng = _engine(tm, **SPEC)
    eng.margins = {}
    got = serve(eng)
    assert got == base
    assert eng.spec_stats()["proposed"] > 0
    jeng = jserving.Engine(jm, kv_cache_dtype="int8", **GEOM,
                           **SPEC).warmup()
    if not _streams_agree(serve(jeng), got, eng.margins):
        for key in ("proposed", "accepted", "verifies"):
            assert eng.spec_stats()[key] == jeng.spec_stats()[key], key


def test_int8_kv_pool_with_lora():
    """Twin of ``test_lora.py`` ``test_int8_kv_pool``: an adapter request
    on the int8 engine equals ``generate(kv_cache_dtype="int8")`` of the
    merged-weight model, and the JAX LoRA int8 engine's stream."""
    jm, _ = _llama_pair("off")
    arrays = {k: np.asarray(v) for k, v in jm.named_parameters()}

    def port():
        return params_from_numpy(torch_llama("tiny", device="cpu",
                                             fused_ops="off"), arrays)

    ws = {f"ad{i}": jserving.random_adapter(
        jm, rank=8, rng=np.random.default_rng(20 + i)) for i in range(2)}
    model = port()
    pool = LoRAPool(model, max_adapters=2, rank=8)
    jpool = jserving.LoRAPool(jm, max_adapters=2, rank=8)
    for name, w in ws.items():
        pool.load(name, w)
        jpool.load(name, w)
    eng = _engine(model, lora=pool)
    eng.margins = {}
    p = np.random.default_rng(11).integers(0, 256, 11)
    rid = eng.add_request(p, max_new_tokens=6, adapter="ad1",
                          request_id="l")
    outs = eng.run()
    merged = port()
    merge_adapter(merged, ws["ad1"])
    ref = merged.generate(torch.from_numpy(p)[None], max_new_tokens=6,
                          kv_cache_dtype="int8")[0, len(p):].tolist()
    assert outs[rid] == ref
    jeng = jserving.Engine(jm, lora=jpool, kv_cache_dtype="int8",
                           **GEOM).warmup()
    jrid = jeng.add_request(p, max_new_tokens=6, adapter="ad1",
                            request_id="l")
    _streams_agree(jeng.run(), outs, eng.margins)
    assert eng.hbm_stats()["lora_pool_bytes"] == pool.nbytes() > 0


def test_weight_int8_with_int8_kv_matches_jax():
    """``weight_quant="int8"`` stacked on int8 pools, each side
    quantizing its own model: streams under the near-tie rule, prefix
    accounting equal."""
    jm, tm = _llama_pair("on")
    jeng = jserving.Engine(jm, weight_quant="int8", kv_cache_dtype="int8",
                           **GEOM).warmup()
    jout, _ = _drive(jeng)
    teng = _engine(tm, weight_quant="int8")
    teng.margins = {}
    tout, _ = _drive(teng)
    _streams_agree(jout, tout, teng.margins)
    for key in ("hits", "misses", "cow_copies"):
        assert teng.prefix_stats()[key] == jeng.prefix_stats()[key], key
    assert teng.launches_per_step()["int8_matmul"] == 2 * 7 + 1


def test_hbm_stats(llama_pair):
    """Keys and bytes: the int8 pools' bytes (D + 4) / (2 D) of the same
    engine's f32 / 2 (bf16-width) pools, the parameters' bytes, no LoRA
    pool, and 0 temporaries on the CPU."""
    tm = llama_pair[1]
    d = tm.cfg.head_dim
    fp = tserving.Engine(tm, device="cpu", kv_cache_dtype="bfloat16",
                         **GEOM).hbm_stats()
    q8 = tserving.Engine(tm, device="cpu", kv_cache_dtype="int8",
                         **GEOM).hbm_stats()
    assert sorted(q8) == ["kv_pool_bytes", "lora_pool_bytes", "param_bytes",
                          "peak_temp_bytes"]
    assert q8["kv_pool_bytes"] * 2 * d == fp["kv_pool_bytes"] * (d + 4)
    assert q8["param_bytes"] == sum(p.numel() * 4 for p in tm.parameters())
    assert q8["lora_pool_bytes"] == 0 and q8["peak_temp_bytes"] == 0


def test_bucket_path_over_int8_pools_matches_jax(llama_pair):
    """The paged bucket-prefill/decode path over ``PagedKVCache(dtype=
    "int8")``: one prefill of two prompts (lengths 7 and 11) and two
    decode calls, logits within F32 and the pools' scales within F32
    (codes at most one unit apart, where a tie rounds) of JAX's."""
    jm, tm = llama_pair
    cfg = tm.cfg
    kv = PagedKVCache(cfg.num_hidden_layers, 8, 4, cfg.num_key_value_heads,
                      cfg.head_dim, dtype="int8", device="cpu")
    tables = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    lens = np.array([7, 11], np.int32)
    ids = np.random.default_rng(13).integers(0, 256, (2, 11)).astype(np.int32)
    jcaches = [tuple(jnp.asarray(t.numpy()) for t in pools)
               for pools in kv.caches]
    tcaches = kv.caches
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lens)
    with torch.no_grad():
        th, tcaches = tm.model(torch.from_numpy(ids).long(), caches=tcaches,
                               seq_lens=tl, block_tables=tt)
    jh, jcaches = jm.model(jnp.asarray(ids), caches=jcaches,
                           seq_lens=jnp.asarray(lens),
                           block_tables=jnp.asarray(tables))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32)
    tok = np.array([[3], [5]], np.int32)
    for _ in range(2):
        with torch.no_grad():
            th, tcaches = tm.model(torch.from_numpy(tok).long(),
                                   caches=tcaches, seq_lens=tl,
                                   block_tables=tt)
            tlg = tm.logits(th[:, -1]).numpy()
        jh, jcaches = jm.model(jnp.asarray(tok), caches=jcaches,
                               seq_lens=jnp.asarray(lens),
                               block_tables=jnp.asarray(tables))
        np.testing.assert_allclose(tlg, np.asarray(jm.logits(jh[:, -1])),
                                   **F32)
        tok = tlg.argmax(-1)[:, None].astype(np.int32)
        tl = tl + 1
        lens = lens + 1
    for tp, jp in zip(tcaches, jcaches):
        for g, w in zip(tp, jp):
            if g.dtype == torch.int8:
                assert np.abs(g.numpy().astype(int)
                              - np.asarray(w).astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)
