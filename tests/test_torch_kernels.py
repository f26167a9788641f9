"""The port's three kernel ops (paddle_tpu_torch.ops.cuda) held against the
JAX package on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; here that
version must match the JAX ``_ref`` composition and the JAX Pallas kernel
run in interpret mode, on the same numpy inputs.  (The CUDA kernels
themselves run only on the card: ``chip_smoke.py`` holds each against
its plain version there.)

Tolerances: f32 rtol 1e-5 / atol 2e-5 -- the same arithmetic in another
summation order.  bf16 rtol/atol 1e-2 -- the same rounding points, where
an f32 sum that lands on a rounding boundary can move a bf16 value by one
unit in the last place (2**-8 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.ops.pallas import fused_mlp as JFM
from paddle_tpu.ops.pallas import fused_norm_qkv as JFQ
from paddle_tpu.ops.pallas import ragged_attention as JRA
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.ops.cuda import fused_mlp as TFM
from paddle_tpu_torch.ops.cuda import fused_norm_qkv as TFQ
from paddle_tpu_torch.ops.cuda import ragged_attention as TRA

F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a)).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# -- fused_rms_rope_qkv ------------------------------------------------------

def _qkv_inputs(rng, t=24, h=128, nq=256, nk=128, hd=128):
    x = rng.normal(size=(t, h)).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=(h,))).astype(np.float32)
    wq = (0.05 * rng.normal(size=(h, nq))).astype(np.float32)
    wk = (0.05 * rng.normal(size=(h, nk))).astype(np.float32)
    wv = (0.05 * rng.normal(size=(h, nk))).astype(np.float32)
    ang = rng.uniform(0, 50, size=(t, hd // 2)).astype(np.float32)
    ang = np.concatenate([ang, ang], axis=-1)
    return x, g, wq, wk, wv, np.cos(ang), np.sin(ang), hd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_rms_rope_qkv_plain_matches_jax(dtype):
    rng = np.random.default_rng(1)
    *arrs, hd = _qkv_inputs(rng)
    pairs = [_pair(a, dtype) for a in arrs]
    j = [p[0] for p in pairs]
    t = [p[1] for p in pairs]
    tol = DTYPES[dtype][2]
    got = TFQ.fused_rms_rope_qkv(*t, hd, 1e-5)
    ref = JIF._fused_rms_rope_qkv_ref(*j, hd, 1e-5)
    ker = JFQ.fused_rms_rope_qkv(*j, hd, eps=1e-5, interpret=True)
    for g_, r_, k_ in zip(got, ref, ker):
        assert g_.dtype == DTYPES[dtype][1]
        _close(g_, r_, tol)
        _close(g_, k_, tol)


# -- fused_swiglu_mlp --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_swiglu_mlp_plain_matches_jax(dtype):
    rng = np.random.default_rng(2)
    t, h, i = 24, 128, 256
    arrs = [rng.normal(size=(t, h)).astype(np.float32),
            (0.08 * rng.normal(size=(h, i))).astype(np.float32),
            (0.08 * rng.normal(size=(h, i))).astype(np.float32),
            (0.08 * rng.normal(size=(i, h))).astype(np.float32)]
    pairs = [_pair(a, dtype) for a in arrs]
    j = [p[0] for p in pairs]
    tt = [p[1] for p in pairs]
    tol = DTYPES[dtype][2]
    got = TFM.fused_swiglu_mlp(*tt)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, JIF._fused_swiglu_mlp_ref(*j), tol)
    _close(got, JFM.fused_swiglu_mlp(*j, interpret=True), tol)


# -- ragged paged attention ----------------------------------------------------

B, C, H, HKV, D, PAGE, NB, MB = 4, 8, 4, 2, 128, 16, 32, 4
# a decode token, a mid-prompt chunk, a span starting past page 2, and an
# idle slot
STARTS = np.array([33, 10, 50, 0], np.int32)
LENS = np.array([1, 6, 5, 0], np.int32)


def _ragged_inputs(rng):
    q = rng.normal(size=(B, C, H, D)).astype(np.float32)
    kp = rng.normal(size=(NB, PAGE, HKV, D)).astype(np.float32)
    vp = rng.normal(size=(NB, PAGE, HKV, D)).astype(np.float32)
    tables = np.full((B, MB), NB, np.int32)        # OOB table padding
    perm = rng.permutation(NB)
    k = 0
    for b in range(B):
        live_pages = -(-(STARTS[b] + LENS[b]) // PAGE)
        tables[b, :live_pages] = perm[k:k + live_pages]
        k += live_pages
    return q, kp, vp, tables


def _live(got, want, tol):
    for b in range(B):
        if LENS[b]:
            _close(got[b, :LENS[b]], want[b, :LENS[b]], tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_paged_attention_plain_matches_jax(dtype):
    rng = np.random.default_rng(3)
    q, kp, vp, tables = _ragged_inputs(rng)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kp, vp))
    tol = DTYPES[dtype][2]
    scale = 1.0 / np.sqrt(D)
    got = TRA.ragged_paged_attention(
        tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(STARTS),
        torch.from_numpy(LENS))
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, C, H, D)
    ref = JIF._ragged_attend_dense(
        jq, *JIF._paged_gather_dense(jk, jv, jnp.asarray(tables)),
        jnp.asarray(STARTS), scale)
    ker = JRA.ragged_paged_attention(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(STARTS),
        jnp.asarray(LENS), interpret=True)
    _live(got, ref, tol)
    _live(got, ker, tol)
    assert np.isfinite(_np(got)).all()


def test_ragged_paged_attend_span_write_matches_jax():
    """The full entry point: span write (dead rows and the OOB padding
    dropped) plus attention, against the JAX entry point on the CPU."""
    rng = np.random.default_rng(4)
    q, kp, vp, tables = _ragged_inputs(rng)
    nk = rng.normal(size=(B, C, HKV, D)).astype(np.float32)
    nv = rng.normal(size=(B, C, HKV, D)).astype(np.float32)
    jout, (jkc, jvc) = JIF.ragged_paged_attend(
        (jnp.asarray(kp), jnp.asarray(vp)), jnp.asarray(q), jnp.asarray(nk),
        jnp.asarray(nv), jnp.asarray(tables), jnp.asarray(STARTS),
        jnp.asarray(LENS))
    tkc, tvc = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tout, (tkc2, tvc2) = TIF.ragged_paged_attend(
        (tkc, tvc), torch.from_numpy(q), torch.from_numpy(nk),
        torch.from_numpy(nv), torch.from_numpy(tables),
        torch.from_numpy(STARTS), torch.from_numpy(LENS))
    assert tkc2 is tkc and tvc2 is tvc               # written in place
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(jkc))
    np.testing.assert_array_equal(tvc.numpy(), np.asarray(jvc))
    _live(tout, jout, F32_TOL)


def test_paged_copy_blocks_drops_oob_like_jax():
    rng = np.random.default_rng(5)
    kp = rng.normal(size=(NB, PAGE, HKV, D)).astype(np.float32)
    src = np.array([3, 7, NB, NB], np.int32)
    dst = np.array([9, 1, NB, NB], np.int32)
    want = JIF.paged_copy_blocks((jnp.asarray(kp),), jnp.asarray(src),
                                 jnp.asarray(dst))[0]
    got = TIF.paged_copy_blocks((torch.from_numpy(kp.copy()),),
                                torch.from_numpy(src),
                                torch.from_numpy(dst))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("op", ["qkv", "mlp", "attn"])
def test_wrappers_refuse_devices_without_a_kernel(op):
    """A wrapper runs its plain version only for CPU tensors; any other
    device gets the kernel or an error, never a silent fallback."""
    m = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        if op == "qkv":
            e = torch.empty((8, 128), device=m)
            TFQ.fused_rms_rope_qkv(e, e[0], e.T, e.T, e.T, e, e, 128)
        elif op == "mlp":
            e = torch.empty((8, 128), device=m)
            TFM.fused_swiglu_mlp(e, e.T, e.T, e)
        else:
            q = torch.empty((1, 1, 1, 128), device=m)
            i = torch.zeros((1, 1), dtype=torch.int32, device=m)
            TRA.ragged_paged_attention(q, q, q, i, i[0], i[0])


@pytest.mark.parametrize("scaled", [False, True])
def test_paged_gather_dense_matches_jax(scaled):
    """The plain gather clamps the OOB table padding like JAX, and
    dequantizes int8 pools through their per-(position, head) scales."""
    rng = np.random.default_rng(6)
    _, kp, vp, tables = _ragged_inputs(rng)
    args = [kp, vp, tables]
    if scaled:
        args = [rng.integers(-127, 128, size=kp.shape).astype(np.int8),
                rng.integers(-127, 128, size=vp.shape).astype(np.int8),
                tables,
                rng.uniform(0.01, 0.1, size=kp.shape[:3]).astype(np.float32),
                rng.uniform(0.01, 0.1, size=vp.shape[:3]).astype(np.float32)]
    want = JIF._paged_gather_dense(*map(jnp.asarray, args))
    got = TIF._paged_gather_dense(*map(torch.from_numpy, args))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g_), _np(w_), **F32_TOL)
