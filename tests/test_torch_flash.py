"""The port's flash attention (paddle_tpu_torch.ops.cuda.flash_attention)
held against the JAX package on the CPU.

On CPU tensors the port runs the kernels' plain versions; here they must
match the JAX Pallas kernels run in interpret mode (forward, lse and the
backward through ``jax.vjp`` of ``flash_attention_with_lse``, both
cotangents), and autograd through the port's ``flash_attention`` must
match ``jax.grad`` through the reference's plain ``_xla_attention``.  The
JAX side is computed once per module.  (The CUDA kernels run only on the
card: ``chip_smoke.py`` holds each against its plain version there.)

Tolerances: f32 rtol 1e-5 / atol 2e-5 -- the same arithmetic in another
summation order; bf16 rtol/atol 2e-2 -- the same rounding points, where a
probability rounded to bf16 at another running maximum moves an output by
about one bf16 unit (2**-8 relative); f16 rtol/atol 2e-3 -- the same
argument with f16's finer unit (2**-11 relative, 8 times finer than bf16's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl

import paddle_tpu.ops.pallas.flash_attention as JFA
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda import flash_attention as TFA
from paddle_tpu_torch.ops.cuda._build import dtype_code

B, S, H, HKV, D = 1, 64, 4, 2, 32       # GQA: two q heads per kv head
TOL = {"float32": dict(rtol=1e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2),
       "float16": dict(rtol=2e-3, atol=2e-3)}
# (causal, dtype, query rows): the fourth case has Sq < Sk, so the causal
# mask is offset to the bottom right
CASES = [(True, "float32", S), (False, "float32", S), (True, "bfloat16", S),
         (True, "float32", S // 2), (True, "float16", S)]


def _inputs(seed, sq=S):
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.normal(size=(B, sq, H, D))).astype(np.float32)
    k = (0.5 * rng.normal(size=(B, S, HKV, D))).astype(np.float32)
    v = rng.normal(size=(B, S, HKV, D)).astype(np.float32)
    do = rng.normal(size=(B, sq, H, D)).astype(np.float32)
    dlse = rng.normal(size=(B, H, sq)).astype(np.float32)
    return q, k, v, do, dlse


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def jax_kernel_results():
    """Per case: the Pallas kernels in interpret mode, 32-row blocks (two
    tiles per axis): (out, lse) and (dq, dk, dv) for cotangents (do,
    dlse)."""
    real = pl.pallas_call
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(real, interpret=True))
        for causal, dtype, sq in CASES:
            q, k, v, do, dlse = _inputs(0, sq)
            jdt = jnp.dtype(dtype)
            args = [jnp.asarray(a, jdt) for a in (q, k, v)]
            fn = functools.partial(JFA.flash_attention_with_lse,
                                   causal=causal, block_q=32, block_k=32)
            (o, lse), vjp = jax.vjp(fn, *args)
            grads = vjp((jnp.asarray(do, jdt), jnp.asarray(dlse)))
            out[(causal, dtype, sq)] = (o, lse, grads)
    return out


@pytest.mark.parametrize("causal,dtype,sq", CASES)
def test_flash_plain_matches_jax_kernels(jax_kernel_results, causal, dtype,
                                         sq):
    o_j, lse_j, grads_j = jax_kernel_results[(causal, dtype, sq)]
    q, k, v, do, dlse = _inputs(0, sq)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    tol = TOL[dtype]
    out, lse = TFA.plain(tq, tk, tv, causal)
    assert out.dtype == tdt and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(o_j), **tol)
    np.testing.assert_allclose(_np(lse), _np(lse_j), **TOL["float32"])
    grads = TFA.plain_bwd(tq, tk, tv, out, lse, tdo, causal,
                          dlse=torch.from_numpy(dlse))
    for g, gj in zip(grads, grads_j):
        assert g.dtype == tdt
        np.testing.assert_allclose(_np(g), _np(gj), **tol)
    # the public op's autograd reaches the same backward, lse cotangent
    # included
    xs = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o2, l2 = TFA.flash_attention_with_lse(*xs, causal=causal)
    torch.autograd.backward([o2, l2], [tdo, torch.from_numpy(dlse)])
    for x, g in zip(xs, grads):
        np.testing.assert_array_equal(_np(x.grad), _np(g))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_xla_attention_grad(causal):
    """The reference's oracle for the backward: ``jax.grad`` through its
    plain ``_xla_attention``, f32."""
    q, k, v, do, _ = _inputs(1)

    def jloss(q_, k_, v_):
        return jnp.sum(JF._xla_attention(q_, k_, v_, is_causal=causal)
                       * jnp.asarray(do))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = TF.scaled_dot_product_attention(*xs, is_causal=causal)
    (out * torch.from_numpy(do)).sum().backward()
    want = JF._xla_attention(*map(jnp.asarray, (q, k, v)), is_causal=causal)
    np.testing.assert_allclose(_np(out), _np(want), rtol=1e-5, atol=2e-5)
    for x, g in zip(xs, jg):
        np.testing.assert_allclose(_np(x.grad), _np(g), rtol=1e-4, atol=1e-4)


def test_sdpa_routing_and_gate():
    """A mask or dropout, or a shape the gate declines, takes the plain
    composition; causal sq > sk is rejected as in the reference."""
    q, k, v, _, _ = _inputs(2)
    mask = np.tril(np.ones((S, S), bool))[None, None]
    got = TF.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), attn_mask=torch.from_numpy(mask))
    want = JF._xla_attention(*map(jnp.asarray, (q, k, v)),
                             attn_mask=jnp.asarray(mask))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=2e-5)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k[:, :16])
    assert not TFA.supported(tq, tk, tk, causal=True)
    assert TFA.supported(tq, tk, tk, causal=False)
    with pytest.raises(ValueError, match="sq <= sk"):
        TFA.flash_attention(tq, tk, tk, causal=True)
    meta = torch.empty((1, 8, 2, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        TFA.flash_attention(meta, meta, meta)


@pytest.mark.parametrize("sq,sk,h,hkv,d,causal,dtype", [
    (64, 64, 4, 2, 128, True, "bfloat16"),
    (64, 64, 4, 2, 80, False, "float16"),     # neither d nor f16 is special
    (64, 64, 4, 2, 256, True, "float32"),
    (64, 64, 4, 2, 257, False, "float32"),    # past the gate's d <= 256
    (64, 64, 4, 3, 64, False, "float32"),     # h % hkv != 0
    (4, 64, 4, 2, 64, False, "float32"),      # a sequence shorter than 8
    (64, 32, 4, 2, 64, True, "float32"),      # causal sq > sk
])
def test_supported_is_the_reference_gate(sq, sk, h, hkv, d, causal, dtype):
    """The port's gate admits exactly what the reference's admits, on any
    device: a card tensor the kernels cannot take raises in the wrapper
    rather than taking the plain composition."""
    q = np.zeros((1, sq, h, d), np.float32)
    k = np.zeros((1, sk, hkv, d), np.float32)
    want = JFA.supported(*(jnp.asarray(a, jnp.dtype(dtype))
                           for a in (q, k, k)), causal=causal)
    got = TFA.supported(*(torch.from_numpy(a).to(getattr(torch, dtype))
                          for a in (q, k, k)), causal=causal)
    assert got == want


def test_causal_overhang_raises_in_both_wrappers():
    """sq > sk under a causal mask raises in the forward and backward
    wrappers on every device, before any launch."""
    q, k, v, do, _ = _inputs(3)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k[:, :16],
                                                      v[:, :16], do))
    with pytest.raises(ValueError, match="sq <= sk"):
        TFA.flash_fwd(tq, tk, tv, D ** -0.5, True)
    lse = torch.zeros((B, H, S))
    with pytest.raises(ValueError, match="sq <= sk"):
        TFA.flash_bwd(tq, tk, tv, tq, lse, tdo, D ** -0.5, True)


@pytest.mark.parametrize("dtype,code", [("float32", 0), ("bfloat16", 1),
                                        ("float16", 2), ("float64", None)])
def test_kernel_dtype_gate(dtype, code):
    """The card path's checks admit f32, bf16 and f16 (C dtype codes 0, 1,
    2) and raise on any other type, before a launch."""
    q = torch.zeros((1, 16, 4, 64), dtype=getattr(torch, dtype))
    k = torch.zeros((1, 16, 2, 64), dtype=q.dtype)
    if code is None:
        with pytest.raises(ValueError, match="the kernels take"):
            TFA._check("flash_attention", q, k, k)
        with pytest.raises(TypeError):
            dtype_code(q.dtype, TFA._DTYPES)
    else:
        TFA._check("flash_attention", q, k, k)
        assert dtype_code(q.dtype, TFA._DTYPES) == code
