"""The port's paged two-phase serving path held against the JAX package on
the CPU: the plain ``paged_attention`` (the paged-attention kernel's
plain version), the decode write and ``paged_decode_attend``, and the
bucket prefill plus one-token decode through the GPT and Llama models
with block tables.

Tolerances: the attention op f32 rtol 1e-5 / atol 2e-5 (the same
arithmetic in another summation order), bf16 rtol = atol = 1e-2 (one
bf16 unit of the output), f16 rtol = atol = 1e-2 (the f16 tolerance the
kernels are held to on the card); the models' logits and final pools f32
rtol = atol = 1e-4 (two layers and five calls of the same arithmetic).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models.gpt import gpt as jax_gpt
from paddle_tpu.models.llama import llama as jax_llama
from paddle_tpu.ops.pallas import decode_attention as JDA
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.models import gpt as torch_gpt
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import params_from_numpy
from paddle_tpu_torch.ops.cuda import paged_attention as TPA

F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
F16_TOL = dict(rtol=1e-2, atol=1e-2)
TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL),
          "float16": (jnp.float16, torch.float16, F16_TOL)}


def _decode_inputs(rng, b, h, hkv, d, page, nb, mb, lens):
    """q, pools and block tables of a random permutation of the pool,
    padded with the out-of-range sentinel ``nb`` past each slot's live
    pages (a zero-length slot's whole row is sentinel)."""
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(nb, page, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(nb, page, hkv, d)).astype(np.float32)
    tables = np.full((b, mb), nb, np.int32)
    perm = rng.permutation(nb)
    used = 0
    for s in range(b):
        n = -(-int(lens[s]) // page)
        tables[s, :n] = perm[used:used + n]
        used += n
    return q, kp, vp, tables


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_paged_attention_plain_matches_jax(dtype, h, hkv):
    """Partial pages, an exact page multiple, a single position, a slot
    reaching the table's end and a zero-length slot, over sentinel-padded
    tables: against the interpret-mode Pallas kernel (zeros for the empty
    slot) and the reference's dense composition (live slots)."""
    jdt, tdt, tol = DTYPES[dtype]
    b, d, page, nb, mb = 5, 128, 16, 24, 4
    lens = np.array([37, 16, 1, 64, 0], np.int32)
    rng = np.random.default_rng(3)
    q, kp, vp, tables = _decode_inputs(rng, b, h, hkv, d, page, nb, mb, lens)
    tt = [torch.from_numpy(a).to(tdt) for a in (q, kp, vp)]
    got = TIF.paged_attention(*tt, torch.from_numpy(tables),
                              torch.from_numpy(lens))
    assert got.dtype == tdt
    assert torch.equal(got[lens == 0], torch.zeros_like(got[lens == 0]))
    jj = [jnp.asarray(a, jdt) for a in (q, kp, vp)]
    kern = JDA.paged_attention(*jj, jnp.asarray(tables), jnp.asarray(lens),
                               interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(kern, jnp.float32)),
                               **tol)
    dense = JIF.paged_attention(*jj, jnp.asarray(tables), jnp.asarray(lens))
    live = lens > 0
    np.testing.assert_allclose(
        got.float().numpy()[live],
        np.asarray(jnp.asarray(dense, jnp.float32))[live], **tol)


def test_attend_dense_gqa_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 8, 64)).astype(np.float32)
    k = rng.normal(size=(3, 20, 2, 64)).astype(np.float32)
    v = rng.normal(size=(3, 20, 2, 64)).astype(np.float32)
    lens = np.array([20, 7, 1], np.int32)
    got = TIF._attend_dense_gqa(*map(torch.from_numpy, (q, k, v, lens)),
                                0.125)
    want = JIF._attend_dense_gqa(*map(jnp.asarray, (q, k, v, lens)), 0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_paged_decode_attend_matches_jax():
    """The decode write and attention, pools and outputs: three live
    slots (one starting a fresh page, one mid-page, one at the table's
    last position) and a dead slot whose sentinel table drops its
    write."""
    b, h, hkv, d, page, nb, mb = 4, 8, 4, 64, 8, 16, 3
    write_pos = np.array([8, 13, 23, 0], np.int32)
    rng = np.random.default_rng(5)
    q, kp, vp, tables = _decode_inputs(rng, b, h, hkv, d, page, nb, mb,
                                       write_pos + 1)
    tables[3] = nb                                    # the dead slot
    nk = rng.normal(size=(b, hkv, d)).astype(np.float32)
    nv = rng.normal(size=(b, hkv, d)).astype(np.float32)
    tout, (tk, tv) = TIF.paged_decode_attend(
        (torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())),
        *map(torch.from_numpy, (q, nk, nv, tables, write_pos)))
    jout, (jk, jv) = JIF.paged_decode_attend(
        (jnp.asarray(kp), jnp.asarray(vp)),
        *map(jnp.asarray, (q, nk, nv, tables, write_pos)))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **F32_TOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    changed = (tk.numpy() != kp).any(axis=(2, 3))
    assert changed.sum() == 3                          # the dead write dropped
    # the int8 4-tuple takes the reference's composition: JAX's pools and
    # output (tests/test_torch_kv8.py holds it in full)
    k8, ks = TIF.quantize_kv(torch.from_numpy(kp))
    v8, vs = TIF.quantize_kv(torch.from_numpy(vp))
    pools = [k8, v8, ks, vs]
    t8, tc8 = TIF.paged_decode_attend(
        tuple(t.clone() for t in pools),
        *map(torch.from_numpy, (q, nk, nv, tables, write_pos)))
    j8, jc8 = JIF.paged_decode_attend(
        tuple(jnp.asarray(t.numpy()) for t in pools),
        *map(jnp.asarray, (q, nk, nv, tables, write_pos)))
    np.testing.assert_allclose(t8.numpy(), np.asarray(j8), **F32_TOL)
    for g, w in zip(tc8, jc8):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("branch", ["ragged", "decode", "prefill"])
def test_paged_attend_chooses_the_models_branch(branch):
    """``paged_attend`` equals the branch's own calls, outputs and pools
    bit for bit, and ``paged_positions`` gives that branch's positions:
    ``start + j`` on the ragged step, ``seq_lens`` for a decode, None
    (``arange(S)``) for a prefill."""
    b, h, hkv, d, page, nb, mb = 3, 4, 2, 16, 4, 12, 4
    s = 1 if branch == "decode" else 5
    rng = np.random.default_rng(11)
    _, kp, vp, tables = _decode_inputs(rng, b, h, hkv, d, page, nb, mb,
                                       [16, 9, 12])
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(
        np.float32)) for n in (h, hkv, hkv))
    tt = torch.from_numpy(tables)
    lens = torch.tensor([5, 3, 1] if branch != "decode" else [15, 8, 11],
                        dtype=torch.int32)
    starts = torch.tensor([4, 0, 9], dtype=torch.int32) \
        if branch == "ragged" else None
    pools = lambda: (torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()))
    got, (gk, gv) = TIF.paged_attend(pools(), q, k, v, tt, lens, starts)
    if branch == "ragged":
        want, (wk, wv) = TIF.ragged_paged_attend(pools(), q, k, v, tt,
                                                 starts, lens)
        pos = starts.long()[:, None] + torch.arange(s)[None]
    elif branch == "decode":
        want, (wk, wv) = TIF.paged_decode_attend(pools(), q[:, 0], k[:, 0],
                                                 v[:, 0], tt, lens)
        want, pos = want[:, None], lens.long()[:, None]
    else:
        wk, wv = TIF.paged_prefill_write(pools(), k, v, tt, lens)
        want = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.repeat_interleave(h // hkv, 2).transpose(
                1, 2), v.repeat_interleave(h // hkv, 2).transpose(1, 2),
            is_causal=True).transpose(1, 2)
        pos = None
    assert got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    tpos = TIF.paged_positions(s, lens, starts)
    assert (tpos is None and pos is None) or torch.equal(tpos, pos)


def _model_pair(family):
    pt.seed(0)
    if family == "gpt":
        jm = jax_gpt("tiny", fused_ops="on")
        tm = torch_gpt("tiny", device="cpu", fused_ops="on")
    else:
        jm = jax_llama("tiny", fused_ops="on")
        tm = torch_llama("tiny", device="cpu", fused_ops="on")
    rng = np.random.default_rng(1)
    arrays = {}
    for k, v in jm.named_parameters():
        a = np.asarray(v)
        if k.endswith(".bias"):                       # zero at JAX init
            a = (0.05 * rng.normal(size=a.shape)).astype(np.float32)
        arrays[k] = a
    jm.set_state_dict(arrays)
    return jm, params_from_numpy(tm, arrays)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_bucket_prefill_then_decode_matches_jax(family):
    """One bucket prefill of ragged prompts (the fourth slot dead: zero
    length, sentinel table), then 4 greedy decode calls, through the
    model with block tables: logits and final pools equal JAX's."""
    jm, tm = _model_pair(family)
    cfg = jm.cfg
    b, s, page, nb, mb = 4, 12, 4, 24, 5
    kvh = getattr(cfg, "num_key_value_heads", None) or \
        cfg.num_attention_heads
    hd = cfg.head_dim
    plens = np.array([12, 7, 5, 0], np.int32)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    tables = np.full((b, mb), nb, np.int32)
    perm = rng.permutation(nb)
    for i in range(3):
        tables[i] = perm[i * mb:(i + 1) * mb]
    pools = [(rng.normal(size=(nb, page, kvh, hd)).astype(np.float32),
              rng.normal(size=(nb, page, kvh, hd)).astype(np.float32))
             for _ in range(cfg.num_hidden_layers)]
    jc = [(jnp.asarray(k), jnp.asarray(v)) for k, v in pools]
    tc = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
          for k, v in pools]
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)

    def step(tokens, lens):
        nonlocal jc, tc
        jh, jc = jm.model(jnp.asarray(tokens), caches=jc,
                          seq_lens=jnp.asarray(lens), block_tables=jt)
        with torch.no_grad():
            th, tc = tm.model(torch.from_numpy(tokens), caches=tc,
                              seq_lens=torch.from_numpy(lens),
                              block_tables=tt)
            tl = tm.logits(th).numpy()
        jl = np.asarray(jm.logits(jh))
        np.testing.assert_allclose(tl, jl, **TOL)
        return jl

    jl = step(ids, plens)
    last = jl[np.arange(b), np.maximum(plens - 1, 0)]
    lens = plens.copy()
    for _ in range(4):
        tok = last.argmax(-1).astype(np.int32)[:, None]
        last = step(tok, lens)[:, 0]
        lens = np.where(plens > 0, lens + 1, 0).astype(np.int32)
    for (tk, tv), (jk, jv) in zip(tc, jc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    untouched = perm[3 * mb:]
    for (tk, _), (k0, _) in zip(tc, pools):
        np.testing.assert_array_equal(tk.numpy()[untouched], k0[untouched])


def test_paged_attention_wrapper_refuses_devices_without_a_kernel():
    m = torch.device("meta")
    q = torch.empty((1, 1, 128), device=m)
    p = torch.empty((1, 16, 1, 128), device=m)
    i = torch.zeros((1, 1), dtype=torch.int32, device=m)
    with pytest.raises(ValueError, match="no kernel for device"):
        TPA.paged_attention(q, p, p, i, i[0])
