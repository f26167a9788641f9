"""The decode megakernel's phase and split plan
(paddle_tpu_torch.ops.cuda.mega_plan), the wrapper's use of it, and the
bf16 kernel's order of operations, on the CPU.

The plan is a pure function of the shapes, the dtype and the SM count:
in bf16 the phases (norm, Q/K/V tiles, their split sum, attention, O
projection into f32 partials, their sum with the residual), the Q/K/V
contraction split by the fused QKV kernel's rule, the O projection split
to fill the co-resident grid, and one scratch (nx, then the partials the
two phases share).  The CUDA kernel runs only on the card
(``chip_smoke.py`` holds it against its plain version there); here the
wrapper is driven as if its tensors lay on a card, with the launch
replaced by a recorder.

The split emulation repeats the bf16 kernel's arithmetic in torch: nx
rounded once; each Q/K/V split's f32 product, the partials added in split
order, round -> RoPE -> round; the plain ragged attention (the kernel's
phase 2 is unchanged, and ``chip_smoke.py`` holds it on the card); each O
split's f32 product over its contraction steps, the partials added in
split order, rounded, x added, rounded.  It is held against the JAX
megakernel in interpret mode at the existing bf16 tolerance (2e-2: an f32
sum taken in another order can move a bf16 rounding by one unit) on live
rows, span k/v on every row.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import mega_decode as JMD
from paddle_tpu_torch.ops.cuda import mega_decode as TMD
from paddle_tpu_torch.ops.cuda import ragged_attention as TRA
from paddle_tpu_torch.ops.cuda.mega_plan import (BLOCKS_PER_SM, check_plan,
                                                 mega_plan)
from paddle_tpu_torch.ops.cuda.mlp_plan import H100_SMS, MAX_PARTIAL_BYTES

BF16, F32 = torch.bfloat16, torch.float32
ALL = ("norm", "qkv", "qkv_sum", "attention", "o_proj", "o_sum")

# (T, H, Nq, Nk, HD) -> (qkv tiles, qkv splits, o tiles, o splits,
# partial bytes) in bf16
MAIN = {
    (128, 4096, 4096, 4096, 128): (96, 2, 32, 8, 16_777_216),   # llama2-7b
    (128, 8192, 8192, 1024, 128): (80, 2, 64, 4, 16_777_216),   # 70b GQA
    (8, 4096, 4096, 4096, 128): (96, 2, 32, 8, 1_048_576),      # C = 1
    (32, 2048, 2048, 1024, 256): (32, 5, 16, 16, 4_194_304),    # HD 256
}


def _invariants(p):
    check_plan("test", p)
    for steps, splits in ((p.qkv_steps, p.qkv_splits),
                          (p.o_steps, p.o_splits)):
        assert 1 <= splits <= steps
        per = -(-steps // splits)
        assert (splits - 1) * per < steps <= splits * per
    assert p.partial_offset >= p.nx_bytes and p.partial_offset % 256 == 0
    assert p.scratch_bytes == p.partial_offset + p.partial_bytes
    assert p.partial_bytes <= MAX_PARTIAL_BYTES


@pytest.mark.parametrize("shape", list(MAIN),
                         ids=lambda s: "-".join(map(str, s)))
def test_plan_at_the_main_geometries(shape):
    p = mega_plan(*shape, BF16)
    _invariants(p)
    assert (p.qkv_tiles, p.qkv_splits, p.o_tiles, p.o_splits,
            p.partial_bytes) == MAIN[shape]
    assert p.phases == ALL and p.qkv_sum
    assert p.nx_bytes == shape[0] * shape[1] * 2
    # the O projection's items fill the co-resident grid to within one
    # split (no split left empty), or its partials cap them
    t, h = shape[:2]
    assert (p.o_tiles * (p.o_splits + 1) > BLOCKS_PER_SM * H100_SMS
            or 4 * t * h * (p.o_splits + 1) > MAX_PARTIAL_BYTES)


def test_one_qkv_split_keeps_rope_in_registers():
    p = mega_plan(128, 4096, 4096, 4096, 128, BF16, sms=64)
    assert p.qkv_splits == 1 and not p.qkv_sum
    assert "qkv_sum" not in p.phases
    assert p.partial_bytes == 4 * p.o_splits * 128 * 4096
    # a head of 256 spans two tiles: the sum phase runs at one split too
    wide = mega_plan(128, 4096, 4096, 4096, 256, BF16, sms=64)
    assert wide.qkv_splits == 1 and wide.qkv_sum and "qkv_sum" in wide.phases


@pytest.mark.parametrize("shape", list(MAIN),
                         ids=lambda s: "-".join(map(str, s)))
def test_f32_plan_is_three_simt_phases_without_scratch(shape):
    p = mega_plan(*shape, F32)
    _invariants(p)
    assert (p.qkv_splits, p.o_splits, p.scratch_bytes) == (1, 1, 0)
    assert p.phases == ("qkv", "attention", "o_proj")


@pytest.mark.parametrize("args,err", [
    ((128, 4096, 4096, 4096, 128, torch.float16), TypeError),
    ((0, 4096, 4096, 4096, 128, BF16), ValueError),
    ((128, 4000, 4096, 4096, 128, BF16), ValueError),
    ((128, 4096, 4096, 4096, 32, BF16), ValueError),
    ((128, 4096, 4000, 4096, 128, BF16), ValueError)],
    ids=["f16", "t0", "h", "hd32", "nq"])
def test_plan_refuses_what_no_kernel_takes(args, err):
    with pytest.raises(err):
        mega_plan(*args)


@pytest.mark.parametrize("change", [dict(qkv_splits=0), dict(o_splits=0),
                                    dict(qkv_splits=40), dict(o_splits=65)],
                         ids=["qkv0", "o0", "qkv-empty", "o-empty"])
def test_check_plan_refuses_a_plan_the_kernel_cannot_run(change):
    good = mega_plan(128, 4096, 4096, 4096, 128, BF16)
    with pytest.raises(ValueError, match="cannot run the plan"):
        check_plan("test", dataclasses.replace(good, **change))
    with pytest.raises(ValueError):   # f32 takes no split
        check_plan("test", dataclasses.replace(
            mega_plan(128, 4096, 4096, 4096, 128, F32), o_splits=2))


def _case(starts, lens, b=3, c=8, h=256, nh=4, nkh=2, hd=64, page=8, nb=24,
          mb=6, seed=0):
    """One ragged layer case as numpy f32 values exact in bf16: weights,
    per-slot rope tables at the span positions, random pools, a permuted
    block table."""
    r = np.random.default_rng(seed)

    def arr(*shape, scale=0.1):
        a = jnp.asarray(r.normal(size=shape) * scale, jnp.bfloat16)
        return np.asarray(a.astype(jnp.float32))

    st = np.asarray(starts, np.int32)
    cos, sin = JF.rope_cos_sin(
        c, hd, dtype=jnp.bfloat16,
        position_ids=jnp.asarray(st)[:, None] + jnp.arange(c)[None, :])
    fp = [arr(b, c, h, scale=1.0), arr(h, scale=0.1) + 1.0,
          arr(h, nh * hd), arr(h, nkh * hd), arr(h, nkh * hd),
          arr(nh * hd, h), np.asarray(cos.astype(jnp.float32)),
          np.asarray(sin.astype(jnp.float32))]
    pools = [arr(nb, page, nkh, hd, scale=0.5),
             arr(nb, page, nkh, hd, scale=0.5)]
    ints = [r.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32), st,
            np.asarray(lens, np.int32)]
    return fp, pools, ints, hd


def _rope(y, cos, sin, hd):
    """Rotate-half RoPE in f32 on y (T, N) of rounded values, head by
    head, as the kernel's register epilogue and its split sum compute it."""
    t, n = y.shape
    yh = y.reshape(t, n // hd, hd)
    lo, hi = yh[..., :hd // 2], yh[..., hd // 2:]
    c, s = cos.float()[:, None, :], sin.float()[:, None, :]
    out_lo = lo * c[..., :hd // 2] + (-hi) * s[..., :hd // 2]
    out_hi = hi * c[..., hd // 2:] + lo * s[..., hd // 2:]
    return torch.cat([out_lo, out_hi], -1).reshape(t, n)


def _split_sum(a, w, splits, bk=64):
    """a @ w as the kernel's splits take it: each split's f32 product over
    its contraction steps, the partials added in split order."""
    steps = a.shape[1] // bk
    per = -(-steps // splits) * bk
    acc = torch.zeros((a.shape[0], w.shape[1]))
    for s in range(splits):
        acc = acc + a[:, s * per:(s + 1) * per].float() @ \
            w[s * per:(s + 1) * per].float()
    return acc


def split_emulation(x, g, wq, wk, wv, wo, cos, sin, kp, vp, tables, starts,
                    lens, hd, eps, plan):
    b, c, h = x.shape
    t, dt = b * c, x.dtype
    nq, nk = wq.shape[1], wk.shape[1]
    xf = x.reshape(t, h).float()
    nx = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
          * g.float()).to(dt)
    y = _split_sum(nx, torch.cat([wq, wk, wv], 1), plan.qkv_splits)
    y = y.to(dt).float()
    cs, sn = cos.reshape(t, hd), sin.reshape(t, hd)
    q = _rope(y[:, :nq], cs, sn, hd).to(dt)
    k = _rope(y[:, nq:nq + nk], cs, sn, hd).to(dt)
    v = y[:, nq + nk:].to(dt)
    kc, vc = TRA.span_write(kp.clone(), vp.clone(),
                            k.reshape(b, c, -1, hd), v.reshape(b, c, -1, hd),
                            tables, starts, lens)
    attn = TRA.plain(q.reshape(b, c, -1, hd), kc, vc, tables, starts, lens,
                     None)
    o = _split_sum(attn.reshape(t, nq), wo, plan.o_splits).to(dt)
    out = (xf + o.float()).to(dt)
    return out.reshape(b, c, h), k.reshape(b, c, nk), v.reshape(b, c, nk)


@pytest.mark.parametrize("sms", [H100_SMS, 2], ids=["splits", "few-splits"])
@pytest.mark.parametrize("starts,lens", [([13, 0, 5], [1, 8, 0]),
                                         ([7, 21, 3], [3, 1, 5])],
                         ids=["decode-chunk-idle", "mid-chunk"])
def test_split_order_keeps_the_rounding_points(starts, lens, sms):
    fp, pools, ints, hd = _case(starts, lens)
    x = fp[0]
    plan = mega_plan(x.shape[0] * x.shape[1], x.shape[2], fp[2].shape[1],
                     fp[3].shape[1], hd, BF16, sms=sms)
    assert (plan.qkv_splits, plan.o_splits) == (
        (4, 4) if sms == H100_SMS else (1, 2))
    tf = [torch.tensor(a).to(BF16) for a in fp + pools]
    ti = [torch.from_numpy(a) for a in ints]
    got = split_emulation(*tf, *ti, hd, 1e-5, plan)
    want = JMD.mega_decode(*[jnp.asarray(a, jnp.bfloat16) for a in fp + pools],
                           *[jnp.asarray(a) for a in ints], hd,
                           interpret=True)
    live = np.arange(x.shape[1])[None, :] < np.asarray(lens)[:, None]
    tol = dict(rtol=2e-2, atol=2e-2)
    w = [np.asarray(jnp.asarray(a, jnp.float32)) for a in want]
    np.testing.assert_allclose(got[0].float().numpy()[live], w[0][live],
                               **tol)
    for gt, wt in zip(got[1:], w[1:]):
        np.testing.assert_allclose(gt.float().numpy(), wt, **tol)
    plain = TMD.plain(*tf, *ti, hd)
    np.testing.assert_allclose(got[0].float().numpy()[live],
                               plain[0].float().numpy()[live], **tol)


def test_wrapper_passes_the_plan_and_its_scratch(monkeypatch):
    """On a card the wrapper passes the plan's splits and one scratch:
    nx first, the partials at the plan's offset."""
    calls = []
    monkeypatch.setattr(TMD, "on_cuda", lambda op, *ts, kernel=None: True)
    monkeypatch.setattr(TMD, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(TMD, "grid_blocks", lambda *a: 264)
    monkeypatch.setattr(TMD, "stream_of", lambda x: 0)
    monkeypatch.setattr(TMD.KERNEL, "launch", lambda *a: calls.append(a))
    fp, pools, ints, hd = _case([13, 0, 5], [1, 8, 0])
    tf = [torch.tensor(a).to(BF16) for a in fp + pools]
    TMD.mega_decode(*tf, *[torch.from_numpy(a) for a in ints], hd)
    plan = mega_plan(24, 256, 256, 128, 64, BF16)
    args = calls[-1]
    nx, partial = args[18], args[19]
    assert partial - nx == plan.partial_offset
    # (..., b, c, h, nq, nk, nb, page, h_kv, d, mb, qkv_splits, o_splits)
    assert args[20:32] == (3, 8, 256, 256, 128, 24, 8, 2, 64, 6,
                           plan.qkv_splits, plan.o_splits)
    assert (plan.qkv_splits, plan.o_splits) == (4, 4)
