"""The fused RMSNorm -> QKV -> RoPE kernel's launch plan
(paddle_tpu_torch.ops.cuda.qkv_plan), the wrapper's refusals, and the
split kernel's order of operations, on the CPU.

The plan is a pure function of the shapes, the dtype and the SM count:
128 x 128 tiles of [q | k | v] in bf16, the contraction split only where
those tiles are too few to fill the card, and the scratch (nx in bf16,
then the f32 partials).  The CUDA kernel runs only on the card
(``chip_smoke.py`` holds it against its plain version there); here the
wrapper is driven as if its tensors lay on a card, with the launch
replaced by a tripwire, to show that a bad shape, dtype or plan raises
before any launch.

The split emulation repeats the split kernel's arithmetic in torch: the
per-split f32 partial products summed in split order, then round ->
RoPE -> round.  Held against the JAX reference
``_fused_rms_rope_qkv_ref`` in bf16 at rtol/atol 1e-2 (an f32 sum taken
in another order can move a bf16 rounding by one unit, 2**-8 relative),
it shows that moving RoPE into the split sum keeps the contract's
rounding points.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu_torch.ops.cuda import fused_norm_qkv as TFQ
from paddle_tpu_torch.ops.cuda.mlp_plan import H100_SMS, MAX_PARTIAL_BYTES
from paddle_tpu_torch.ops.cuda.qkv_plan import check_plan, qkv_plan

BF16, F32 = torch.bfloat16, torch.float32

# (T, H, Nq, Nk, HD) -> (tiles, splits, partial bytes) in bf16
MAIN = {
    (128, 4096, 4096, 4096, 128): (96, 2, 12_582_912),       # llama2-7b
    (128, 8192, 8192, 1024, 128): (80, 2, 10_485_760),       # llama2-70b
    (4096, 4096, 4096, 4096, 128): (3072, 1, 0),             # training
    (128, 4096, 4096, 4096, 64): (96, 2, 12_582_912),        # HD = 64
}
# the widths the port serves: llama2-7b, llama2-70b GQA, llama-350m-hd128
WIDTHS = [(4096, 4096, 4096, 128), (8192, 8192, 1024, 128),
          (1024, 1024, 1024, 128)]


def _invariants(p):
    check_plan("test", p)
    assert p.n_total == p.nq + 2 * p.nk
    assert p.nx_bytes == (p.t * p.h * 2 if p.dtype == BF16 else 0)
    assert p.partial_offset >= p.nx_bytes and p.partial_offset % 256 == 0
    assert p.scratch_bytes == p.partial_offset + p.partial_bytes
    assert 1 <= p.splits <= p.k_steps
    assert (p.splits - 1) * p.steps_per_split < p.k_steps
    assert p.splits * p.steps_per_split >= p.k_steps


@pytest.mark.parametrize("shape", list(MAIN),
                         ids=lambda s: "-".join(map(str, s)))
def test_plan_at_the_main_shapes(shape):
    p = qkv_plan(*shape, BF16)
    _invariants(p)
    assert (p.tiles, p.splits, p.partial_bytes) == MAIN[shape]
    assert (p.bm, p.bn, p.bk) == (128, 128, 64)
    assert p.nx_bytes == shape[0] * shape[1] * 2
    if p.splits > 1:
        assert p.tiles < H100_SMS <= p.blocks
    assert p.partial_bytes <= MAX_PARTIAL_BYTES


@pytest.mark.parametrize("shape", list(MAIN),
                         ids=lambda s: "-".join(map(str, s)))
def test_f32_plan_is_one_simt_pass_without_scratch(shape):
    p = qkv_plan(*shape, F32)
    _invariants(p)
    t, h, nq, nk, hd = shape
    assert (p.bm, p.bn, p.splits, p.scratch_bytes) == (64, hd, 1, 0)
    assert p.col_tiles == nq // hd + 2 * (nk // hd)


@pytest.mark.parametrize("h,nq,nk,hd", WIDTHS)
def test_partials_stay_small_at_serving_token_counts(h, nq, nk, hd):
    """At every T <= 257 the f32 partials stay within 16 MiB, and where
    the contraction is split the blocks fill the 132 SMs."""
    for t in range(1, 258):
        p = qkv_plan(t, h, nq, nk, hd, BF16)
        _invariants(p)
        assert p.partial_bytes <= MAX_PARTIAL_BYTES == 16 << 20, (t, p)
        if p.splits > 1:
            assert p.blocks >= H100_SMS and p.tiles < H100_SMS, (t, p)
        else:
            assert p.partial_bytes == 0


def test_no_split_at_the_training_token_count():
    p = qkv_plan(4096, 4096, 4096, 4096, 128, BF16)
    assert p.splits == 1 and p.partial_bytes == 0
    assert p.scratch_bytes == p.nx_bytes == 4096 * 4096 * 2


def test_plan_follows_the_sm_count():
    shape = (128, 4096, 4096, 4096, 128)
    assert qkv_plan(*shape, BF16, sms=132).splits == 2
    assert qkv_plan(*shape, BF16, sms=96).splits == 1
    assert qkv_plan(*shape, BF16, sms=64).splits == 1
    assert qkv_plan(*shape, BF16, sms=97).splits == 2
    # ceil(200 / 96) = 3 splits would need 18.9 MB of partials: capped
    assert qkv_plan(*shape, BF16, sms=200).splits == 2
    assert qkv_plan(64, 4096, 4096, 4096, 128, BF16, sms=200).splits == 3


def test_a_32_wide_contraction_tail_counts_as_a_step():
    p = qkv_plan(128, 4128, 4096, 4096, 128, BF16)
    _invariants(p)
    assert p.k_steps == 65 and p.splits == 2 and p.steps_per_split == 33


def test_gqa_and_half_tiles():
    """Nq or Nk an odd multiple of 64 at HD = 64 ends in a half tile."""
    p = qkv_plan(16, 256, 192, 64, 64, BF16)
    assert p.col_tiles == 2 + 2 * 1 and p.tiles == 4
    _invariants(p)


@pytest.mark.parametrize("args,err", [
    ((128, 4100, 4096, 4096, 128, BF16), ValueError),
    ((128, 4096, 4096, 4096, 96, BF16), ValueError),
    ((128, 4096, 4000, 4096, 128, BF16), ValueError),
    ((128, 4096, 4096, 0, 128, BF16), ValueError),
    ((0, 4096, 4096, 4096, 128, BF16), ValueError),
    ((128, 4096, 4096, 4096, 128, torch.float16), TypeError),
    ((128, 4096, 4096, 4096, 128, torch.float64), TypeError),
], ids=["h", "hd96", "nq", "nk0", "t0", "f16", "f64"])
def test_plan_refuses_what_no_kernel_takes(args, err):
    with pytest.raises(err):
        qkv_plan(*args)


@pytest.mark.parametrize("change", [
    dict(splits=0), dict(splits=65), dict(splits=40), dict(bm=64),
    dict(bn=64), dict(h=4100), dict(head_dim=96),
    dict(dtype=torch.float16)],
    ids=["splits0", "splits-past-k", "empty-split", "bm64", "bn64", "h",
         "hd96", "f16"])
def test_check_plan_refuses_a_plan_the_kernel_cannot_run(change):
    good = qkv_plan(128, 4096, 4096, 4096, 128, BF16)
    check_plan("test", good)
    check_plan("test", dataclasses.replace(good, splits=64))
    # 65 splits of 64 steps, or 40 of 2 steps each: some split is empty
    with pytest.raises(ValueError):
        check_plan("test", dataclasses.replace(good, **change))


def test_check_plan_refuses_a_split_f32_plan():
    good = qkv_plan(128, 4096, 4096, 4096, 128, F32)
    check_plan("test", good)
    with pytest.raises(ValueError):
        check_plan("test", dataclasses.replace(good, splits=2))


def _qkv_call(t=4, h=256, nq=256, nk=128, hd=128, dtype=BF16):
    z = lambda *s: torch.zeros(s, dtype=dtype)
    return (z(t, h), z(h), z(h, nq), z(h, nk), z(h, nk), z(t, hd),
            z(t, hd), hd)


@pytest.fixture
def as_if_on_card(monkeypatch):
    """The QKV wrapper takes its CPU tensors for card tensors and trips on
    any launch."""
    def tripwire(*args):
        raise AssertionError("launched")
    monkeypatch.setattr(TFQ, "on_cuda", lambda op, *ts, kernel=None: True)
    monkeypatch.setattr(TFQ, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(TFQ, "stream_of", lambda x: 0)
    monkeypatch.setattr(TFQ.KERNEL, "launch", tripwire)
    return monkeypatch


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_wrapper_raises_on_an_unsupported_plan_before_launch(dtype,
                                                             as_if_on_card):
    args = _qkv_call(dtype=dtype)
    good = qkv_plan(4, 256, 256, 128, 128, dtype)
    as_if_on_card.setattr(
        TFQ, "qkv_plan", lambda *a, **k: dataclasses.replace(good, splits=0))
    launches = TFQ.KERNEL.launches
    with pytest.raises(ValueError, match="cannot run the plan"):
        TFQ.fused_rms_rope_qkv(*args)
    assert TFQ.KERNEL.launches == launches
    # with its own plan the wrapper reaches the launch
    as_if_on_card.setattr(TFQ, "qkv_plan", qkv_plan)
    with pytest.raises(AssertionError, match="launched"):
        TFQ.fused_rms_rope_qkv(*args)


@pytest.mark.parametrize("kw,err", [
    (dict(h=240), ValueError), (dict(hd=96, nq=192, nk=96), ValueError),
    (dict(nq=200), ValueError), (dict(dtype=torch.float16), TypeError)],
    ids=["h", "hd96", "nq", "f16"])
def test_wrapper_gate_raises_before_launch(kw, err, as_if_on_card):
    with pytest.raises(err):
        TFQ.fused_rms_rope_qkv(*_qkv_call(**kw))


# -- the split kernel's order of operations against the JAX reference -------

def _rope_heads(y, cos, sin, hd):
    """Rotate-half RoPE in f32 on y (T, N) of rounded values, head by
    head, as the GEMM's epilogue and the split sum compute it."""
    t, n = y.shape
    yh = y.reshape(t, n // hd, hd)
    lo, hi = yh[..., :hd // 2], yh[..., hd // 2:]
    c, s = cos.float()[:, None, :], sin.float()[:, None, :]
    out_lo = lo * c[..., :hd // 2] + (-hi) * s[..., :hd // 2]
    out_hi = hi * c[..., hd // 2:] + lo * s[..., hd // 2:]
    return torch.cat([out_lo, out_hi], -1).reshape(t, n)


def split_emulation(x, g, wq, wk, wv, cos, sin, hd, eps, plan):
    """The bf16 kernel's arithmetic: nx rounded once; each split's f32
    product over its contraction steps; the partials added in split
    order; round, RoPE on q and k in f32, round."""
    dt = x.dtype
    xf = x.float()
    nx = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
          * g.float()).to(dt)
    w = torch.cat([wq, wk, wv], 1).float()
    per = plan.steps_per_split * plan.bk
    acc = torch.zeros((x.shape[0], w.shape[1]))
    for s in range(plan.splits):
        k0, k1 = s * per, min(plan.h, (s + 1) * per)
        acc = acc + nx[:, k0:k1].float() @ w[k0:k1]
    y = acc.to(dt).float()
    nq, nk = wq.shape[1], wk.shape[1]
    q = _rope_heads(y[:, :nq], cos, sin, hd).to(dt)
    k = _rope_heads(y[:, nq:nq + nk], cos, sin, hd).to(dt)
    return q, k, y[:, nq + nk:].to(dt)


@pytest.mark.parametrize("sms", [H100_SMS, 4], ids=["split", "one-split"])
@pytest.mark.parametrize("hd,nq,nk", [(128, 256, 128), (64, 192, 64)],
                         ids=["hd128", "hd64-gqa"])
def test_split_order_keeps_the_rounding_points(hd, nq, nk, sms):
    rng = np.random.default_rng(8)
    t, h = 24, 160                        # three 64-deep steps, the last 32
    x = rng.normal(size=(t, h)).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=(h,))).astype(np.float32)
    ws = [(0.05 * rng.normal(size=(h, n))).astype(np.float32)
          for n in (nq, nk, nk)]
    ang = rng.uniform(0, 50, size=(t, hd // 2)).astype(np.float32)
    ang = np.concatenate([ang, ang], axis=-1)
    arrs = [x, g, *ws, np.cos(ang), np.sin(ang)]
    plan = qkv_plan(t, h, nq, nk, hd, BF16, sms=sms)
    assert plan.k_steps == 3
    assert plan.splits == (3 if sms == H100_SMS else 1)
    got = split_emulation(*[torch.from_numpy(a).to(BF16) for a in arrs], hd,
                          1e-5, plan)
    want = JIF._fused_rms_rope_qkv_ref(
        *[jnp.asarray(a, jnp.bfloat16) for a in arrs], hd, 1e-5)
    plain = TFQ.plain(*[torch.from_numpy(a).to(BF16) for a in arrs], hd,
                      1e-5)
    for gt, w, p in zip(got, want, plain):
        assert gt.dtype == BF16
        np.testing.assert_allclose(gt.float().numpy(),
                                   np.asarray(jnp.asarray(w, jnp.float32)),
                                   rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(gt.float().numpy(), p.float().numpy(),
                                   rtol=1e-2, atol=1e-2)
