"""The weight-only int8 matmul's launch plan
(paddle_tpu_torch.ops.cuda.int8_plan), the wrapper's refusals, and the
split kernel's order of operations, on the CPU.

The plan is a pure function of the shapes, the dtype and the SM count:
128 x 128 tiles for bf16 and f16 with the contraction split only where
the tiles are too few to fill the card (the MLP plan's rule), 64 x 64
tiles for f32 with the SIMT body's own rule.  The CUDA kernel runs only
on the card (``chip_smoke.py`` holds it against its plain version
there); here the wrapper is driven as if its tensors lay on a card, with
the launch replaced by a tripwire, to show that a bad dtype or plan
raises before any launch.

The split emulation repeats the split kernel's arithmetic in torch: the
per-split f32 partial products summed in split order, then the scale,
then one rounding.  Held against the JAX Pallas kernel in interpret mode
(as ``tests/test_torch_quant.py`` calls it) in bf16 and f16 at
rtol/atol 2e-2 (an f32 sum taken in another order can move the output's
rounding by one unit), it shows that moving the scale into the split sum
keeps the contract's single rounding.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.nn import quant as JQ
from paddle_tpu.ops.pallas import int8_matmul as JI8
from paddle_tpu_torch.ops.cuda import int8_matmul as TI8
from paddle_tpu_torch.ops.cuda.int8_plan import check_plan, int8_plan
from paddle_tpu_torch.ops.cuda.mlp_plan import H100_SMS, MAX_PARTIAL_BYTES

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32

# the quantized llama2-7b engine step: (M, K, N) -> (tiles, splits,
# partial bytes) for the 16-bit types
MAIN = {
    (128, 4096, 4096): (32, 5, 10_485_760),
    (128, 4096, 11008): (86, 2, 11_272_192),
    (128, 11008, 4096): (32, 5, 10_485_760),
    (8, 4096, 32000): (250, 1, 0),
}
# the f32 SIMT body's own rule: 8 blocks per SM, at most 16 splits
MAIN_F32 = {(128, 4096, 4096): 8, (128, 4096, 11008): 4,
            (128, 11008, 4096): 9, (8, 4096, 32000): 3}


def _invariants(p):
    check_plan("test", p)
    assert 1 <= p.splits <= max(1, p.k_steps)
    if p.k_steps:
        assert (p.splits - 1) * p.steps_per_split < p.k_steps
        assert p.splits * p.steps_per_split >= p.k_steps
    assert p.partial_bytes == (0 if p.splits == 1
                               else 4 * p.splits * p.m * p.n)


@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "f16"])
@pytest.mark.parametrize("shape", list(MAIN),
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_at_the_main_shapes(shape, dtype):
    p = int8_plan(*shape, dtype)
    _invariants(p)
    assert (p.tiles, p.splits, p.partial_bytes) == MAIN[shape]
    assert (p.bm, p.bn, p.bk) == (128, 128, 64)
    assert p.partial_bytes <= MAX_PARTIAL_BYTES
    if p.splits > 1:
        assert p.tiles < H100_SMS <= p.blocks


@pytest.mark.parametrize("shape", list(MAIN_F32),
                         ids=lambda s: "x".join(map(str, s)))
def test_f32_plan_keeps_the_simt_rule(shape):
    p = int8_plan(*shape, F32)
    _invariants(p)
    assert (p.bm, p.bn, p.bk) == (64, 64, 64)
    assert p.splits == MAIN_F32[shape]


@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "f16"])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096),
                                 (4096, 32000), (8192, 28672)])
def test_partials_stay_small_at_serving_row_counts(k, n, dtype):
    for m in range(1, 258, 8):
        p = int8_plan(m, k, n, dtype)
        _invariants(p)
        assert p.partial_bytes <= MAX_PARTIAL_BYTES, (m, p)
        if p.splits > 1:
            assert p.tiles < H100_SMS <= p.blocks, (m, p)


def test_no_split_at_the_lm_head_or_a_prefill():
    assert int8_plan(8, 4096, 32000, BF16).splits == 1
    assert int8_plan(4096, 4096, 4096, BF16).splits == 1


def test_plan_follows_the_sm_count():
    assert int8_plan(128, 4096, 4096, BF16, sms=132).splits == 5
    assert int8_plan(128, 4096, 4096, BF16, sms=64).splits == 2
    assert int8_plan(128, 4096, 4096, BF16, sms=32).splits == 1
    assert int8_plan(128, 4096, 11008, BF16, sms=86).splits == 1
    assert int8_plan(128, 4096, 4096, F32, sms=66).splits == 5


def test_edge_shapes():
    """K and N off the tiles, K = 0 and the identity product of the codes
    check."""
    p = int8_plan(257, 100, 200, BF16)
    assert (p.tiles, p.k_steps, p.splits) == (6, 2, 2)
    p = int8_plan(257, 4160, 272, F16)
    assert (p.tiles, p.k_steps) == (9, 65) and p.splits == 13
    p = int8_plan(16, 16, 16, BF16)
    assert (p.tiles, p.k_steps, p.splits) == (1, 1, 1)
    p = int8_plan(4, 0, 16, BF16)
    assert (p.k_steps, p.splits, p.partial_bytes) == (0, 1, 0)
    for p in (int8_plan(257, 100, 200, BF16), int8_plan(257, 4160, 272, F16),
              int8_plan(4, 0, 16, F32)):
        _invariants(p)


@pytest.mark.parametrize("args,err", [
    ((0, 4096, 4096, BF16), ValueError), ((128, 4096, 0, BF16), ValueError),
    ((128, -1, 4096, BF16), ValueError),
    ((128, 4096, 4096, torch.float64), TypeError),
    ((128, 4096, 4096, torch.int8), TypeError)],
    ids=["m0", "n0", "k-1", "f64", "int8"])
def test_plan_refuses_what_no_kernel_takes(args, err):
    with pytest.raises(err):
        int8_plan(*args)


@pytest.mark.parametrize("change", [
    dict(splits=0), dict(splits=65), dict(splits=40), dict(bm=64),
    dict(bn=64), dict(m=0), dict(dtype=torch.float64)],
    ids=["splits0", "splits-past-k", "empty-split", "bm64", "bn64", "m0",
         "f64"])
def test_check_plan_refuses_a_plan_the_kernel_cannot_run(change):
    good = int8_plan(128, 4096, 4096, BF16)
    check_plan("test", good)
    check_plan("test", dataclasses.replace(good, splits=64))
    with pytest.raises(ValueError):
        check_plan("test", dataclasses.replace(good, **change))


def test_check_plan_refuses_a_split_without_contraction():
    good = int8_plan(4, 0, 16, BF16)
    check_plan("test", good)
    with pytest.raises(ValueError):
        check_plan("test", dataclasses.replace(good, splits=2))


@pytest.fixture
def as_if_on_card(monkeypatch):
    """The int8 wrapper takes its CPU tensors for card tensors and trips
    on any launch."""
    def tripwire(*args):
        raise AssertionError("launched")
    monkeypatch.setattr(TI8, "on_cuda", lambda op, *ts, kernel=None: True)
    monkeypatch.setattr(TI8, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(TI8, "stream_of", lambda x: 0)
    monkeypatch.setattr(TI8.KERNEL, "launch", tripwire)
    return monkeypatch


def _int8_call(m=4, k=256, n=128, dtype=BF16):
    return (torch.zeros((m, k), dtype=dtype),
            torch.zeros((k, n), dtype=torch.int8), torch.ones(n))


@pytest.mark.parametrize("dtype", [BF16, F16, F32],
                         ids=["bf16", "f16", "f32"])
def test_wrapper_raises_on_an_unsupported_plan_before_launch(dtype,
                                                             as_if_on_card):
    args = _int8_call(dtype=dtype)
    good = int8_plan(4, 256, 128, dtype)
    as_if_on_card.setattr(
        TI8, "int8_plan", lambda *a, **k: dataclasses.replace(good, splits=0))
    launches = TI8.KERNEL.launches
    with pytest.raises(ValueError, match="cannot run the plan"):
        TI8.int8_matmul(*args)
    assert TI8.KERNEL.launches == launches
    as_if_on_card.setattr(TI8, "int8_plan", int8_plan)
    with pytest.raises(AssertionError, match="launched"):
        TI8.int8_matmul(*args)


@pytest.mark.parametrize("case", ["f64", "scale-bf16", "w-uint8",
                                  "noncontiguous"])
def test_wrapper_gate_raises_before_launch(case, as_if_on_card):
    x, w, s = _int8_call()
    if case == "f64":
        x = x.double()
    elif case == "scale-bf16":
        s = s.to(BF16)
    elif case == "w-uint8":
        w = w.to(torch.uint8)
    else:
        x = torch.zeros((256, 4), dtype=BF16).t()
    with pytest.raises(ValueError):
        TI8.int8_matmul(x, w, s)


# -- the split kernel's order of operations against the JAX kernel -----------

def split_emulation(x, q, s, plan):
    """The 16-bit kernel's arithmetic: each split's f32 product over its
    contraction steps, the partials added in split order, the scale on the
    f32 sum, one rounding."""
    per = plan.steps_per_split * plan.bk
    acc = torch.zeros((x.shape[0], q.shape[1]))
    for i in range(plan.splits):
        k0, k1 = i * per, min(plan.k, (i + 1) * per)
        acc = acc + x[:, k0:k1].float() @ q[k0:k1].float()
    return (acc * s.float()).to(x.dtype)


@pytest.mark.parametrize("sms", [H100_SMS, 2], ids=["split", "one-split"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_split_order_keeps_the_single_rounding(dtype, sms):
    rng = np.random.default_rng(9)
    m, k, n = 5, 200, 256             # four 64-deep steps, the last 8
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    q, s = JQ.weight_quantize(jnp.asarray(w), algo="weight_only_int8")
    x = rng.standard_normal((m, k)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    plan = int8_plan(m, k, n, tdt, sms=sms)
    assert plan.k_steps == 4 and plan.splits == (4 if sms == H100_SMS else 1)
    tx = torch.from_numpy(x).to(tdt)
    tq = torch.from_numpy(np.array(q))
    ts = torch.from_numpy(np.array(s))
    got = split_emulation(tx, tq, ts, plan)
    want = JI8.int8_matmul.__wrapped__(
        jnp.asarray(x, jdt), q, s, block_k=128, block_n=128, interpret=True)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               TI8.plain(tx, tq, ts).float().numpy(),
                               rtol=2e-2, atol=2e-2)
