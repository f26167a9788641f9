"""The fused MLP kernels' launch plan (paddle_tpu_torch.ops.cuda.mlp_plan)
and the wrappers' refusals, on the CPU.

The plan is a pure function of the shapes, the dtype and the SM count:
tiles, the down projection's split-K count and the scratch bytes (h in
x's dtype, f32 partials only where the contraction is split).  The CUDA
kernels themselves run only on the card (``chip_smoke.py`` holds them
against their plain versions there); here the wrappers are driven as if
their tensors lay on a card, with the launch replaced by a tripwire, to
show that a bad shape, dtype or plan raises before any launch.
"""

import dataclasses

import pytest
import torch

from paddle_tpu_torch.ops.cuda import fused_gelu_mlp as TFG
from paddle_tpu_torch.ops.cuda import fused_mlp as TFM
from paddle_tpu_torch.ops.cuda.mlp_plan import (H100_SMS, MAX_PARTIAL_BYTES,
                                                check_plan, mlp_plan)

BF16, F32 = torch.bfloat16, torch.float32

# (kind, T, H, I) -> {dtype: (up_bn, splits)}
MAIN = {
    ("swiglu", 128, 4096, 11008): {BF16: (64, 5), F32: (128, 3)},
    ("gelu", 1, 4096, 16384): {BF16: (64, 5), F32: (128, 5)},
    ("gelu", 8, 4096, 16384): {BF16: (64, 5), F32: (128, 5)},
    ("gelu", 257, 4096, 16384): {BF16: (128, 2), F32: (128, 1)},
    ("swiglu", 128, 8192, 28672): {BF16: (64, 3), F32: (128, 2)},
    ("swiglu", 4096, 4096, 11008): {BF16: (64, 1), F32: (128, 1)},
}
# the widths the port serves or trains: llama2-7b, llama2-70b, gpt3-6.7b,
# gpt3-13b
WIDTHS = [("swiglu", 4096, 11008), ("swiglu", 8192, 28672),
          ("gelu", 4096, 16384), ("gelu", 5120, 20480)]


def _invariants(p):
    check_plan("test", p)
    assert p.t * p.inter * (2 if p.dtype == BF16 else 4) == p.h_bytes
    assert p.partial_offset >= p.h_bytes and p.partial_offset % 256 == 0
    assert p.scratch_bytes == p.partial_offset + p.partial_bytes
    # every split has work, and the splits cover the contraction
    assert 1 <= p.splits <= p.k_steps
    assert (p.splits - 1) * p.steps_per_split < p.k_steps
    assert p.splits * p.steps_per_split >= p.k_steps


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(MAIN), ids=lambda s: "-".join(map(str, s)))
def test_plan_at_the_main_shapes(shape, dtype):
    kind, t, h, inter = shape
    p = mlp_plan(t, h, inter, dtype, kind)
    _invariants(p)
    assert (p.up_bn, p.splits) == MAIN[shape][dtype]
    assert p.bm == (128 if dtype == BF16 else 64) and p.down_bn == 128
    assert p.partial_bytes == (0 if p.splits == 1
                               else 4 * p.splits * t * h)
    if p.splits > 1:
        assert p.down_tiles < H100_SMS <= p.down_blocks
    else:
        assert p.partial_bytes == 0


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind,h,inter", WIDTHS)
def test_partials_stay_small_at_serving_token_counts(kind, h, inter, dtype):
    """At every T <= 257 the f32 partials stay within 16 MiB, and where
    the contraction is split the down blocks fill the 132 SMs."""
    for t in range(1, 258):
        p = mlp_plan(t, h, inter, dtype, kind)
        _invariants(p)
        assert p.partial_bytes <= MAX_PARTIAL_BYTES == 16 << 20, (t, p)
        if p.splits > 1:
            assert p.down_blocks >= H100_SMS, (t, p)
            assert p.down_tiles < H100_SMS, (t, p)
        else:
            assert p.partial_bytes == 0


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_no_partials_at_the_training_token_count(kind, dtype):
    p = mlp_plan(4096, 4096, 11008, dtype, kind)
    assert p.splits == 1 and p.partial_bytes == 0
    assert p.down_blocks >= H100_SMS and p.up_blocks >= H100_SMS


def test_plan_follows_the_sm_count():
    """The split count fills the card the plan is given."""
    assert mlp_plan(128, 4096, 11008, BF16, "swiglu", sms=132).splits == 5
    assert mlp_plan(128, 4096, 11008, BF16, "swiglu", sms=64).splits == 2
    assert mlp_plan(128, 4096, 11008, BF16, "swiglu", sms=32).splits == 1
    # gelu's up band: 128 wide unless that leaves SMs idle
    assert mlp_plan(128, 4096, 16384, BF16, "gelu", sms=128).up_bn == 128
    assert mlp_plan(128, 4096, 16384, BF16, "gelu", sms=129).up_bn == 64


@pytest.mark.parametrize("args,err", [
    ((128, 4000, 11008, BF16), ValueError),
    ((128, 4096, 11000, BF16), ValueError),
    ((0, 4096, 11008, BF16), ValueError),
    ((128, 4096, 11008, torch.float16), TypeError),
    ((128, 4096, 11008, torch.float64), TypeError),
], ids=["h", "inter", "t0", "f16", "f64"])
def test_plan_refuses_what_no_kernel_takes(args, err):
    with pytest.raises(err):
        mlp_plan(*args)


@pytest.mark.parametrize("change", [
    dict(splits=0), dict(splits=173), dict(splits=100), dict(up_bn=32),
    dict(up_bn=128), dict(bm=64), dict(down_bn=64), dict(h=4000),
    dict(dtype=torch.float16)],
    ids=["splits0", "splits-past-k", "empty-split", "up32", "up128",
         "bm64", "down64", "h", "f16"])
def test_check_plan_refuses_a_plan_the_kernel_cannot_run(change):
    good = mlp_plan(128, 4096, 11008, BF16, "swiglu")
    check_plan("test", good)
    check_plan("test", dataclasses.replace(good, splits=172))
    # 173 splits of 172 steps, or 100 of 2 steps each: some split is empty
    bad = dataclasses.replace(good, **change)
    with pytest.raises(ValueError):
        check_plan("test", bad)


def _mlp_call(kind, h=256, inter=512, t=4, dtype=BF16):
    z = lambda *s: torch.zeros(s, dtype=dtype)
    if kind == "swiglu":
        return TFM, TFM.fused_swiglu_mlp, (z(t, h), z(h, inter), z(h, inter),
                                           z(inter, h))
    return TFG, TFG.fused_gelu_mlp, (z(t, h), z(h, inter), z(inter),
                                     z(inter, h), z(h))


@pytest.fixture
def as_if_on_card(monkeypatch):
    """The MLP wrappers take their CPU tensors for card tensors and trip
    on any launch."""
    def tripwire(*args):
        raise AssertionError("launched")
    for mod in (TFM, TFG):
        monkeypatch.setattr(mod, "on_cuda", lambda op, *ts, kernel=None: True)
        monkeypatch.setattr(mod, "sm_count", lambda dev: H100_SMS)
        monkeypatch.setattr(mod, "stream_of", lambda x: 0)
        monkeypatch.setattr(mod.KERNEL, "launch", tripwire)
    return monkeypatch


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_wrapper_raises_on_an_unsupported_plan_before_launch(kind,
                                                             as_if_on_card):
    mod, fn, args = _mlp_call(kind)
    t, h = args[0].shape
    inter = args[1].shape[1]
    good = mlp_plan(t, h, inter, BF16, kind)
    as_if_on_card.setattr(
        mod, "mlp_plan",
        lambda *a, **k: dataclasses.replace(good, splits=0))
    launches = mod.KERNEL.launches
    with pytest.raises(ValueError, match="cannot run the plan"):
        fn(*args)
    assert mod.KERNEL.launches == launches
    # with its own plan the wrapper reaches the launch
    as_if_on_card.setattr(mod, "mlp_plan", mlp_plan)
    with pytest.raises(AssertionError, match="launched"):
        fn(*args)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("h,inter,dtype,err", [
    (192, 512, BF16, ValueError), (256, 320, BF16, ValueError),
    (256, 512, torch.float16, TypeError)], ids=["h", "inter", "f16"])
def test_wrapper_gate_raises_before_launch(kind, h, inter, dtype, err,
                                           as_if_on_card):
    _, fn, args = _mlp_call(kind, h=h, inter=inter, dtype=dtype)
    with pytest.raises(err):
        fn(*args)
