"""The int4 dequant GEMM's launch plan (paddle_tpu_torch.ops.cuda.int4_plan),
the wrapper's refusals and padding, the swapped-operand kernel's fragment
mapping, and its split order, on the CPU.

The plan is a pure function of the shapes, the dtype and the SM count:
the wgmma n (8, 64 or 128 rows of x), 128-column tiles of W, the
contraction split only where the tiles are fewer than the SMs, into as
many splits as one wave of two blocks per SM holds.  The
CUDA kernel runs only on the card (``chip_smoke.py`` holds it against its
plain version there); here the wrapper is driven as if its tensors lay
on a card, with the launch replaced by a tripwire that records its
arguments.

The fragment model repeats, in numpy, how ``csrc/dequant_swap.cuh`` turns
packed bytes into wgmma's register A operand: the tile's packed rows
handed to ``ldmatrix.x4.trans`` in the order (0, 4, 1, 5, 2, 6, 3, 7),
what the transposed load delivers to each lane, the column pairing
(fragment rows g and g + 8 are output columns 2g and 2g + 1), the nibble
widening by masks, a magic OR and one subtraction -- and shows that it
rebuilds ``unpack_int4(packed)ᵀ`` exactly for every byte value, and that
the epilogue's index map puts every product where ``x @ W`` has it.

The split emulation repeats the split kernel's arithmetic in torch: the
per-split f32 partial products summed in split order, the scale on the
f32 sum, one rounding.  It is held against the JAX Pallas kernel in
interpret mode at 2e-2 (an f32 sum taken in another order can move a
bf16 rounding by one unit, 2**-8 relative).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.nn import quant as JQ
from paddle_tpu.ops.pallas import int4_matmul as JI4
from paddle_tpu_torch.ops.cuda import int4_matmul as TI4
from paddle_tpu_torch.ops.cuda.int4_plan import (BLOCKS_PER_SM, BM16, BN16,
                                                 MAX_PARTIAL_BYTES,
                                                 check_plan, int4_plan)
from paddle_tpu_torch.ops.cuda.mlp_plan import H100_SMS

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32

# the quantized llama2-7b engine step and the smoke's edges: (M, K, N) ->
# (bm, bn, tiles, splits, partial bytes) for the 16-bit types
MAIN = {
    (128, 4096, 4096): (128, 128, 32, 8, 16_777_216),
    (128, 4096, 11008): (128, 128, 86, 3, 16_908_288),
    (128, 11008, 4096): (128, 128, 32, 8, 16_777_216),
    (8, 4096, 32000): (8, 128, 250, 1, 0),
    (1, 4096, 4096): (8, 128, 32, 8, 131_072),
    (8, 4096, 4096): (8, 128, 32, 8, 1_048_576),
    (257, 4096, 4096): (128, 128, 96, 2, 8_421_376),
    (1, 102, 200): (8, 128, 2, 2, 1_600),
    (257, 102, 200): (128, 128, 6, 2, 411_200),
}
# the f32 SIMT body's rule (the int8 plan's): 8 blocks per SM, at most 16
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
    assert p.partial_bytes <= MAX_PARTIAL_BYTES or p.dtype == F32


@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "f16"])
@pytest.mark.parametrize("shape", list(MAIN),
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_at_the_main_and_edge_shapes(shape, dtype):
    p = int4_plan(*shape, dtype)
    _invariants(p)
    assert (p.bm, p.bn, p.tiles, p.splits, p.partial_bytes) == MAIN[shape]
    assert p.bm in BM16 and p.bn == BN16 and p.bk == 64
    # n: the smallest instantiation that holds the rows, 128 past that
    assert p.bm == min(b for b in BM16 if b >= min(shape[0], 128))
    if p.splits > 1:   # one wave of the blocks the SMs hold, filled but
        # for the steps, the partials or a split that would be empty
        assert p.tiles < H100_SMS
        assert p.blocks <= BLOCKS_PER_SM * H100_SMS
        assert (p.tiles * (p.splits + 1) > BLOCKS_PER_SM * H100_SMS
                or p.splits == p.k_steps
                or 4 * p.m * p.n * (p.splits + 1) > MAX_PARTIAL_BYTES
                or -(-p.k_steps // (p.splits + 1)) * p.splits >= p.k_steps)


@pytest.mark.parametrize("shape", list(MAIN_F32),
                         ids=lambda s: "x".join(map(str, s)))
def test_f32_plan_keeps_the_simt_rule(shape):
    p = int4_plan(*shape, F32)
    _invariants(p)
    assert (p.bm, p.bn, p.splits) == (64, 64, MAIN_F32[shape])


def test_plan_is_cached_and_follows_the_sm_count():
    assert int4_plan(128, 4096, 4096, BF16) is int4_plan(128, 4096, 4096,
                                                         BF16)
    few = int4_plan(128, 4096, 4096, BF16, sms=16)
    assert (few.tiles, few.splits) == (32, 1)   # 32 tiles fill 16 SMs
    many = int4_plan(8, 4096, 32000, BF16, sms=512)
    assert (many.tiles, many.splits) == (250, 4)   # floor(1024 / 250)


@pytest.mark.parametrize("args,err", [
    ((4, 64, 8, torch.int8), TypeError), ((0, 64, 8, BF16), ValueError),
    ((4, 65, 8, BF16), ValueError), ((4, 64, 0, BF16), ValueError)],
    ids=["int8-x", "m0", "odd-k", "n0"])
def test_plan_refuses_what_no_kernel_takes(args, err):
    with pytest.raises(err):
        int4_plan(*args)


@pytest.mark.parametrize("change", [dict(bm=32), dict(bn=64), dict(splits=0),
                                    dict(splits=40), dict(k=63)],
                         ids=["bm", "bn", "splits0", "empty-split", "odd-k"])
def test_check_plan_refuses_a_plan_the_kernel_cannot_run(change):
    good = int4_plan(128, 4096, 4096, BF16)
    with pytest.raises(ValueError, match="cannot run the plan"):
        check_plan("test", dataclasses.replace(good, **change))
    with pytest.raises(ValueError):
        check_plan("test", dataclasses.replace(int4_plan(8, 128, 64, F32),
                                               bm=8))


@pytest.fixture
def as_if_on_card(monkeypatch):
    """The int4 wrapper takes its CPU tensors for card tensors; the launch
    records its arguments instead of running."""
    calls = []

    def record(*args):
        calls.append(args)
    monkeypatch.setattr(TI4, "on_cuda", lambda op, *ts, kernel=None: True)
    monkeypatch.setattr(TI4, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(TI4, "stream_of", lambda x: 0)
    monkeypatch.setattr(TI4.KERNEL, "launch", record)
    return monkeypatch, calls


def _int4_call(m=4, k=256, n=128, dtype=BF16):
    return (torch.zeros((m, k), dtype=dtype),
            torch.zeros((k // 2, n), dtype=torch.int8), torch.ones(n))


@pytest.mark.parametrize("dtype", [BF16, F16, F32],
                         ids=["bf16", "f16", "f32"])
def test_wrapper_raises_on_an_unsupported_plan_before_launch(dtype,
                                                             as_if_on_card):
    mp, calls = as_if_on_card
    TI4._checked_plan.cache_clear()
    args = _int4_call(dtype=dtype)
    good = int4_plan(4, 256, 128, dtype)
    mp.setattr(TI4, "int4_plan",
               lambda *a, **k: dataclasses.replace(good, splits=0))
    with pytest.raises(ValueError, match="cannot run the plan"):
        TI4.int4_matmul(*args)
    assert not calls
    mp.setattr(TI4, "int4_plan", int4_plan)
    TI4.int4_matmul(*args)
    # (x, w, scale, out, partial, m, k, n, ldx, dtype, bm, bn, splits, s)
    assert calls[-1][5:13] == (4, 256, 128, 256, {F32: 0, BF16: 1, F16: 2}[
        dtype], good.bm, good.bn, good.splits)
    assert (calls[-1][4] is None) == (good.splits == 1)


@pytest.mark.parametrize("k,offset,ldx", [(102, 0, 104), (256, 1, 256),
                                          (96, 0, 96)],
                         ids=["k-tail", "unaligned", "aligned"])
def test_wrapper_pads_a_16_bit_x_the_copies_cannot_take(k, offset, ldx,
                                                        as_if_on_card):
    """K % 8 != 0 or an x not 16-byte aligned: the kernel gets a copy with
    an aligned row stride of ceil(K / 8) * 8 and zeros past K; f32 x goes
    as it is."""
    mp, calls = as_if_on_card
    flat = torch.arange(3 * k + offset, dtype=torch.float32).to(BF16)
    x = flat[offset:].view(3, k)
    w, s = torch.zeros((k // 2, 40), dtype=torch.int8), torch.ones(40)
    TI4.int4_matmul(x, w, s)
    assert calls[-1][8] == ldx
    TI4.int4_matmul(x.float(), w, s)
    assert calls[-1][8] == k


# -- the swapped-operand fragment mapping, in numpy ---------------------------

_ORDER = (0, 4, 1, 5, 2, 6, 3, 7)   # the packed rows ldmatrix is handed
# (OR magic, subtrahend, float type): the nibble + 8 in the low mantissa
# bits of 128.0 (bf16) or 1024.0 (f16), less 136 or 1032
_MAGIC = {"bfloat16": (0x4300, 136.0), "float16": (0x6400, 1032.0)}


def _halves_to_float(bits16, dtype):
    """16-bit patterns -> their values in f32 (exact)."""
    bits16 = bits16.astype(np.uint32)
    if dtype == "bfloat16":
        return (bits16 << 16).view(np.float32)
    return bits16.astype(np.uint16).view(np.float16).astype(np.float32)


def _widen(bytes_, dtype):
    """A register built from one packed byte: (low half, high half) as
    floats -- the masks, the magic OR and one packed subtraction."""
    magic, sub = _MAGIC[dtype]
    u = bytes_.astype(np.uint32) ^ 0x88
    reg = (u & 0xF) | ((u << 12) & 0xF0000) | (magic << 16 | magic)
    lo = _halves_to_float(reg & 0xFFFF, dtype) - np.float32(sub)
    hi = _halves_to_float(reg >> 16, dtype) - np.float32(sub)
    return lo, hi


def _fragment_a(tile, dtype):
    """One warp's A operand for one 64-deep step, as the kernel assembles
    it: tile (32 packed rows, 16 output columns) uint8 -> A (4 k16 steps,
    16 fragment rows, 16 contraction columns) float32."""
    a = np.zeros((4, 16, 16), np.float32)
    for i in range(4):                      # matrix i: k16 step i
        rows = tile[8 * i + np.array(_ORDER)]          # (8, 16) bytes
        pairs = rows.reshape(8, 8, 2)       # b16 element (q, gc): 2 bytes
        for lane in range(32):
            g, c = lane // 4, lane % 4
            # .trans: elements (2c, g) and (2c + 1, g), low half first
            reg = [pairs[2 * c, g, 0], pairs[2 * c, g, 1],
                   pairs[2 * c + 1, g, 0], pairs[2 * c + 1, g, 1]]
            for p, (r, col) in enumerate(((g, 2 * c), (g + 8, 2 * c),
                                          (g, 2 * c + 8), (g + 8, 2 * c + 8))):
                lo, hi = _widen(np.array([reg[p]]), dtype)
                a[i, r, col], a[i, r, col + 1] = lo[0], hi[0]
    return a.transpose(1, 0, 2).reshape(16, 64)


def _unpair(rows16):
    """Fragment rows g, g + 8 -> output columns 2g, 2g + 1."""
    out = np.empty_like(rows16)
    out[0::2], out[1::2] = rows16[:8], rows16[8:]
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_fragment_mapping_rebuilds_every_byte_exactly(dtype):
    every = np.arange(256, dtype=np.uint8)
    rng = np.random.default_rng(3)
    for rep in range(2):    # 512 bytes a tile: every value twice a rep
        tile = rng.permutation(np.concatenate([every, every])).reshape(32, 16)
        want = TI4.unpack_int4(torch.from_numpy(tile.view(np.int8))).numpy()
        got = _unpair(_fragment_a(tile, dtype))
        np.testing.assert_array_equal(got, want.T.astype(np.float32))
    # the widening alone, through all 256 bytes
    lo, hi = _widen(every, dtype)
    nib = TI4.unpack_int4(torch.from_numpy(every.view(np.int8))[None])
    np.testing.assert_array_equal(lo, nib[0].numpy())
    np.testing.assert_array_equal(hi, nib[1].numpy())


def test_epilogue_index_map_puts_each_product_in_place():
    """The accumulator of outᵀ = A . xᵀ (A in fragment row order) holds,
    at thread (w, g, c), entry [16w + g + 8i][8j + 2c + e]; the epilogue
    writes it to out[8j + 2c + e][16w + 2g + i].  That must be x @ W."""
    rng = np.random.default_rng(4)
    nm = 8                                   # the LM head's n
    tile = rng.integers(0, 256, size=(32, 64), dtype=np.uint8)
    x = rng.integers(-3, 4, size=(nm, 64)).astype(np.float32)
    w = TI4.unpack_int4(torch.from_numpy(tile.view(np.int8))).numpy()
    a = np.concatenate([_fragment_a(tile[:, 16 * wp:16 * wp + 16],
                                    "bfloat16") for wp in range(4)])
    acc = a @ x.T                            # (64 fragment rows, nm)
    out = np.full((nm, 64), np.nan, np.float32)
    for wp in range(4):
        for lane in range(32):
            g, c = lane // 4, lane % 4
            for j in range(nm // 8):
                for i in range(2):
                    for e in range(2):
                        out[8 * j + 2 * c + e, 16 * wp + 2 * g + i] = \
                            acc[16 * wp + g + 8 * i, 8 * j + 2 * c + e]
    np.testing.assert_array_equal(out, x @ w.astype(np.float32))


# -- the split kernel's order of operations against the JAX kernel -----------

def split_emulation(x, packed, s, plan):
    """The 16-bit kernel's arithmetic: each split's f32 product over its
    contraction steps, the partials added in split order, the scale on the
    f32 sum, one rounding."""
    w = TI4.unpack_int4(packed).float()
    per = plan.steps_per_split * plan.bk
    acc = torch.zeros((x.shape[0], w.shape[1]))
    for i in range(plan.splits):
        k0, k1 = i * per, min(plan.k, (i + 1) * per)
        acc = acc + x[:, k0:k1].float() @ w[k0:k1]
    return (acc * s.float()).to(x.dtype)


@pytest.mark.parametrize("sms", [H100_SMS, 2], ids=["split", "one-split"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_split_order_keeps_the_single_rounding(dtype, sms):
    rng = np.random.default_rng(10)
    m, k, n = 5, 200, 256             # four 64-deep steps, the last 8
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    q, s = JQ.weight_quantize(jnp.asarray(w), algo="weight_only_int4")
    x = rng.standard_normal((m, k)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    plan = int4_plan(m, k, n, tdt, sms=sms)
    assert plan.k_steps == 4 and plan.splits == (4 if sms == H100_SMS else 1)
    tx = torch.from_numpy(x).to(tdt)
    tq = torch.from_numpy(np.array(q))
    ts = torch.from_numpy(np.array(s))
    got = split_emulation(tx, tq, ts, plan)
    want = JI4.int4_matmul.__wrapped__(
        jnp.asarray(x, jdt), q, s, block_k2=64, block_n=128, interpret=True)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               TI4.plain(tx, tq, ts).float().numpy(),
                               rtol=2e-2, atol=2e-2)
