"""The paged decode-attention kernel's plan
(paddle_tpu_torch.ops.cuda.paged_plan), the wrapper's use of it, and the
order in which the kernel merges its spans, on the CPU.

The plan is a pure function of the shapes, the dtype and the SM count:
bf16 and f16 run one block per (slot, kv head, 16-row tile of the GQA
group, span of 64-position stages), f32 the SIMT kernel with 8-row tiles
and 32-position stages, the number of spans chosen to give four blocks
per SM if every table were full.  The CUDA kernel runs only on the card
(``chip_smoke.py`` holds it against its plain version there); here the
wrapper is driven as if its tensors lay on a card, with the launch
replaced by a recorder.

The span emulation repeats the kernel's merge in torch: each span's
online softmax over its positions in the log2 domain (masked scores weigh
exactly 0), then the spans merged in span order (m = max, w = 2^(m_s -
m), l = sum w l_s, acc = sum w acc_s).  It is held against the plain
version at f32 atol = rtol = 1e-4 (the same arithmetic in another order),
and an empty span's state (-1e30, 0, 0) must drop out of the merge bit
for bit.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import paged_attention as TPA
from paddle_tpu_torch.ops.cuda.mlp_plan import H100_SMS
from paddle_tpu_torch.ops.cuda.paged_plan import (BLOCKS_PER_SM, HEAD_DIMS,
                                                  MAX_PARTIAL_BYTES,
                                                  SMEM_LIMIT, check_plan,
                                                  paged_plan)

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
NEG = -1e30

# (B, H, H_kv, D, page, MB, dtype) -> (path, tiles, splits, per, grid
# blocks, scratch bytes) on 132 SMs; MB 33 holds lengths up to 512.  A
# block of head dim 128 takes ~74 KB of shared memory: 3 per SM, 396 on
# the card
MAIN = {
    (8, 32, 32, 128, 16, 33, BF16):                 # gpt3-6.7b decode
        ("tensor_cores", 1, 1, 9, 256, 0),
    (8, 64, 8, 128, 16, 33, BF16):                  # llama2-70b GQA
        ("tensor_cores", 1, 5, 2, 320, 1_331_456),
    (6, 16, 16, 64, 16, 33, BF16):                  # edges d=64
        ("tensor_cores", 1, 5, 2, 480, 127_104),
    (8, 32, 32, 128, 16, 33, F16):
        ("tensor_cores", 1, 1, 9, 256, 0),
    (8, 32, 32, 128, 16, 33, F32):                  # 32-position stages
        ("simt", 1, 1, 17, 256, 0),
    (8, 64, 8, 128, 16, 33, F32):
        ("simt", 1, 6, 3, 384, 1_597_696),
    (8, 32, 32, 128, 16, 1, BF16):                  # one page: no spans
        ("tensor_cores", 1, 1, 1, 256, 0),
    (2, 96, 4, 64, 16, 33, BF16):                   # G 24: two tiles
        ("tensor_cores", 2, 9, 1, 144, 608_320),
}


@pytest.mark.parametrize("shape", sorted(MAIN, key=str))
def test_plan_at_the_main_geometries(shape):
    p = paged_plan(*shape, H100_SMS)
    check_plan("test", p)
    assert (p.path, p.tiles, p.splits, p.per, p.grid_blocks,
            p.scratch_bytes) == MAIN[shape]
    assert (p.splits - 1) * p.per < p.stages <= p.splits * p.per
    assert p.smem_bytes <= SMEM_LIMIT
    if p.splits > 1:
        # partials, then (m, l), then one counter per (slot, head, tile)
        assert p.ml_offset >= p.partial_rows * p.d * 4
        assert p.scratch_bytes == p.counter_offset + 4 * p.b * p.h_kv \
            * p.tiles


@pytest.mark.parametrize("h_kv,g", [(32, 1), (8, 8)])
def test_grid_fills_the_card_at_full_tables(h_kv, g):
    """Batches 1-64 at contexts of 2048 and 4096: the grid holds at least
    one block per SM and no more than the card holds at once (one span
    per block where the base grid alone is larger), and more than half of
    what it holds where spans could fill it."""
    for ctx in (2048, 4096):
        for b in range(1, 65):
            p = paged_plan(b, h_kv * g, h_kv, 128, 16, ctx // 16, BF16,
                           H100_SMS)
            base = b * h_kv * p.tiles
            wave = p.resident_per_sm * H100_SMS
            assert p.resident_per_sm == 3 <= BLOCKS_PER_SM
            assert p.grid_blocks >= H100_SMS, (b, ctx, p)
            if base < wave:
                assert wave / 2 < p.grid_blocks <= wave, (b, ctx, p)
            else:
                assert p.splits == 1


def test_no_span_is_empty_over_many_shapes():
    rng = np.random.default_rng(0)
    for _ in range(300):
        b, h_kv = (int(v) for v in rng.integers(1, 33, size=2))
        g = int(rng.choice([1, 2, 4, 8, 16, 24]))
        page = int(rng.choice([8, 16, 32, 64, 128]))
        mb = int(rng.integers(1, 129))
        dt = [BF16, F16, F32][int(rng.integers(3))]
        p = paged_plan(b, h_kv * g, h_kv, 128, page, mb, dt, H100_SMS)
        check_plan("test", p)
        assert (p.splits - 1) * p.per < p.stages <= p.splits * p.per
        assert 1 <= p.splits <= p.stages
        assert p.scratch_bytes <= MAX_PARTIAL_BYTES + p.ml_offset + (1 << 20)


@pytest.mark.parametrize("dtype", [BF16, F16, F32])
@pytest.mark.parametrize("page", [16, 64])
def test_shared_memory_within_the_limit(dtype, page):
    for d in HEAD_DIMS:
        for mb in (1, 33, 256):
            p = paged_plan(8, 32, 8, d, page, mb, dtype, H100_SMS)
            assert p.smem_bytes <= SMEM_LIMIT, p
            # every page a span touches has a table slot
            assert p.table_slots * page >= p.per * p.stage + page


def test_plan_is_cached():
    paged_plan.cache_clear()
    a = paged_plan(8, 32, 32, 128, 16, 33, BF16, H100_SMS)
    b = paged_plan(8, 32, 32, 128, 16, 33, BF16, H100_SMS)
    assert a is b and paged_plan.cache_info().hits == 1


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(TypeError, match="float64"):
        paged_plan(8, 32, 32, 128, 16, 33, torch.float64)
    with pytest.raises(TypeError, match="int32"):
        paged_plan(8, 32, 32, 128, 16, 33, torch.int32)
    for d in (16, 80, 256):
        with pytest.raises(ValueError, match="head_dim"):
            paged_plan(8, 32, 32, d, 16, 33, F16)
    with pytest.raises(ValueError, match="kv heads"):
        paged_plan(8, 30, 8, 128, 16, 33, BF16)
    with pytest.raises(ValueError, match="mb 0"):
        paged_plan(8, 32, 32, 128, 16, 0, BF16)
    p = paged_plan(8, 32, 32, 128, 16, 33, BF16)
    for bad in (dict(splits=2, per=3), dict(splits=4, per=3),
                dict(splits=0), dict(b=65536)):
        with pytest.raises(ValueError, match="cannot run"):
            check_plan("op", dataclasses.replace(p, **bad))
    with pytest.raises(ValueError, match="shared memory"):   # 1-row pages
        paged_plan(600, 1, 1, 128, 1, 100000, BF16)


def _decode_inputs(rng, b, h, hkv, d, page, mb, lens):
    nb = b * mb
    tables = np.full((b, mb), nb, np.int32)
    perm = rng.permutation(nb)
    used = 0
    for s in range(b):
        n = -(-int(lens[s]) // page)
        tables[s, :n] = perm[used:used + n]
        used += n
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(nb, page, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(nb, page, hkv, d)).astype(np.float32)
    return q, kp, vp, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("dtype,code,rows", [(BF16, 1, 16), (F16, 2, 16),
                                             (F32, 0, 8)])
def test_wrapper_passes_the_plan_and_its_scratch(monkeypatch, dtype, code,
                                                 rows):
    """On a card the wrapper passes the plan's spans and scratch:
    partials, then (m, l) at the plan's offset, then the counters; the
    scratch is allocated once, zeroed, and reused by the next call."""
    calls = []
    monkeypatch.setattr(TPA, "on_cuda", lambda op, *ts, kernel=None: True)
    monkeypatch.setattr(TPA, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(TPA, "stream_of", lambda x: 0)
    monkeypatch.setattr(TPA.KERNEL, "launch", lambda *a: calls.append(a))
    TPA._launch_args.cache_clear()
    rng = np.random.default_rng(1)
    q, kp, vp, tables, lens = _decode_inputs(rng, 6, 16, 4, 64, 16, 12,
                                             [5, 190, 0, 64, 1, 17])
    t = [torch.from_numpy(a).to(dtype) for a in (q, kp, vp)]
    ti = [torch.from_numpy(a) for a in (tables, lens)]
    out = TPA.paged_attention(*t, *ti)
    plan = paged_plan(6, 16, 4, 64, 16, 12, dtype, H100_SMS)
    assert plan.splits > 1 and plan.rows_per_tile == rows
    args = calls[-1]
    assert args[5] == out.data_ptr() and out.shape == t[0].shape
    assert args[7] - args[6] == plan.ml_offset
    assert args[8] - args[6] == plan.counter_offset
    # (..., b, h, nb, page, h_kv, d, mb, splits, per, scale, dtype)
    assert args[9:18] == (6, 16, 72, 16, 4, 64, 12, plan.splits, plan.per)
    assert args[18] == pytest.approx(1 / 8) and args[19] == code
    buf = TPA._launch_args(plan, out.device, 0)[-1]
    assert buf.numel() == plan.scratch_bytes and not buf.any()
    assert args[6] == buf.data_ptr()
    TPA.paged_attention(*t, *ti, scale=0.5)
    assert calls[-1][6] == args[6]
    assert TPA._launch_args.cache_info().currsize == 1
    assert calls[-1][18] == 0.5
    # one page: a single span, no scratch
    TPA.paged_attention(*t, ti[0][:, :1].contiguous(), ti[1])
    assert calls[-1][6:9] == (None, None, None)
    assert calls[-1][16:18] == (1, 1)


def test_wrapper_refuses_what_the_kernel_cannot_take(monkeypatch):
    monkeypatch.setattr(TPA, "on_cuda", lambda op, *ts, kernel=None: True)
    monkeypatch.setattr(TPA, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(TPA.KERNEL, "launch", lambda *a: None)
    q = torch.zeros((1, 1, 80), dtype=F16)
    p = torch.zeros((1, 16, 1, 80), dtype=F16)
    tt, ln = torch.zeros((1, 1), dtype=torch.int32), torch.ones(
        (1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim 80"):
        TPA.paged_attention(q, p, p, tt, ln)
    with pytest.raises(TypeError, match="float64"):
        TPA.paged_attention(q[..., :64].double().contiguous(),
                            p[..., :64].double().contiguous(),
                            p[..., :64].double().contiguous(), tt, ln)
    with pytest.raises(ValueError, match="expected torch.int32"):
        TPA.paged_attention(q[..., :64].contiguous(),
                            p[..., :64].contiguous(),
                            p[..., :64].contiguous(), tt.long(), ln)


# -- the kernel's merge of spans ----------------------------------------------

def _span_state(qg, k, v, lo, hi, end, scale_log2):
    """One span's online softmax over positions [lo, hi) in chunks of 16:
    (m, l, acc) in the log2 domain, masked scores (pos >= end) weigh
    exactly 0; a span with no visible position stays (-1e30, 0, 0)."""
    rows, d = qg.shape
    m = torch.full((rows,), NEG)
    l = torch.zeros(rows)
    acc = torch.zeros(rows, d)
    for p0 in range(lo, hi, 16):
        pos = torch.arange(p0, min(p0 + 16, hi))
        sc = (qg @ k[pos].T) * scale_log2
        vis = pos < end
        sc = torch.where(vis, sc, torch.tensor(NEG))
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(vis, torch.exp2(sc - m_new[:, None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[:, None] + p @ v[pos]
        m = m_new
    return m, l, acc


def _merge(states):
    """The spans merged in order: m = max, w = 2^(m_s - m)."""
    mm = torch.stack([s[0] for s in states]).amax(0)
    ll = torch.zeros_like(states[0][1])
    aa = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        w = torch.exp2(m - mm)
        ll = ll + w * l
        aa = aa + w[:, None] * acc
    return mm, ll, aa


def test_span_merge_in_order_matches_plain():
    """Every slot of a small batch split into spans of 2 stages of 64
    positions, merged in span order, with an empty span appended: equal
    to the plain version within f32 tolerance; the empty span changes
    nothing, bit for bit; a zero-length slot is zeros."""
    rng = np.random.default_rng(7)
    b, h, hkv, d, page, mb = 5, 8, 2, 32, 16, 24
    lens = [300, 1, 128, 0, 384]
    q, kp, vp, tables, ln = _decode_inputs(rng, b, h, hkv, d, page, mb,
                                           lens)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, kp, vp))
    tt, tl = torch.from_numpy(tables), torch.from_numpy(ln)
    want = TPA.plain(tq, tk, tv, tt, tl)
    k, v = TPA.paged_gather_dense(tk, tv, tt)
    g, span = h // hkv, 2 * 64
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    got = torch.zeros_like(want)
    empty = (torch.full((g,), NEG), torch.zeros(g), torch.zeros(g, d))
    for s in range(b):
        end = min(int(ln[s]), mb * page)
        if end == 0:
            continue
        for hk in range(hkv):
            qg = tq[s, hk * g:(hk + 1) * g]
            states = [_span_state(qg, k[s, :, hk], v[s, :, hk], lo,
                                  min(lo + span, -(-end // 64) * 64), end,
                                  scale_log2)
                      for lo in range(0, end, span)]
            m, l, acc = _merge(states)
            m2, l2, acc2 = _merge(states + [empty])
            assert torch.equal(m, m2) and torch.equal(l, l2) \
                and torch.equal(acc, acc2)
            got[s, hk * g:(hk + 1) * g] = acc / l[:, None]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(want[3], torch.zeros_like(want[3]))
