"""The ragged paged-attention kernel's split plan
(paddle_tpu_torch.ops.cuda.ragged_plan), the wrapper's use of it, and the
bf16 kernel's order of operations, on the CPU.

The plan is a pure function of the shapes, the dtype and the SM count:
bf16 with a head dim that is a multiple of 8 up to 256 runs one block per
(slot, kv head, 16-row tile, span of 64-position stages), the number of
spans chosen to give four blocks per SM if every table were full; other
shapes run the SIMT path with no split.  The CUDA kernel runs only on the
card (``chip_smoke.py`` holds it against its plain version there); here
the wrapper is driven as if its tensors lay on a card, with the launch
replaced by a recorder.

The split emulation repeats the kernel's arithmetic in torch: per span,
4 warps each take one 16-position chunk of every stage with their own
online softmax in the log2 domain (masked scores weigh exactly 0; P
rounded to bf16 before P.V when the inputs are bf16), the warps merged in
order, then the spans merged in order (m = max, w = 2^(m_s - m)).  It is
held against the JAX ``_ragged_attend_dense`` over ``_paged_gather_dense``
and the Pallas kernel in interpret mode on live rows, at f32 1e-4 and
bf16 2e-2 (an f32 sum taken in another order and P's rounding move a bf16
output by a unit or two); dead rows must be exact zeros.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.ops.pallas import ragged_attention as JRA
from paddle_tpu_torch.ops.cuda import ragged_attention as TRA
from paddle_tpu_torch.ops.cuda.mlp_plan import H100_SMS
from paddle_tpu_torch.ops.cuda.ragged_plan import (MAX_PARTIAL_BYTES,
                                                   SMEM_LIMIT, check_plan,
                                                   ragged_plan)

BF16, F32 = torch.bfloat16, torch.float32
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
NEG = -1e30

# (B, C, H, H_kv, D, page, MB) -> (tiles, splits, per, grid blocks,
# partial bytes) in bf16 on 132 SMs
MAIN = {
    (8, 16, 32, 32, 128, 16, 32): (1, 3, 3, 768, 6_389_760),  # llama2-7b
    (8, 16, 64, 8, 128, 16, 32): (8, 2, 4, 1024, 8_519_680),  # 70b GQA
    (8, 1, 32, 32, 128, 16, 32): (1, 3, 3, 768, 6_389_760),   # C = 1
    (8, 1, 64, 8, 128, 16, 32): (1, 8, 1, 512, 4_259_840),    # C = 1, G 8
    (1, 16, 32, 32, 128, 16, 32): (1, 8, 1, 256, 2_129_920),  # one slot
    (8, 16, 32, 32, 128, 16, 1): (1, 1, 1, 256, 0),           # one page
    (4, 16, 32, 32, 128, 64, 8): (1, 4, 2, 512, 4_259_840),   # page 64
}


@pytest.mark.parametrize("shape", sorted(MAIN))
def test_plan_at_the_main_geometries(shape):
    p = ragged_plan(*shape, BF16, H100_SMS)
    check_plan("test", p)
    assert p.path == "tensor_cores"
    assert (p.tiles, p.splits, p.per, p.grid_blocks,
            p.partial_bytes) == MAIN[shape]
    assert p.combine == (p.splits > 1)
    assert (p.splits - 1) * p.per < p.stages <= p.splits * p.per
    assert p.partial_bytes <= MAX_PARTIAL_BYTES + p.ml_offset
    assert p.smem_bytes == 73_984 <= SMEM_LIMIT


@pytest.mark.parametrize("dtype,d,path,smem", [
    (F32, 128, "simt", 4 * (64 * 129 + 64 * 128 + 16 * 129 + 16 * 128
                            + 64 * 16 + 192)),
    (BF16, 100, "simt", 4 * (64 * 101 + 64 * 100 + 16 * 101 + 16 * 100
                             + 64 * 16 + 192)),
    (BF16, 72, "tensor_cores", 2 * 136 * (16 + 256)),
    (BF16, 64, "tensor_cores", 2 * 72 * (16 + 256)),
    (BF16, 256, "tensor_cores", 2 * 264 * (16 + 256)),
])
def test_paths_and_shared_memory(dtype, d, path, smem):
    p = ragged_plan(8, 16, 32, 32, d, 16, 32, dtype, H100_SMS)
    check_plan("test", p)
    assert (p.path, p.smem_bytes) == (path, smem)
    if path == "simt":
        assert (p.splits, p.per, p.partial_bytes) == (1, 1, 0)
        assert p.grid_blocks == 8 * 32 * 1          # 64-row blocks


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(TypeError, match="float16"):
        ragged_plan(8, 16, 32, 32, 128, 16, 32, torch.float16)
    with pytest.raises(ValueError, match="kv heads"):
        ragged_plan(8, 16, 30, 8, 128, 16, 32, BF16)
    # an f32 head dim of 512: the SIMT block's page needs too much memory
    with pytest.raises(ValueError, match="shared memory"):
        check_plan("op", ragged_plan(1, 1, 1, 1, 512, 16, 1, F32))
    p = ragged_plan(8, 16, 32, 32, 128, 16, 32, BF16)
    for bad in (dict(splits=2, per=3), dict(splits=3, per=4),
                dict(splits=0)):
        with pytest.raises(ValueError, match="cannot run"):
            check_plan("op", dataclasses.replace(p, **bad))


def test_split_rule_over_many_shapes():
    """No empty span, no more spans than stages, partials within their
    cap, and spans only where the tiles leave SMs idle."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        b, c, hkv = (int(v) for v in rng.integers(1, 17, size=3))
        g = int(rng.choice([1, 2, 4, 8]))
        page = int(rng.choice([8, 16, 32, 64, 128]))
        mb = int(rng.integers(1, 65))
        p = ragged_plan(b, c, hkv * g, hkv, 128, page, mb, BF16, H100_SMS)
        check_plan("test", p)
        assert 1 <= p.splits <= p.stages
        assert p.partial_bytes <= MAX_PARTIAL_BYTES + p.ml_offset
        base = b * hkv * p.tiles
        if base >= 4 * H100_SMS:
            assert p.splits == 1


# -- the kernel's order of operations ----------------------------------------

def emulate(q, kp, vp, tables, starts, lens, splits, per, round_p):
    """The tensor-core kernel's arithmetic in torch, in its order."""
    b, c, h, d = q.shape
    _, page, hkv, _ = kp.shape
    g = h // hkv
    rows = c * g
    k, v = TRA.paged_gather_dense(kp, vp, tables)
    kk = k.permute(0, 2, 1, 3).float()               # (B, Hkv, S, D)
    vv = v.permute(0, 2, 1, 3).float()
    qg = q.reshape(b, c, hkv, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, hkv, rows, d).float()
    j = torch.arange(rows) // g
    live = j[None, :] < lens.long()[:, None]
    lim = torch.where(live, starts.long()[:, None] + j[None, :], -1)
    lim = lim[:, None, :, None]                      # (B, 1, rows, 1)
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    total = kk.shape[2]
    stages = -(-total // 64)
    spans = []
    for s in range(splits):
        m = torch.full((4, b, hkv, rows), NEG)
        l = torch.zeros((4, b, hkv, rows))
        acc = torch.zeros((4, b, hkv, rows, d))
        for st in range(s * per, min((s + 1) * per, stages)):
            for w in range(4):                       # warp w: chunk w
                p0 = st * 64 + 16 * w
                if p0 >= total:
                    continue
                pos = torch.arange(p0, p0 + 16)
                sc = qg @ kk[:, :, p0:p0 + 16].transpose(-1, -2)
                vis = pos <= lim
                sc = torch.where(vis, sc * scale_log2, NEG)
                m_new = torch.maximum(m[w], sc.amax(-1))
                alpha = torch.exp2(m[w] - m_new)
                p = torch.where(vis, torch.exp2(sc - m_new[..., None]), 0.0)
                l[w] = l[w] * alpha + p.sum(-1)
                pr = p.to(BF16).float() if round_p else p
                acc[w] = acc[w] * alpha[..., None] + pr @ vv[:, :, p0:p0 + 16]
                m[w] = m_new
        spans.append(_merge(m, l, acc))
    mm, ll, aa = _merge(*(torch.stack(t) for t in zip(*spans)))
    out = torch.where(ll[..., None] > 0, aa / ll.clamp_min(1e-30)[..., None],
                      0.0)
    out = out.reshape(b, hkv, c, g, d).permute(0, 2, 1, 3, 4)
    return out.reshape(b, c, h, d).to(q.dtype)


def _merge(m, l, acc):
    """Merge states along dim 0 in order: m = max, w = 2^(m_i - m)."""
    mm = m.amax(0)
    ll, aa = torch.zeros_like(l[0]), torch.zeros_like(acc[0])
    for i in range(m.shape[0]):
        w = torch.exp2(m[i] - mm)
        ll = ll + w * l[i]
        aa = aa + w[..., None] * acc[i]
    return mm, ll, aa


def _batch(rng, c, g, hkv, d, page, mb):
    """Decode deep in its context, a chunk from 0, a chunk straddling a
    page, a partial chunk, the idle slot, a decode at the last position;
    tables padded with the out-of-range sentinel."""
    b = 6
    total = page * mb
    starts = np.array([total // 2 + 3, 0, page + page // 2 + 1, 7, 0,
                       total - 1], np.int32)
    lens = np.array([1, c, c, c // 2, 0, 1], np.int32)
    nb = b * mb
    tables = np.full((b, mb), nb, np.int32)
    perm = rng.permutation(nb)
    used = 0
    for s in range(b):
        n = -(-(int(starts[s]) + int(lens[s])) // page)
        tables[s, :n] = perm[used:used + n]
        used += n
    q = rng.normal(size=(b, c, g * hkv, d)).astype(np.float32)
    kp = rng.normal(size=(nb, page, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(nb, page, hkv, d)).astype(np.float32)
    return q, kp, vp, tables, starts, lens


@pytest.mark.parametrize("g,page,mb,per,dtype", [
    (1, 16, 8, 1, "float32"), (4, 16, 12, 2, "bfloat16"),
    (8, 64, 4, 1, "bfloat16"), (8, 64, 4, 1, "float32")])
def test_split_order_matches_jax(g, page, mb, per, dtype):
    rng = np.random.default_rng(g * 100 + page)
    c, hkv, d = 8, 2, 32
    q, kp, vp, tables, starts, lens = _batch(rng, c, g, hkv, d, page, mb)
    jdt, tdt = (jnp.bfloat16, BF16) if dtype == "bfloat16" \
        else (jnp.float32, F32)
    t = [torch.from_numpy(a).to(tdt) for a in (q, kp, vp)]
    ti = [torch.from_numpy(a) for a in (tables, starts, lens)]
    stages = -(-page * mb // 64)
    splits = -(-stages // per)
    assert splits > 1
    got = emulate(*t, *ti, splits, per, dtype == "bfloat16").float()
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, kp, vp))
    jt, js, jl = (jnp.asarray(a) for a in (tables, starts, lens))
    refs = [JIF._ragged_attend_dense(jq, *JIF._paged_gather_dense(jk, jv, jt),
                                     js, 1.0 / math.sqrt(d)),
            JRA.ragged_paged_attention(jq, jk, jv, jt, js, jl,
                                       interpret=True)]
    for s in range(len(lens)):
        n = int(lens[s])
        assert bool((got[s, n:] == 0).all())           # dead rows
        for ref in refs:
            want = np.asarray(jnp.asarray(ref, jnp.float32))[s, :n]
            np.testing.assert_allclose(got[s, :n].numpy(), want,
                                       **TOL[dtype])


def test_wrapper_passes_the_plan_and_its_scratch(monkeypatch):
    """On a card the wrapper passes the plan's spans and one allocation:
    the output, the acc partials, then (m, l) at the plan's offset."""
    calls = []
    monkeypatch.setattr(TRA, "on_cuda", lambda op, *ts, kernel=None: True)
    monkeypatch.setattr(TRA, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(TRA, "stream_of", lambda x: 0)
    monkeypatch.setattr(TRA.KERNEL, "launch", lambda *a: calls.append(a))
    rng = np.random.default_rng(1)
    q, kp, vp, tables, starts, lens = _batch(rng, 8, 4, 2, 32, 16, 12)
    t = [torch.from_numpy(a).to(BF16) for a in (q, kp, vp)]
    out = TRA.ragged_paged_attention(*t, *[torch.from_numpy(a)
                                           for a in (tables, starts, lens)])
    plan = ragged_plan(6, 8, 8, 2, 32, 16, 12, BF16, H100_SMS)
    args = calls[-1]
    # the output, then the partials behind it in the same allocation
    assert args[6] == out.data_ptr() and out.shape == t[0].shape
    assert args[7] - args[6] == -(-out.numel() * 2 // 256) * 256
    assert plan.combine and args[8] - args[7] == plan.ml_offset
    # (..., b, c, h, nb, page, h_kv, d, mb, splits, per)
    assert args[9:19] == (6, 8, 8, 72, 16, 2, 32, 12, plan.splits, plan.per)
    assert (plan.splits, plan.per) == (3, 1)
    # f32 takes the SIMT path: no scratch
    t = [torch.from_numpy(a) for a in (q, kp, vp)]
    TRA.ragged_paged_attention(*t, *[torch.from_numpy(a)
                                     for a in (tables, starts, lens)])
    assert calls[-1][7] is None and calls[-1][8] is None
    assert calls[-1][17:19] == (1, 1)
