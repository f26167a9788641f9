"""The port's captured serving step on the CPU: the sync-free span write
(``ops/cuda/ragged_attention.span_write`` on a ``PoolPair``) against the
``nonzero`` composition it replaced and against the JAX package's
``_paged_span_write``; the engine's static buffers and pools through a
churny run; and the per-replay launch credit (``serving.graph``).

The CPU runs the step eagerly on the same static buffers that the card's
CUDA graph reads; the capture itself runs only on the card
(``chip_smoke.py``'s engine phases).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.incubate.nn.functional import _paged_span_write as jax_write
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.ops.cuda import ragged_attention as TRA
from paddle_tpu_torch.serving.graph import credit_launches, launch_delta


def nonzero_span_write(k_pool, v_pool, k, v, block_tables, span_starts,
                       span_lens):
    """The span write before the capture: dead rows masked out through
    ``nonzero()`` (a host sync) before any index is formed."""
    s = k.shape[1]
    bs = k_pool.shape[1]
    mb = block_tables.shape[1]
    ar = torch.arange(s, device=k.device)
    pos = span_starts.long()[:, None] + ar[None, :]
    live = ar[None, :] < span_lens.long()[:, None]
    bi, ci = live.nonzero(as_tuple=True)
    p = pos[bi, ci]
    blk = block_tables.long()[bi, torch.clamp(p // bs, max=mb - 1)]
    off = p % bs
    k_pool[blk, off] = k[bi, ci].to(k_pool.dtype)
    v_pool[blk, off] = v[bi, ci].to(v_pool.dtype)
    return k_pool, v_pool


B, C, PAGE, MB, HKV, D = 3, 8, 4, 4, 2, 8
NB = B * MB
OOB = NB


def _tables(rows):
    """(B, MB) tables: slot b owns pages [b*MB, b*MB + n_b), the rest of
    its row the sentinel; ``rows[b]`` is n_b (0: an idle slot)."""
    t = np.full((B, MB), OOB, np.int32)
    for b, n in enumerate(rows):
        t[b, :n] = np.arange(b * MB, b * MB + n)
    return t


# (tables' live pages per slot, starts, lens)
CASES = {
    # the engine's warmup: all-out-of-range tables, zero lengths
    "warmup": ([0, 0, 0], [0, 0, 0], [0, 0, 0]),
    # slot 1 idle between two decoding slots
    "dead_slot": ([2, 0, 3], [5, 0, 9], [1, 0, 1]),
    # a 5-token prefill chunk in a span of 8
    "chunk_padded": ([2, 1, 2], [0, 0, 3], [5, 1, 4]),
    # a span from position 2 to 9: pages 0, 1 and 2
    "page_cross": ([3, 1, 1], [2, 1, 0], [8, 1, 2]),
    # slot 0 owns 2 pages; its padding reaches positions of page 2,
    # whose table entry is the sentinel
    "sentinel_past_last_page": ([2, 2, 2], [5, 0, 7], [3, 8, 1]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sync_free_span_write_equals_nonzero_write(case):
    pages, starts, lens = CASES[case]
    rng = np.random.default_rng(7)
    pools = rng.normal(size=(2, NB, PAGE, HKV, D)).astype(np.float32)
    k = rng.normal(size=(B, C, HKV, D)).astype(np.float32)
    v = rng.normal(size=(B, C, HKV, D)).astype(np.float32)
    ints = [torch.from_numpy(np.asarray(a, np.int32))
            for a in (_tables(pages), starts, lens)]
    pair = TRA.pool_pair(NB, PAGE, HKV, D, B * C, torch.float32, "cpu")
    for t, a in zip(pair, pools):
        t.copy_(torch.from_numpy(a))
    spare = [r[NB * PAGE:].clone() for r in pair.rows]
    ptrs = [t.data_ptr() for t in (*pair, *pair.rows)]
    got = TRA.span_write(pair[0], pair[1], torch.from_numpy(k),
                         torch.from_numpy(v), *ints, rows=pair.rows)
    assert got[0] is pair[0] and got[1] is pair[1]
    assert ptrs == [t.data_ptr() for t in (*pair, *pair.rows)]
    want = nonzero_span_write(*(torch.from_numpy(a.copy()) for a in pools),
                              torch.from_numpy(k), torch.from_numpy(v),
                              *ints)
    jk, jv = jax_write(tuple(jnp.asarray(a) for a in pools),
                       jnp.asarray(k), jnp.asarray(v),
                       *(jnp.asarray(t.numpy()) for t in ints))
    for g, w, j in zip(pair, want, (jk, jv)):
        assert torch.equal(g, w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    if case == "warmup":
        for r, before in zip(pair.rows, spare):
            assert not torch.equal(r[NB * PAGE:], before)  # dead rows there


def test_span_write_without_spare_rows_masks():
    """Pools a caller allocates (no spare rows, or too few for B x C)
    take the masked write, with the same result."""
    pages, starts, lens = CASES["chunk_padded"]
    rng = np.random.default_rng(8)
    pools = rng.normal(size=(2, NB, PAGE, HKV, D)).astype(np.float32)
    k, v = (torch.from_numpy(rng.normal(size=(B, C, HKV, D))
                             .astype(np.float32)) for _ in range(2))
    ints = [torch.from_numpy(np.asarray(a, np.int32))
            for a in (_tables(pages), starts, lens)]
    want = nonzero_span_write(*(torch.from_numpy(a.copy()) for a in pools),
                              k, v, *ints)
    small = TRA.pool_pair(NB, PAGE, HKV, D, B * C - 1, torch.float32, "cpu")
    for t, a in zip(small, pools):
        t.copy_(torch.from_numpy(a))
    for kp, vp, rows in (
            (*(torch.from_numpy(a.copy()) for a in pools), None),
            (small[0], small[1], small.rows)):
        got = TRA.span_write(kp, vp, k, v, *ints, rows=rows)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _ptrs(eng, pool):
    pools = [t.data_ptr() for pair in eng.kv.caches
             for t in (*pair, *pair.rows)]
    stacks = [t.data_ptr() for pack in pool.device_stacks()
              for ab in pack.values() for t in ab.values()]
    static = [t.data_ptr() for t in eng._graph.inputs.values()]
    return pools, stacks, static, eng._graph.output.data_ptr()


def test_churny_engine_keeps_every_buffer_in_place():
    """Joins into a running batch, leaves, a fully cached prompt (prefix
    hit and copy-on-write) and a LoRA load and evict: the pools, the
    LoRA stacks and the step's static inputs and output never move, as a
    captured graph needs; the engine's eager CPU step counts no
    capture."""
    model = torch_llama("tiny", device="cpu", seed=0, fused_ops="off")
    pool = tserving.LoRAPool(model, max_adapters=2, rank=4)
    arng = np.random.default_rng(5)
    pool.load("a0", tserving.random_adapter(model, rank=4, rng=arng,
                                            scale=0.05))
    eng = tserving.Engine(model, device="cpu", max_batch=3, max_seq_len=48,
                          page_size=8, prefill_chunk=8, lora=pool)
    eng.add_request(np.arange(3, 13), max_new_tokens=2, request_id="w")
    eng.step()                       # the first step warms up the engine
    ptrs = _ptrs(eng, pool)
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, 256, size=16)
    eng.add_request(np.concatenate([prefix, [5, 6, 7]]), max_new_tokens=3,
                    request_id="p0")
    eng.add_request(rng.integers(0, 256, size=11), max_new_tokens=6,
                    request_id="a", adapter="a0")
    for _ in range(2):
        eng.step()
    eng.add_request(rng.integers(0, 256, size=5), max_new_tokens=4,
                    request_id="join")
    eng.run()
    eng.add_request(prefix.copy(), max_new_tokens=3, request_id="p1")
    eng.run()
    pool.evict("a0")
    pool.load("a1", tserving.random_adapter(model, rank=4, rng=arng,
                                            scale=0.05))
    eng.add_request(rng.integers(0, 256, size=9), max_new_tokens=3,
                    request_id="b", adapter="a1")
    eng.run()
    stats = eng.prefix_stats()
    assert stats["hits"] > 0 and stats["cow_copies"] > 0, stats
    assert eng.kv_blocks_used == 0
    assert _ptrs(eng, pool) == ptrs
    assert (eng.captures, eng.replays) == (0, 0)


def test_replay_credits_its_launches_to_the_counters():
    kernels = {"a": SimpleNamespace(launches=3),
               "b": SimpleNamespace(launches=0)}
    before = {k: t.launches for k, t in kernels.items()}
    kernels["a"].launches += 2               # what a capture launched
    delta = launch_delta(before, {k: t.launches for k, t in kernels.items()})
    assert delta == {"a": 2, "b": 0}
    credit_launches(kernels, {k: -n for k, n in delta.items()})
    assert kernels["a"].launches == 3        # the capture ran nothing
    for _ in range(4):                       # four replays
        credit_launches(kernels, delta)
    assert (kernels["a"].launches, kernels["b"].launches) == (11, 0)
