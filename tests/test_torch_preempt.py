"""Preemption, restore and the request lifecycle of the port's serving
Engine (``SwapManager``, ``Engine.preempt``, fault isolation, ``max_queue``,
``retry``, ``detokenize``, ``on_token``) held against the JAX package on the
CPU, on ``tiny``: twins of ``tests/test_serving.py``'s preemption,
admission, streaming and isolation tests.

A preempted-and-restored request must give the stream it gives without
preemption, token for token: the swap round-trips the exact page bytes
(checked bit for bit) and re-running a span rewrites identical values.
Against the JAX Engine driven the same way (the same preemption at the
same step), streams are equal under the near-tie rule of
``test_torch_serving.py`` (a first difference only where the JAX model's
top-2 logit margin is below ``TIE``).  The copied resilience modules must
behave as the reference's: the same sites, parsed plans and backoff.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import resilience as jrs
from paddle_tpu import serving as jserving
from paddle_tpu.models.llama import llama as jax_llama
from paddle_tpu_torch import resilience as trs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import params_from_numpy
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving.block_allocator import (PagedKVCache,
                                                      SwapManager)
from test_torch_serving import _jax_margins, _near_tie_equal

GEOM = dict(max_batch=2, max_seq_len=64, page_size=8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """tiny's ops are too small to gain from intra-op threads, and the
    suite runs several test processes side by side: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompt(rng, n):
    return rng.integers(0, 256, size=n).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    pt.seed(0)
    jm = jax_llama("tiny", fused_ops="on")
    tm = params_from_numpy(
        torch_llama("tiny", device="cpu", fused_ops="on"),
        {k: np.asarray(v) for k, v in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def jax_engine(pair):
    """The JAX Engine the twins below drive, built once."""
    return jserving.Engine(pair[0], **GEOM).warmup()


def _engine(model, **kw):
    return tserving.Engine(model, device="cpu", **{**GEOM, **kw}).warmup()


def _alone(model, prompt, max_new, **kw):
    """The request's stream from an engine that never preempts it."""
    eng = _engine(model, **kw)
    rid = eng.add_request(prompt, max_new_tokens=max_new)
    return eng.run()[rid]


# -- the swap manager ---------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 2, 8])
def test_swap_round_trips_bytes_in_place(chunk):
    """swap_out then swap_in into other blocks: the same bytes, the same
    pool tensors (data_ptr), spare rows and every other block untouched;
    any chunk size."""
    kv = PagedKVCache(2, 10, 4, 2, 8, device="cpu", spare_rows=6)
    g = torch.Generator().manual_seed(0)
    for pair in kv.caches:
        for rows in pair.rows:
            rows.normal_(generator=g)
    ptrs = [t.data_ptr() for pair in kv.caches for t in pair]
    before = [tuple(r.clone() for r in pair.rows) for pair in kv.caches]
    sm = SwapManager(kv, chunk=chunk)
    src, dst = [3, 7, 1], [0, 9, 5]
    host = sm.swap_out(src)
    assert host.ready is None and host.synchronize() is host
    assert host.nbytes() == 3 * 2 * 2 * (4 * 2 * 8) * 4
    for layer, hl in zip(kv.caches, host):
        for c, h in zip(layer, hl):
            assert torch.equal(h, c[src])
    sm.swap_in(dst, host)
    assert (sm.pages_out, sm.pages_in) == (3, 3)
    assert [t.data_ptr() for pair in kv.caches for t in pair] == ptrs
    keep = [b for b in range(10) if b not in dst]
    for pair, old in zip(kv.caches, before):
        for c, r, r0 in zip(pair, pair.rows, old):
            view0 = r0[:40].view(10, 4, 2, 8)
            assert torch.equal(c[dst], view0[src])
            assert torch.equal(c[keep], view0[keep])
            assert torch.equal(r[40:], r0[40:])          # spare rows


def test_swap_rejects_bad_ids_and_payloads():
    kv = PagedKVCache(1, 4, 4, 1, 8, device="cpu")
    sm = SwapManager(kv)
    with pytest.raises(ValueError, match="outside"):
        sm.swap_out([4])
    host = sm.swap_out([0, 1])
    with pytest.raises(ValueError, match="does not match"):
        sm.swap_in([2], host)
    with pytest.raises(ValueError, match="chunk"):
        SwapManager(kv, chunk=0)


def test_swap_fault_is_retried_then_raised(pair):
    """``serve.swap`` fires in both directions; the engine's RetryPolicy
    turns a transient fault into a retry and re-raises at exhaustion."""
    slept = []
    eng = _engine(pair[1], retry=trs.RetryPolicy(max_attempts=3,
                                                 sleep=slept.append))
    p = _prompt(np.random.default_rng(1), 11)
    rid = eng.add_request(p, max_new_tokens=6)
    eng.step()
    eng.step()
    inj = trs.install_faults("serve.swap@0x2")
    try:
        assert eng.preempt(rid)
        eng.run()
    finally:
        trs.clear_faults()
    assert len(slept) == 2 and len(inj.fired) == 2
    assert inj.calls("serve.swap") == 4       # 3 out, 1 in
    assert eng.output_ids(rid) == _alone(pair[1], p, 6)
    eng2 = _engine(pair[1], retry=trs.RetryPolicy(max_attempts=2,
                                                  sleep=lambda s: None))
    rid = eng2.add_request(p, max_new_tokens=6)
    eng2.step()
    trs.install_faults("serve.swap@0x2")
    try:
        with pytest.raises(trs.InjectedFault):
            eng2.preempt(rid)
    finally:
        trs.clear_faults()


# -- preemption ----------------------------------------------------------------


def test_preempt_swap_restore_token_identity(pair, jax_engine):
    jm, tm = pair
    rng = np.random.default_rng(2)
    p1, p2 = _prompt(rng, 6), _prompt(rng, 11)
    outs = {}
    for tag, eng in (("jax", jax_engine), ("port", _engine(tm))):
        out0, in0 = eng._swap.pages_out, eng._swap.pages_in
        r1 = eng.add_request(p1, max_new_tokens=12, request_id="r1")
        r2 = eng.add_request(p2, max_new_tokens=8, request_id="r2")
        for _ in range(4):
            eng.step()
        used = eng.kv_blocks_used
        assert eng.preempt(r1)
        st = eng._states[r1]
        assert st.swapped is not None and st.slot is None
        assert eng.kv_blocks_used < used          # victim's blocks freed
        assert eng._swap.pages_out > out0
        eng.run()
        assert st.preempts == 1 and st.swapped is None
        assert eng._swap.pages_in - in0 == eng._swap.pages_out - out0
        assert eng.kv_blocks_used == 0
        outs[tag] = {r: eng.output_ids(r) for r in (r1, r2)}
    assert outs["port"] == {"r1": _alone(tm, p1, 12),
                            "r2": _alone(tm, p2, 8)}
    prompts = {"r1": p1, "r2": p2}
    for rid, ref in outs["jax"].items():
        assert _near_tie_equal(ref, outs["port"][rid], lambda rid=rid:
                               _jax_margins(jm, prompts[rid], ref))


def test_preempt_mid_prefill_restores(pair):
    """A victim still chunk-prefilling swaps its written prefix and
    resumes prefill at kv_len, not from scratch."""
    tm = pair[1]
    p = _prompt(np.random.default_rng(3), 41)
    eng = _engine(tm, prefill_chunk=4)
    rid = eng.add_request(p, max_new_tokens=5)
    eng.step()
    eng.step()                                  # 8 of 41 prompt tokens
    st = eng._states[rid]
    assert st.prefilling and st.kv_len == 8
    assert eng.preempt(rid)
    assert eng._swap.pages_out == 1
    eng.step()
    assert st.kv_len == 12                      # resumed, not reset
    eng.run()
    assert eng.output_ids(rid) == _alone(tm, p, 5, prefill_chunk=4)
    assert eng.kv_blocks_used == 0


def test_preempt_with_shared_prefix_pages(pair):
    """Preempting a borrower leaves the donor and the cache alone: the
    shared pages are copied, the victim's references drop (refcounts
    back to the donor's), and later requests still hit the pages."""
    tm = pair[1]
    rng = np.random.default_rng(4)
    common = _prompt(rng, 16)                   # 2 full pages
    p1 = np.concatenate([common, _prompt(rng, 3)])
    p2 = np.concatenate([common, _prompt(rng, 5)])
    eng = _engine(tm, prefill_chunk=16)
    r1 = eng.add_request(p1, max_new_tokens=20)     # donor, long decode
    eng.step()
    eng.step()
    r2 = eng.add_request(p2, max_new_tokens=10)     # borrows the pages
    eng.step()
    eng.step()
    st2 = eng._states[r2]
    assert st2.num_shared == 2
    shared = [int(b) for b in st2.table[:2]]
    alloc = eng.kv.allocator
    assert [alloc.refcount(b) for b in shared] == [2, 2]
    ptrs = eng._ptrs(eng.kv.caches)
    assert eng.preempt(r2)
    assert [alloc.refcount(b) for b in shared] == [1, 1]
    assert eng._ptrs(eng.kv.caches) == ptrs
    eng.run()
    assert eng.output_ids(r1) == _alone(tm, p1, 20, prefill_chunk=16)
    assert eng.output_ids(r2) == _alone(tm, p2, 10, prefill_chunk=16)
    hits = eng.prefix_stats()["hits"]
    eng.add_request(np.concatenate([common, _prompt(rng, 2)]),
                    max_new_tokens=3)
    eng.run()
    assert eng.prefix_stats()["hits"] > hits        # cache intact
    assert eng.kv_blocks_used == 0


def test_preempt_non_running_returns_false(pair):
    eng = _engine(pair[1], max_batch=1, max_seq_len=32)
    rng = np.random.default_rng(5)
    r1 = eng.add_request(_prompt(rng, 4), max_new_tokens=2)
    r2 = eng.add_request(_prompt(rng, 5), max_new_tokens=2)   # waits
    assert not eng.preempt("nope")
    eng.step()
    assert not eng.preempt(r2)
    eng.run()
    assert not eng.preempt(r1)
    assert eng._swap.pages_out == 0 and eng.kv_blocks_used == 0


def test_pools_keep_their_addresses_across_swaps(pair):
    """The captured step reads every pool by address: preempt and restore
    must write in place (Engine._check_pools holds, data_ptr equal)."""
    eng = _engine(pair[1])
    ptrs = eng._ptrs(eng.kv.caches)
    rows = [r.data_ptr() for c in eng.kv.caches for r in c.rows]
    rng = np.random.default_rng(6)
    rids = [eng.add_request(_prompt(rng, n), max_new_tokens=6)
            for n in (9, 13)]
    for _ in range(3):
        eng.step()
    assert eng.preempt(rids[0]) and eng.preempt(rids[1])
    eng.run()
    assert eng._swap.pages_in == eng._swap.pages_out > 0
    assert eng._ptrs(eng.kv.caches) == ptrs
    assert [r.data_ptr() for c in eng.kv.caches for r in c.rows] == rows
    eng._check_pools(eng.kv.caches)


# -- admission, streaming -------------------------------------------------------


def test_queue_full_typed(pair):
    eng = _engine(pair[1], max_batch=1, max_seq_len=32, max_queue=2)
    rng = np.random.default_rng(7)
    eng.add_request(_prompt(rng, 3), max_new_tokens=2)
    eng.add_request(_prompt(rng, 3), max_new_tokens=2)
    with pytest.raises(tserving.QueueFull):
        eng.add_request(_prompt(rng, 3), max_new_tokens=2)
    assert issubclass(tserving.QueueFull, ValueError)
    outs = eng.run()
    assert len(outs) == 2 and eng.kv_blocks_used == 0
    eng.add_request(_prompt(rng, 3), max_new_tokens=2)      # room again


def test_streaming_callbacks_and_detokenize(pair):
    got = []
    eng = _engine(pair[1], detokenize=lambda ids: " ".join(map(str, ids)))
    rid = eng.add_request(
        _prompt(np.random.default_rng(8), 4), max_new_tokens=3,
        tenant="t0", on_token=lambda r, t, txt: got.append((r, t, txt)))
    events = list(eng.stream())
    assert [t for _, t, _ in got] == eng.output_ids(rid)
    assert [ev.text for ev in events] == [txt for _, _, txt in got]
    assert "".join(txt for _, _, txt in got) == \
        " ".join(map(str, eng.output_ids(rid)))
    assert events[-1].finished and events[-1].finish_reason == "length"
    assert eng._states[rid].request.tenant == "t0"


def test_raising_on_token_callback_is_isolated(pair):
    """One request's broken callback must not tear down step(): the
    batch's other requests keep their events."""
    eng = _engine(pair[1], max_seq_len=32)
    rng = np.random.default_rng(9)
    got = []

    def bad(r, t, txt):
        raise RuntimeError("consumer bug")

    r1 = eng.add_request(_prompt(rng, 3), max_new_tokens=3, on_token=bad)
    r2 = eng.add_request(_prompt(rng, 5), max_new_tokens=3,
                         on_token=lambda r, t, txt: got.append(t))
    with pytest.warns(RuntimeWarning, match="on_token"):
        outs = eng.run()
    assert len(outs[r1]) == 3 and len(outs[r2]) == 3
    assert got == outs[r2]
    assert eng.kv_blocks_used == 0


def test_streaming_detok_window_stays_linear(pair, monkeypatch):
    """The incremental text path re-detokenizes only a bounded tail
    window; across re-anchors the pieces still concatenate to the full
    detokenization."""
    monkeypatch.setattr(engine_mod, "_DETOK_WINDOW", 4)
    calls = []

    def detok(ids):
        calls.append(len(ids))
        return " ".join(map(str, ids))

    eng = _engine(pair[1], max_batch=1, detokenize=detok)
    rid = eng.add_request(_prompt(np.random.default_rng(10), 5),
                          max_new_tokens=14)
    text = "".join(ev.text for ev in eng.stream())
    assert text == " ".join(map(str, eng.output_ids(rid)))
    assert max(calls) <= 4


# -- fault isolation -------------------------------------------------------------


def test_step_and_prefill_faults_confined(pair):
    """Injected serve.step / serve.prefill / serve.admit / serve.cow
    faults are confined to the request they hit (rewind, preempt,
    re-admit): every stream equals its un-faulted twin's."""
    tm = pair[1]
    rng = np.random.default_rng(11)
    common = _prompt(rng, 16)
    prompts = [_prompt(rng, 9), _prompt(rng, 14),
               np.concatenate([common, _prompt(rng, 3)]), common]
    geom = dict(max_batch=4, prefill_chunk=4)

    def serve(eng):
        rids = [eng.add_request(p, max_new_tokens=6, request_id=f"f{i}")
                for i, p in enumerate(prompts[:3])]
        eng.run()
        rids.append(eng.add_request(prompts[3], max_new_tokens=6,
                                    request_id="f3"))   # full hit: CoW
        eng.run()
        return {r: eng.output_ids(r) for r in rids}

    base = serve(_engine(tm, **geom))
    eng = _engine(tm, **geom)
    inj = trs.install_faults("serve.step@2,serve.prefill@1,serve.admit@1,"
                             "serve.cow@0")
    try:
        with pytest.warns(RuntimeWarning, match="isolated"):
            got = serve(eng)
    finally:
        trs.clear_faults()
    assert {s for s, _ in inj.fired} == {"serve.step", "serve.prefill",
                                         "serve.admit", "serve.cow"}
    assert got == base
    assert sum(eng._states[r].preempts for r in got) == 3
    assert eng.kv_blocks_used == 0


def test_isolation_matches_the_jax_engine(pair, jax_engine):
    """The same injected faults in the JAX Engine and the port's: the
    same requests are isolated, and the streams agree."""
    jm, tm = pair
    rng = np.random.default_rng(12)
    prompts = {"i0": _prompt(rng, 7), "i1": _prompt(rng, 12)}
    outs = {}
    for tag, eng, rs in (("jax", jax_engine, jrs), ("port", _engine(tm), trs)):
        rs.install_faults("serve.step@3,serve.prefill@0")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                for rid, p in prompts.items():
                    eng.add_request(p, max_new_tokens=5, request_id=rid)
                eng.run()
        finally:
            rs.clear_faults()
        outs[tag] = ({r: eng.output_ids(r) for r in prompts},
                     {r: eng._states[r].preempts for r in prompts})
    assert outs["port"][1] == outs["jax"][1]
    for rid, ref in outs["jax"][0].items():
        assert _near_tie_equal(ref, outs["port"][0][rid], lambda rid=rid:
                               _jax_margins(jm, prompts[rid], ref))


# -- the copied resilience modules --------------------------------------------------


def test_fault_sites_and_plans_match_the_reference():
    assert trs.SITES == jrs.SITES
    spec = "serve.step@2x3:OSError;serve.swap@0,serve.spec@1:ValueError"
    ours, ref = trs.parse_faults(spec), jrs.parse_faults(spec)
    assert [(p.site, p.at, p.times, p.exc.__name__) for p in ours] == \
        [(p.site, p.at, p.times, p.exc.__name__) for p in ref]
    with pytest.raises(ValueError, match="unknown fault site"):
        trs.parse_faults("serve.nope@1")
    inj = trs.FaultInjector(spec)
    fired = []
    for _ in range(6):
        try:
            inj("serve.step")
        except OSError:
            fired.append(inj.calls("serve.step") - 1)
    assert fired == [2, 3, 4]


@pytest.mark.parametrize("site", ["serve.swap", "ckpt.save", ""])
def test_retry_backoff_matches_the_reference(site):
    ours = trs.RetryPolicy(max_attempts=3, backoff_s=0.02)
    ref = jrs.RetryPolicy(max_attempts=3, backoff_s=0.02)
    assert [ours.delay_s(a, site) for a in range(1, 6)] == \
        [ref.delay_s(a, site) for a in range(1, 6)]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise trs.InjectedFault("transient")
        return "ok"

    pol = trs.RetryPolicy(max_attempts=3, sleep=lambda s: None)
    assert pol.run(flaky, site=site) == "ok" and len(calls) == 3
    with pytest.raises(ValueError):
        pol.run(lambda: (_ for _ in ()).throw(ValueError("logic")))
