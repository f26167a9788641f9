"""Speculative decoding in the port's serving Engine
(``paddle_tpu_torch.serving.spec``, ``Engine(spec_decode=True)``) held
against the JAX package on the CPU, on ``tiny``.

The n-gram proposer is a copy of the reference's: the eight cases of
``tests/test_spec.py`` as one parametrised test, and the same histories
through both proposers giving equal drafts.  The spec engine's greedy
streams equal the JAX spec engine's under the near-tie rule (a stream may
first differ only where the JAX model's top-2 logit margin is below
``TIE``; f32 logits of the two packages differ by ~1e-5), with the same
proposal and acceptance counts when no request is exempt; against the
port's own spec-off engine they are equal token for token (the same
arithmetic on the same rows), and so are temperature streams.  Every
draft depth rides one ``StepGraph``, built once.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import serving as jserving
from paddle_tpu.models.llama import llama as jax_llama
from paddle_tpu.serving.spec import NgramProposer as JaxProposer
from paddle_tpu_torch import resilience as trs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import params_from_numpy
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving.spec import NgramProposer
from test_torch_gpt import model_pair as gpt_pair
from test_torch_serving import _jax_margins, _near_tie_equal

GEOM = dict(max_batch=4, max_seq_len=96, page_size=8, prefill_chunk=8)
SPEC = dict(spec_decode=True, draft_depth=4)


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


def _motif(rng, motif_len=5, reps=3):
    return np.tile(_prompt(rng, motif_len), reps)


class _St:
    """Minimal RequestState stand-in for the proposer cases."""

    def __init__(self, prompt, output=(), rid="r0"):
        class _Req:
            pass
        self.request = _Req()
        self.request.request_id = rid
        self.request.prompt_ids = np.asarray(prompt, np.int32)
        self.output_ids = list(output)


# -- the proposer --------------------------------------------------------------


def _basic_suffix_match():
    p = NgramProposer(depth=4)
    # suffix [1,2,3] matched at position 2 -> continuation [9,8,1,2]
    assert p.propose(_St([1, 2, 3, 9, 8, 1, 2, 3]), 4) == [9, 8, 1, 2]
    assert p.draft_hits == 1


def _longest_ngram_wins():
    p = NgramProposer(depth=2, min_ngram=1, max_ngram=3)
    # [5,6] occurs earlier followed by 7; the bare [6] later followed by 0
    assert p.propose(_St([5, 6, 7, 4, 6, 0, 5, 6]), 2) == [7, 4]


def _miss_returns_empty():
    p = NgramProposer(depth=4)
    assert p.propose(_St([1, 2, 3, 4, 5, 6, 7, 8]), 4) == []
    assert p.draft_misses == 1


def _cap_bounds_draft():
    p = NgramProposer(depth=8)
    st = _St([1, 2, 3, 9, 8, 7, 6, 1, 2, 3])
    assert len(p.propose(st, 2)) == 2
    assert p.propose(st, 0) == []


def _incremental_growth_and_self_match():
    p = NgramProposer(depth=3)
    st = _St([4, 4, 4])
    # the current suffix is never its own match; the longest available
    # continuation wins
    assert p.propose(st, 3) == [4, 4]
    st.output_ids.extend([4, 4])
    assert p.propose(st, 3) == [4, 4, 4]


def _rollback_rebuilds():
    p = NgramProposer(depth=4)
    st = _St([1, 2], output=[3, 1, 2])
    assert p.propose(st, 4) == [3, 1, 2]
    del st.output_ids[1:]          # an isolation rewind truncated output
    assert isinstance(p.propose(st, 4), list)


def _drop_and_lru_bound():
    p = NgramProposer(depth=2, max_requests=2)
    for i in range(4):
        p.propose(_St([1, 2, 1, 2], rid=f"r{i}"), 2)
    assert len(p) == 2
    p.drop("r3")
    assert len(p) == 1
    p.drop("unknown")


def _validation():
    with pytest.raises(ValueError, match="depth"):
        NgramProposer(depth=0)
    with pytest.raises(ValueError, match="min_ngram"):
        NgramProposer(depth=2, min_ngram=3, max_ngram=2)


@pytest.mark.parametrize("case", [
    _basic_suffix_match, _longest_ngram_wins, _miss_returns_empty,
    _cap_bounds_draft, _incremental_growth_and_self_match,
    _rollback_rebuilds, _drop_and_lru_bound, _validation],
    ids=lambda f: f.__name__.strip("_"))
def test_ngram_proposer(case):
    case()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_proposer_drafts_equal_the_reference(seed):
    """Random looping histories grown token by token, with rewinds and
    drops, through both proposers: equal drafts and counters."""
    rng = np.random.default_rng(seed)
    ours, ref = NgramProposer(depth=4), JaxProposer(depth=4)
    for rid in ("a", "b", "c"):
        motif = [int(t) for t in rng.integers(0, 9, int(rng.integers(2, 6)))]
        prompt = motif * 2 + [int(t) for t in rng.integers(0, 9, 3)]
        sts = [_St(prompt, rid=rid) for _ in range(2)]
        for step in range(40):
            cap = int(rng.integers(0, 6))
            assert ours.propose(sts[0], cap) == ref.propose(sts[1], cap)
            tok = int(rng.integers(0, 9)) if rng.random() < 0.3 \
                else motif[step % len(motif)]
            for st in sts:
                st.output_ids.append(tok)
            if step == 25:
                for st in sts:
                    del st.output_ids[10:]
        ours.drop(rid)
        ref.drop(rid)
    assert ours.stats() == ref.stats()


# -- the spec engine -------------------------------------------------------------


@pytest.fixture(scope="module")
def llama_pair():
    pt.seed(0)
    jm = jax_llama("tiny", fused_ops="on")
    tm = params_from_numpy(
        torch_llama("tiny", device="cpu", fused_ops="on"),
        {k: np.asarray(v) for k, v in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def mixed_prompts():
    rng = np.random.default_rng(7)
    return [_motif(rng, 5, 3), _prompt(rng, 3), _prompt(rng, 17),
            _motif(rng, 4, 4), _prompt(rng, 9)]


def _engine(model, **kw):
    return tserving.Engine(model, device="cpu", **{**GEOM, **kw}).warmup()


def _serve(eng, prompts, max_new=16, **kw):
    rids = [eng.add_request(p, max_new_tokens=max_new, **kw)
            for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def _drive(eng, prompts):
    """Staggered arrivals: each prompt joins a running batch one step
    after the last (prefill churn beside verify spans), 16 new tokens."""
    rids = []
    for i, p in enumerate(prompts):
        rids.append(eng.add_request(p, max_new_tokens=16,
                                    request_id=f"s{i}"))
        eng.step()
    out = eng.run()
    return {r: out[r] for r in rids}, dict(zip(rids, prompts))


@pytest.fixture(scope="module")
def baseline(llama_pair, mixed_prompts):
    """The port's spec-off greedy streams for the shared prompt mix."""
    return _serve(_engine(llama_pair[1]), mixed_prompts)


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_spec_engine_matches_jax_spec_engine(family, llama_pair,
                                             mixed_prompts):
    """The port's spec engine against the JAX spec engine (one per
    family, built here once) under staggered traffic, and against the
    port's spec-off engine token for token."""
    jm, tm = llama_pair if family == "llama" else gpt_pair("on")
    jeng = jserving.Engine(jm, **GEOM, **SPEC).warmup()
    jout, prompts = _drive(jeng, mixed_prompts)
    teng = _engine(tm, **SPEC)
    tout, _ = _drive(teng, mixed_prompts)
    exempt = [rid for rid in jout if _near_tie_equal(
        jout[rid], tout[rid],
        lambda rid=rid: _jax_margins(jm, prompts[rid], jout[rid]))
        == "exempt"]
    assert len(exempt) <= 1, exempt
    ts, js = teng.spec_stats(), jeng.spec_stats()
    assert ts["proposed"] > 0 and ts["accepted"] > 0
    if not exempt:
        for key in ("proposed", "accepted", "verifies", "draft_hits"):
            assert ts[key] == js[key], key
    off, _ = _drive(_engine(tm), mixed_prompts)
    assert list(off.values()) == list(tout.values())
    assert teng.kv_blocks_used == 0 and jeng.kv_blocks_used == 0


def test_greedy_identity_and_acceptance(llama_pair, mixed_prompts,
                                        baseline):
    eng = _engine(llama_pair[1], **SPEC)
    eng.margins = {}
    got = _serve(eng, mixed_prompts)
    assert got == baseline
    st = eng.spec_stats()
    assert st["proposed"] > 0 and st["accepted"] > 0
    assert 0.0 < st["accept_rate"] <= 1.0
    # fewer steps than tokens: accepted drafts emit several per step
    assert eng.steps < sum(len(o) for o in got)
    # one margin per emitted token, at the position it came from
    assert sorted(map(len, eng.margins.values())) == \
        sorted(map(len, got))
    assert eng.kv_blocks_used == 0


def test_draft_depth_widens_span(llama_pair):
    tm = llama_pair[1]
    eng = tserving.Engine(tm, device="cpu", **{**GEOM, "prefill_chunk": 2},
                          spec_decode=True, draft_depth=6)
    assert eng.prefill_chunk == 7      # max(chunk, depth + 1)
    assert eng._graph.inputs["tokens"].shape == (4, 7)
    with pytest.raises(ValueError, match="draft_depth"):
        tserving.Engine(tm, device="cpu", **GEOM, spec_decode=True,
                        draft_depth=0)
    with pytest.raises(ValueError, match="draft_depth"):
        tserving.Engine(tm, device="cpu", **GEOM, spec_decode=True,
                        draft_depth=GEOM["max_seq_len"])


def test_one_step_graph_under_hit_miss_churn(llama_pair, mixed_prompts,
                                             monkeypatch):
    """Draft hits and misses, prefill chunks and idle slots all ride the
    ONE step built at construction: on the CPU the step is eager, so
    count the StepGraph builds and preparations, and the output keeps its
    (B, C, V) shape."""
    built, prepared = [], []

    class Counting(engine_mod.StepGraph):
        def __init__(self, *a, **kw):
            built.append(self)
            super().__init__(*a, **kw)

        def _eager(self):
            if not self.ready:
                prepared.append(self)
            return super()._eager()

    monkeypatch.setattr(engine_mod, "StepGraph", Counting)
    eng = _engine(llama_pair[1], **SPEC)
    for p in mixed_prompts:          # staggered: churn
        eng.add_request(p, max_new_tokens=12)
        eng.step()
    eng.run()
    st = eng.spec_stats()
    assert st["draft_hits"] > 0 and st["draft_misses"] > 0
    assert len(built) == 1 and len(prepared) == 1
    assert eng._graph.output.shape == (4, 8, eng.model.cfg.vocab_size)
    assert (eng.captures, eng.replays) == (0, 0)


def test_identity_with_prefix_cache_hits(llama_pair):
    rng = np.random.default_rng(11)
    common = _prompt(rng, 16)                   # 2 full pages
    prompts = [np.concatenate([common, _prompt(rng, t)])
               for t in (5, 9, 3)] + [common]
    base_eng, eng = _engine(llama_pair[1]), _engine(llama_pair[1], **SPEC)
    base = [_serve(base_eng, [p], max_new=8)[0] for p in prompts]
    got = [_serve(eng, [p], max_new=8)[0] for p in prompts]
    assert got == base
    assert eng.prefix_stats()["hits"] > 0
    assert eng.prefix_stats()["cow_copies"] > 0
    assert eng.kv_blocks_used == 0


def test_identity_across_preemption(llama_pair):
    rng = np.random.default_rng(3)
    prompts = [_motif(rng, 5, 3), _prompt(rng, 9)]
    base = _serve(_engine(llama_pair[1], **SPEC), prompts, max_new=14)
    eng = _engine(llama_pair[1], **SPEC)
    rids = [eng.add_request(p, max_new_tokens=14) for p in prompts]
    victim = None
    for _ in range(40):
        eng.step()
        victim = next((st.request.request_id
                       for _, st in eng.scheduler.active()
                       if not st.prefilling and st.output_ids), None)
        if victim is not None:
            break
    # preempt a DECODING slot mid-speculation: the swap round-trips
    # exactly the accepted prefix (kv_len), nothing speculative
    assert victim is not None and eng.preempt(victim)
    eng.run()
    assert [eng.output_ids(r) for r in rids] == base
    assert eng._states[victim].preempts == 1
    assert eng.kv_blocks_used == 0


def test_mid_verify_fault_rolls_back_token_identical(llama_pair,
                                                     mixed_prompts,
                                                     baseline):
    eng = _engine(llama_pair[1], **SPEC)
    inj = trs.install_faults("serve.step@2x2")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = _serve(eng, mixed_prompts)
    finally:
        trs.clear_faults()
    assert len(inj.fired) == 2
    assert got == baseline
    assert sum(s.preempts for s in eng._states.values()) == 2
    assert eng.kv_blocks_used == 0


def test_draft_fault_degrades_not_isolates(llama_pair, mixed_prompts,
                                           baseline):
    """A serve.spec fault costs that slot its draft for the step, never
    the request: no warning, no preemption."""
    eng = _engine(llama_pair[1], **SPEC)
    trs.install_faults("serve.spec@0x3")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            got = _serve(eng, mixed_prompts)
    finally:
        trs.clear_faults()
    assert got == baseline
    assert eng.spec_stats()["errors"] == 3
    assert all(s.preempts == 0 for s in eng._states.values())


def test_temperature_stream_reproducible_spec_on_off(llama_pair):
    """Keys derive per emitted-token index, so the sampled stream does not
    depend on how many tokens each step accepted."""
    p = _prompt(np.random.default_rng(4), 6)
    greedy = _motif(np.random.default_rng(5), 4, 4)

    def streams(spec):
        eng = _engine(llama_pair[1], spec_decode=spec, seed=11)
        r = eng.add_request(p, max_new_tokens=10, temperature=0.9)
        g = eng.add_request(greedy, max_new_tokens=10)
        eng.run()
        return eng.output_ids(r), eng.output_ids(g)

    (a, ga), (b, gb) = streams(False), streams(True)
    assert a == b and ga == gb
    assert len(set(a)) > 1       # actually sampling
    assert (a, ga) == streams(False)


def test_duplicate_prompts_sample_distinct_streams(llama_pair):
    p = _prompt(np.random.default_rng(6), 6)

    def streams():
        eng = _engine(llama_pair[1], seed=3, **SPEC)
        rids = [eng.add_request(p, max_new_tokens=8, temperature=0.9)
                for _ in range(3)]
        eng.run()
        return [eng.output_ids(r) for r in rids]

    a = streams()
    assert a == streams()                  # reproducible per engine
    assert len({tuple(s) for s in a}) > 1  # but not collapsed


def test_temperature_slots_never_draft(llama_pair):
    eng = _engine(llama_pair[1], **SPEC)
    rid = eng.add_request(_motif(np.random.default_rng(8), 4, 4),
                          max_new_tokens=10, temperature=0.8)
    eng.run()
    assert len(eng.output_ids(rid)) == 10
    assert eng.spec_stats()["proposed"] == 0


def test_eos_mid_acceptance_truncates(llama_pair):
    """An accepted draft token that IS the eos finishes the request there,
    as the one-token-at-a-time engine would have stopped."""
    tm = llama_pair[1]
    p = _motif(np.random.default_rng(5), 5, 3)
    ref = _serve(_engine(tm), [p])[0]
    eos = int(ref[len(ref) // 2])
    base = _serve(_engine(tm), [p], eos_token_id=eos)[0]
    got = _serve(_engine(tm, **SPEC), [p], eos_token_id=eos)[0]
    assert got == base and got[-1] == eos


def test_tight_budget_caps_draft(llama_pair):
    rng = np.random.default_rng(9)
    prompts = [_motif(rng, 5, 3), _prompt(rng, 7)]
    base = _serve(_engine(llama_pair[1]), prompts, max_new=2)
    got = _serve(_engine(llama_pair[1], **SPEC), prompts, max_new=2)
    assert got == base and all(len(o) == 2 for o in got)


def test_spec_off_by_default(llama_pair):
    eng = tserving.Engine(llama_pair[1], device="cpu", **GEOM)
    assert eng.spec is None and eng.draft_depth == 0
    assert eng.spec_stats()["proposed"] == 0
    assert eng._graph.inputs["tokens"].shape == (4, 8)


def test_spec_under_mega(llama_pair, mixed_prompts, baseline):
    """Verify spans through the megakernel path: on the CPU the plain
    megakernel is the composition of the "on" path's ops, so the streams
    equal the spec-off "on" engine's."""
    jm = llama_pair[0]
    tm = params_from_numpy(
        torch_llama("tiny", device="cpu", fused_ops="mega"),
        {k: np.asarray(v) for k, v in jm.named_parameters()})
    eng = _engine(tm, **SPEC)
    assert _serve(eng, mixed_prompts) == baseline
    assert eng.spec_stats()["accepted"] > 0
    assert eng.launches_per_step()["mega_decode"] == \
        tm.cfg.num_hidden_layers


def test_launches_per_step_equal_on_and_off(llama_pair, mixed_prompts):
    counts = []
    for kw in ({}, SPEC):
        eng = _engine(llama_pair[1], **kw)
        _serve(eng, mixed_prompts[:2], max_new=4)
        counts.append(eng.launches_per_step())
    assert counts[0] == counts[1]


def test_spec_with_lora_not_ported(llama_pair):
    pool = tserving.LoRAPool(llama_pair[1], max_adapters=2, rank=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserving.Engine(llama_pair[1], device="cpu", **GEOM, lora=pool,
                        **SPEC)
