"""The port's telemetry (``paddle_tpu_torch.observability``: registry,
sinks, spans, request trace, ``SLOCapture``, the ``torch.profiler``
facade) and its serving wiring, held against the JAX package on the CPU:
twins of ``tests/test_trace.py``.

Both sides run the same seeded tiny Llama (``pt.seed(0)``, weights
carried by ``params_from_numpy``), the same traffic and the same injected
clocks, each under its own telemetry session (enabled one after the
other; each scenario disables its own).  Held exactly equal between the
JAX ``Engine``/``FrontDoor`` and the port's: each request's sequence of
trace phases, every counter of the registry and every histogram's
observation count (the names too), admission decisions, and the
timelines of the copied tracer under a fake clock.  Greedy streams are
equal under the near-tie rule of ``test_torch_serving.py``, with the
port engine's own top-2 margins (``TIE`` 1e-3 on f32 logits that agree
to ~1e-5).  Wall-clock readings (ms, tok/s) are never compared across
the packages; the port's timelines must sum exactly (to 1e-9 ms) to
their wall time.

Not twinned: ``test_trace.py``'s replica-set evacuation tests (replica
sets are not ported, ROADMAP.md queue 1 item 10) and its
``trace_export`` unit test on a hand-made event (a test of the tool
alone).
"""

import contextlib
import http.client
import json
import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import observability as jobs
from paddle_tpu import resilience as jrs
from paddle_tpu import serving as jserving
from paddle_tpu.models.llama import llama as jax_llama
from paddle_tpu.observability import sinks as jsinks
from paddle_tpu.observability.trace import RequestTracer as JTracer
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import resilience as trs
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import params_from_numpy
from paddle_tpu_torch.observability import sinks as tsinks
from paddle_tpu_torch.observability.registry import MetricsRegistry
from paddle_tpu_torch.observability.trace import RequestTracer as TTracer
from paddle_tpu_torch.observability.trace import SLOCapture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIE = 1e-3
GEOM = dict(max_batch=2, max_seq_len=64, page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the two sides ------------------------------------------------------------


class Side:
    """One package's serving stack on the shared tiny Llama: its
    ``serving``, ``observability`` and ``resilience`` modules and warmed
    engines, cached per geometry so both sides keep identical histories
    (every scenario drives both the same way)."""

    def __init__(self, name, serving, obs, rs, model, **engine_kw):
        self.name, self.serving, self.obs, self.rs = name, serving, obs, rs
        self.model = model
        self.engine_kw = engine_kw
        self._engines = {}

    @property
    def port(self):
        return self.name == "torch"

    def engine(self, fresh=False, **kw):
        geom = {**GEOM, **kw}
        key = tuple(sorted(geom.items()))
        if fresh or key not in self._engines:
            eng = self.serving.Engine(self.model, **self.engine_kw,
                                      **geom).warmup()
            if fresh:
                return eng
            self._engines[key] = eng
        eng = self._engines[key]
        assert eng.kv_blocks_used == 0 and not eng.has_work()
        if self.port:
            eng.margins = {}
        return eng

    @contextlib.contextmanager
    def telemetry(self, **kw):
        kw.setdefault("sinks", [self.obs.InMemorySink()])
        tel = self.obs.enable(crash_hooks=False, **kw)
        try:
            yield tel
        finally:
            self.obs.disable()


@pytest.fixture(scope="module")
def sides():
    pt.seed(0)
    jm = jax_llama("tiny", fused_ops="on")
    tm = params_from_numpy(
        torch_llama("tiny", device="cpu", fused_ops="on"),
        {k: np.asarray(v) for k, v in jm.named_parameters()})
    return (Side("jax", jserving, jobs, jrs, jm),
            Side("torch", tserving, tobs, trs, tm, device="cpu"))


def prompts(seed, *lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in lens]


def twin(sides, scenario, *args):
    """``scenario(side, *args)`` on the JAX side, then the port's."""
    return [scenario(s, *args) for s in sides]


def streams_equal(ref, got, margins):
    """Greedy streams in submission order, equal under the near-tie rule
    (the port's margin at the first difference below ``TIE``); returns
    the number of requests exempted (at most one)."""
    assert len(ref) == len(got)
    exempt = 0
    for (rr, r), (rg, g) in zip(ref, got):
        r, g = list(r), list(g)
        for i, (a, b) in enumerate(zip(r, g)):
            if a != b:
                assert margins[rg][i] < TIE, (rg, i, margins[rg][i])
                exempt += 1
                break
        else:
            assert len(r) == len(g), (rr, rg)
    assert exempt <= 1
    return exempt


def phases(tl):
    return [e["phase"] for e in tl["events"]]


def assert_exact_sum(tl):
    s = tl["summary"]
    assert abs(s["queue_ms"] + s["prefill_ms"] + s["xfer_ms"]
               + s["decode_ms"] - s["wall_ms"]) < 1e-9, s


def registry_counts(reg):
    """Every counter's value and every histogram's observation count, by
    name: the deterministic part of a registry."""
    out = {}
    for name in reg.names():
        m = reg.get(name)
        kind = type(m).__name__
        if kind == "Counter":
            out[name] = m.snapshot()
        elif kind == "Histogram":
            out[name + "#count"] = m.count
    return out


def gauge_names(reg):
    return {n for n in reg.names() if type(reg.get(n)).__name__ == "Gauge"}


# JAX-only series: the reference's compiled-artifact ledger gauges, which
# the port leaves out (observability.NOT_PORTED, ROADMAP.md item 11)
JAX_ONLY = re.compile(r"serve\.(roofline\.|dispatches_per_step)")


def assert_same_registry(jtel, ttel):
    jc, tc = registry_counts(jtel.registry), registry_counts(ttel.registry)
    assert tc == jc
    jg = {n for n in gauge_names(jtel.registry) if not JAX_ONLY.match(n)}
    assert gauge_names(ttel.registry) == jg


# -- Prometheus exposition (copied sinks.py) ----------------------------------


PROM_NAMES = ["serve.replica[0].free_blocks", "serve.tenant[acme].ttft_ms",
              "span[ckpt.save].ms", "serve.tok_s", "weird-name.with+chars",
              "9lives", "fault[serve.step].count", "serve.shed[quota].count"]


def test_prom_grammar_equals_reference():
    for name in PROM_NAMES:
        assert tsinks.prom_split(name) == jsinks.prom_split(name), name
        assert tsinks.prom_name(name) == jsinks.prom_name(name), name
    assert tsinks.prom_split("serve.replica[0].free_blocks") == \
        ("serve_replica_free_blocks", [("replica", "0")])
    assert tsinks.prom_split("span[ckpt.save].ms") == \
        ("span_ms", [("span", "ckpt.save")])
    name, _ = tsinks.prom_split("weird-name.with+chars")
    assert re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", name)
    assert tsinks.prom_name("9lives") == "_9lives"


def _fill(reg):
    reg.counter("serve.requests").inc(3)
    reg.gauge("serve.replica[0].free_blocks").set(12)
    reg.gauge("serve.replica[1].free_blocks").set(7)
    reg.gauge("serve.broken").set("not-a-number")   # must be skipped
    h = reg.histogram("serve.ttft_ms")
    for v in (10.0, 20.0, 30.0):
        h.observe(v)
    return reg


def test_registry_to_prometheus_valid_and_equal_to_reference():
    from paddle_tpu.observability.registry import \
        MetricsRegistry as JRegistry
    extra = {"serve.live": 1, "serve.requests": 99}
    body = tsinks.registry_to_prometheus(_fill(MetricsRegistry()),
                                         extra=extra)
    assert body == jsinks.registry_to_prometheus(_fill(JRegistry()),
                                                 extra=extra)
    sample = re.compile(
        r"[a-zA-Z_:][a-zA-Z0-9_:]*"
        r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
        r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? -?[0-9.eE+-]+')
    typed = set()
    for line in body.strip().splitlines():
        if line.startswith("# TYPE "):
            typed.add(line.split()[2])
            continue
        assert sample.fullmatch(line), line
        base = re.match(r"[a-zA-Z0-9_:]+", line).group(0)
        assert any(base.startswith(t) for t in typed), line
    assert 'serve_replica_free_blocks{replica="0"} 12' in body
    assert 'serve_ttft_ms{quantile="0.95"} 30.0' in body
    assert "serve_ttft_ms_count 3" in body
    assert "broken" not in body and "serve_live 1" in body
    assert "serve_requests 3" in body and "99" not in body
    body = tsinks.registry_to_prometheus(None, extra={"serve.queue_depth": 2})
    assert "# TYPE serve_queue_depth gauge" in body
    assert "serve_queue_depth 2" in body


# -- the copied tracer under a fake clock -------------------------------------


class Clock:
    def __init__(self):
        self.t = 100.0

    def tick(self, s):
        self.t += s

    def __call__(self):
        return self.t


def _script_phases(T, ctx):
    clk = Clock()
    tr = T(clock=clk)
    tr.begin("r1", tenant="t")
    clk.tick(0.010)
    tr.transition("r1", "prefill", event="admit")
    clk.tick(0.020)
    tr.transition("r1", "decode", event="first_token")
    clk.tick(0.030)
    tr.retire("r1", reason="length", tokens=3)
    s = tr.timeline("r1")["summary"]
    assert (s["queue_ms"], s["prefill_ms"], s["decode_ms"],
            s["wall_ms"]) == (10.0, 20.0, 30.0, 60.0)
    assert s["done"] and s["reason"] == "length"
    return [tr.timeline("r1")]


def _script_preempt(T, ctx):
    clk = Clock()
    tr = T(clock=clk)
    tr.begin("r1")
    clk.tick(0.005)
    tr.transition("r1", "decode", event="admit")
    clk.tick(0.010)
    tr.transition("r1", "queue", event="preempt", reason="pool_pressure")
    clk.tick(0.007)
    tr.transition("r1", "decode", event="admit")
    clk.tick(0.002)
    tr.retire("r1", tokens=1)
    s = tr.timeline("r1")["summary"]
    assert s["queue_ms"] == 12.0 and s["decode_ms"] == 12.0
    assert s["preempts"] == 1
    return [tr.timeline("r1")]


def _script_get_or_create(T, ctx):
    tr = T(clock=Clock())
    a = tr.begin("r1", trace_id="outer")
    b = tr.begin("r1", trace_id="other")
    assert a == b == "outer"
    assert phases(tr.timeline("r1")).count("submit") == 1
    return [tr.timeline("r1")]


def _script_context(T, ctx):
    tr = T(clock=Clock())
    with ctx("ctx-id") as tid:
        assert tid == "ctx-id" and tr.begin("r1") == "ctx-id"
    assert tr.begin("r2").startswith("tr-")     # generated outside
    return [tr.timeline("r1")]


def _script_unknown(T, ctx):
    tr = T(clock=Clock())
    tr.point("ghost", "prefill_chunk")
    tr.transition("ghost", "decode")
    tr.retire("ghost")
    assert tr.timeline("ghost") is None
    return []


def _script_bounded(T, ctx):
    tr = T(max_events=4, clock=Clock())
    tr.begin("r1")
    for _ in range(10):
        tr.point("r1", "prefill_chunk", tokens=1)
    tr.retire("r1", reason="length", tokens=1)
    tl = tr.timeline("r1")
    assert len(tl["events"]) == 5 and tl["events"][-1]["phase"] == "retire"
    assert tl["summary"]["dropped_events"] == 7
    assert tl["summary"]["prefill_chunks"] == 10
    return [tl]


def _script_retention(T, ctx):
    tr = T(capacity=3, clock=Clock())
    for i in range(6):
        tr.begin(f"r{i}", trace_id=f"t{i}")
        tr.retire(f"r{i}")
    assert len(tr) == 3
    assert tr.timeline("r0") is None and tr.timeline("r5") is not None
    return [tr.timeline(f"r{i}") for i in range(3, 6)]


def _script_emit(T, ctx):
    events = []
    tr = T(emit=events.append, clock=Clock())
    tr.begin("r1", tenant="acme", trace_id="t1")
    tr.retire("r1", reason="eos", tokens=2)
    assert len(events) == 1
    ev = events[0]
    assert ev["event"] == "serve_trace" and ev["id"] == "r1"
    assert ev["tenant"] == "acme" and ev["summary"]["done"]
    json.dumps(ev)
    return events


def _script_reused_id(T, ctx):
    events = []
    tr = T(emit=events.append, clock=Clock())
    tr.begin("dup", trace_id="first")
    tr.retire("dup", reason="eos", tokens=1)
    assert tr.begin("dup", trace_id="second") == "second"
    tr.transition("dup", "decode", event="admit")
    tr.retire("dup", reason="length", tokens=2)
    assert [e["trace_id"] for e in events] == ["first", "second"]
    tl = tr.timeline("dup")
    assert tl["trace_id"] == "second" and phases(tl).count("retire") == 1
    tr.point("dup", "prefill_chunk")
    tr.transition("dup", "queue")
    assert phases(tr.timeline("dup"))[-1] == "retire"
    return events + [tr.timeline("dup")]


def _script_find(T, ctx):
    tr = T(clock=Clock())
    with ctx("batch-7"):
        tr.begin("a")
        tr.begin("b")
    assert {t.request_id for t in tr.find("batch-7")} == {"a", "b"}
    return [tr.timeline("a"), tr.timeline("b")]


TRACER_SCRIPTS = {f.__name__[len("_script_"):]: f for f in (
    _script_phases, _script_preempt, _script_get_or_create, _script_context,
    _script_unknown, _script_bounded, _script_retention, _script_emit,
    _script_reused_id, _script_find)}


def _no_wall(x):
    """A timeline or event without its wall-clock anchor ``t0``/``ts``."""
    return {k: v for k, v in x.items() if k not in ("t0", "ts")}


@pytest.mark.parametrize("script", sorted(TRACER_SCRIPTS))
def test_tracer_equals_reference(script):
    """The copied tracer gives the reference's timelines and events, to
    the float, under the same fake clock (only ``t0``, the wall anchor,
    differs)."""
    fn = TRACER_SCRIPTS[script]
    got = fn(TTracer, tobs.trace_context)
    want = fn(JTracer, jobs.trace_context)
    assert [_no_wall(x) for x in got] == [_no_wall(x) for x in want]
    for x in got:
        if "summary" in x:
            assert_exact_sum(x)


# -- SLO capture and the profiler facade --------------------------------------


class FakeProf:
    def __init__(self):
        self.steps = 0
        self.stopped = False

    def step(self):
        self.steps += 1

    def stop(self):
        self.stopped = True


def _seed_ttft(n=10, ms=100.0):
    reg = tobs.get_registry()
    for _ in range(n):
        reg.histogram("serve.ttft_ms").observe(ms)


def test_slo_capture_arms_after_consecutive_breaches(sides, tmp_path):
    profs = []

    def factory(d):
        profs.append((d, FakeProf()))
        return profs[-1][1]

    with sides[1].telemetry() as tel:
        cap = SLOCapture(50.0, str(tmp_path), window_steps=2, windows=2,
                         capture_steps=3, min_samples=4,
                         profiler_factory=factory)
        _seed_ttft()
        for _ in range(3):
            cap.on_step()
        assert not cap.capturing
        cap.on_step()
        assert cap.capturing and len(profs) == 1
        for _ in range(3):
            cap.on_step()
        assert not cap.capturing and profs[0][1].stopped
        assert profs[0][1].steps == 3 and cap.captures == [profs[0][0]]
        evs = tel.sinks[0].events("serve_slo_capture")
        assert [e["state"] for e in evs] == ["armed", "done"]
        assert evs[1]["trace_dir"] == profs[0][0]
        assert tel.registry.snapshot()["serve.slo_captures"] == 1


def test_slo_capture_healthy_window_resets_and_never_without_signal(
        sides, tmp_path):
    made = []
    with sides[1].telemetry():
        cap = SLOCapture(50.0, str(tmp_path), window_steps=1, windows=2,
                         capture_steps=1, max_captures=1, min_samples=2,
                         profiler_factory=lambda d: (made.append(d)
                                                     or FakeProf()))
        quiet = SLOCapture(50.0, str(tmp_path), window_steps=1, windows=1,
                           min_samples=8, profiler_factory=lambda d: 1 / 0)
        for _ in range(10):
            quiet.on_step()              # no ttft observations at all
        assert not quiet.capturing and not quiet.captures
        _seed_ttft(ms=100.0)
        cap.on_step()                    # breach 1
        _seed_ttft(n=512, ms=1.0)
        cap.on_step()                    # healthy: reset
        _seed_ttft(n=512, ms=100.0)
        cap.on_step()                    # breach 1 again
        assert not cap.capturing
        cap.on_step()                    # breach 2: armed
        cap.on_step()                    # capture step: done
        for _ in range(8):
            cap.on_step()                # max_captures=1
        assert len(made) == 1 and len(cap.captures) == 1


def test_slo_capture_engine_wiring_fake_profiler(sides, tmp_path):
    """Every non-empty step of the port engine ticks its SLOCapture: a
    1e-9 ms threshold arms after the first TTFT and the capture counts
    down through the next two steps."""
    profs = []
    cap = SLOCapture(1e-9, str(tmp_path), window_steps=1, windows=1,
                     capture_steps=2, min_samples=1,
                     profiler_factory=lambda d: profs.append(FakeProf())
                     or profs[-1])
    eng = sides[1].serving.Engine(sides[1].model, device="cpu",
                                  slo_capture=cap, **GEOM).warmup()
    with sides[1].telemetry():
        eng.add_request(prompts(1, 12)[0], max_new_tokens=6)
        eng.run()
    assert profs and profs[0].stopped and profs[0].steps == 2
    assert len(cap.captures) == 1 and eng.captures == 0


def _trace_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_windowed_profiler_writes_a_torch_trace_on_cpu(tmp_path):
    """The facade's window: ``steps`` steps recorded, then a chrome trace
    of ``torch.profiler`` written into ``trace_dir``, naming the host
    scopes (RecordEvent) and the ops that ran inside the window."""
    from paddle_tpu_torch.profiler import (RecordEvent, _active_profilers,
                                           windowed_profiler)
    d = tmp_path / "w"
    prof = windowed_profiler(str(d), steps=2)
    assert _active_profilers == [prof]
    try:
        for _ in range(2):
            with RecordEvent("my.scope"):
                torch.mm(torch.ones(8, 8), torch.ones(8, 8))
            prof.step()
    finally:
        prof.stop()
    assert _active_profilers == []
    assert prof.traces == [str(d / "torch_trace_0.json")]
    names = _trace_names(prof.traces[0])
    assert "my.scope" in names and "aten::mm" in names
    host = str(tmp_path / "host.json")
    prof.export(host)
    assert {"my.scope", "ProfileStep#0"} <= _trace_names(host)


def test_slo_capture_default_profiler_traces_the_engine(sides, tmp_path):
    """The default factory on the port engine: the capture arms, a
    ``torch.profiler`` trace of the next steps lands in its directory and
    names the step's spans and ops; nothing is captured on the CPU."""
    cap = SLOCapture(1e-9, str(tmp_path), window_steps=1, windows=1,
                     capture_steps=2, min_samples=1)
    eng = sides[1].serving.Engine(sides[1].model, device="cpu",
                                  slo_capture=cap, **GEOM).warmup()
    with sides[1].telemetry() as tel:
        eng.add_request(prompts(2, 12)[0], max_new_tokens=5)
        eng.run()
        evs = tel.sinks[0].events("serve_slo_capture")
    assert [e["state"] for e in evs] == ["armed", "done"]
    d = cap.captures[0]
    files = sorted(os.listdir(d))
    assert files == ["torch_trace_0.json"], files
    names = _trace_names(os.path.join(d, files[0]))
    assert {"serve.step", "serve.step.finish"} <= names
    assert any(n and n.startswith("aten::") for n in names)


# -- engine lifecycle tracing: twins ------------------------------------------


def _lifecycle(side, fresh=False):
    eng = side.engine(fresh=fresh)
    p = prompts(10, 20, 5)
    with side.telemetry() as tel:
        rids = [eng.add_request(p[0], max_new_tokens=4, tenant="acme"),
                eng.add_request(p[1], max_new_tokens=3)]
        outs = eng.run()
        tr = side.obs.get_request_tracer()
        assert tr is tel.tracer is not None
        tls = [tr.timeline(r) for r in rids]
        n_traces = len(tel.sinks[0].events("serve_trace"))
    return dict(tel=tel, tls=tls, outs=[(r, outs[r]) for r in rids],
                n_traces=n_traces, eng=eng)


def _trace_id(side):
    eng = side.engine()
    with side.telemetry() as tel:
        with side.obs.trace_context("client-abc"):
            rid = eng.add_request(prompts(11, 6)[0], max_new_tokens=2)
        outs = eng.run()
        tl = side.obs.get_request_tracer().timeline(rid)
        assert tl["trace_id"] == "client-abc"
        assert eng._states[rid].request.trace_id == "client-abc"
    return dict(tel=tel, tls=[tl], outs=[(rid, outs[rid])], eng=eng)


def _preempt_restore(side):
    eng = side.engine()
    with side.telemetry() as tel:
        rid = eng.add_request(prompts(12, 12)[0], max_new_tokens=8)
        eng.step()
        eng.step()
        tr = side.obs.get_request_tracer()
        tid = tr.timeline(rid)["trace_id"]
        assert eng.preempt(rid, reason="operator")
        outs = eng.run()
        tl = tr.timeline(rid)
        assert tl["trace_id"] == tid
        pre = tel.sinks[0].events("serve_preempt")
    assert [e["reason"] for e in pre] == ["operator"]
    assert [e.get("reason") for e in tl["events"]
            if e["phase"] == "preempt"] == ["operator"]
    return dict(tel=tel, tls=[tl], outs=[(rid, outs[rid])], eng=eng)


def _isolated(side):
    eng = side.engine()
    with side.telemetry() as tel:
        rid = eng.add_request(prompts(13, 5)[0], max_new_tokens=3)
        side.rs.install_faults("serve.step@0")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                outs = eng.run()
        finally:
            side.rs.clear_faults()
        tl = side.obs.get_request_tracer().timeline(rid)
    assert "isolated" in phases(tl)
    return dict(tel=tel, tls=[tl], outs=[(rid, outs[rid])], eng=eng)


def _prefix_cow(side):
    """A 16-token prompt served to the end, then the same prompt twice
    (fully cached: both copy-on-write their last page in one step) and a
    longer one sharing its two pages: prefix hits, misses, CoW copies."""
    eng = side.engine()
    base, tail = prompts(20, 16, 7)
    with side.telemetry() as tel:
        rids = [eng.add_request(base, max_new_tokens=3)]
        outs = eng.run()
        rids += [eng.add_request(base, max_new_tokens=4),
                 eng.add_request(base, max_new_tokens=5),
                 eng.add_request(np.concatenate([base, tail]),
                                 max_new_tokens=3)]
        outs.update(eng.run())
        tr = side.obs.get_request_tracer()
        tls = [tr.timeline(r) for r in rids]
        snap = tel.registry.snapshot()
    assert snap["serve.prefix_hits"] >= 4 and snap["serve.cow_copies"] >= 2
    return dict(tel=tel, tls=tls, outs=[(r, outs[r]) for r in rids],
                eng=eng)


def _tracing_off(side):
    eng = side.engine()
    with side.telemetry(request_tracing=False) as tel:
        assert side.obs.get_request_tracer() is None
        rid = eng.add_request(prompts(14, 5)[0], max_new_tokens=2)
        outs = eng.run()
        assert eng._states[rid].request.trace_id is None
        assert not tel.sinks[0].events("serve_trace")
        assert "serve.queue_ms" not in tel.registry.snapshot()
    return dict(tel=tel, tls=[], outs=[(rid, outs[rid])], eng=eng)


ENGINE_SCENARIOS = {"lifecycle": _lifecycle, "trace_id": _trace_id,
                    "preempt_restore": _preempt_restore,
                    "isolated_failure": _isolated,
                    "prefix_cow": _prefix_cow, "tracing_off": _tracing_off}


@pytest.mark.parametrize("name", list(ENGINE_SCENARIOS))
def test_engine_tracing_equals_reference(sides, name):
    """The same traffic through both engines under telemetry: equal
    streams (near-tie rule), equal trace phase sequences per request,
    equal counters and histogram counts, and on the port every timeline
    sums exactly to its wall time with submit/first_token/retire exactly
    once (admit once per queue episode)."""
    j, t = twin(sides, ENGINE_SCENARIOS[name])
    streams_equal(j["outs"], t["outs"], t["eng"].margins)
    assert [phases(x) for x in t["tls"]] == [phases(x) for x in j["tls"]]
    assert_same_registry(j["tel"], t["tel"])
    for tl in t["tls"]:
        ph = phases(tl)
        for once in ("submit", "first_token", "retire"):
            assert ph.count(once) == 1, (once, ph)
        assert ph.count("admit") == 1 + tl["summary"]["preempts"]
        assert ph.index("submit") < ph.index("admit") \
            < ph.index("first_token") < ph.index("retire")
        assert_exact_sum(tl)
        assert tl["summary"]["done"]


def test_lifecycle_details(sides):
    """``test_trace.py``'s lifecycle specifics on the port: prefill
    chunks, phase histograms, per-tenant aggregates, one serve_trace per
    retired request, and a decode token count per output."""
    t = _lifecycle(sides[1], fresh=True)
    assert t["tls"][0]["summary"]["prefill_chunks"] == 3
    for tl, (_, out) in zip(t["tls"], t["outs"]):
        assert tl["summary"]["decode_tokens"] == len(out)
    snap = t["tel"].registry.snapshot()
    assert snap["serve.queue_ms"]["count"] >= 2
    assert snap["serve.prefill_ms"]["count"] == 2
    assert snap["serve.decode_ms_per_token"]["count"] == 2
    assert snap["serve.tenant[acme].ttft_ms"]["count"] == 1
    assert snap["serve.tenant[acme].queue_ms"]["count"] >= 1
    assert snap["serve.ttft_ms"]["count"] == 2
    assert t["n_traces"] == 2


def test_hbm_gauges_at_warmup(sides):
    """An engine warmed under telemetry publishes ``hbm_stats()`` as the
    reference's ``serve.hbm.*`` gauges (the port's leaves out the
    ledger's roofline and dispatch gauges)."""
    with sides[1].telemetry() as tel:
        eng = sides[1].engine(fresh=True)
        snap = tel.registry.snapshot()
    for k, v in eng.hbm_stats().items():
        assert snap[f"serve.hbm.{k}"] == v
    assert not any(JAX_ONLY.match(n) for n in snap)
    assert snap["span[serve.warmup].ms"]["count"] == 1


def test_enable_leaves_not_ported_parts_out(sides):
    """``enable()`` takes the reference's arguments; the parts whose
    machinery the port lacks install nothing."""
    assert tobs.NOT_PORTED == ("step_monitor", "recompile_sentinel",
                               "compiled_ledger", "collectives")
    import inspect
    assert list(inspect.signature(tobs.enable).parameters) == \
        list(inspect.signature(jobs.enable).parameters)
    from paddle_tpu_torch.observability import _state
    with sides[1].telemetry(step_monitor=True, recompile_sentinel=True,
                            compiled_ledger=True, collectives=True) as tel:
        assert (tel.monitor, tel.sentinel, tel.ledger) == (None, None, None)
        assert tobs.get_ledger() is None and tobs.enabled()
        assert (_state.MONITOR[0], _state.COLLECTIVE[0],
                _state.LEDGER[0]) == (None, None, None)
        assert tobs.get_request_tracer() is tel.tracer
    assert not tobs.enabled() and _state.EMIT[0] is None


def test_faults_feed_the_registry(sides):
    """``resilience.faults`` bumps the reference's ``fault[<site>].count``
    and ``retry`` counters into the port's registry (never raising)."""
    eng = sides[1].engine()
    with sides[1].telemetry() as tel:
        rid = eng.add_request(prompts(15, 12)[0], max_new_tokens=6)
        eng.step()
        eng.step()
        trs.install_faults("serve.swap@0")
        try:
            assert eng.preempt(rid)
        finally:
            trs.clear_faults()
        eng.run()
        snap = tel.registry.snapshot()
    assert snap["fault[serve.swap].count"] == 1
    assert snap["retry[serve.swap].count"] == 1 and snap["retry.count"] == 1


# -- the front door under telemetry: twins ------------------------------------


def _slo_exemption(side):
    eng = side.engine()
    with side.telemetry() as tel:
        door = side.serving.FrontDoor(eng, policies={
            "lo": side.serving.TenantPolicy(priority=0),
            "ok": side.serving.TenantPolicy(priority=0)},
            slo_ttft_p95_ms=50.0)
        reg = tel.registry
        for _ in range(4):
            reg.histogram("serve.ttft_ms").observe(500.0)
            reg.histogram("serve.tenant[ok].ttft_ms").observe(1.0)
            reg.histogram("serve.tenant[lo].ttft_ms").observe(500.0)
        p = prompts(16, 3, 3, 3, 3)
        adm = [door.submit(p[0], tenant="ok", max_new_tokens=2),
               door.submit(p[1], tenant="lo", max_new_tokens=2),
               door.submit(p[2], tenant="new", max_new_tokens=2)]
        for _ in range(512):
            reg.histogram("serve.ttft_ms").observe(1.0)
        adm.append(door.submit(p[3], tenant="lo", max_new_tokens=2))
        outs = door.run()
    return dict(tel=tel, adm=[(a.admitted, a.reason) for a in adm],
                outs=[(a.request_id, outs[a.request_id]) for a in adm
                      if a.admitted], eng=eng)


def _pump_shed(side):
    eng = side.engine()
    with side.telemetry() as tel:
        door = side.serving.FrontDoor(eng)
        orig = eng.add_request

        def boom(*a, **kw):
            eng.add_request = orig           # refuse exactly once
            raise side.serving.AdmissionError("id raced")

        eng.add_request = boom
        a = door.submit(prompts(17, 5)[0], max_new_tokens=2)
        assert a.admitted
        tr = side.obs.get_request_tracer()
        t = tr.get(a.request_id)
        assert t is not None and t.done and t.finish_reason == "shed"
        sheds = tel.sinks[0].events("serve_shed")
        assert sheds
        door.run()
        tl = tr.timeline(a.request_id)
    return dict(tel=tel, adm=[(a.admitted, a.reason)], outs=[], eng=eng,
                tls=[tl], sheds=[(e["tenant"], e["reason"]) for e in sheds])


@pytest.mark.parametrize("scenario", [_slo_exemption, _pump_shed],
                         ids=["slo_exemption", "pump_shed"])
def test_frontdoor_tracing_equals_reference(sides, scenario):
    j, t = twin(sides, scenario)
    assert t["adm"] == j["adm"]
    streams_equal(j["outs"], t["outs"], t["eng"].margins)
    assert_same_registry(j["tel"], t["tel"])
    if scenario is _slo_exemption:
        assert t["adm"] == [(True, None), (False, "slo_shed"),
                            (False, "slo_shed"), (True, None)]
    else:
        assert t["sheds"] == j["sheds"]
        assert [phases(x) for x in t["tls"]] == [phases(x) for x in j["tls"]]


# -- HTTP surfaces ------------------------------------------------------------


@contextlib.contextmanager
def serving_server(side, eng, **kw):
    srv = side.serving.ServingServer(eng, poll_s=0.001, **kw)
    host, port = srv.start()
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        yield srv, conn
    finally:
        conn.close()
        srv.close()


def post(conn, body, headers=None):
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def get(conn, path):
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, r.getheader("Content-Type"), r.read().decode()


def prom_families(body):
    return {line.split()[2] for line in body.splitlines()
            if line.startswith("# TYPE ")}


def _http_metrics(side):
    eng = side.engine()
    p = prompts(18, 4)[0]
    with side.telemetry() as tel, serving_server(side, eng) as (srv, conn):
        status, out = post(conn, {"prompt": p.tolist(), "max_tokens": 3},
                           headers={"X-Trace-Id": "edge-42"})
        assert status == 200
        rid = out["id"]
        s, _, tl = get(conn, f"/v1/requests/{rid}")
        assert s == 200
        tl = json.loads(tl)
        s, _, _ = get(conn, "/v1/requests/no-such")
        assert s == 404
        s, ctype, body = get(conn, "/metrics")
        assert s == 200 and "text/plain" in ctype
    return dict(tel=tel, tls=[tl], eng=eng, body=body,
                outs=[(rid, out["choices"][0]["token_ids"])])


def test_http_metrics_and_timeline_equal_reference(sides):
    """``POST /v1/completions`` with ``X-Trace-Id`` through both servers:
    the same tokens, the timeline carries the caller's id and the same
    phases, and ``/metrics`` exposes the same metric families (less the
    reference's ledger gauges) with the same counter samples."""
    j, t = twin(sides, _http_metrics)
    streams_equal(j["outs"], t["outs"], t["eng"].margins)
    tl = t["tls"][0]
    assert tl["trace_id"] == "edge-42"
    assert phases(tl) == phases(j["tls"][0])
    assert_exact_sum(tl)
    jf = {f for f in prom_families(j["body"])
          if not f.startswith(("serve_roofline", "serve_dispatches"))}
    assert prom_families(t["body"]) == jf
    assert "# TYPE serve_ttft_ms summary" in t["body"]
    assert "serve_requests 1" in t["body"]
    assert re.search(r"serve_queue_ms_count \d+", t["body"])
    assert_same_registry(j["tel"], t["tel"])


def test_http_without_telemetry(sides):
    eng = sides[1].engine()
    with serving_server(sides[1], eng) as (srv, conn):
        s, _, body = get(conn, "/metrics")
        assert s == 200 and "serve_queue_depth 0" in body
        s, _, body = get(conn, "/v1/requests/x")
        assert s == 503 and "tracing_disabled" in body


# -- the repo's tools over the port's JSONL -----------------------------------


def _jsonl(side, path):
    eng = side.engine()
    with side.telemetry(sinks=None, jsonl_path=path):
        for p, tenant in zip(prompts(19, 12, 5), ("acme", "bob")):
            eng.add_request(p, max_new_tokens=3, tenant=tenant)
            eng.step()
        eng.run()
    return path


def _tool(name, *args):
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", name),
                        *args], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout


@pytest.fixture(scope="module")
def jsonl_pair(sides, tmp_path_factory):
    d = tmp_path_factory.mktemp("jsonl")
    return [_jsonl(s, str(d / f"{s.name}.jsonl")) for s in sides]


def test_trace_export_folds_port_like_reference(jsonl_pair, tmp_path):
    """``tools/trace_export.py`` (unchanged) over the port's file: the
    same request count and the same slices and markers as over the JAX
    engine's file for the same traffic."""
    folds = []
    for path in jsonl_pair:
        out = str(tmp_path / (os.path.basename(path) + ".trace.json"))
        summary = json.loads(_tool("trace_export.py", path, "-o", out)
                             .strip().splitlines()[-1])
        with open(out) as f:
            evs = json.load(f)["traceEvents"]
        tracks = {e["args"]["name"] for e in evs
                  if e.get("ph") == "M" and e["name"] == "thread_name"}
        slices = sorted(e["name"] for e in evs if e["ph"] == "X")
        marks = sorted(e["name"] for e in evs if e["ph"] == "i")
        for e in evs:
            if e["ph"] == "X":
                assert e["dur"] >= 0 and {"pid", "tid", "ts"} <= set(e)
        folds.append((summary["requests"], len(tracks), slices, marks))
    assert folds[1] == folds[0]
    assert folds[1][0] == 2 and {"queue", "prefill", "decode"} <= \
        set(folds[1][2]) and "prefill_chunk" in folds[1][3]


def test_telemetry_report_folds_port_like_reference(jsonl_pair):
    """``tools/telemetry_report.py --json`` (unchanged) over both files:
    the same phase counts, tenants, trace counts and serving counters;
    the table mode renders the request-phase and tenant tables."""
    sums = [json.loads(_tool("telemetry_report.py", p, "--json")
                       .strip().splitlines()[-1]) for p in jsonl_pair]
    j, t = sums
    for k in ("queue_ms", "prefill_ms", "decode_ms", "decode_ms_per_token",
              "wall_ms"):
        assert t["trace_phases"][k]["n"] == j["trace_phases"][k]["n"] == 2
        assert t["trace_phases"][k]["p50"] is not None
    assert set(t["trace_tenants"]) == set(j["trace_tenants"]) == \
        {"acme", "bob"}
    for ten in ("acme", "bob"):
        assert t["trace_tenants"][ten]["traces"] == \
            j["trace_tenants"][ten]["traces"] == 1
        assert t["trace_tenants"][ten]["ttft_p95"] is not None
    for k in ("requests", "finished", "tokens", "preempts", "restores"):
        if k in j["serving"]:
            assert t["serving"][k] == j["serving"][k], k
    out = _tool("telemetry_report.py", jsonl_pair[1])
    assert "Request phase" in out and "| Tenant |" in out
