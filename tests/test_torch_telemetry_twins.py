"""The port's copied telemetry modules held against the reference's, one
unit at a time, on the CPU: ``observability/aggregate.py``
(``HistogramSketch``, ``registry_to_wire``, ``fleet_fold``,
``stitch_trace_segments``), ``registry.py``, ``sinks.py`` (``_jsonable``,
the Prometheus grammar, ``JsonlSink``/``StdoutSink``),
``flight_recorder.py``, ``spans.py``, ``watchdog.py`` and
``launch/preempt.py``.

The copies promise the reference's names, events, metric names and wire
formats, so a dashboard, a fleet controller or ``tools/`` reads both.
The same inputs, made from a seed with numpy, go through both packages
and the outputs are held equal exactly: the copies run the same pure
Python arithmetic, so no tolerance applies.  The one exception is a
sketch's ``sum`` after a merge, whose float additions run in another
order than the whole stream's (relative 1e-12).  Wall-clock fields
(``ts``, ``ms``, ``pid``, thread stacks) are dropped before comparing.
Sketch wire dicts cross the packages both ways, as a fleet of mixed
workers would send them.
"""

import io
import json
import math
import signal

import numpy as np
import pytest
import torch

from paddle_tpu import observability as jobs
from paddle_tpu.launch import preempt as jpreempt
from paddle_tpu.observability import _state as jstate
from paddle_tpu.observability import aggregate as jagg
from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import registry as jreg
from paddle_tpu.observability import sinks as jsinks
from paddle_tpu.observability import spans as jspans
from paddle_tpu.observability import watchdog as jwd
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.launch import preempt as tpreempt
from paddle_tpu_torch.observability import _state as tstate
from paddle_tpu_torch.observability import aggregate as tagg
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import registry as treg
from paddle_tpu_torch.observability import sinks as tsinks
from paddle_tpu_torch.observability import spans as tspans
from paddle_tpu_torch.observability import watchdog as twd

PCTS = (0, 1, 5, 25, 50, 75, 90, 95, 99, 100)


def _stream(name, seed=0, n=500):
    rng = np.random.default_rng(seed)
    return {
        "lognormal": lambda: rng.lognormal(1.0, 1.5, n),
        "uniform": lambda: rng.uniform(0.0, 1.0, n),
        "exponential": lambda: rng.exponential(40.0, n),
        "constant": lambda: np.full(n, 3.25),
        "tiny": lambda: rng.uniform(0.0, 1.0, n) * 1e-6,
        "huge": lambda: rng.uniform(1.0, 9.0, n) * 1e9,
        "signed": lambda: np.concatenate(
            [rng.normal(0.0, 5.0, n - 2), [0.0, -0.0]]),
        "integers": lambda: rng.integers(0, 1000, n).astype(float),
    }[name]().tolist()


STREAMS = ("lognormal", "uniform", "exponential", "constant", "tiny",
           "huge", "signed", "integers")


def _sketch(mod, values):
    sk = mod.HistogramSketch()
    for v in values:
        sk.observe(v)
    return sk


def _percentiles(sk):
    return [sk.percentile(p) for p in PCTS]


def _no_wall(ev, drop=("ts", "ms", "pid")):
    return {k: v for k, v in ev.items() if k not in drop}


# -- HistogramSketch ----------------------------------------------------------


@pytest.mark.parametrize("stream", STREAMS)
def test_sketch_equals_reference(stream):
    xs = _stream(stream)
    j, t = _sketch(jagg, xs), _sketch(tagg, xs)
    assert t.to_dict() == j.to_dict()
    assert _percentiles(t) == _percentiles(j)
    assert t.snapshot() == j.snapshot()
    assert (t.count, t.sum) == (j.count, j.sum)
    assert tagg.NUM_BUCKETS == jagg.NUM_BUCKETS
    assert tagg.BUCKETS_PER_DECADE == jagg.BUCKETS_PER_DECADE


@pytest.mark.parametrize("stream", STREAMS)
def test_sketch_merge_equals_whole_stream(stream):
    """Merging the sketches of two halves gives the sketch of the whole
    stream (the fleet fold's premise), and the port merges as the
    reference does."""
    xs = _stream(stream, seed=1)
    half = len(xs) // 3
    whole = _sketch(tagg, xs)
    t = _sketch(tagg, xs[:half]).merge(_sketch(tagg, xs[half:]))
    j = _sketch(jagg, xs[:half]).merge(_sketch(jagg, xs[half:]))
    tw, ww = t.to_dict(), whole.to_dict()
    assert {k: tw[k] for k in ("count", "min", "max", "buckets")} == \
        {k: ww[k] for k in ("count", "min", "max", "buckets")}
    assert math.isclose(tw["sum"], ww["sum"], rel_tol=1e-12, abs_tol=1e-12)
    assert _percentiles(t) == _percentiles(whole)
    assert t.to_dict() == j.to_dict()
    assert _percentiles(t.copy()) == _percentiles(j.copy())


@pytest.mark.parametrize("stream", STREAMS)
def test_sketch_wire_crosses_packages(stream):
    """A sketch's JSON wire from either package reads back in the other
    with the same buckets, bounds and percentiles."""
    xs = _stream(stream, seed=2)
    j, t = _sketch(jagg, xs), _sketch(tagg, xs)
    j_wire = json.loads(json.dumps(j.to_dict()))
    t_wire = json.loads(json.dumps(t.to_dict()))
    t_from_j = tagg.HistogramSketch.from_dict(j_wire)
    j_from_t = jagg.HistogramSketch.from_dict(t_wire)
    assert t_from_j.to_dict() == j.to_dict()
    assert j_from_t.to_dict() == t.to_dict()
    assert _percentiles(t_from_j) == _percentiles(j)
    assert _percentiles(j_from_t) == _percentiles(t)


FOREIGN = {
    "no_bounds": {"count": 3, "sum": 6.0, "buckets": {"40": 3}},
    "bad_buckets": {"count": 2, "sum": 1.0, "min": 0.5, "max": 0.9,
                    "buckets": {"-1": 2, "99999": 1, "5": 0, "7": -3,
                                "10": 2}},
    "empty": {},
    "all_none": {"count": None, "sum": None, "min": None, "max": None,
                 "buckets": None},
    "edges": {"count": 4, "sum": 1e12, "min": 1e-9, "max": 5e11,
              "buckets": {"0": 2, "LAST": 2}},
}


@pytest.mark.parametrize("case", list(FOREIGN))
def test_sketch_from_foreign_wire_equals_reference(case):
    wire = json.loads(json.dumps(FOREIGN[case]).replace(
        "LAST", str(jagg.NUM_BUCKETS - 1)))
    j = jagg.HistogramSketch.from_dict(wire)
    t = tagg.HistogramSketch.from_dict(wire)
    assert t.to_dict() == j.to_dict()
    assert _percentiles(t) == _percentiles(j)
    assert t.snapshot() == j.snapshot()


# -- registry -----------------------------------------------------------------


@pytest.mark.parametrize("window,stream", [
    (1, "lognormal"), (10, "integers"), (10, "constant"),
    (512, "exponential"), (512, "signed"), (2048, "uniform")])
def test_registry_histogram_equals_reference(window, stream):
    xs = _stream(stream, seed=3, n=700)
    j = jreg.MetricsRegistry().histogram("h", window=window)
    t = treg.MetricsRegistry().histogram("h", window=window)
    for v in xs:
        j.observe(v)
        t.observe(v)
    assert t.snapshot() == j.snapshot()
    assert [t.percentile(p) for p in PCTS] == \
        [j.percentile(p) for p in PCTS]
    assert (t.count, t.sum) == (j.count, j.sum)
    assert t.sketch.to_dict() == j.sketch.to_dict()


@pytest.mark.parametrize("first,second", [
    ("counter", "gauge"), ("gauge", "histogram"), ("histogram", "counter")])
def test_registry_kinds_equal_reference(first, second):
    """A name keeps its first kind in both packages: asking for another
    raises the same TypeError; counters and gauges read as the
    reference's."""
    msgs = []
    for mod in (jreg, treg):
        reg = mod.MetricsRegistry()
        getattr(reg, first)("x")
        with pytest.raises(TypeError) as e:
            getattr(reg, second)("x")
        msgs.append(str(e.value))
        reg.counter("c").inc()
        reg.counter("c").inc(41)
        reg.gauge("g").set(3.5)
        assert reg.counter("c").value == 42 and reg.gauge("g").value == 3.5
        assert reg.names() == sorted(["x", "c", "g"])
    assert msgs[0] == msgs[1]


class _Sketchless:
    """A histogram without a mergeable sketch (a foreign metric)."""

    def observe(self, v):
        pass

    def snapshot(self):
        return {"count": 0, "sum": 0.0}


def _random_registry(mod, seed):
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    for i in range(int(rng.integers(2, 6))):
        reg.counter(f"serve.c{i}").inc(int(rng.integers(0, 100)))
    for i in range(int(rng.integers(1, 4))):
        reg.gauge(f"serve.g{i}").set(float(rng.normal()))
    reg.gauge("serve.flag").set(bool(seed % 2))
    reg.gauge("serve.label").set("not a number")
    reg.gauge("serve.unset")
    for i in range(int(rng.integers(1, 4))):
        h = reg.histogram(f"serve.h{i}[tenant=t{i}]", window=16)
        for v in rng.lognormal(2.0, 1.0, int(rng.integers(1, 60))):
            h.observe(float(v))
    reg._metrics["serve.foreign"] = _Sketchless()
    return reg


@pytest.mark.parametrize("seed", range(4))
def test_registry_to_wire_equals_reference(seed):
    j = jagg.registry_to_wire(_random_registry(jreg, seed))
    t = tagg.registry_to_wire(_random_registry(treg, seed))
    assert t == j
    assert json.loads(json.dumps(t)) == t
    assert "serve.foreign" not in t and "serve.label" not in t


# -- the fleet fold -----------------------------------------------------------


def _fleet_snapshots(seed):
    """Per-worker wire snapshots as a controller reads them, made with
    the reference's sketches (the input is plain JSON to both folds)."""
    rng = np.random.default_rng(seed)
    names = ["serve.tokens", "serve.ttft_ms", "serve.queue_depth",
             "serve.tenant[acme].requests", "weird name,[x]=1"]
    snaps = {}
    for w in range(int(rng.integers(2, 6))):
        metrics = {}
        for name in names:
            kind = ("counter", "gauge", "sketch", "gauge", "counter")[
                names.index(name)]
            if rng.random() < 0.2:
                continue
            if kind == "counter":
                metrics[name] = {"kind": kind,
                                 "value": int(rng.integers(0, 1000))}
            elif kind == "gauge":
                v = float(rng.normal(10.0, 3.0))
                metrics[name] = {"kind": kind,
                                 "value": True if rng.random() < 0.1 else v}
            else:
                sk = _sketch(jagg, rng.lognormal(3.0, 1.0, 40).tolist())
                metrics[name] = {"kind": kind, **sk.to_dict()}
        role = ("prefill", "decode", None)[w % 3]
        snaps[f"w{w}"] = {"role": role, "metrics": metrics}
    return json.loads(json.dumps(snaps))


@pytest.mark.parametrize("seed", range(4))
def test_fleet_fold_equals_reference(seed):
    snaps = _fleet_snapshots(seed)
    j, t = jagg.fleet_fold(snaps), tagg.fleet_fold(snaps)
    assert t.names() == j.names()
    assert t.snapshot() == j.snapshot()
    assert tsinks.registry_to_prometheus(t) == \
        jsinks.registry_to_prometheus(j)


# -- cross-host trace stitching -----------------------------------------------


def _segment(worker, role, t0, off, wall, rid="r0", **phases):
    summary = {"wall_ms": wall, "reason": "stop", "decode_tokens": 4,
               **phases}
    return {"id": rid, "trace_id": "tr-1", "tenant": "acme",
            "worker": worker, "role": role, "epoch": 1, "t0": t0,
            "clock_offset": off, "summary": summary,
            "events": [{"event": "admit", "t": 0.0},
                       {"event": "retire", "t": wall}]}


STITCH = {
    "empty": [],
    "single": [_segment("p0", "prefill", 100.0, 0.0, 12.5,
                        queue_ms=2.0, prefill_ms=10.5)],
    "handoff_gap": [
        _segment("p0", "prefill", 100.0, 0.25, 12.0, queue_ms=1.0,
                 prefill_ms=11.0),
        _segment("d0", "decode", 100.30, 0.0, 40.0, decode_ms=40.0)],
    "overlap_skew": [
        _segment("p0", "prefill", 100.0, 0.0, 50.0, prefill_ms=50.0),
        _segment("d0", "decode", 100.01, 0.0, 20.0, decode_ms=20.0)],
    "unsorted_three": [
        _segment("d1", "decode", 200.5, 0.1, 30.0, decode_ms=30.0),
        _segment("p1", "prefill", 200.0, 0.0, 5.0, prefill_ms=5.0),
        _segment("d0", "decode", 200.2, 0.0, 10.0, decode_ms=10.0,
                 xfer_ms=1.5)],
}


@pytest.mark.parametrize("case", list(STITCH))
def test_stitch_trace_segments_equals_reference(case):
    segs = json.loads(json.dumps(STITCH[case]))
    j = jagg.stitch_trace_segments(json.loads(json.dumps(segs)))
    t = tagg.stitch_trace_segments(segs)
    assert t == j
    if t is not None:
        phases = sum(t[k] for k in ("queue_ms", "prefill_ms", "xfer_ms",
                                    "decode_ms"))
        assert math.isclose(t["wall_ms"], phases, abs_tol=1e-3)


# -- sinks and the Prometheus grammar -----------------------------------------


PROM_NAMES = ["serve.ttft_ms", "serve.replica[0].free_blocks",
              "serve.tenant[acme].requests", "span[ckpt.save].ms",
              "serve.ttft_ms[worker=w0,role=decode]", "9lives",
              "a.b[unbalanced", "x[]", "bad-chars!@#.metric",
              "fault[serve.step].count"]


@pytest.mark.parametrize("name", PROM_NAMES)
def test_prom_split_equals_reference(name):
    assert tsinks.prom_split(name) == jsinks.prom_split(name)
    assert tsinks.prom_name(name) == jsinks.prom_name(name)


class _Opaque:
    def __repr__(self):
        return "<opaque>"


JSONABLE = {
    "np_float32": np.float32(2.5),
    "np_int64": np.int64(-7),
    "np_bool": np.bool_(True),
    "zero_d_array": np.array(1.25),
    "nested": {"a": [np.float64(1.5), (np.int32(2), "s")],
               "b": {"c": None, "d": True}},
    "opaque": _Opaque(),
    "plain": [1, 2.0, "x", None, False],
    "opaque_in_list": [_Opaque(), {"k": _Opaque()}],
}


@pytest.mark.parametrize("case", list(JSONABLE))
def test_jsonable_equals_reference(case):
    v = JSONABLE[case]
    assert tsinks._jsonable(v) == jsinks._jsonable(v)
    json.dumps(tsinks._jsonable(v))


def test_jsonable_reads_torch_scalars_as_numpy_ones():
    """The port's events may carry 0-d torch tensors where the
    reference's carry numpy or device scalars: both become the same
    Python float."""
    ev = {"loss": torch.tensor(2.5), "n": torch.tensor(3),
          "xs": [torch.tensor(0.125, dtype=torch.float64)]}
    ref = {"loss": np.float32(2.5), "n": np.int64(3),
           "xs": [np.float64(0.125)]}
    assert tsinks._jsonable(ev) == jsinks._jsonable(ref)


EVENTS = [{"event": "step", "step": 1, "ms": np.float32(3.5)},
          {"event": "serve_shed", "tenant": "free", "reason": "quota",
           "retry_after_s": 0.25},
          {"event": "custom", "nested": {"xs": [np.int64(1), 2]},
           "obj": _Opaque()}]


def test_jsonl_sink_writes_reference_bytes(tmp_path):
    paths = []
    for mod, tag in ((jsinks, "j"), (tsinks, "t")):
        sink = mod.JsonlSink(str(tmp_path / f"{tag}.jsonl"))
        for ev in EVENTS:
            sink.write(ev)
        sink.close()
        paths.append(tmp_path / f"{tag}.jsonl")
    assert paths[1].read_bytes() == paths[0].read_bytes()
    assert len(paths[1].read_text().splitlines()) == len(EVENTS)


def test_stdout_sink_writes_reference_lines():
    outs = []
    for mod in (jsinks, tsinks):
        buf = io.StringIO()
        sink = mod.StdoutSink(stream=buf)
        for ev in EVENTS:
            sink.write(ev)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    mem = tsinks.InMemorySink(maxlen=2)
    for ev in EVENTS:
        mem.write(ev)
    assert [e["event"] for e in mem.events()] == ["serve_shed", "custom"]


# -- flight recorder, post-mortem, spans, watchdog ----------------------------


@pytest.mark.parametrize("capacity", [1, 8, 256])
def test_flight_recorder_equals_reference(capacity):
    recs = [jfr.FlightRecorder(capacity=capacity),
            tfr.FlightRecorder(capacity=capacity)]
    for rec in recs:
        for i in range(50):
            rec.record("beat", i=i, phase="decode" if i % 2 else "prefill")
        rec.record_event({"event": "custom", "marker": 17})
    j, t = recs
    assert (len(t), t.total, t.capacity) == (len(j), j.total, j.capacity)
    assert [_no_wall(e) for e in t.snapshot()] == \
        [_no_wall(e) for e in j.snapshot()]
    assert t.age_s() < 60.0
    t.clear()
    assert len(t) == 0 and t.total == j.total


def test_write_postmortem_equals_reference(tmp_path):
    """The post-mortem file has the reference's lines in the reference's
    order: header, flight-recorder meta, the last ring entries, thread
    stacks, the metrics snapshot."""
    out = []
    for mod, fr, tag in ((jreg, jfr, "j"), (treg, tfr, "t")):
        rec = fr.FlightRecorder(capacity=4)
        for i in range(6):
            rec.record("crumb", i=i)
        reg = mod.MetricsRegistry()
        reg.counter("c").inc(3)
        reg.histogram("h").observe(2.0)
        path = str(tmp_path / f"{tag}.postmortem")
        assert fr.write_postmortem(reason="test", path=path, recorder=rec,
                                   registry_fn=reg.snapshot,
                                   extra={"why": "twin"}) == path
        lines = [json.loads(ln) for ln in open(path)]
        out.append([_no_wall(ln, ("ts", "pid", "stack", "thread",
                                  "thread_id", "daemon", "name"))
                    for ln in lines if ln.get("event") != "thread_stack"])
    assert out[1] == out[0]
    assert out[1][-1]["metrics"]["c"] == 3


@pytest.mark.parametrize("emit", [True, False])
def test_span_hook_equals_reference(emit):
    """A ``span`` under each package's installed hook feeds the same
    events, histogram names and breadcrumbs."""
    got = []
    for obs_mod, state, spans, fr in ((jreg, jstate, jspans, jfr),
                                      (treg, tstate, tspans, tfr)):
        reg, events = obs_mod.MetricsRegistry(), []
        rec = fr.FlightRecorder()
        prev = state.SPAN[0]
        state.SPAN[0] = spans._SpanHook(registry=reg, emit=events.append,
                                        recorder=rec)
        try:
            with spans.span("serve.step", emit=emit, batch=2):
                pass
            with spans.span("ckpt.save", emit=emit):
                pass
        finally:
            state.SPAN[0] = prev
        got.append(([_no_wall(e) for e in events], reg.names(),
                    [_no_wall(e) for e in rec.snapshot()],
                    {n: reg.get(n).count for n in reg.names()}))
    assert got[1] == got[0]
    if not emit:
        assert got[1][0] == [] and got[1][1] == []


@pytest.mark.parametrize("deadline", [0.01, 0.2, 1.0, 40.0, 300.0, 1e4])
def test_watchdog_timing_equals_reference(deadline):
    """The poll interval a deadline implies, and the liveness read
    through a recorder and a manual beat, are the reference's."""
    j = jwd.HangWatchdog(deadline_s=deadline,
                         recorder=jfr.FlightRecorder())
    t = twd.HangWatchdog(deadline_s=deadline,
                         recorder=tfr.FlightRecorder())
    assert (t.poll_s, t.deadline_s, t.fired, t.abort) == \
        (j.poll_s, j.deadline_s, j.fired, j.abort)
    t.beat()
    assert 0.0 <= t.age_s() < 60.0 and t.last_dump is None
    t.stop()          # never started: a no-op, as in the reference


# -- PreemptionGuard ----------------------------------------------------------


def _preempt_run(obs_mod, guard_mod, tmp_path, tag, catch_sigint):
    sink = obs_mod.InMemorySink()
    obs_mod.enable(sinks=[sink], crash_hooks=False, step_monitor=False,
                   recompile_sentinel=False, collectives=False,
                   compiled_ledger=False,
                   postmortem_path=str(tmp_path / f"{tag}.postmortem"))
    saved = []
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                signal.SIGINT)}
    try:
        guard = guard_mod.PreemptionGuard(save_fn=lambda: saved.append(1),
                                          catch_sigint=catch_sigint)
        with guard:
            if catch_sigint:
                signal.raise_signal(signal.SIGINT)
            signal.raise_signal(signal.SIGTERM)
            signal.raise_signal(signal.SIGTERM)
        events = [_no_wall(e) for e in sink.events("preemption")]
    finally:
        obs_mod.disable()
    after = {s: signal.getsignal(s) for s in before}
    pm = [json.loads(ln)
          for ln in open(tmp_path / f"{tag}.postmortem")][0]
    return guard.preempted, saved, events, after == before, pm["reason"]


@pytest.mark.parametrize("catch_sigint", [False, True])
def test_preemption_guard_equals_reference(tmp_path, catch_sigint):
    """The first signal flips ``preempted``, emits one ``preemption``
    event and drains the post-mortem; the save runs once on exit and the
    previous handlers come back, as in the reference."""
    j = _preempt_run(jobs, jpreempt, tmp_path, "j", catch_sigint)
    t = _preempt_run(tobs, tpreempt, tmp_path, "t", catch_sigint)
    assert t == j
    assert t[0] and t[1] == [1] and len(t[2]) == 1 and t[3]


def test_preemption_guard_restores_handlers_after_a_raising_save():
    for mod in (jpreempt, tpreempt):
        before = signal.getsignal(signal.SIGTERM)

        def boom():
            raise RuntimeError("save failed")

        with pytest.raises(RuntimeError, match="save failed"):
            with mod.PreemptionGuard(save_fn=boom):
                signal.raise_signal(signal.SIGTERM)
        assert signal.getsignal(signal.SIGTERM) is before
