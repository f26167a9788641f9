"""Request-lifecycle tracing: one host-side timeline per serving request.

The serving metrics (``serve.ttft_ms``, ``serve.step_ms``) can say *that*
latency degraded; this module says *where a given request spent its
time* — FrontDoor admission → queue wait → each chunked-prefill span →
decode → preempt/swap/restore → replica migration → retire.  One
:class:`RequestTrace` per request, produced by a process-global
:class:`RequestTracer` installed in ``_state.TRACE[0]`` by
``observability.enable()`` (one falsy check per site when disabled — the
same zero-overhead contract as every other producer, enforced by the
``telemetry-overhead`` CI gate).

Identity and propagation:

- A **trace id** names the request across process boundaries.  It comes
  from (in order) an explicit ``trace_id=``, the ``current_trace_id``
  contextvar (set via :func:`trace_context` — the HTTP server sets it
  from an ``X-Trace-Id`` header), or a generated ``tr-<pid>-<n>``.
- The tracer is keyed by **request id**, and the id rides the
  ``Request`` object itself (``Request.trace_id``), so the trace
  survives preempt→swap→restore and replica-failure evacuation — the
  migrated state keeps feeding the same timeline.

Phase accounting is exact by construction: a trace is always in exactly
one of the phases ``queue`` / ``prefill`` / ``xfer`` / ``decode``; every
transition closes the current segment at the same clock read that opens
the next, so ``queue_ms + prefill_ms + xfer_ms + decode_ms == wall_ms``
to float precision.  The ``xfer`` phase is the disaggregated-serving
handoff window (docs/SERVING.md "Disaggregated serving"): a prefill
replica enters it at first token when the request will stream its KV
pages to a decode replica, and the transfer transition back to ``queue``
closes it — colocated serving never enters it, so its accumulator stays
zero.  Transitions observe the phase histograms ``serve.queue_ms`` (per
queue-wait episode), ``serve.prefill_ms`` (once, at first token),
``serve.xfer_ms`` (per handoff episode) and
``serve.decode_ms_per_token`` (at retire), plus their
``serve.tenant[<t>].*`` per-tenant aggregates.

Consumption: ``GET /v1/requests/<rid>`` on the serving server returns
:meth:`RequestTracer.timeline`; every retired trace is also emitted as
one ``serve_trace`` JSONL event, which ``tools/trace_export.py`` folds
into Perfetto-loadable Chrome trace-event JSON and
``tools/telemetry_report.py`` folds into per-phase/per-tenant tables.

:class:`SLOCapture` closes the loop from signal to evidence: when TTFT
p95 breaches a threshold for K consecutive windows, it arms a bounded
``torch.profiler`` capture (via ``profiler.windowed_profiler``: the
card's kernels, the replays of the captured step's graph included) of
the next N engine steps and emits a ``serve_slo_capture`` event naming
the trace directory.

The port's copy of ``paddle_tpu/observability/trace.py``: the same
names, phases, events and metrics; only the default capture is
``torch.profiler`` where the reference's is ``jax.profiler``.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

from . import _state

__all__ = ["RequestTrace", "RequestTracer", "SLOCapture", "current_trace_id",
           "new_trace_id", "trace_context"]

_PHASES = ("queue", "prefill", "xfer", "decode")
_ids = itertools.count()

# the cross-boundary propagation channel: a caller (HTTP handler, test,
# batch job) sets this around submit and every request created inside
# inherits the id — contextvars so concurrent handler threads never
# bleed ids into each other's submissions
current_trace_id: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("pdtpu_trace_id", default=None)


def new_trace_id() -> str:
    """Process-unique trace id (``tr-<pid>-<n>``)."""
    return f"tr-{os.getpid():x}-{next(_ids):x}"


@contextlib.contextmanager
def trace_context(trace_id: Optional[str] = None):
    """Bind ``trace_id`` (generated when None) as the current trace id
    for submissions made inside the scope; yields the id."""
    tid = trace_id or new_trace_id()
    tok = current_trace_id.set(tid)
    try:
        yield tid
    finally:
        current_trace_id.reset(tok)


class RequestTrace:
    """One request's timeline: an ordered, bounded event list plus
    exact per-phase accumulators (see the module docstring)."""

    __slots__ = ("trace_id", "request_id", "tenant", "t0", "_p0",
                 "events", "phase", "_phase_t", "queue_ms", "prefill_ms",
                 "xfer_ms", "decode_ms", "decode_tokens",
                 "prefill_chunks", "preempts", "handoffs", "done",
                 "finish_reason", "dropped", "_prefill_obs",
                 "max_events")

    def __init__(self, trace_id: str, request_id: str,
                 tenant: Optional[str], p_now: float,
                 max_events: int = 256):
        self.trace_id = trace_id
        self.request_id = request_id
        self.tenant = tenant
        self.t0 = time.time()        # wall anchor for exported traces
        self._p0 = p_now             # perf_counter anchor for offsets
        self.events: List[dict] = []
        self.phase = "queue"
        self._phase_t = p_now
        self.queue_ms = 0.0
        self.prefill_ms = 0.0
        self.xfer_ms = 0.0
        self.decode_ms = 0.0
        self.decode_tokens = 0
        self.prefill_chunks = 0
        self.preempts = 0
        self.handoffs = 0            # prefill→decode replica transfers
        self.done = False
        self.finish_reason: Optional[str] = None
        self.dropped = 0             # events beyond max_events
        self._prefill_obs = False    # serve.prefill_ms observed once
        self.max_events = max_events

    def add(self, phase: str, p_now: float, force: bool = False,
            **attrs) -> None:
        """Append one timeline event (bounded: beyond ``max_events``
        only forced events — retire — land, others count ``dropped``)."""
        if len(self.events) >= self.max_events and not force:
            self.dropped += 1
            return
        ev = {"phase": phase,
              "t_ms": round((p_now - self._p0) * 1e3, 3)}
        ev.update(attrs)
        self.events.append(ev)

    def to_phase(self, phase: Optional[str], p_now: float):
        """Close the current phase segment at ``p_now`` and enter
        ``phase`` (None = final close).  Returns ``(closed_phase,
        segment_ms)`` — contiguous segments are what make the
        accumulators sum exactly to wall time."""
        seg_ms = (p_now - self._phase_t) * 1e3
        closed = self.phase
        if closed == "queue":
            self.queue_ms += seg_ms
        elif closed == "prefill":
            self.prefill_ms += seg_ms
        elif closed == "xfer":
            self.xfer_ms += seg_ms
        elif closed == "decode":
            self.decode_ms += seg_ms
        self.phase = phase
        self._phase_t = p_now
        return closed, seg_ms

    @property
    def wall_ms(self) -> float:
        return self.queue_ms + self.prefill_ms + self.decode_ms

    def summary(self) -> dict:
        q = round(self.queue_ms, 3)
        p = round(self.prefill_ms, 3)
        x = round(self.xfer_ms, 3)
        d = round(self.decode_ms, 3)
        # wall from the ROUNDED parts: the reported invariant
        # queue + prefill + xfer + decode == wall holds exactly as
        # printed (xfer is 0.0 outside disaggregated serving, so the
        # colocated three-phase sum is unchanged)
        return {"queue_ms": q,
                "prefill_ms": p,
                "xfer_ms": x,
                "decode_ms": d,
                "wall_ms": round(q + p + x + d, 3),
                "decode_tokens": self.decode_tokens,
                "prefill_chunks": self.prefill_chunks,
                "preempts": self.preempts,
                "handoffs": self.handoffs,
                "done": self.done,
                "reason": self.finish_reason,
                "dropped_events": self.dropped}

    def timeline(self) -> dict:
        return {"trace_id": self.trace_id,
                "request_id": self.request_id,
                "tenant": self.tenant,
                "t0": round(self.t0, 3),
                "events": [dict(e) for e in self.events],
                "summary": self.summary()}


class RequestTracer:
    """The process-global trace store + producer surface
    (``_state.TRACE[0]`` while observability is enabled).

    All methods are no-ops for unknown request ids (tracing may be
    enabled mid-flight) and safe under the serving stack's threading
    model: one internal lock serializes handler-thread ``begin`` against
    loop-thread phase updates.  Retention is bounded: ``capacity``
    retired traces stay queryable (``GET /v1/requests/<rid>``), older
    ones are evicted — live traces are bounded by the engines' own
    queue+slot+retention bookkeeping.
    """

    def __init__(self, capacity: int = 2048, registry=None, emit=None,
                 clock=time.perf_counter, max_events: int = 256):
        self.capacity = int(capacity)
        self.max_events = int(max_events)
        self._reg = registry
        self._emit = emit
        self._clock = clock
        self._lock = threading.Lock()
        self._traces: Dict[str, RequestTrace] = {}
        self._finished: "collections.deque[str]" = collections.deque()

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)

    # -- producer surface --------------------------------------------------

    def begin(self, request_id: str, *, tenant: Optional[str] = None,
              trace_id: Optional[str] = None, **attrs) -> str:
        """Get-or-create the trace for ``request_id`` and return its
        trace id; the create path records the ``submit`` event.  A
        door-submitted request reaching ``Engine.add_request`` hits the
        get path, so ``submit`` appears exactly once."""
        with self._lock:
            t = self._traces.get(request_id)
            if t is not None and not t.done:
                return t.trace_id
            if t is not None:
                # a legitimately REUSED request id (the engine's
                # keep_finished window is smaller than trace_capacity):
                # the retired timeline must not absorb the new request's
                # events — start fresh, and drop the old id from the
                # retention queue so eviction can't reap the new trace
                # in its place
                try:
                    self._finished.remove(request_id)
                except ValueError:
                    pass
            tid = trace_id or current_trace_id.get() or new_trace_id()
            t = RequestTrace(tid, request_id, tenant, self._clock(),
                             max_events=self.max_events)
            t.add("submit", t._p0, **attrs)
            self._traces[request_id] = t
            return tid

    def point(self, request_id: str, name: str, **attrs) -> None:
        """Record an instantaneous event (no phase change): prefill
        chunks, restore, route, migrate, isolated..."""
        with self._lock:
            t = self._traces.get(request_id)
            if t is None or t.done:
                return
            if name == "prefill_chunk":
                t.prefill_chunks += 1
            t.add(name, self._clock(), **attrs)

    def transition(self, request_id: str, phase: str,
                   event: Optional[str] = None, **attrs) -> None:
        """Move the request into ``phase`` (queue/prefill/decode),
        closing the current segment; records an event carrying the
        closed phase + its duration, and feeds the phase histograms."""
        with self._lock:
            t = self._traces.get(request_id)
            if t is None or t.done:
                return
            now = self._clock()
            closed, seg_ms = t.to_phase(phase, now)
            if event == "preempt":
                t.preempts += 1
            if phase == "xfer":
                t.handoffs += 1
            t.add(event or phase, now, closed=closed,
                  ms=round(seg_ms, 3), **attrs)
            reg = self._reg
            if reg is None:
                return
            if closed == "queue":
                # one observation per queue-wait EPISODE (submit→admit,
                # and each preempt→re-admit wait)
                reg.histogram("serve.queue_ms").observe(seg_ms)
                if t.tenant:
                    reg.histogram(
                        f"serve.tenant[{t.tenant}].queue_ms").observe(
                            seg_ms)
            if closed == "xfer":
                # one observation per handoff EPISODE (first token →
                # pages landed on the decode replica's queue)
                reg.histogram("serve.xfer_ms").observe(seg_ms)
                if t.tenant:
                    reg.histogram(
                        f"serve.tenant[{t.tenant}].xfer_ms").observe(
                            seg_ms)
            if phase == "decode" and closed == "prefill" \
                    and not t._prefill_obs:
                t._prefill_obs = True
                reg.histogram("serve.prefill_ms").observe(t.prefill_ms)
                if t.tenant:
                    reg.histogram(
                        f"serve.tenant[{t.tenant}].prefill_ms").observe(
                            t.prefill_ms)

    def retire(self, request_id: str, *, reason: Optional[str] = None,
               tokens: int = 0, **attrs) -> None:
        """Close the trace: final segment, ``retire`` event,
        ``serve.decode_ms_per_token`` observation, retention eviction,
        and ONE ``serve_trace`` event with the full timeline."""
        with self._lock:
            t = self._traces.get(request_id)
            if t is None or t.done:
                return
            now = self._clock()
            closed, seg_ms = t.to_phase(None, now)
            t.done = True
            t.finish_reason = reason
            t.decode_tokens = int(tokens)
            t.add("retire", now, force=True, closed=closed,
                  ms=round(seg_ms, 3), reason=reason, tokens=tokens,
                  **attrs)
            reg = self._reg
            if reg is not None and tokens:
                per_tok = t.decode_ms / tokens
                reg.histogram("serve.decode_ms_per_token").observe(per_tok)
                if t.tenant:
                    reg.histogram(
                        f"serve.tenant[{t.tenant}].decode_ms_per_token"
                    ).observe(per_tok)
            self._finished.append(request_id)
            while len(self._finished) > self.capacity:
                rid = self._finished.popleft()
                old = self._traces.get(rid)
                if old is not None and old.done:
                    del self._traces[rid]
            payload = {"event": "serve_trace", "id": request_id,
                       **t.timeline()}
            payload.pop("request_id", None)
            emit = self._emit
        # outside the lock: a slow sink must not stall trace producers
        if emit is not None:
            emit(payload)

    # -- consumer surface --------------------------------------------------

    def get(self, request_id: str) -> Optional[RequestTrace]:
        with self._lock:
            return self._traces.get(request_id)

    def find(self, trace_id: str) -> List[RequestTrace]:
        """All traces carrying ``trace_id`` (a caller may submit many
        requests under one id via :func:`trace_context`)."""
        with self._lock:
            return [t for t in self._traces.values()
                    if t.trace_id == trace_id]

    def timeline(self, request_id: str) -> Optional[dict]:
        with self._lock:
            t = self._traces.get(request_id)
            return t.timeline() if t is not None else None


class SLOCapture:
    """SLO-triggered on-chip capture: evidence that collects itself.

    Attach to an engine (``Engine(slo_capture=SLOCapture(...))``); each
    non-empty step calls :meth:`on_step` (host-side only — no device
    interaction until a capture arms).  Every ``window_steps`` steps the
    rolling ``serve.ttft_ms`` p95 is compared against ``ttft_p95_ms``
    (needing ``min_samples`` observations first); ``windows`` CONSECUTIVE
    breached windows arm a bounded ``torch.profiler`` capture — via
    ``profiler.windowed_profiler`` — of the next ``capture_steps``
    steps into ``trace_dir/slo_capture_NNN``, then emit a
    ``serve_slo_capture`` event naming the directory.  ``max_captures``
    bounds the lifetime profile volume; breach counting resets after
    each capture and on any healthy window.

    ``profiler_factory(trace_dir)`` is injectable (tests); the default
    builds a started ``profiler.windowed_profiler``.
    """

    def __init__(self, ttft_p95_ms: float, trace_dir: str, *,
                 window_steps: int = 50, windows: int = 3,
                 capture_steps: int = 20, max_captures: int = 1,
                 min_samples: int = 8, profiler_factory=None):
        if ttft_p95_ms <= 0:
            raise ValueError(f"ttft_p95_ms must be > 0, got {ttft_p95_ms}")
        self.ttft_p95_ms = float(ttft_p95_ms)
        self.trace_dir = trace_dir
        self.window_steps = max(1, int(window_steps))
        self.windows = max(1, int(windows))
        self.capture_steps = max(1, int(capture_steps))
        self.max_captures = int(max_captures)
        self.min_samples = int(min_samples)
        self._factory = profiler_factory
        self._steps = 0
        self._breaches = 0
        self._prof = None
        self._remaining = 0
        self._dir: Optional[str] = None
        self._armed_p95: Optional[float] = None
        self.captures: List[str] = []   # finished capture directories

    @property
    def capturing(self) -> bool:
        return self._prof is not None

    def _ttft_p95(self) -> Optional[float]:
        from . import get_registry
        reg = get_registry()
        if reg is None:
            return None
        h = reg.get("serve.ttft_ms")
        if h is None or h.count < self.min_samples:
            return None
        return h.percentile(95)

    def _emit(self, **fields) -> None:
        emit = _state.EMIT[0]
        if emit is not None:
            emit({"event": "serve_slo_capture", **fields})

    def _arm(self, p95: float) -> None:
        d = os.path.join(self.trace_dir,
                         f"slo_capture_{len(self.captures):03d}")
        factory = self._factory
        if factory is None:
            from ..profiler import windowed_profiler
            factory = windowed_profiler
        self._prof = factory(d)
        self._remaining = self.capture_steps
        self._dir = d
        self._armed_p95 = p95
        from . import get_registry
        reg = get_registry()
        if reg is not None:
            reg.counter("serve.slo_captures").inc()
        self._emit(state="armed", trace_dir=d,
                   ttft_p95_ms=round(p95, 3),
                   threshold_ms=self.ttft_p95_ms,
                   breached_windows=self._breaches,
                   capture_steps=self.capture_steps)

    def _finish(self) -> None:
        prof, d = self._prof, self._dir
        self._prof = None
        self._dir = None
        self._breaches = 0
        try:
            prof.stop()
        except Exception:
            pass
        self.captures.append(d)
        self._emit(state="done", trace_dir=d,
                   ttft_p95_ms=self._armed_p95,
                   capture_steps=self.capture_steps)

    def on_step(self) -> None:
        """One engine step happened.  While capturing: count it down and
        stop the profiler at zero.  Otherwise: window bookkeeping +
        breach detection (a registry read every ``window_steps`` steps,
        nothing per step)."""
        if self._prof is not None:
            self._prof.step()
            self._remaining -= 1
            if self._remaining <= 0:
                self._finish()
            return
        self._steps += 1
        if self._steps % self.window_steps:
            return
        if len(self.captures) >= self.max_captures:
            return
        p95 = self._ttft_p95()
        if p95 is None:
            return                   # not enough signal: hold the count
        if p95 <= self.ttft_p95_ms:
            self._breaches = 0
            return
        self._breaches += 1
        if self._breaches >= self.windows:
            self._arm(p95)
