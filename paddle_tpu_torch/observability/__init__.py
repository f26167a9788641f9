"""Runtime telemetry of the port (``paddle_tpu/observability`` counterpart).

What it holds, each a copy of the reference's JAX-free module with the
same names, events and metric names:

1. **Metrics registry** (``registry.py``, ``aggregate.py``): thread-safe
   counters, gauges, histograms with rolling p50/p95 and mergeable
   sketches; pluggable sinks (``sinks.py``) -- in-memory for tests, JSONL
   file, stdout -- process-0-gated under ``torch.distributed``, and the
   Prometheus text exposition of ``GET /metrics``.
2. **Spans, flight recorder, hang watchdog** (``spans.py``,
   ``flight_recorder.py``, ``watchdog.py``): ``span[<name>].ms``
   histograms, breadcrumbs in a bounded ring, crash post-mortems.
3. **Request trace** (``trace.py``): one lifecycle timeline per serving
   request (queue, prefill, decode, preempt/restore, retire), the
   ``serve_trace`` event, and :class:`SLOCapture`, which arms a bounded
   ``torch.profiler`` window (``paddle_tpu_torch.profiler``) when the
   TTFT p95 breaches its threshold.

The serving engine, its LoRA pool, the front door, the HTTP server and
the fault sites write here at the reference's sites.

Not ported (:data:`NOT_PORTED`): the step monitor, the recompile
sentinel, the compiled-artifact ledger and collective accounting -- the
reference builds them on ``jax.monitoring``, XLA's cost analysis and its
communication layer (ROADMAP.md, queue 1 item 11).  ``enable()`` keeps
their arguments and defaults, so a call moves between the packages
unchanged, but installs none of them: the handle's ``monitor``,
``sentinel`` and ``ledger`` stay ``None``.

Zero overhead when disabled (the default): every producer does ONE falsy
check against a ``_state`` hook container.

Usage::

    import paddle_tpu_torch.observability as obs
    tel = obs.enable(jsonl_path="run_telemetry.jsonl")
    ... serve ...
    obs.disable()          # final metrics snapshot + sink close

Report folding: ``python tools/telemetry_report.py run_telemetry.jsonl``.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from . import _state
from .aggregate import (FleetRegistry, HistogramSketch, fleet_fold,
                        registry_to_wire, stitch_trace_segments)
from .flight_recorder import (FlightRecorder, install_crash_hooks,
                              uninstall_crash_hooks, write_postmortem)
from .flight_recorder import _reset_postmortem, configure_postmortem
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .sinks import (InMemorySink, JsonlSink, Sink, StdoutSink,
                    _ProcessZeroGate)
from .spans import _SpanHook, span
from .trace import (RequestTrace, RequestTracer, SLOCapture,
                    current_trace_id, new_trace_id, trace_context)
from .watchdog import HangWarning, HangWatchdog

__all__ = ["Counter", "FleetRegistry", "FlightRecorder", "Gauge",
           "HangWarning", "HangWatchdog", "Histogram", "HistogramSketch",
           "InMemorySink", "JsonlSink", "MetricsRegistry", "NOT_PORTED",
           "RequestTrace", "RequestTracer", "SLOCapture", "Sink",
           "StdoutSink", "Telemetry", "configure_postmortem",
           "current_trace_id", "disable", "emit_event", "enable",
           "enabled", "fleet_fold", "get_flight_recorder", "get_ledger",
           "get_registry", "get_request_tracer", "get_telemetry",
           "get_watchdog", "install_crash_hooks", "new_trace_id",
           "registry_to_wire", "span", "stitch_trace_segments",
           "trace_context", "uninstall_crash_hooks", "write_postmortem"]

#: ``enable()`` arguments kept for the reference's signature that install
#: nothing in the port (their machinery is JAX-bound in the reference).
NOT_PORTED = ("step_monitor", "recompile_sentinel", "compiled_ledger",
              "collectives")

_ACTIVE: List[Optional["Telemetry"]] = [None]


class Telemetry:
    """One enabled telemetry session: registry + sinks + recorder."""

    def __init__(self, registry: MetricsRegistry, sinks: List[Sink],
                 recorder: Optional[FlightRecorder] = None,
                 watchdog: Optional[HangWatchdog] = None):
        self.registry = registry
        self.sinks = list(sinks)
        # the reference's step monitor, recompile sentinel and ledger:
        # not ported (NOT_PORTED), kept as None for code that reads them
        self.monitor = self.sentinel = self.ledger = None
        self.recorder = recorder
        self.watchdog = watchdog
        self.tracer: Optional[RequestTracer] = None
        # RLock, not Lock: the preemption SIGTERM handler emits from the
        # main thread, possibly interrupting an emit already holding the
        # lock — a plain Lock would self-deadlock the dying process
        self._lock = threading.RLock()

    def emit(self, event: dict) -> None:
        """Stamp ``ts`` and fan out to every sink (serialized: events may
        come from the engine loop thread and handler threads at once)."""
        if "ts" not in event:
            event = {"ts": round(time.time(), 3), **event}
        # the flight ring sees every event, BEFORE the sink lock: a sink
        # wedged on a dead filesystem must not starve the post-mortem ring
        rec = self.recorder
        if rec is not None:
            rec.record_event(event)
        with self._lock:
            for s in self.sinks:
                try:
                    s.write(event)
                except Exception:
                    # a broken sink must never take down a serving step
                    pass

    def flush(self, emit_metrics: bool = True) -> None:
        """Emit a ``metrics`` registry snapshot, then flush sinks."""
        if emit_metrics:
            self.emit({"event": "metrics",
                       "metrics": self.registry.snapshot()})
        with self._lock:
            for s in self.sinks:
                s.flush()

    def close(self) -> None:
        with self._lock:
            for s in self.sinks:
                s.close()


def enabled() -> bool:
    return _ACTIVE[0] is not None


def get_telemetry() -> Optional[Telemetry]:
    return _ACTIVE[0]


def get_registry() -> Optional[MetricsRegistry]:
    tel = _ACTIVE[0]
    return tel.registry if tel is not None else None


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _state.RECORDER[0]


def get_watchdog() -> Optional[HangWatchdog]:
    tel = _ACTIVE[0]
    return tel.watchdog if tel is not None else None


def get_request_tracer() -> Optional[RequestTracer]:
    """The active request-lifecycle tracer (serving timelines), or None
    when telemetry is disabled / tracing was opted out."""
    return _state.TRACE[0]


def get_ledger():
    """The compiled-artifact ledger: always None in the port
    (:data:`NOT_PORTED`)."""
    return _state.LEDGER[0]


def emit_event(event: str, **fields) -> None:
    """Fire-and-forget structured event; no-op when disabled."""
    emit = _state.EMIT[0]
    if emit is not None:
        emit({"event": event, **fields})


def _process_index() -> int:
    """This process's rank under ``torch.distributed`` when a process
    group is up, else 0 (the reference's ``jax.process_index()``)."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


def enable(jsonl_path: Optional[str] = None, stdout: bool = False,
           sinks: Optional[List[Sink]] = None, *,
           step_monitor: bool = True, recompile_sentinel: bool = True,
           collectives: bool = True, warmup_steps: int = 1,
           sentinel_warmup: int = 1, storm_threshold: int = 3,
           storm_window_s: float = 60.0, storm_all_sites: bool = False,
           all_processes: bool = False,
           registry: Optional[MetricsRegistry] = None,
           flight_recorder: bool = True,
           flight_recorder_capacity: int = 256,
           spans: bool = True, crash_hooks: bool = True,
           postmortem_path: Optional[str] = None,
           watchdog_s: Optional[float] = None, on_hang=None,
           watchdog_abort: bool = False,
           request_tracing: bool = True,
           trace_capacity: int = 2048,
           compiled_ledger: bool = True,
           chip_spec_override: Optional[dict] = None) -> Telemetry:
    """Turn telemetry on (replacing any active session) and return the
    ``Telemetry`` handle -- the reference's signature.

    With no sink arguments an ``InMemorySink`` is installed so events are
    at least inspectable via ``get_telemetry().sinks[0]``.  File/stdout
    sinks only write on process 0 (rank 0 of an initialized
    ``torch.distributed`` group) unless ``all_processes=True``;
    in-memory sinks are never gated.

    ``flight_recorder`` keeps the last ``flight_recorder_capacity``
    events/breadcrumbs in a ring; ``crash_hooks`` drains it to
    ``postmortem_path`` (default ``<jsonl_path>.postmortem``, else
    ``run.postmortem``) on unhandled exceptions / ``sys.exit`` mid-run /
    SIGQUIT -- call ``disable()`` for a clean shutdown without a dump.
    ``watchdog_s`` starts a :class:`HangWatchdog` with that deadline;
    ``on_hang`` and ``watchdog_abort`` pick the escalation beyond the
    warning+dump.  ``spans`` installs the ``span(...)`` hook (per-span
    events + ``span[<name>].ms`` histograms).

    ``request_tracing`` installs a :class:`RequestTracer` -- one
    per-request lifecycle timeline across the serving stack, retaining
    the last ``trace_capacity`` retired traces for
    ``GET /v1/requests/<rid>`` and emitting one ``serve_trace`` event per
    retired request.

    ``step_monitor``, ``recompile_sentinel``, ``collectives``,
    ``compiled_ledger`` and the arguments that tune them
    (``warmup_steps``, ``sentinel_warmup``, ``storm_*``,
    ``chip_spec_override``) are accepted and install nothing
    (:data:`NOT_PORTED`).
    """
    del step_monitor, recompile_sentinel, collectives, warmup_steps
    del sentinel_warmup, storm_threshold, storm_window_s, storm_all_sites
    del compiled_ledger, chip_spec_override
    if watchdog_s and not flight_recorder:
        raise ValueError(
            "watchdog_s needs the flight recorder: its ring beat is "
            "the liveness signal — drop flight_recorder=False or run "
            "a standalone HangWatchdog with manual beat()s")
    disable()
    out: List[Sink] = list(sinks) if sinks else []
    file_sinks: List[Sink] = []
    if jsonl_path:
        file_sinks.append(JsonlSink(jsonl_path))
    if stdout:
        file_sinks.append(StdoutSink())
    if file_sinks and not all_processes:
        is_zero = _process_index() == 0
        file_sinks = [_ProcessZeroGate(s, is_zero) for s in file_sinks]
    out.extend(file_sinks)
    if not out:
        # bounded: a sinkless enable() on a long-running server must not
        # grow an event list without limit
        out = [InMemorySink(maxlen=65536)]

    reg = registry if registry is not None else MetricsRegistry()
    rec = FlightRecorder(flight_recorder_capacity) if flight_recorder \
        else None
    tel = Telemetry(reg, out, recorder=rec)

    pm_path = postmortem_path or (
        jsonl_path + ".postmortem" if jsonl_path else None)
    if rec is not None:
        configure_postmortem(pm_path, recorder=rec,
                             registry_fn=reg.snapshot)
        if crash_hooks:
            install_crash_hooks()
    if watchdog_s:
        tel.watchdog = HangWatchdog(
            deadline_s=watchdog_s, recorder=rec, registry=reg,
            emit=tel.emit, postmortem_path=pm_path, on_hang=on_hang,
            abort=watchdog_abort)

    if request_tracing:
        tel.tracer = RequestTracer(capacity=trace_capacity, registry=reg,
                                   emit=tel.emit)

    _ACTIVE[0] = tel
    _state.MONITOR[0] = None
    _state.EMIT[0] = tel.emit
    _state.TRACE[0] = tel.tracer
    _state.LEDGER[0] = None
    _state.COLLECTIVE[0] = None
    _state.RECORDER[0] = rec
    if spans:
        _state.SPAN[0] = _SpanHook(registry=reg, emit=tel.emit,
                                   recorder=rec)
    if tel.watchdog is not None:
        tel.watchdog.start()
    return tel


def disable() -> None:
    """Tear down: unhook producers, emit a final metrics snapshot, close
    sinks.  Idempotent."""
    tel = _ACTIVE[0]
    if tel is None:
        return
    _state.MONITOR[0] = None
    _state.COLLECTIVE[0] = None
    _state.EMIT[0] = None
    _state.SPAN[0] = None
    _state.RECORDER[0] = None
    _state.TRACE[0] = None
    _state.LEDGER[0] = None
    _ACTIVE[0] = None
    if tel.watchdog is not None:
        tel.watchdog.stop()
    # a clean disable() means the run ended on purpose: no atexit dump
    uninstall_crash_hooks()
    _reset_postmortem()
    try:
        tel.flush(emit_metrics=True)
    finally:
        tel.close()
