"""Trace spans: one vocabulary for the always-on JSONL stream AND the
deep-dive chrome trace.

``with span("ckpt.save"):`` feeds, depending on what is enabled:

- the **flight recorder**: a ``span_begin`` breadcrumb at entry (the
  liveness beat the hang watchdog polls — recorded BEFORE the body so a
  span that never returns is visible as a stuck name, not silence);
- the **registry**: a ``span[<name>].ms`` duration histogram;
- the **event stream**: one ``span`` JSONL event on exit;
- the **profiler**: while a ``paddle_tpu_torch.profiler.Profiler`` is
  active, the span opens a ``RecordEvent`` so the same name lands on the
  host timeline of the chrome-trace export (and, via
  ``torch.profiler.record_function``, in the ``torch.profiler`` trace
  beside the card's kernels).

Pre-instrumented sites: ``jit.TrainStep`` steps (via StepMonitor, as
``emit=False`` spans — the ``step`` event already carries the numbers),
``distributed.Engine.fit`` / ``hapi.Model.fit`` epochs, ``ckpt``
save/load, eager collectives, and ``jit.save``/``jit.load`` AOT export.

Disabled cost: one falsy check on the ``_state.SPAN`` hook plus one
falsy check on the profiler's active list — no imports, no clock reads
beyond ``perf_counter`` when something is on.

The port's copy of ``paddle_tpu/observability/spans.py``, its profiler
bridge bound to the port's ``profiler`` facade over ``torch.profiler``.
"""

from __future__ import annotations

import time
from typing import Optional

from . import _state

__all__ = ["span", "spans_active"]

# lazily bound to paddle_tpu_torch.profiler's module-level
# _active_profilers list (a stable object) + its RecordEvent class; the
# profiler imports torch, so nothing is imported until a span runs
_PROF = [None, None]            # [_active_profilers, RecordEvent]


def _profiler_bridge():
    lst = _PROF[0]
    if lst is None:
        try:
            from .. import profiler as _p
            _PROF[0] = lst = _p._active_profilers
            _PROF[1] = _p.RecordEvent
        except Exception:
            _PROF[0] = lst = ()
    return lst


def spans_active() -> bool:
    """True when a span would observe anything (telemetry span hook or
    an active profiler).  Per-call producers (eager collectives) use
    this as a fast path so the fully-disabled cost stays two falsy
    checks, with no span/f-string construction."""
    return _state.SPAN[0] is not None or bool(_profiler_bridge())


class _SpanHook:
    """Installed in ``_state.SPAN[0]`` by ``observability.enable()``:
    routes span begin/ends into the recorder, registry, and sinks."""

    __slots__ = ("_reg", "_emit", "_rec")

    def __init__(self, registry=None, emit=None, recorder=None):
        self._reg = registry
        self._emit = emit
        self._rec = recorder

    def begin(self, name: str) -> None:
        rec = self._rec
        if rec is not None:
            rec.record("span_begin", name=name)

    def end(self, name: str, dur_ms: float, attrs: Optional[dict],
            emit: bool) -> None:
        if emit:
            if self._reg is not None:
                self._reg.histogram(f"span[{name}].ms").observe(dur_ms)
            if self._emit is not None:
                ev = {"event": "span", "name": name,
                      "ms": round(dur_ms, 3)}
                if attrs:
                    ev.update(attrs)
                self._emit(ev)   # lands in the ring via Telemetry.emit
                return
        rec = self._rec
        if rec is not None:
            rec.record("span_end", name=name, ms=round(dur_ms, 3))


class span:
    """Context manager: ``with span("name", **attrs): ...``.

    ``emit=False`` keeps the breadcrumbs and the profiler bridge but
    suppresses the JSONL event + registry histogram — used where another
    event already carries the numbers (TrainStep's ``step`` event).
    """

    __slots__ = ("name", "attrs", "emit", "_t0", "_rec_event", "_hook")

    def __init__(self, name: str, emit: bool = True, **attrs):
        self.name = name
        self.attrs = attrs
        self.emit = emit
        self._rec_event = None
        self._hook = None
        self._t0 = 0.0

    def __enter__(self):
        self._hook = hook = _state.SPAN[0]
        if hook is not None:
            hook.begin(self.name)
        if _profiler_bridge():
            self._rec_event = _PROF[1](self.name)
            self._rec_event.begin()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        rec_event = self._rec_event
        if rec_event is not None:
            rec_event.end()
            self._rec_event = None
        hook = self._hook
        if hook is not None:
            hook.end(self.name, (t1 - self._t0) * 1e3, self.attrs,
                     self.emit)
        return False
