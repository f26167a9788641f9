"""Profiler facade over ``torch.profiler`` (``paddle_tpu/profiler``
counterpart), holding what the telemetry reaches: :class:`Profiler`
(``start``/``step``/``stop``/``export``), :class:`RecordEvent`,
:func:`make_scheduler`, :func:`windowed_profiler` and the
``_active_profilers`` list that ``observability.span`` bridges to, with
the reference's names.

Host scopes (``RecordEvent``, and the ``span(...)`` names while a
profiler is active) land on the profiler's own host timeline, exported as
chrome-trace JSON by :meth:`Profiler.export`, and, through
``torch.profiler.record_function``, in the ``torch.profiler`` trace.  A
profiler built with ``trace_dir`` runs a ``torch.profiler.profile`` over
each record window -- CPU activity, and the card's kernels when CUDA is
available (the replays of a captured CUDA graph included) -- and writes
its chrome trace into ``trace_dir`` when the window closes.

The rest of the reference's ``profiler/`` (summary tables, result
loading, targets, timer-only profilers) is not ported yet (ROADMAP.md,
queue 1 item 11).
"""

from __future__ import annotations

import json
import os
import threading
import time
from enum import Enum
from typing import Callable, List, Optional

__all__ = ["Profiler", "ProfilerState", "RecordEvent", "make_scheduler",
           "windowed_profiler"]


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3  # last step of a record window


class _HostEvent:
    __slots__ = ("name", "start_ns", "end_ns", "tid")

    def __init__(self, name, start_ns, end_ns, tid):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.tid = tid


# profilers between start() and stop(): observability.span keys its
# bridge off this list (a stable object)
_active_profilers: List["Profiler"] = []
_lock = threading.Lock()


class RecordEvent:
    """User scope: ``with RecordEvent("forward"):``.  Recorded on the host
    timeline of every recording profiler, and opened as a
    ``torch.profiler.record_function`` scope so the name also shows in the
    ``torch.profiler`` trace."""

    def __init__(self, name: str):
        self.name = name
        self._scope = None
        self._t0 = 0

    def begin(self):
        from torch.profiler import record_function
        self._scope = record_function(self.name)
        self._scope.__enter__()
        self._t0 = time.perf_counter_ns()

    def end(self):
        t1 = time.perf_counter_ns()
        if self._scope is not None:
            self._scope.__exit__(None, None, None)
            self._scope = None
        ev = _HostEvent(self.name, self._t0, t1, threading.get_ident())
        with _lock:
            for p in _active_profilers:
                if p._recording:
                    p._events.append(ev)

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Step-indexed state machine, mirroring paddle.profiler.make_scheduler:
    ``skip_first`` steps CLOSED, then cycles of (closed, ready, record)."""
    cycle = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        if repeat and step >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = step % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def _torch_profile():
    """A ``torch.profiler.profile`` over the CPU and, when a card is
    present, its CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


class Profiler:
    """``paddle.profiler.Profiler`` parity over ``torch.profiler``.

    - host events from RecordEvent scopes (+ step markers from ``step()``)
    - with ``trace_dir``: a ``torch.profiler`` trace of each record window
      (``torch_trace_<n>.json`` in ``trace_dir``, written when the window
      closes; ``traces`` lists the files)
    """

    def __init__(self, *, scheduler=None, trace_dir: Optional[str] = None):
        self._schedule = scheduler
        self.trace_dir = trace_dir
        self.traces: List[str] = []
        self._events: List[_HostEvent] = []
        self._step = 0
        self._step_t0: Optional[int] = None
        self._recording = False
        self._device = None          # the live torch.profiler.profile

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        with _lock:
            _active_profilers.append(self)
        self._apply_state(self._schedule(self._step) if self._schedule
                          else ProfilerState.RECORD)
        self._step_t0 = time.perf_counter_ns()
        return self

    def stop(self):
        self._apply_state(ProfilerState.CLOSED)
        with _lock:
            if self in _active_profilers:
                _active_profilers.remove(self)

    def step(self):
        """Mark a step boundary; advances the scheduler."""
        t1 = time.perf_counter_ns()
        if self._recording and self._step_t0 is not None:
            self._events.append(_HostEvent(f"ProfileStep#{self._step}",
                                           self._step_t0, t1, 0))
        self._step += 1
        self._step_t0 = t1
        if self._schedule:
            self._apply_state(self._schedule(self._step))

    def _apply_state(self, state: ProfilerState):
        was_recording = self._recording
        self._recording = state in (ProfilerState.RECORD,
                                    ProfilerState.RECORD_AND_RETURN)
        want_device = self._recording and self.trace_dir is not None
        if want_device and self._device is None:
            self._device = _torch_profile()
            self._device.start()
        elif not want_device and self._device is not None:
            prof, self._device = self._device, None
            prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(self.trace_dir,
                                f"torch_trace_{len(self.traces)}.json")
            prof.export_chrome_trace(path)
            self.traces.append(path)
        if self._recording and not was_recording:
            self._events = []

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def export(self, path: str, format: str = "json"):
        """The host timeline as chrome-trace JSON at ``path``."""
        if format != "json":
            raise ValueError("only chrome-trace json export is supported")
        events = [{"name": ev.name, "ph": "X", "pid": os.getpid(),
                   "tid": ev.tid, "ts": ev.start_ns / 1e3,
                   "dur": (ev.end_ns - ev.start_ns) / 1e3}
                  for ev in self._events]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return path


def windowed_profiler(trace_dir: str, steps: Optional[int] = None
                      ) -> Profiler:
    """A STARTED :class:`Profiler` recording host scopes and a
    ``torch.profiler`` trace (the card's kernels when CUDA is available)
    into ``trace_dir`` -- the bounded-capture entry the SLO-triggered
    capture arms (``observability.trace.SLOCapture``): the caller
    advances it with ``step()`` and ``stop()``s it after its window, which
    writes the trace.  With ``steps`` given, a ``make_scheduler`` window
    closes the trace on its own after that many ``step()`` calls
    (``stop()`` is still required to deregister)."""
    os.makedirs(trace_dir, exist_ok=True)
    sched = None
    if steps is not None:
        sched = make_scheduler(closed=0, ready=0, record=int(steps),
                               repeat=1)
    return Profiler(scheduler=sched, trace_dir=trace_dir).start()
