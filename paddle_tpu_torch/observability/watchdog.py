"""Hang watchdog: a daemon thread that turns "the job went quiet" into
an on-disk post-mortem within a bounded deadline.

The liveness signal is the flight recorder's ``last_beat`` — every step
``span_begin``, collective issue, ckpt span, compile event, and emitted
telemetry event stamps it — plus an explicit ``beat()`` for loops that
produce no telemetry (data loading, setup).  Crucially the beat fires at
operation BEGIN (the ``span_begin`` breadcrumb), so a step or collective
that enters and never returns shows a growing age, not a frozen clock.

When no beat lands within ``deadline_s``, the watchdog — from its own
thread, which is exactly why it can observe a wedged main thread —
writes a post-mortem (all thread stacks, the ring, a registry snapshot),
then escalates: ``HangWarning`` always, then the ``on_hang`` callback if
given, then ``os._exit`` if ``abort=True`` (a multihost job wedged on
one host should die loudly so the launcher's elastic restart can act,
rather than burn the whole slice forever).  One dump per stall episode:
it re-arms only after progress resumes.

The port's copy of ``paddle_tpu/observability/watchdog.py``:
the same names, events and metrics, so a dashboard, a test or
``tools/`` reads both.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
import warnings
from typing import Callable, Optional

from .flight_recorder import FlightRecorder, write_postmortem

__all__ = ["HangWatchdog", "HangWarning"]


class HangWarning(RuntimeWarning):
    """No step/collective/span progress within the watchdog deadline."""


class HangWatchdog:
    """Daemon-thread stall detector over the flight recorder's beat.

    Usage (``observability.enable(watchdog_s=300)`` does this wiring)::

        wd = HangWatchdog(deadline_s=300, recorder=rec,
                          postmortem_path="run.jsonl.postmortem")
        wd.start()
        ... train ...
        wd.stop()

    Pick ``deadline_s`` above the worst first-step XLA compile: no beat
    lands while the compiler runs, so a long compile reads as a stall —
    the dump disambiguates (main thread inside ``backend_compile`` =
    still compiling; see docs/OBSERVABILITY.md).
    """

    def __init__(self, deadline_s: float = 300.0,
                 poll_s: Optional[float] = None,
                 recorder: Optional[FlightRecorder] = None,
                 registry=None, emit=None,
                 postmortem_path: Optional[str] = None,
                 on_hang: Optional[Callable[["HangWatchdog"], None]] = None,
                 abort: bool = False):
        self.deadline_s = float(deadline_s)
        # poll often enough that a fire lands "within its deadline" plus
        # a fraction, without busy-waiting on long deadlines
        self.poll_s = float(poll_s) if poll_s is not None \
            else max(min(self.deadline_s / 4.0, 10.0), 0.05)
        self._recorder = recorder
        self._registry = registry
        self._emit = emit
        self._postmortem_path = postmortem_path
        self.on_hang = on_hang
        self.abort = bool(abort)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._manual_beat = time.monotonic()
        self._stalled = False
        self._fire_beat = 0.0
        self.fired = 0
        self.last_dump: Optional[str] = None

    # -- liveness ----------------------------------------------------------

    def beat(self) -> None:
        """Manual liveness beat for phases that emit no telemetry."""
        self._manual_beat = time.monotonic()

    def _last_beat(self) -> float:
        b = self._manual_beat
        rec = self._recorder
        if rec is not None and rec.last_beat > b:
            b = rec.last_beat
        return b

    def age_s(self) -> float:
        return time.monotonic() - self._last_beat()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "HangWatchdog":
        if self._thread is not None:
            return self
        self.beat()          # arm from start(), not construction
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="pdtpu-hang-watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.poll_s + 1.0)
            self._thread = None

    # -- the loop ----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            if self._stalled:
                # one dump per stall episode: re-arm only on a beat NEWER
                # than the fire's own "hang" emission (which lands in the
                # ring and must not read as progress)
                if self._last_beat() > self._fire_beat:
                    self._stalled = False
                continue
            age = self.age_s()
            if age <= self.deadline_s:
                continue
            self._stalled = True
            self._fire(age)
            self._fire_beat = self._last_beat()

    def _fire(self, age: float) -> None:
        self.fired += 1
        reason = (f"hang: no step/collective/span progress for "
                  f"{age:.1f}s (deadline {self.deadline_s:.1f}s)")
        # post-mortem FIRST and via a direct file write: the emit path
        # can block on a lock the wedged thread is holding
        self.last_dump = write_postmortem(
            reason=reason, path=self._postmortem_path,
            recorder=self._recorder,
            registry_fn=(self._registry.snapshot
                         if self._registry is not None else None))
        try:
            # guarded like every other escalation step: under -W error
            # the raise would otherwise kill the watchdog thread and
            # silently end stall detection for the rest of the run
            warnings.warn(
                f"hang watchdog: {reason}. Thread stacks + the last "
                f"{self._recorder.capacity if self._recorder else 0} "
                f"flight-recorder events are in {self.last_dump!r} — see "
                "docs/OBSERVABILITY.md (\"Reading a hang dump\").",
                HangWarning, stacklevel=2)
        except Exception:
            pass
        cb = self.on_hang
        if callable(cb):
            try:
                cb(self)
            except Exception:
                pass
        if self._emit is not None:
            # emit LAST and on a helper thread with a bounded join: a
            # wedged trainer may hold the sink lock, and a blocked emit
            # here must not stop the abort below (or future stall
            # episodes).  The join normally completes — emit beats the
            # ring before touching the sink lock — so the loop's
            # _fire_beat capture sees this beat and does not read it as
            # progress.
            ev = {"event": "hang", "age_s": round(age, 1),
                  "deadline_s": self.deadline_s,
                  "postmortem": self.last_dump}

            def _bg_emit():
                try:
                    self._emit(ev)
                except Exception:
                    pass

            try:
                t = threading.Thread(target=_bg_emit, daemon=True)
                t.start()
                t.join(timeout=1.0)
            except Exception:
                pass
        if self.abort:
            # last resort: raw stacks to stderr (async-signal-safe),
            # then hard-exit so the launcher's elastic restart can act
            try:
                faulthandler.dump_traceback(file=sys.stderr)
            except Exception:
                pass
            os._exit(42)
