"""Flight recorder + crash post-mortems: the half of observability that
works when the job is NOT making progress.

The JSONL sinks (``sinks.py``) report on healthy runs; the failure mode
that actually burns multihost TPU time is the job that silently stops —
a wedged collective, a host stuck in data loading, a preemption that
kills the process mid-step.  The reference capability (PaddlePaddle's
profiler/monitor stack, SURVEY §5.5) demands that when that happens, the
artifacts to diagnose it are already on disk.

Two pieces:

- **FlightRecorder**: a fixed-size in-memory ring that passively records
  the last N telemetry events plus lightweight breadcrumbs (span
  begin/end around steps, collectives, ckpt I/O; compile events).  One
  deque append per record when enabled — CPython deque appends are
  atomic, so producers on the trainer thread and the compile listener
  never contend on a lock.  The newest append also stamps ``last_beat``
  (monotonic), which is the liveness signal the hang watchdog polls.
- **Post-mortems**: ``write_postmortem`` drains every thread's stack
  (``sys._current_frames``), the ring, and a registry snapshot to a
  ``*.postmortem`` JSONL file in ONE buffered write + fsync.  It is
  called by the hang watchdog, ``launch.PreemptionGuard`` (first
  SIGTERM), an unhandled-exception hook, an ``atexit`` hook (covers
  ``sys.exit`` mid-run and forgotten ``disable()``), and a SIGQUIT
  handler (``kill -QUIT`` = dump-without-dying, the classic flight-
  recorder convention).  It never raises: it runs in crash context.

Pure stdlib; ``tools/telemetry_report.py`` reads the post-mortem file
with the same JSONL parser as a telemetry stream.  Schema:
docs/OBSERVABILITY.md ("Crash post-mortems").

The port's copy of ``paddle_tpu/observability/flight_recorder.py``:
the same names, events and metrics, so a dashboard, a test or
``tools/`` reads both.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Callable, List, Optional

from . import _state
from .sinks import _jsonable

__all__ = ["FlightRecorder", "write_postmortem", "install_crash_hooks",
           "uninstall_crash_hooks"]


class FlightRecorder:
    """Bounded ring of the last ``capacity`` events/breadcrumbs."""

    __slots__ = ("capacity", "_ring", "last_beat", "total")

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self.last_beat = time.monotonic()
        self.total = 0          # lifetime appends (ring drops the oldest)

    def record(self, kind: str, **fields) -> None:
        """One breadcrumb: dict build + ONE deque append, no lock."""
        self._ring.append({"ts": round(time.time(), 3), "event": kind,
                           **fields})
        self.total += 1
        self.last_beat = time.monotonic()

    def record_event(self, event: dict) -> None:
        """Append an already-built telemetry event (Telemetry.emit path)."""
        self._ring.append(event)
        self.total += 1
        self.last_beat = time.monotonic()

    def age_s(self) -> float:
        """Seconds since the last recorded event — the liveness signal."""
        return time.monotonic() - self.last_beat

    def snapshot(self) -> List[dict]:
        # list() of a deque is safe against concurrent appends
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)


# ---------------------------------------------------------------------------
# post-mortem writing
# ---------------------------------------------------------------------------

# session defaults, set by observability.enable() via configure_postmortem;
# last_reason remembers that a post-mortem was already written this
# session so the atexit drain doesn't overwrite a targeted dump
# (exception/hang/preemption) with a generic end-of-process one
_PM = {"path": None, "recorder": None, "registry_fn": None,
       "last_reason": None}

DEFAULT_POSTMORTEM_PATH = "run.postmortem"


def configure_postmortem(path: Optional[str],
                         recorder: Optional[FlightRecorder] = None,
                         registry_fn: Optional[Callable[[], dict]] = None
                         ) -> None:
    """Bind the session's post-mortem destination + sources, and expose
    ``write_postmortem`` through the ``_state.POSTMORTEM`` hook so signal
    handlers (preemption) reach it without imports."""
    _PM.update(path=path, recorder=recorder, registry_fn=registry_fn)
    _state.POSTMORTEM[0] = write_postmortem


def _reset_postmortem() -> None:
    _PM.update(path=None, recorder=None, registry_fn=None,
               last_reason=None)
    _state.POSTMORTEM[0] = None


def _thread_stacks() -> List[dict]:
    """One ``thread_stack`` record per live thread, from the outside —
    this is how a hang dump shows WHERE the wedged thread is stuck."""
    threads = {t.ident: t for t in threading.enumerate()}
    out = []
    for tid, frame in sorted(sys._current_frames().items()):
        t = threads.get(tid)
        out.append({
            "event": "thread_stack",
            "thread": t.name if t is not None else str(tid),
            "thread_id": tid,
            "daemon": bool(t.daemon) if t is not None else None,
            "frames": [ln.rstrip("\n")
                       for ln in traceback.format_stack(frame)],
        })
    return out


def write_postmortem(reason: str = "unknown", path: Optional[str] = None,
                     recorder: Optional[FlightRecorder] = None,
                     registry_fn: Optional[Callable[[], dict]] = None,
                     exc=None, extra: Optional[dict] = None
                     ) -> Optional[str]:
    """Drain thread stacks + flight ring + registry snapshot to ``path``.

    Returns the path written, or None on failure — it NEVER raises (the
    callers are signal handlers, excepthooks, and a watchdog looking at
    a process that is already in trouble).  The file is rewritten whole
    each call (newest post-mortem wins) with one buffered write + fsync,
    so even a SIGKILL right after still leaves a complete file.
    """
    try:
        path = path or _PM["path"] or DEFAULT_POSTMORTEM_PATH
        recorder = recorder if recorder is not None \
            else (_PM["recorder"] or _state.RECORDER[0])
        registry_fn = registry_fn or _PM["registry_fn"]

        head = {"event": "postmortem", "reason": reason,
                "ts": round(time.time(), 3), "pid": os.getpid()}
        if exc is not None:
            etype, value, tb = exc
            head["exception"] = {
                "type": getattr(etype, "__name__", str(etype)),
                "message": str(value),
                "traceback": [ln.rstrip("\n") for ln in
                              traceback.format_exception(etype, value, tb)],
            }
        if extra:
            head.update(extra)
        lines = [head]
        lines.extend(_thread_stacks())
        led = _state.LEDGER[0]
        if led is not None:
            # the compiled-program cost/memory rows + the last HBM pool
            # snapshot: an OOM/stall dump names which program or pool
            # owned the bytes.  Pure host-side copies — never touches a
            # device buffer from a dying process.
            lines.append({"event": "compiled_artifacts",
                          "rows": led.snapshot(), "hbm": led.hbm})
        if recorder is not None:
            lines.append({"event": "flight_recorder",
                          "recorded": len(recorder),
                          "total": recorder.total,
                          "capacity": recorder.capacity,
                          "last_beat_age_s": round(recorder.age_s(), 3)})
            lines.extend(recorder.snapshot())
        if registry_fn is not None:
            # snapshot on a helper thread with a timeout: this runs from
            # signal handlers (preemption/SIGQUIT), and the interrupted
            # frame may HOLD a non-reentrant per-metric lock — a direct
            # registry_fn() would self-deadlock the dying process (the
            # same reentrancy hazard Telemetry.emit's RLock guards).  On
            # timeout the dump proceeds without the metrics line.
            got = []
            try:
                t = threading.Thread(
                    target=lambda: got.append(registry_fn()), daemon=True)
                t.start()
                t.join(timeout=2.0)
            except Exception:
                pass
            if got:
                lines.append({"event": "metrics", "metrics": got[0]})
            else:
                lines.append({"event": "metrics_unavailable",
                              "reason": "registry snapshot timed out "
                                        "(lock held by the interrupted "
                                        "thread?)"})
        buf = "\n".join(json.dumps(_jsonable(l), separators=(",", ":"))
                        for l in lines) + "\n"
        with open(path, "w") as f:
            f.write(buf)
            f.flush()
            os.fsync(f.fileno())
        _PM["last_reason"] = reason
        return path
    except Exception:
        return None


# ---------------------------------------------------------------------------
# crash hooks: atexit + unhandled exception + SIGQUIT
# ---------------------------------------------------------------------------

_HOOKS = {"installed": False, "prev_excepthook": None, "sigquit": False,
          "prev_sigquit": None, "in_excepthook": False}


def _atexit_drain() -> None:
    # a targeted dump (unhandled exception, hang, preemption) already on
    # disk wins over a generic end-of-process drain
    if _HOOKS["installed"] and _PM["last_reason"] is None:
        write_postmortem(reason="atexit")


def _crash_excepthook(etype, value, tb) -> None:
    # reentrancy guard: a third party may have chained over us across an
    # uninstall/reinstall cycle, putting this function in its own prev
    # chain — loop once, then fall through to the interpreter default
    if _HOOKS["in_excepthook"]:
        sys.__excepthook__(etype, value, tb)
        return
    _HOOKS["in_excepthook"] = True
    try:
        # like _atexit_drain: a clean disable() must mean no dump, even
        # if a chaining third party still routes exceptions through us
        if _HOOKS["installed"]:
            write_postmortem(reason="unhandled_exception",
                             exc=(etype, value, tb))
        prev = _HOOKS["prev_excepthook"] or sys.__excepthook__
        prev(etype, value, tb)
    finally:
        _HOOKS["in_excepthook"] = False


def _sigquit_handler(signum, frame) -> None:
    # dump-without-dying: operators `kill -QUIT` a suspicious job to get
    # stacks + the ring on disk, and the job keeps running
    write_postmortem(reason="SIGQUIT")


def install_crash_hooks(path: Optional[str] = None,
                        recorder: Optional[FlightRecorder] = None,
                        registry_fn: Optional[Callable[[], dict]] = None,
                        sigquit: bool = True) -> None:
    """Arrange for the ring to be drained on every exit the interpreter
    can still see: ``atexit`` (covers ``sys.exit`` mid-run and a run
    that never called ``disable()``), unhandled exceptions, and SIGQUIT.
    Idempotent; ``observability.disable()`` uninstalls."""
    if path or recorder or registry_fn:
        configure_postmortem(path or _PM["path"],
                             recorder or _PM["recorder"],
                             registry_fn or _PM["registry_fn"])
    if _HOOKS["installed"]:
        return
    _HOOKS["installed"] = True
    atexit.register(_atexit_drain)
    _HOOKS["prev_excepthook"] = sys.excepthook
    sys.excepthook = _crash_excepthook
    if sigquit and hasattr(signal, "SIGQUIT") \
            and threading.current_thread() is threading.main_thread():
        try:
            prev = signal.getsignal(signal.SIGQUIT)
            if prev == signal.SIG_DFL:   # never clobber a user handler
                signal.signal(signal.SIGQUIT, _sigquit_handler)
                _HOOKS["sigquit"] = True
                _HOOKS["prev_sigquit"] = prev
        except (ValueError, OSError):
            pass


def uninstall_crash_hooks() -> None:
    if not _HOOKS["installed"]:
        return
    _HOOKS["installed"] = False
    try:
        atexit.unregister(_atexit_drain)
    except Exception:
        pass
    if sys.excepthook is _crash_excepthook:
        sys.excepthook = _HOOKS["prev_excepthook"] or sys.__excepthook__
        _HOOKS["prev_excepthook"] = None
    # else: a third party chained over us — leave prev_excepthook bound
    # so the still-reachable _crash_excepthook keeps forwarding to the
    # user's original hook (it will not write: installed is False)
    if _HOOKS["sigquit"]:
        try:
            signal.signal(signal.SIGQUIT, _HOOKS["prev_sigquit"])
        except (ValueError, OSError):
            pass
        _HOOKS["sigquit"] = False
        _HOOKS["prev_sigquit"] = None
