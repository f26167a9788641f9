"""Preemption-aware training support (SURVEY §5.3).

Reference behavior: elastic restarts rely on user checkpoints; the launcher
sends SIGTERM with a grace window before SIGKILL (launch/job.py). This
module is the trainer-side half: catch the SIGTERM, finish the current
step, save a checkpoint, exit cleanly — so the relaunched job (same or
smaller slice) resumes via ckpt reshard-on-load.

Usage::

    guard = PreemptionGuard(save_fn=lambda: pt.save(state, path))
    with guard:
        for batch in loader:
            state, metrics = step(state, batch)
            if guard.preempted:       # SIGTERM arrived mid-epoch
                break                  # guard saves on exit

The port's copy of ``paddle_tpu/launch/preempt.py`` (stdlib only): the
serving server's SIGTERM drain runs under it.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Optional

from ..observability import _state as _obs_state


class PreemptionGuard:
    """Installs a SIGTERM (and optionally SIGINT) handler that flips
    ``preempted`` instead of killing the process; on context exit after a
    preemption, runs ``save_fn`` exactly once."""

    def __init__(self, save_fn: Optional[Callable[[], None]] = None,
                 catch_sigint: bool = False):
        self.save_fn = save_fn
        self._signals = [signal.SIGTERM] + (
            [signal.SIGINT] if catch_sigint else [])
        self._event = threading.Event()
        self._prev = {}
        self._saved = False

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def _handler(self, signum, frame):
        first = not self._event.is_set()
        self._event.set()
        # structured telemetry (timestamp is stamped by the sink layer):
        # interrupted runs are diagnosable from the JSONL stream.  First
        # signal only — the repeat SIGTERM before SIGKILL is not a new
        # preemption.  Guarded hard: a telemetry failure inside a signal
        # handler must never turn a graceful preemption into a crash.
        if not first:
            return
        try:
            reason = signal.Signals(signum).name
        except Exception:
            reason = str(signum)
        if _obs_state.EMIT[0] is not None:
            try:
                mon = _obs_state.MONITOR[0]
                _obs_state.EMIT[0]({
                    "event": "preemption", "reason": reason,
                    "step": mon.total_steps if mon is not None else None})
            except Exception:
                pass
        # drain the flight-recorder ring to the .postmortem file NOW: the
        # grace window may not be honored (SIGKILL follows), and a killed
        # run must never be blind.  write_postmortem never raises, but the
        # hook read is guarded anyway — this is a signal frame.
        pm = _obs_state.POSTMORTEM[0]
        if pm is not None:
            try:
                pm(reason=f"preemption:{reason}")
            except Exception:
                pass

    def __enter__(self):
        # fresh lifecycle per entry: a guard object may be reused across
        # retry attempts, and a stale preempted/saved flag from the last
        # run must not short-circuit the next one
        self._event.clear()
        self._saved = False
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, exc_type, exc, tb):
        # Save BEFORE restoring handlers: a second SIGTERM during the
        # checkpoint write must not kill the process mid-save.  Restore
        # in a finally: a raising save_fn must not leave the SIGTERM
        # handler installed forever on a dead guard.
        try:
            if self.preempted and self.save_fn is not None \
                    and not self._saved:
                self._saved = True
                self.save_fn()
        finally:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._prev.clear()
        return False

    def checkpoint_now(self):
        """Run save_fn immediately (periodic saves can share the fn).

        Deliberately does NOT mark the exit-time save as done: a later
        preemption must still snapshot the newest state on exit."""
        if self.save_fn is not None:
            self.save_fn()
