"""Retry with bounded exponential backoff and deterministic jitter (a copy
of ``paddle_tpu/resilience/retry.py``; the port's serving engine wraps its
KV page swaps in it).

The transient-failure half of resilience: a flaky rendezvous-store
socket, a checkpoint filesystem hiccup, an injected chaos fault — all
become a logged retry instead of a dead job.  Every attempt beyond the
first emits a ``retry`` event (site, attempt, delay, exception) into the
telemetry stream and flight-recorder ring, plus ``retry[<site>].count``
registry counters — one falsy check when telemetry is disabled.

Jitter is *deterministic*: derived from ``crc32(site, attempt)``, not a
RNG, so two runs of the same chaos plan sleep identically and the chaos
CI gate's bitwise-reproducibility contract holds.  (Across a fleet the
site string differs per host/step context rarely; the jitter exists to
de-synchronize genuinely different callers, not to be cryptographic.)

On exhaustion the ORIGINAL exception is re-raised — callers' existing
``except FileNotFoundError:``-style handling keeps working.

Pure stdlib.
"""

from __future__ import annotations

import time
import zlib

from .faults import InjectedFault, _emit_telemetry

__all__ = ["DEFAULT_RETRYABLE", "RetryPolicy", "retry_call"]

#: exceptions worth retrying by default: transport/filesystem transients
#: plus injected chaos faults.  NOT retryable by default: ValueError/
#: KeyError-style logic errors (retrying cannot fix a wrong argument)
#: and checkpoint corruption (same bytes, same failure — fallback to an
#: older checkpoint is the supervisor's job, not retry's).
DEFAULT_RETRYABLE = (ConnectionError, TimeoutError, OSError, InjectedFault)


class RetryPolicy:
    """Max attempts + exponential backoff with deterministic jitter +
    a retryable-exception filter.

    ``sleep`` is injectable (default ``time.sleep``) so tests and CI
    gates run the full retry machinery without wall-clock cost.
    """

    __slots__ = ("max_attempts", "backoff_s", "multiplier", "max_backoff_s",
                 "jitter", "retryable", "sleep")

    def __init__(self, max_attempts=3, backoff_s=0.05, multiplier=2.0,
                 max_backoff_s=5.0, jitter=0.25,
                 retryable=DEFAULT_RETRYABLE, sleep=None):
        if int(max_attempts) < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)
        self.multiplier = float(multiplier)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self.retryable = tuple(retryable)
        self.sleep = sleep if sleep is not None else time.sleep

    def is_retryable(self, exc) -> bool:
        return isinstance(exc, self.retryable)

    def delay_s(self, attempt, site="") -> float:
        """Backoff before retry number ``attempt`` (1-based): exponential,
        capped, stretched by up to ``jitter`` fraction — deterministically
        from ``(site, attempt)``, never a RNG."""
        base = min(self.backoff_s * self.multiplier ** (attempt - 1),
                   self.max_backoff_s)
        frac = (zlib.crc32(f"{site}#{attempt}".encode()) % 10000) / 10000.0
        return base * (1.0 + self.jitter * frac)

    def run(self, fn, *args, site="", **kwargs):
        """Call ``fn(*args, **kwargs)``; on a retryable exception, emit a
        ``retry`` event, back off, and try again — up to ``max_attempts``
        total attempts, then re-raise the original exception."""
        attempt = 1
        while True:
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                if attempt >= self.max_attempts or not self.is_retryable(e):
                    raise
                d = self.delay_s(attempt, site)
                _emit_retry(site, attempt, d, e)
                self.sleep(d)
                attempt += 1


def retry_call(fn, *args, policy=None, site="", **kwargs):
    """One-shot sugar: ``retry_call(fn, x, policy=p, site="ckpt.save")``."""
    return (policy or RetryPolicy()).run(fn, *args, site=site, **kwargs)


def _emit_retry(site, attempt, delay_s, exc):
    _emit_telemetry({"event": "retry", "site": site, "attempt": attempt,
                     "delay_s": round(delay_s, 4),
                     "exc": type(exc).__name__, "message": str(exc)},
                    ("retry.count", f"retry[{site or '?'}].count"))
