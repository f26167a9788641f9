"""Thread-safe metrics registry: counters, gauges, histograms.

Reference capability (SURVEY §5.5): PaddlePaddle's monitor/profiler stack
keeps always-on runtime statistics next to training; here the registry is
the in-process store every telemetry producer (StepMonitor, the recompile
sentinel, collective accounting) writes through, and sinks snapshot.

Design constraints:

- Pure stdlib — importing this module must stay featherweight so the
  hot-path modules (jit, distributed.communication, launch.preempt) can
  reference the hook containers without dragging jax in.
- One registry lock guards metric *creation*; each metric carries its own
  lock for updates (a counter ``inc`` never contends with an unrelated
  histogram ``observe``).
- Histograms keep a bounded ring of recent observations (default 512) so
  p50/p95 are rolling, not lifetime — a regression shows up in the next
  snapshot instead of being averaged away by an hour of healthy steps.

The port's copy of ``paddle_tpu/observability/registry.py``:
the same names, events and metrics, so a dashboard, a test or
``tools/`` reads both.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, Optional, Union

from .aggregate import HistogramSketch

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonic counter (calls, bytes, compiles...)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Union[int, float]:
        return self._value

    def snapshot(self):
        return self._value


class Gauge:
    """Last-written value (queue depth, HBM highwater, lr...)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = None
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return self._value


class Histogram:
    """Rolling histogram over the last ``window`` observations.

    ``count``/``sum`` are lifetime; ``percentile`` and the snapshot's
    p50/p95 cover only the ring, so they track the *current* regime.
    Percentile convention: nearest-rank (``ceil(p/100 * n)``-th smallest),
    the same convention tools/telemetry_report.py applies offline.

    ``sketch`` is the histogram's lifetime fleet-mergeable shadow
    (:class:`~paddle_tpu_torch.observability.aggregate.HistogramSketch`):
    fixed log-spaced buckets a controller can merge across workers so
    the fleet p95 is computed from merged counts, never from averaged
    per-worker p95s.  The ring cannot serve that role — two rings merge
    into neither worker's distribution.
    """

    __slots__ = ("name", "_ring", "_count", "_sum", "_max", "_lock",
                 "sketch")

    def __init__(self, name: str, window: int = 512):
        self.name = name
        self._ring: deque = deque(maxlen=window)
        self._count = 0
        self._sum = 0.0
        self._max = None
        self._lock = threading.Lock()
        self.sketch = HistogramSketch()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._ring.append(v)
            self._count += 1
            self._sum += v
            if self._max is None or v > self._max:
                self._max = v
        self.sketch.observe(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, p: float) -> Optional[float]:
        with self._lock:
            data = sorted(self._ring)
        if not data:
            return None
        rank = max(1, math.ceil(p / 100.0 * len(data)))
        return data[min(rank, len(data)) - 1]

    def snapshot(self) -> dict:
        with self._lock:
            data = sorted(self._ring)
            count, total, mx = self._count, self._sum, self._max
        out = {"count": count, "sum": round(total, 6)}
        if data:
            def _pick(p):
                return data[max(1, math.ceil(p / 100.0 * len(data))) - 1]
            out.update(mean=round(total / max(count, 1), 6),
                       p50=_pick(50), p95=_pick(95), max=mx)
        return out


_KINDS = {"counter": Counter, "gauge": Gauge}


class MetricsRegistry:
    """Name → metric store; metrics are created on first use.

    A name is bound to one kind for the registry's lifetime — asking for
    ``counter("x")`` after ``gauge("x")`` raises instead of silently
    aliasing two semantics onto one series.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 512) -> Histogram:
        return self._get(name, Histogram, window=window)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        """{name: value | histogram-summary} for the metrics event."""
        with self._lock:
            items = list(self._metrics.items())
        return {n: m.snapshot() for n, m in sorted(items)}
