"""Fleet-mergeable telemetry: histogram sketches, wire snapshots, folds.

The single-process registry (``registry.py``) keeps a rolling ring per
histogram — right for one worker's "current regime" p95, useless for a
fleet: percentiles do not average, so a controller holding ten workers'
p95s cannot produce the fleet p95.  This module is the mergeable half:

- :class:`HistogramSketch` — fixed log-spaced buckets shared by every
  sketch in the fleet, so ``merge`` is element-wise addition and is
  associative/commutative by construction.  Fleet p95 is computed from
  the MERGED sketch, never from averaged per-worker p95s.
- :func:`registry_to_wire` — one worker's registry as a JSON-able
  snapshot (counters/gauges by value, histograms by sketch), the
  payload workers publish to ``telemetry/<wid>`` store keys.
- :func:`fleet_fold` — per-worker wire snapshots folded into one
  :class:`FleetRegistry` carrying per-worker-labelled series
  (``serve.ttft_ms[worker=w0,role=decode]``), per-role tier rollups and
  unlabelled fleet rollups; duck-typed so
  ``sinks.registry_to_prometheus`` renders it unchanged.
- :func:`stitch_trace_segments` — per-worker ``serve_trace`` segments
  of one request (prefill worker + decode worker, split by a cross-host
  KV handoff) joined into one timeline on the controller's timebase,
  with per-worker clock-skew correction; each segment's exact-sum phase
  invariant is preserved verbatim, and inter-segment gaps are
  attributed to ``xfer``.

Keep this module stdlib-only with NO relative imports:
``tools/telemetry_report.py`` and ``tools/trace_export.py`` load it
standalone (``importlib``, no package import, no jax), the same
contract ``sinks.py`` honors, so the live controller surface and the
offline tools cannot drift.

The port's copy of ``paddle_tpu/observability/aggregate.py``:
the same names, events and metrics, so a dashboard, a test or
``tools/`` reads both.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["HistogramSketch", "FleetRegistry", "fleet_fold",
           "registry_to_wire", "stitch_trace_segments"]

# Bucket geometry — a module constant so every sketch in the fleet (and
# every release that keeps this table) merges element-wise.  16 buckets
# per decade over [1e-3, 1e7) covers microsecond phase times through
# multi-hour walls with a per-bucket width of 10^(1/16) ≈ 1.155, i.e. a
# worst-case relative quantile error of ~15.5% (typically half that);
# index 0 is the underflow bucket (v <= 1e-3, including zeros), the
# last index the overflow bucket (v > 1e7).
BUCKETS_PER_DECADE = 16
_MIN_EXP = -3
_MAX_EXP = 7
_CORE = (_MAX_EXP - _MIN_EXP) * BUCKETS_PER_DECADE
NUM_BUCKETS = _CORE + 2                  # + underflow + overflow


def _bucket_index(v: float) -> int:
    if v <= 10.0 ** _MIN_EXP:
        return 0
    x = (math.log10(v) - _MIN_EXP) * BUCKETS_PER_DECADE
    if x >= _CORE:
        return NUM_BUCKETS - 1
    # strictly-greater lower edge: a value exactly on a bucket's lower
    # bound belongs to that bucket's predecessor's successor — int(x)
    # floors, +1 skips the underflow slot
    return min(int(x) + 1, _CORE)


def _bucket_upper(i: int) -> float:
    """Upper bound of core bucket ``i`` (1..CORE)."""
    return 10.0 ** (_MIN_EXP + i / BUCKETS_PER_DECADE)


class HistogramSketch:
    """Fixed-bucket log-spaced histogram; merge = element-wise add.

    Lifetime (not rolling) on purpose: merged fleet series must be
    monotone so scrapes at different instants stay comparable; the
    rolling "current regime" view stays the per-worker ring's job.
    ``percentile`` is nearest-rank over the cumulative bucket counts,
    answering with the bucket's upper bound clamped into the exact
    observed ``[min, max]`` — a single-value sketch reports that value
    exactly, and the error bound is one bucket width.
    """

    __slots__ = ("_counts", "_count", "_sum", "_min", "_max", "_lock")

    def __init__(self):
        self._counts: Dict[int, int] = {}
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = _bucket_index(v)
        with self._lock:
            self._counts[i] = self._counts.get(i, 0) + 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def merge(self, other: "HistogramSketch") -> "HistogramSketch":
        """Fold ``other`` into self (returns self).  Element-wise over
        the shared bucket table: associative and commutative, the
        property that makes fleet percentiles well-defined no matter
        which controller folds which worker first."""
        with other._lock:
            counts = dict(other._counts)
            cnt, tot = other._count, other._sum
            mn, mx = other._min, other._max
        with self._lock:
            for i, n in counts.items():
                self._counts[i] = self._counts.get(i, 0) + n
            self._count += cnt
            self._sum += tot
            if mn is not None and (self._min is None or mn < self._min):
                self._min = mn
            if mx is not None and (self._max is None or mx > self._max):
                self._max = mx
        return self

    def copy(self) -> "HistogramSketch":
        return HistogramSketch().merge(self)

    def percentile(self, p: float) -> Optional[float]:
        with self._lock:
            if not self._count:
                return None
            rank = max(1, math.ceil(p / 100.0 * self._count))
            seen = 0
            for i in sorted(self._counts):
                seen += self._counts[i]
                if seen >= rank:
                    if i == 0:
                        v = self._min
                    elif i == NUM_BUCKETS - 1:
                        v = self._max
                    else:
                        v = _bucket_upper(i)
                    if v is None:    # foreign wire without min/max
                        v = _bucket_upper(max(min(i, _CORE), 1))
                    if self._min is not None:
                        v = max(v, self._min)
                    if self._max is not None:
                        v = min(v, self._max)
                    return v
        return self._max

    def snapshot(self) -> dict:
        """Same shape as ``registry.Histogram.snapshot`` so the prom
        exporter's summary rendering applies unchanged."""
        with self._lock:
            count, total, mx = self._count, self._sum, self._max
        out = {"count": count, "sum": round(total, 6)}
        if count:
            out.update(mean=round(total / count, 6),
                       p50=self.percentile(50), p95=self.percentile(95),
                       max=mx)
        return out

    # -- wire format ---------------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-able snapshot (sparse buckets, keys stringified for
        JSON round-trips)."""
        with self._lock:
            return {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    "buckets": {str(i): n
                                for i, n in sorted(self._counts.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "HistogramSketch":
        sk = cls()
        sk._count = int(d.get("count") or 0)
        sk._sum = float(d.get("sum") or 0.0)
        sk._min = None if d.get("min") is None else float(d["min"])
        sk._max = None if d.get("max") is None else float(d["max"])
        for k, n in (d.get("buckets") or {}).items():
            i = int(k)
            if 0 <= i < NUM_BUCKETS and int(n) > 0:
                sk._counts[i] = sk._counts.get(i, 0) + int(n)
        return sk


# ---------------------------------------------------------------------------
# registry wire snapshots
# ---------------------------------------------------------------------------

def registry_to_wire(registry) -> Dict[str, dict]:
    """One registry as a JSON-able ``{name: {"kind": ..., ...}}`` dict —
    counters/gauges by value, histograms by their mergeable sketch.
    Duck-typed (``sketch``/``inc``/``observe``) so it works on the real
    :class:`~paddle_tpu_torch.observability.MetricsRegistry` and on fakes.
    Gauges holding non-numeric values are skipped (same rule as the
    prom exporter)."""
    out: Dict[str, dict] = {}
    for name in registry.names():
        m = registry.get(name)
        if m is None:
            continue
        sk = getattr(m, "sketch", None)
        if sk is not None:
            out[name] = {"kind": "sketch", **sk.to_dict()}
        elif hasattr(m, "observe"):
            continue                # sketchless histogram: not mergeable
        elif hasattr(m, "inc"):
            out[name] = {"kind": "counter", "value": m.snapshot()}
        else:
            v = m.snapshot()
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, (int, float)):
                out[name] = {"kind": "gauge", "value": v}
    return out


# ---------------------------------------------------------------------------
# the fleet fold
# ---------------------------------------------------------------------------

class _CounterView:
    """Read-mostly counter view (``inc`` marks the prom kind)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value=0):
        self.name = name
        self.value = value

    def inc(self, n=1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class _GaugeView:
    __slots__ = ("name", "value")

    def __init__(self, name: str, value=None):
        self.name = name
        self.value = value

    def set(self, v) -> None:
        self.value = v

    def snapshot(self):
        return self.value


class _SketchView:
    """Sketch wrapper; ``observe`` marks the prom summary kind and the
    snapshot carries the merged p50/p95."""

    __slots__ = ("name", "sketch")

    def __init__(self, name: str, sketch: Optional[HistogramSketch] = None):
        self.name = name
        self.sketch = sketch if sketch is not None else HistogramSketch()

    def observe(self, v: float) -> None:
        self.sketch.observe(v)

    def percentile(self, p: float):
        return self.sketch.percentile(p)

    def snapshot(self) -> dict:
        return self.sketch.snapshot()


class FleetRegistry:
    """A read-only registry of fold views, duck-type compatible with
    ``sinks.registry_to_prometheus`` (``names``/``get`` plus per-metric
    ``inc``/``observe``/``snapshot``)."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        return {n: m.snapshot()
                for n, m in sorted(self._metrics.items())}

    # fold surface ----------------------------------------------------------

    def _counter(self, name: str) -> _CounterView:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = _CounterView(name)
        return m

    def _gauge(self, name: str) -> _GaugeView:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = _GaugeView(name)
        return m

    def _sketch(self, name: str) -> _SketchView:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = _SketchView(name)
        return m


def _label_value(v) -> str:
    """Bracket-content sanitization: the fleet grammar's reserved chars
    cannot appear inside a label value."""
    s = str(v)
    for ch in "[],=":
        s = s.replace(ch, "_")
    return s


def _labeled(name: str, pairs: List[Tuple[str, str]]) -> str:
    lbl = ",".join(f"{k}={_label_value(v)}" for k, v in pairs)
    return f"{name}[{lbl}]"


def fleet_fold(snapshots: Dict[str, dict]) -> FleetRegistry:
    """Fold per-worker wire snapshots (``{wid: {"role": ...,
    "metrics": {name: wire}}}`` — the ``telemetry/<wid>`` payloads)
    into one :class:`FleetRegistry`:

    - ``name[worker=<wid>,role=<role>]`` — per-worker series,
    - ``name[role=<role>]`` — tier rollup (counters/gauges summed,
      sketches merged),
    - ``name`` — fleet rollup.

    Sketch percentiles in the rollups come from the MERGED buckets;
    gauge rollups are sums (additive gauges — queue depth, tok/s, KV
    blocks — are the fleet reading; non-additive ones are still exact
    in their per-worker series)."""
    fleet = FleetRegistry()
    for wid in sorted(snapshots):
        snap = snapshots[wid] or {}
        role = snap.get("role") or "?"
        per_worker = [("worker", wid), ("role", role)]
        per_role = [("role", role)]
        for name in sorted(snap.get("metrics") or {}):
            wire = snap["metrics"][name]
            kind = wire.get("kind")
            if kind == "counter":
                v = wire.get("value") or 0
                fleet._counter(_labeled(name, per_worker)).inc(v)
                fleet._counter(_labeled(name, per_role)).inc(v)
                fleet._counter(name).inc(v)
            elif kind == "gauge":
                v = wire.get("value")
                if not isinstance(v, (int, float)) \
                        or isinstance(v, bool):
                    continue
                fleet._gauge(_labeled(name, per_worker)).set(v)
                g = fleet._gauge(_labeled(name, per_role))
                g.set((g.value or 0) + v)
                g = fleet._gauge(name)
                g.set((g.value or 0) + v)
            elif kind == "sketch":
                sk = HistogramSketch.from_dict(wire)
                fleet._sketch(_labeled(name, per_worker)).sketch \
                    .merge(sk)
                fleet._sketch(_labeled(name, per_role)).sketch \
                    .merge(sk)
                fleet._sketch(name).sketch.merge(sk)
    return fleet


# ---------------------------------------------------------------------------
# cross-host trace stitching
# ---------------------------------------------------------------------------

def stitch_trace_segments(segments: List[dict]) -> Optional[dict]:
    """Join one request's per-worker ``serve_trace`` segments into one
    timeline on the controller's timebase.

    Each segment is a tracer ``timeline()`` payload plus the worker's
    shipping envelope (``worker``/``role``/``epoch``/``clock_offset``,
    where ``clock_offset`` = worker wall clock − controller wall clock
    as estimated from store round-trips).  Segments are ordered by
    skew-corrected start time; every segment's own phase accounting is
    preserved verbatim (its exact-sum invariant is per-clock and must
    not be re-derived across hosts), and each positive inter-segment
    gap — the cross-host KV handoff window — is added to the stitched
    ``xfer_ms``.  The stitched wall is DEFINED as the sum of segment
    walls plus positive gaps, so the top-level phase sums reproduce the
    exact-sum invariant by construction; ``monotonic`` reports whether
    the corrected segments were in fact non-overlapping (a false value
    means residual skew beyond the correction).
    """
    if not segments:
        return None

    def _summary(seg: dict) -> dict:
        return seg.get("summary") or {}

    corr = []
    for seg in segments:
        t0 = float(seg.get("t0") or 0.0)
        off = float(seg.get("clock_offset") or 0.0)
        start = t0 - off
        wall = float(_summary(seg).get("wall_ms") or 0.0)
        corr.append((start, seg.get("worker") or "?", seg, wall))
    corr.sort(key=lambda c: (c[0], c[1]))

    phases = {"queue_ms": 0.0, "prefill_ms": 0.0, "xfer_ms": 0.0,
              "decode_ms": 0.0}
    out_segs: List[dict] = []
    monotonic = True
    gap_total = 0.0
    prev_end = None
    for start, _, seg, wall in corr:
        s = _summary(seg)
        for k in phases:
            phases[k] += float(s.get(k) or 0.0)
        if prev_end is not None:
            gap_ms = (start - prev_end) * 1e3
            if gap_ms < -0.5:        # > rounding noise: residual skew
                monotonic = False
            gap_ms = max(gap_ms, 0.0)
            phases["xfer_ms"] += gap_ms
            gap_total += gap_ms
        prev_end = start + wall / 1e3
        out_segs.append({"worker": seg.get("worker"),
                         "role": seg.get("role"),
                         "epoch": seg.get("epoch"),
                         "start": round(start, 6),
                         "end": round(prev_end, 6),
                         "clock_offset": seg.get("clock_offset") or 0.0,
                         "summary": dict(s),
                         "events": [dict(e)
                                    for e in seg.get("events") or []]})

    head = corr[0][2]
    tail = corr[-1][2]
    phases = {k: round(v, 3) for k, v in phases.items()}
    last = _summary(tail)
    return {"id": head.get("id") or head.get("request_id"),
            "trace_id": head.get("trace_id"),
            "tenant": head.get("tenant"),
            "segments": out_segs,
            "hosts": sorted({s["worker"] for s in out_segs
                             if s["worker"]}),
            "xfer_gap_ms": round(gap_total, 3),
            "monotonic": monotonic,
            "reason": last.get("reason"),
            "decode_tokens": last.get("decode_tokens"),
            **phases,
            "wall_ms": round(sum(phases.values()), 3)}
