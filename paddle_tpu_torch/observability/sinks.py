"""Telemetry sinks: where structured events go.

One event = one flat-ish JSON-serializable dict with at least ``event``
(kind) and ``ts`` (unix seconds, stamped by ``Telemetry.emit``).  Sinks
are deliberately dumb — no buffering policy beyond line-flush, no
schema enforcement — so a sink can never stall a train step for long,
and the JSONL stream stays greppable/tail-able while the job runs.

Multihost: ``enable()`` wraps file/stdout sinks in process-0 gating (see
``__init__.enable``); ``InMemorySink`` is never gated (tests assert on
every process).

This module also owns the registry→Prometheus text-exposition converter
(:func:`registry_to_prometheus`) and its name grammar
(:func:`prom_split`): bracketed registry names like
``serve.replica[0].free_blocks`` become labelled prom series
(``serve_replica_free_blocks{replica="0"}``) — the label KEY is the
dotted component carrying the bracket.  ``tools/telemetry_report.py``
loads this file standalone (no package import, no jax) and reuses the
same grammar, so the live ``/metrics`` surface and the offline report
cannot drift.  Keep this module stdlib-only with NO relative imports.

The port's copy of ``paddle_tpu/observability/sinks.py``:
the same names, events and metrics, so a dashboard, a test or
``tools/`` reads both.
"""

from __future__ import annotations

import json
import re
import sys
from typing import List, Optional, Tuple

__all__ = ["Sink", "InMemorySink", "JsonlSink", "StdoutSink",
           "prom_name", "prom_split", "registry_to_prometheus"]


def _jsonable(v):
    """Best-effort scalarization: device arrays / numpy scalars become
    Python floats so a sink never triggers a surprising repr or keeps a
    buffer alive inside the event stream."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:
        return float(v)
    except Exception:
        return repr(v)


# -- Prometheus text exposition ---------------------------------------------

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name: str) -> str:
    """Sanitize one metric name into the Prometheus grammar
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``): every other char becomes ``_``."""
    n = _PROM_BAD.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return n


def prom_split(name: str) -> Tuple[str, List[Tuple[str, str]]]:
    """Split a registry name into ``(prom_name, [(label_key, value)])``.

    ``serve.replica[0].free_blocks`` → ``("serve_replica_free_blocks",
    [("replica", "0")])``; the label key is the dotted component the
    bracket is attached to (``serve.tenant[acme].requests`` →
    ``tenant="acme"``, ``span[ckpt.save].ms`` → ``span="ckpt.save"``).
    Bracket content containing ``=`` is the fleet-fold grammar
    (``observability/aggregate.py``): explicit comma-separated label
    pairs — ``serve.ttft_ms[worker=w0,role=decode]`` →
    ``("serve_ttft_ms", [("worker", "w0"), ("role", "decode")])`` — so
    per-worker series and the unlabelled fleet rollup share one prom
    family.  Unbracketed names pass through with no labels.
    """
    labels: List[Tuple[str, str]] = []
    out: List[str] = []
    rest = name
    while True:
        i = rest.find("[")
        if i < 0:
            out.append(rest)
            break
        j = rest.find("]", i)
        if j < 0:                       # unbalanced: treat as literal
            out.append(rest)
            break
        head = rest[:i]
        out.append(head)
        content = rest[i + 1:j]
        if "=" in content:
            for part in content.split(","):
                k, _, v = part.partition("=")
                labels.append((prom_name(k.strip()) or "label",
                               v.strip()))
        else:
            key = head.rsplit(".", 1)[-1]
            labels.append((prom_name(key) or "label", content))
        rest = rest[j + 1:]
    base = "".join(out).strip(".")
    return prom_name(base), labels


def _prom_escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _prom_num(v):
    """A renderable sample value, or None (prom samples are numbers)."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return v
    return None


def registry_to_prometheus(registry=None, extra=None) -> str:
    """Render a ``MetricsRegistry`` as Prometheus text exposition
    (version 0.0.4) — the body of the serving server's ``GET /metrics``.

    Counters/gauges render as their kind; histograms render as
    summaries (``_count``/``_sum`` plus ``quantile="0.5"/"0.95"``
    samples from the rolling window).  Metric kinds are duck-typed
    (``inc``/``set``/``observe``) so this module stays standalone.
    Gauges holding non-numeric values are skipped.  ``extra`` is a
    ``{registry_name: value}`` dict of engine-local gauges appended for
    names the registry does not already carry — the fallback surface
    when telemetry is disabled.
    """
    # prom pname -> (kind, [(suffix, labels, value)]); grouped so every
    # series emits ONE # TYPE line followed by all its samples
    groups: dict = {}
    order: List[str] = []

    def _add(pname, kind, suffix, labels, value):
        v = _prom_num(value)
        if v is None:
            return
        g = groups.get(pname)
        if g is None:
            groups[pname] = g = (kind, [])
            order.append(pname)
        elif g[0] != kind:
            return       # post-sanitation kind collision: first wins
        g[1].append((suffix, labels, v))

    names = registry.names() if registry is not None else []
    for name in names:
        m = registry.get(name)
        if m is None:
            continue
        pname, labels = prom_split(name)
        if hasattr(m, "observe"):
            snap = m.snapshot()
            _add(pname, "summary", "_count", labels, snap.get("count"))
            _add(pname, "summary", "_sum", labels, snap.get("sum"))
            for q, key in (("0.5", "p50"), ("0.95", "p95")):
                _add(pname, "summary", "", labels + [("quantile", q)],
                     snap.get(key))
        elif hasattr(m, "inc"):
            _add(pname, "counter", "", labels, m.snapshot())
        else:
            _add(pname, "gauge", "", labels, m.snapshot())
    have = set(names)
    for name, value in sorted((extra or {}).items()):
        if name in have:
            continue                 # live registry series wins
        pname, labels = prom_split(name)
        _add(pname, "gauge", "", labels, value)

    lines: List[str] = []
    for pname in order:
        kind, samples = groups[pname]
        if not samples:
            continue
        lines.append(f"# TYPE {pname} {kind}")
        for suffix, labels, v in samples:
            lbl = ""
            if labels:
                lbl = "{" + ",".join(
                    f'{k}="{_prom_escape(val)}"' for k, val in labels) \
                    + "}"
            lines.append(f"{pname}{suffix}{lbl} {v}")
    return "\n".join(lines) + ("\n" if lines else "")


class Sink:
    """Interface: ``write(event_dict)`` + optional ``flush``/``close``."""

    def write(self, event: dict) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


class InMemorySink(Sink):
    """Keeps events in memory — the test/inspection sink.

    ``maxlen`` bounds the buffer (oldest events dropped); ``enable()``'s
    default sink passes one so a sinkless long-running job cannot grow
    an event list without bound."""

    def __init__(self, maxlen: Optional[int] = None):
        from collections import deque
        self.records = deque(maxlen=maxlen)

    def write(self, event: dict) -> None:
        self.records.append(event)

    def events(self, kind: Optional[str] = None) -> List[dict]:
        if kind is None:
            return list(self.records)
        return [e for e in self.records if e.get("event") == kind]

    def clear(self) -> None:
        self.records.clear()


class JsonlSink(Sink):
    """Appends one JSON line per event to ``path``.

    The file is opened lazily (first event) and flushed per line, so a
    preemption event emitted from a SIGTERM handler is on disk before the
    process exits, and ``tail -f`` sees steps as they happen.
    """

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def write(self, event: dict) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a")
        # serialize fully, then ONE write call: a signal handler emitting
        # mid-write (preemption) must not interleave half-built lines
        self._fh.write(json.dumps(_jsonable(event),
                                  separators=(",", ":")) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class StdoutSink(Sink):
    """One JSON line per event to stderr by default.

    Default stream is *stderr*, not stdout: bench.py and chip_smoke.py own
    a one-JSON-line-on-stdout contract that interleaved telemetry would
    corrupt.  Pass ``stream=sys.stdout`` explicitly to opt in.
    """

    def __init__(self, stream=None):
        self._stream = stream if stream is not None else sys.stderr

    def write(self, event: dict) -> None:
        self._stream.write(json.dumps(_jsonable(event),
                                      separators=(",", ":")) + "\n")
        self._stream.flush()


class _ProcessZeroGate(Sink):
    """Wraps a sink; drops events on non-zero processes (multihost: one
    JSONL stream per job, not per host, matching how the reference gates
    its logging on rank 0)."""

    def __init__(self, inner: Sink, is_zero: bool):
        self.inner = inner
        self._is_zero = is_zero

    def write(self, event: dict) -> None:
        if self._is_zero:
            self.inner.write(event)

    def flush(self) -> None:
        if self._is_zero:
            self.inner.flush()

    def close(self) -> None:
        if self._is_zero:
            self.inner.close()
