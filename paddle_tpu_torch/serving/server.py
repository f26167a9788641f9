"""Thin streaming HTTP server over the serving front door.

Pure stdlib (``http.server``/``socketserver``) — the process a fleet
actually runs in front of one engine replica: an OpenAI-ish completions
endpoint per tenant, server-sent-event streaming straight off
``Engine.stream()``'s token events, typed shed answers as HTTP status +
``Retry-After``, and graceful drain on SIGTERM via
:class:`~paddle_tpu_torch.launch.preempt.PreemptionGuard` — in-flight
requests finish, new ones get a 503 with a retry hint, and the process
exits with every KV block reclaimed.

Protocol (``POST /v1/completions``, JSON body)::

    {"prompt": [1, 2, 3] | "text...",   # token ids, or text if the
                                        # server was built with tokenize=
     "max_tokens": 16, "temperature": 0.0, "stream": false,
     "tenant": "default"}               # or the X-Tenant header

Responses: 200 with ``choices[0].token_ids`` (+ ``text`` when the
engine detokenizes); ``"stream": true`` switches to ``text/event-stream``
chunks ending in ``data: [DONE]``.  Sheds map to HTTP: 429 for
``rate_limited``/``quota`` (with ``Retry-After``), 503 for
``queue_full``/``slo_shed``/draining, 400 for ``budget`` and malformed
bodies.  ``GET /healthz`` reports serving/degraded/draining and live
depths — over a replica set (DP or disaggregated) it carries one row
per replica with its role, health, queue depth, and free blocks, and
the top-level status flips to ``degraded`` the moment any replica is
dead (before this, a degraded set answered healthy with no way to see
which replica died).

Operational surface (docs/OBSERVABILITY.md "Tracing a request"):
``GET /metrics`` serves the live registry as Prometheus text exposition
(``observability.sinks.registry_to_prometheus``; engine-local gauges
when telemetry is off, so the endpoint is always scrape-able), and
``GET /v1/requests/<rid>`` returns that request's lifecycle timeline
from the request tracer (404 unknown, 503 when tracing is off).  An
``X-Trace-Id`` request header on ``POST /v1/completions`` propagates
the caller's trace id into the request's timeline
(``observability.trace_context``).

Threading model: handler threads only ever *submit* (under the server
lock) and then read their request's event queue; ONE loop thread drives
``FrontDoor.step()`` and routes events — the engine itself is never
entered concurrently.  The loop thread binds the engine's card as its
current device before its first step, so the captured step replays on
the device it was captured on whatever thread built the engine.

The port's copy of ``paddle_tpu/serving/server.py``, over the port's
engine: the same endpoints, status codes and events; ``/healthz`` has
no replica rows until replica sets are ported (ROADMAP.md, queue 1
item 10).
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .. import observability as obs
from ..observability.sinks import registry_to_prometheus
from ..observability.trace import trace_context
from ..launch.preempt import PreemptionGuard
from .engine import Engine
from .frontdoor import FrontDoor

__all__ = ["ServingServer"]

_MAX_BODY = 8 << 20          # 8 MiB: a prompt, not an upload endpoint


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "paddle-tpu-serving"

    # the BaseHTTPRequestHandler default logs every request to stderr
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    @property
    def srv(self) -> "ServingServer":
        return self.server.serving_server  # type: ignore[attr-defined]

    def _json(self, code: int, payload: dict,
              headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            # tell the client (not just the socket): http.client then
            # reconnects transparently on its next request
            self.send_header("Connection", "close")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    @staticmethod
    def _replica_health(eng):
        """Per-replica role/health rows when ``eng`` is a replica set
        (``EngineReplicaSet`` / ``DisaggReplicaSet``), else None.  A
        degraded set must SAY so: before this, a set with a dead
        replica answered ``healthy`` with no way to see which replica
        died or what role the fleet lost."""
        replicas = getattr(eng, "replicas", None)
        if replicas is None:
            return None, True
        health = list(getattr(eng, "_health", [True] * len(replicas)))
        rows = [{"index": i,
                 "role": getattr(r, "role", "both"),
                 "healthy": bool(health[i]),
                 "queue_depth": r.scheduler.queue_depth(),
                 "active": len(r.scheduler.active()),
                 "free_blocks": r.kv.allocator.free_blocks}
                for i, r in enumerate(replicas)]
        return rows, all(health)

    def do_GET(self):  # noqa: N802
        if self.path == "/healthz":
            srv = self.srv
            with srv._lock:
                eng = srv.door.engine
                replicas, all_healthy = self._replica_health(eng)
                status = "draining" if srv.draining else \
                    ("serving" if all_healthy else "degraded")
                payload = {
                    "status": status,
                    "queue_depth": srv.door.queue_depth(),
                    "active_requests": len(eng.scheduler.active()),
                    "kv_blocks_used": eng.kv_blocks_used,
                }
                if replicas is not None:
                    payload["replicas"] = replicas
                else:
                    payload["role"] = getattr(eng, "role", "both")
            self._json(200, payload)
        elif self.path == "/metrics":
            self._metrics()
        elif self.path.startswith("/v1/requests/"):
            from urllib.parse import unquote
            # strip any query string: /v1/requests/req-7?pretty=1 must
            # look up "req-7", not "req-7?pretty=1"
            rid = self.path[len("/v1/requests/"):].split("?", 1)[0]
            self._request_timeline(unquote(rid))
        else:
            self._json(404, {"error": {"type": "not_found"}})

    def _metrics(self):
        """Prometheus text exposition of the live registry; with
        telemetry disabled, the engine-local gauges still render so the
        endpoint is always scrape-able (never a 500 or an empty 200)."""
        srv = self.srv
        with srv._lock:
            eng = srv.door.engine
            live = {
                "serve.queue_depth": srv.door.queue_depth(),
                "serve.active_requests": len(eng.scheduler.active()),
                "serve.kv_blocks_used": eng.kv_blocks_used,
                "serve.draining": 1 if srv.draining else 0,
            }
            replicas, all_healthy = self._replica_health(eng)
            if replicas is not None:
                # per-replica liveness is scrape-able even with the
                # telemetry registry off: serve_replica_healthy{replica=i}
                live["serve.degraded"] = 0 if all_healthy else 1
                for row in replicas:
                    i = row["index"]
                    live[f"serve.replica[{i}].healthy"] = \
                        1 if row["healthy"] else 0
                    live[f"serve.replica[{i}].is_prefill"] = \
                        1 if row["role"] == "prefill" else 0
        reg = obs.get_registry()
        body = registry_to_prometheus(reg, extra=live).encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _request_timeline(self, rid: str):
        """One request's lifecycle timeline (docs/OBSERVABILITY.md):
        the request tracer's ordered events + exact phase summary."""
        tr = obs.get_request_tracer()
        if tr is None:
            self._json(503, {"error": {
                "type": "tracing_disabled",
                "message": "enable observability with request_tracing "
                           "to serve request timelines"}})
            return
        tl = tr.timeline(rid)
        if tl is None:
            self._json(404, {"error": {"type": "not_found", "id": rid}})
            return
        self._json(200, tl)

    def do_POST(self):  # noqa: N802
        if self.path != "/v1/completions":
            self._json(404, {"error": {"type": "not_found"}})
            return
        srv = self.srv
        try:
            n = int(self.headers.get("Content-Length", 0))
            if not 0 < n <= _MAX_BODY:
                raise ValueError(f"bad Content-Length {n}")
            body = json.loads(self.rfile.read(n))
            prompt = body["prompt"]
            if isinstance(prompt, str):
                if srv.tokenize is None:
                    raise ValueError(
                        "text prompts need a server built with "
                        "tokenize=; send token ids instead")
                prompt = srv.tokenize(prompt)
            prompt = [int(t) for t in prompt]
            max_tokens = int(body.get("max_tokens", 16))
            temperature = float(body.get("temperature", 0.0))
            stream = bool(body.get("stream", False))
            tenant = body.get("tenant") or body.get("user") \
                or self.headers.get("X-Tenant") or "default"
        except Exception as e:  # noqa: BLE001 — malformed body
            # the body may be partly (or not at all) read: answering on
            # a keep-alive stream would desync the next request's parse,
            # so drop the connection with the error
            self.close_connection = True
            self._json(400, {"error": {"type": "invalid_request",
                                       "message": str(e)[:300]}})
            return

        if srv.draining:
            # the typed drain answer: come back once a healthy replica
            # picks up (the front door's shed vocabulary over HTTP)
            ra = srv.drain_retry_after_s
            self._json(503, {"error": {"type": "draining",
                                       "retry_after_s": ra}},
                       headers={"Retry-After": str(int(ra + 0.5) or 1)})
            return

        q: "queue.Queue" = queue.Queue()
        # a caller-supplied trace id joins the request's lifecycle
        # timeline (GET /v1/requests/<rid>); contextvars keep concurrent
        # handler threads' ids from bleeding into each other
        trace_id = self.headers.get("X-Trace-Id")
        ctx = trace_context(trace_id) if trace_id \
            else contextlib.nullcontext()
        with srv._lock, ctx:
            adm = srv.door.submit(prompt, tenant=tenant,
                                  max_new_tokens=max_tokens,
                                  temperature=temperature)
            if adm.admitted:
                srv._routes[adm.request_id] = q
        if not adm.admitted:
            code = {"rate_limited": 429, "quota": 429,
                    "budget": 400}.get(adm.reason, 503)
            headers = {}
            if adm.retry_after_s is not None:
                headers["Retry-After"] = str(int(adm.retry_after_s + 0.5)
                                             or 1)
            self._json(code, {"error": {
                "type": adm.reason, "retry_after_s": adm.retry_after_s}},
                headers=headers)
            return

        rid = adm.request_id
        if stream:
            self._stream_response(rid, q, len(prompt))
        else:
            self._full_response(rid, q, len(prompt))

    def _next_event(self, q):
        ev = q.get(timeout=self.srv.token_timeout_s)
        return ev

    def _full_response(self, rid, q, prompt_len):
        tokens, texts, reason = [], [], None
        try:
            while True:
                ev = self._next_event(q)
                tokens.append(ev.token_id)
                if ev.text is not None:
                    texts.append(ev.text)
                if ev.finished:
                    reason = ev.finish_reason
                    break
        except queue.Empty:
            self._json(504, {"error": {"type": "timeout", "id": rid}})
            return
        self._json(200, {
            "id": rid, "object": "text_completion",
            "choices": [{"index": 0,
                         "text": "".join(texts) if texts else None,
                         "token_ids": tokens, "finish_reason": reason}],
            "usage": {"prompt_tokens": prompt_len,
                      "completion_tokens": len(tokens),
                      "total_tokens": prompt_len + len(tokens)}})

    def _stream_response(self, rid, q, prompt_len):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-store")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(data: str):
            payload = f"data: {data}\n\n".encode()
            self.wfile.write(f"{len(payload):x}\r\n".encode()
                             + payload + b"\r\n")

        try:
            while True:
                ev = self._next_event(q)
                chunk(json.dumps({
                    "id": rid, "object": "text_completion.chunk",
                    "choices": [{"index": 0, "token_id": ev.token_id,
                                 "text": ev.text,
                                 "finish_reason": ev.finish_reason}]}))
                if ev.finished:
                    break
            chunk("[DONE]")
            self.wfile.write(b"0\r\n\r\n")
        except queue.Empty:
            chunk(json.dumps({"error": {"type": "timeout", "id": rid}}))
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass          # client went away; the engine finishes anyway


class ServingServer:
    """One engine replica behind an HTTP front door.

    ``door`` is a :class:`FrontDoor` (a bare warmed :class:`Engine` is
    wrapped in a default one).  ``start()`` spins the listener and the
    engine loop thread and returns ``(host, port)``;
    ``serve_forever()`` additionally installs a
    :class:`PreemptionGuard` and blocks until SIGTERM, then drains
    gracefully (must run on the MAIN thread — signal handlers cannot be
    installed elsewhere).  ``begin_drain()``/``wait_drained()``/
    ``close()`` expose the same lifecycle programmatically."""

    def __init__(self, door, host: str = "127.0.0.1", port: int = 0,
                 tokenize: Optional[Callable] = None,
                 poll_s: float = 0.002, token_timeout_s: float = 120.0,
                 drain_retry_after_s: float = 1.0):
        if isinstance(door, Engine):
            door = FrontDoor(door)
        self.door: FrontDoor = door
        self.tokenize = tokenize
        self.poll_s = float(poll_s)
        self.token_timeout_s = float(token_timeout_s)
        self.drain_retry_after_s = float(drain_retry_after_s)
        self._host, self._port = host, int(port)
        self._lock = threading.Lock()
        # request_id → handler-thread event queue; written by handler
        # threads at submit, read/pruned by the engine-loop thread —
        # every touch under _lock (pdtpu-lint lock-discipline)
        self._routes: dict = {}                      # guarded_by: _lock
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._drained = threading.Event()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._threads: list = []

    # -- lifecycle ---------------------------------------------------------

    @property
    def address(self):
        return (self._host, self._port)

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def start(self):
        """Bind, start the HTTP listener + engine loop threads; returns
        ``(host, port)`` (the OS-assigned port when built with 0)."""
        if self._httpd is not None:
            return self.address

        class _Srv(ThreadingHTTPServer):
            daemon_threads = True

        self._httpd = _Srv((self._host, self._port), _Handler)
        self._httpd.serving_server = self      # type: ignore[attr-defined]
        self._host, self._port = self._httpd.server_address[:2]
        for target, name in ((self._httpd.serve_forever, "http"),
                             (self._loop, "engine-loop")):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"serving-server-{name}")
            t.start()
            self._threads.append(t)
        obs.emit_event("serve_server", state="started", host=self._host,
                       port=self._port)
        return self.address

    def _loop(self):
        dev = getattr(self.door.engine, "device", None)
        if dev is not None and dev.type == "cuda":
            import torch
            torch.cuda.set_device(dev)
        while not self._stop.is_set():
            evs = ()
            with self._lock:
                if self.door.has_work():
                    evs = self.door.step()
            for ev in evs:
                # under the lock: handler threads insert routes
                # concurrently (lint's lock-discipline rule flagged the
                # bare read here — a handler registering its queue
                # between this get and the pop could be missed)
                with self._lock:
                    q = self._routes.get(ev.request_id)
                    if q is not None and ev.finished:
                        self._routes.pop(ev.request_id, None)
                if q is not None:
                    q.put(ev)
            if self._draining.is_set():
                with self._lock:
                    idle = not self.door.has_work()
                if idle:
                    self._drained.set()
            if not evs:
                time.sleep(self.poll_s)

    def begin_drain(self, reason: str = "requested") -> None:
        """Stop accepting new requests (503 + Retry-After); in-flight
        requests keep streaming until the engine empties."""
        if not self._draining.is_set():
            self._draining.set()
            obs.emit_event("serve_server", state="draining",
                           reason=reason)

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        return self._drained.wait(timeout)

    def close(self) -> None:
        """Tear down listener + loop threads (does NOT wait for drain —
        call ``begin_drain()``/``wait_drained()`` first for graceful)."""
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        obs.emit_event("serve_server", state="closed")

    def serve_forever(self) -> None:
        """Block until SIGTERM, then drain gracefully and return.  Main
        thread only (installs a signal handler via PreemptionGuard)."""
        self.start()
        guard = PreemptionGuard()
        try:
            with guard:
                while not self._stop.is_set() and not guard.preempted:
                    time.sleep(max(self.poll_s, 0.01))
        finally:
            self.begin_drain(reason="sigterm" if guard.preempted
                             else "closed")
            self.wait_drained(timeout=self.token_timeout_s)
            self.close()
