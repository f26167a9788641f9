"""The port's multi-tenant front door and streaming server
(``paddle_tpu_torch.serving.FrontDoor``, ``TenantPolicy``,
``TokenBucket``, ``ServingServer``) held against the JAX package on the
CPU: twins of ``tests/test_frontdoor.py``, plus the tenant-to-adapter
mapping of ``tests/test_lora.py``'s front-door tests.

Both sides run the same seeded tiny Llama, the same submissions and the
same injected clocks (``test_torch_trace.Side``).  Held exactly equal:
every admission and shed answer (admitted, reason, ``retry_after_s`` --
the hint is deterministic with telemetry off; with it on it divides by
the measured tok/s, so only the reason is compared there), the order in
which the door feeds the engine and requests finish, preemption counts,
the deterministic counters, the shed and preempt events, and
``tools/telemetry_report.py``'s serving fold.  Greedy streams are equal
under the near-tie rule (``TIE`` 1e-3 on the port's own f32 margins).
The HTTP server runs on the port alone, its tokens held against the JAX
engine's for the same prompts.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.serving import (AdapterInUse, LoRAPool, TenantPolicy,
                                      UnknownAdapter)
from test_torch_trace import (  # noqa: F401 (fixtures: one_thread, sides)
    REPO, assert_same_registry, one_thread, prompts, sides, streams_equal,
    twin)

SMALL = dict(max_seq_len=32, page_size=8, prefill_chunk=16)


def answers(adms):
    return [(a.admitted, a.reason, a.retry_after_s) for a in adms]


def in_order(adms, outs):
    return [(a.request_id, outs[a.request_id]) for a in adms if a.admitted]


# -- the token bucket ---------------------------------------------------------


def test_token_bucket_equals_reference():
    waits = []
    for mod in (jserving, tserving):
        t = [0.0]
        b = mod.TokenBucket(rate=10.0, capacity=20.0, clock=lambda: t[0])
        w = [b.try_take(15), b.try_take(10)]
        t[0] += 0.5
        w += [b.try_take(10), b.try_take(25),
              mod.TokenBucket(0.0, 1.0, clock=lambda: t[0]).try_take(2)]
        waits.append(w)
    assert waits[1] == waits[0]
    assert waits[1][:3] == [0.0, pytest.approx(0.5), 0.0]
    assert waits[1][3:] == [float("inf")] * 2


# -- shedding: twins, telemetry off ------------------------------------------


def _shed_retry(side):
    eng = side.engine(max_batch=2, **SMALL)
    door = side.serving.FrontDoor(eng, max_queue_depth=3)
    p = prompts(30, *[4] * 9)
    adms = [door.submit(x, max_new_tokens=3) for x in p[:8]]
    outs = door.run()
    assert eng.kv_blocks_used == 0 and len(outs) == sum(
        a.admitted for a in adms)
    retry = door.submit(p[8], max_new_tokens=3)
    outs.update(door.run())
    adms.append(retry)
    return eng, adms, outs


def _rate_limit(side):
    eng = side.engine(max_batch=2, **SMALL)
    t = [0.0]
    door = side.serving.FrontDoor(eng, policies={
        "free": side.serving.TenantPolicy(rate_tokens_per_s=1.0,
                                          burst_tokens=10.0)},
        clock=lambda: t[0])
    p = prompts(31, 4, 4, 4)
    adms = [door.submit(p[0], tenant="free", max_new_tokens=4),
            door.submit(p[1], tenant="free", max_new_tokens=4)]
    t[0] += adms[1].retry_after_s            # wait as told: admitted
    adms.append(door.submit(p[2], tenant="free", max_new_tokens=4))
    return eng, adms, door.run()


def _quota_budget(side):
    eng = side.engine(max_batch=1, **SMALL)
    door = side.serving.FrontDoor(eng, policies={
        "q": side.serving.TenantPolicy(max_live_requests=1)})
    p = prompts(32, 3, 3, 40, 3)
    adms = [door.submit(p[0], tenant="q", max_new_tokens=8),
            door.submit(p[1], tenant="q", max_new_tokens=8),
            door.submit(p[2], max_new_tokens=8)]
    outs = door.run()
    adms.append(door.submit(p[3], tenant="q", max_new_tokens=8))
    outs.update(door.run())
    return eng, adms, outs


def _raise_on_shed(side):
    eng = side.engine(max_batch=1, **SMALL)
    t = [0.0]
    door = side.serving.FrontDoor(eng, policies={
        "free": side.serving.TenantPolicy(rate_tokens_per_s=1.0,
                                          burst_tokens=5.0)},
        max_queue_depth=2, clock=lambda: t[0])
    p = prompts(33, 3, 3, 3, 3)
    adms = [door.submit(p[0], tenant="free", max_new_tokens=2)]
    with pytest.raises(side.serving.RateLimited) as e:
        door.submit(p[1], tenant="free", max_new_tokens=2,
                    raise_on_shed=True)
    raised = [("RateLimited", e.value.retry_after_s)]
    adms.append(door.submit(p[2], tenant="other", max_new_tokens=2))
    with pytest.raises(side.serving.QueueFull) as e:
        door.submit(p[3], tenant="other", max_new_tokens=2,
                    raise_on_shed=True)
    raised.append(("QueueFull", e.value.retry_after_s))
    assert raised[0][1] > 0
    return eng, adms, door.run(), raised


def _bucket_not_charged(side):
    eng = side.engine(max_batch=1, **SMALL)
    t = [0.0]
    door = side.serving.FrontDoor(eng, policies={
        "free": side.serving.TenantPolicy(rate_tokens_per_s=1.0,
                                          burst_tokens=6.0)},
        max_queue_depth=1, clock=lambda: t[0])
    p = prompts(34, *[4] * 8)
    adms = [door.submit(p[0], max_new_tokens=2)]
    adms += [door.submit(x, tenant="free", max_new_tokens=2)
             for x in p[1:6]]
    outs = door.run()
    adms.append(door.submit(p[6], tenant="free", max_new_tokens=2))
    outs.update(door.run())
    t[0] += 10.0
    adms.append(door.submit(p[7], tenant="free", max_new_tokens=8))
    outs.update(door.run())
    return eng, adms, outs


SHED = {"shed_then_retry": _shed_retry, "rate_limit_clock": _rate_limit,
        "quota_and_budget": _quota_budget, "raise_on_shed": _raise_on_shed,
        "bucket_not_charged": _bucket_not_charged}

WANT = {
    "shed_then_retry": lambda a: [x[:2] for x in a] == [(True, None)] * 3
    + [(False, "queue_full")] * 5 + [(True, None)],
    "rate_limit_clock": lambda a: [x[:2] for x in a] == [
        (True, None), (False, "rate_limited"), (True, None)]
    and a[1][2] >= 6,
    "quota_and_budget": lambda a: a == [(True, None, None),
                                        a[1], (False, "budget", None),
                                        (True, None, None)]
    and a[1][:2] == (False, "quota"),
    "raise_on_shed": lambda a: a == [(True, None, None)] * 2,
    "bucket_not_charged": lambda a: [x[:2] for x in a] == [(True, None)]
    + [(False, "queue_full")] * 5 + [(True, None), (False, "budget")]
    and a[-1][2] is None,
}


@pytest.mark.parametrize("name", list(SHED))
def test_shedding_equals_reference(sides, name):
    """Every answer -- admitted, reason, retry-after -- and every stream
    equal to the reference's; the pool drains."""
    j, t = twin(sides, SHED[name])
    assert answers(t[1]) == answers(j[1])
    assert WANT[name](answers(t[1])), answers(t[1])
    assert all(a.request_id is None for a in t[1] if not a.admitted)
    streams_equal(in_order(j[1], j[2]), in_order(t[1], t[2]), t[0].margins)
    assert t[0].kv_blocks_used == 0
    if name == "raise_on_shed":
        assert t[3] == j[3]


def _slo_backpressure(side):
    eng = side.engine(max_batch=2, **SMALL)
    with side.telemetry() as tel:
        door = side.serving.FrontDoor(eng, policies={
            "lo": side.serving.TenantPolicy(priority=0),
            "hi": side.serving.TenantPolicy(priority=1)},
            slo_ttft_p95_ms=0.000001)
        p = prompts(35, 3, 3, 3)
        adms = [door.submit(p[0], tenant="lo", max_new_tokens=2)]
        outs = door.run()
        adms += [door.submit(p[1], tenant="lo", max_new_tokens=2),
                 door.submit(p[2], tenant="hi", max_new_tokens=2)]
        outs.update(door.run())
        sheds = [(e["tenant"], e["reason"])
                 for e in tel.sinks[0].events("serve_shed")]
    return eng, adms, outs, tel, sheds


def test_slo_ttft_backpressure_equals_reference(sides):
    """With the TTFT p95 over its SLO the low tier sheds ``slo_shed``, the
    protected tier is admitted; the same answers, counters and shed
    events as the reference (retry-after > 0 on both: it divides by the
    measured tok/s)."""
    j, t = twin(sides, _slo_backpressure)
    assert [a[:2] for a in answers(t[1])] == [a[:2] for a in answers(j[1])]
    assert [a[:2] for a in answers(t[1])] == [
        (True, None), (False, "slo_shed"), (True, None)]
    assert t[1][1].retry_after_s > 0 and j[1][1].retry_after_s > 0
    streams_equal(in_order(j[1], j[2]), in_order(t[1], t[2]), t[0].margins)
    assert_same_registry(j[3], t[3])
    assert t[4] == j[4] == [("lo", "slo_shed")]
    assert t[3].registry.snapshot()["serve.shed"] == 1


# -- fairness and preemption: twins -------------------------------------------


def _flood(side):
    eng = side.engine(max_batch=2, **SMALL)
    door = side.serving.FrontDoor(eng, policies={
        "lo": side.serving.TenantPolicy(priority=0),
        "hi": side.serving.TenantPolicy(priority=1)}, max_queue_depth=64)
    p = prompts(36, *[4] * 12)
    adms = [door.submit(x, tenant="lo", max_new_tokens=4) for x in p[:10]]
    adms += [door.submit(x, tenant="hi", max_new_tokens=4) for x in p[10:]]
    order = [adms.index(next(a for a in adms if a.request_id == ev.request_id))
             for ev in door.stream() if ev.finished]
    outs = {a.request_id: eng.output_ids(a.request_id) for a in adms}
    return eng, adms, outs, order


def _drr(side):
    eng = side.engine(max_batch=3, **SMALL)
    door = side.serving.FrontDoor(eng, policies={
        "a": side.serving.TenantPolicy(weight=2.0),
        "b": side.serving.TenantPolicy(weight=1.0)},
        max_queue_depth=64, drr_quantum=4)
    order = []
    orig = eng.add_request

    def tracking(*a, **kw):
        order.append(kw.get("tenant"))
        return orig(*a, **kw)

    eng.add_request = tracking
    try:
        p = prompts(37, *[4] * 12)
        adms = [door.submit(x, tenant="b", max_new_tokens=2) for x in p[:6]]
        adms += [door.submit(x, tenant="a", max_new_tokens=2)
                 for x in p[6:]]
        outs = door.run()
    finally:
        del eng.add_request
    return eng, adms, outs, order


def _pressure(side):
    eng = side.engine(max_batch=2, num_blocks=4, **SMALL)
    with side.telemetry() as tel:
        door = side.serving.FrontDoor(eng, policies={
            "lo": side.serving.TenantPolicy(priority=0),
            "hi": side.serving.TenantPolicy(priority=1)})
        p_lo, p_hi = prompts(38, 9, 11)
        lo = door.submit(p_lo, tenant="lo", max_new_tokens=12)
        door.step()
        door.step()
        hi = door.submit(p_hi, tenant="hi", max_new_tokens=12)
        door.step()
        preempts = eng._states[lo.request_id].preempts
        outs = door.run()
        reasons = [e["reason"] for e in tel.sinks[0].events("serve_preempt")]
    return eng, [lo, hi], outs, (preempts, reasons), tel


def _same_priority(side):
    eng = side.engine(max_batch=2, num_blocks=4, **SMALL)
    door = side.serving.FrontDoor(eng)
    p = prompts(39, 9, 11)
    r1 = door.submit(p[0], max_new_tokens=12)
    door.step()
    door.step()
    r2 = door.submit(p[1], max_new_tokens=12)
    door.step()
    door.step()
    preempts = eng._states[r1.request_id].preempts
    return eng, [r1, r2], door.run(), preempts


FAIR = {"priority_flood": _flood, "weighted_drr": _drr,
        "pool_pressure_preemption": _pressure,
        "no_preemption_same_priority": _same_priority}


@pytest.mark.parametrize("name", list(FAIR))
def test_fairness_equals_reference(sides, name):
    """Strict tiers, weighted DRR and pool-pressure preemption make the
    reference's decisions: the same finish order, feed order and
    preemptions, and the same streams (a preempted request included)."""
    j, t = twin(sides, FAIR[name])
    assert t[3] == j[3]
    streams_equal(in_order(j[1], j[2]), in_order(t[1], t[2]), t[0].margins)
    assert t[0].kv_blocks_used == 0
    if name == "priority_flood":
        lo_tail = sorted(t[3].index(i) for i in range(10))[-4:]
        assert all(t[3].index(i) < lo_tail[0] for i in (10, 11))
    elif name == "weighted_drr":
        assert t[3][:3] == ["b", "b", "b"]
        assert t[3][3:9].count("a") > t[3][3:9].count("b") >= 1
    elif name == "pool_pressure_preemption":
        assert t[3] == (1, ["pool_pressure"])
        assert_same_registry(j[4], t[4])
    else:
        assert t[3] == 0


# -- the door's telemetry through tools/telemetry_report.py -------------------


def _tenant_fold(side, path):
    eng = side.engine(max_batch=2, **SMALL)
    with side.telemetry(sinks=None, jsonl_path=path) as tel:
        door = side.serving.FrontDoor(eng, policies={
            "a": side.serving.TenantPolicy(priority=1)}, max_queue_depth=2)
        p = prompts(40, *[4] * 7)
        rid = door.submit(p[0], tenant="a", max_new_tokens=6).request_id
        door.step()
        door.step()
        eng.preempt(rid)
        adms = [door.submit(x, tenant="b", max_new_tokens=4)
                for x in p[1:]]
        door.run()
        snap = tel.registry.snapshot()
    assert snap["serve.tenant[a].requests"] == 1
    assert snap["serve.preemptions"] >= 1 and snap["serve.shed"] > 0
    assert snap["serve.shed[queue_full].count"] == snap["serve.shed"]
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "telemetry_report.py"),
                        "--json", path], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    return tel, answers(adms), \
        json.loads(r.stdout.strip().splitlines()[-1])["serving"]


def test_tenant_counters_and_report_fold_equal_reference(sides, tmp_path):
    j, t = [_tenant_fold(s, str(tmp_path / f"{s.name}.jsonl"))
            for s in sides]
    assert [a[:2] for a in t[1]] == [a[:2] for a in j[1]]
    assert_same_registry(j[0], t[0])
    sv, jsv = t[2], j[2]
    assert sv["preempts"] >= 1 and sv["restores"] >= 1
    assert sv["sheds"].get("queue_full", 0) > 0
    assert sv["tenants"].get("a") == 1 and sv["swapped_pages"] >= 1
    for k in ("preempts", "restores", "sheds", "tenants", "swapped_pages",
              "requests", "finished", "tokens"):
        assert sv.get(k) == jsv.get(k), k


# -- tenant -> adapter (TenantPolicy(adapter=)) -------------------------------


@pytest.fixture(scope="module")
def lora(sides):
    """The same two adapters (the JAX package's random_adapter, numpy) in
    a pool on each side."""
    jm = sides[0].model
    ws = {f"ad{i}": jserving.random_adapter(
        jm, rank=8, rng=np.random.default_rng(50 + i)) for i in range(2)}
    return ws


def _lora_door(side, ws):
    pool = side.serving.LoRAPool(side.model, max_adapters=2, rank=8)
    eng = side.serving.Engine(side.model, lora=pool, **side.engine_kw,
                              max_batch=2, **SMALL).warmup()
    if side.port:
        eng.margins = {}
    with side.telemetry() as tel:
        for name, w in ws.items():
            pool.load(name, w)
        door = side.serving.FrontDoor(eng, policies={
            "acme": side.serving.TenantPolicy(adapter="ad0"),
            "beta": side.serving.TenantPolicy(adapter="ad1")})
        p = prompts(41, 9, 7, 6, 5)
        adms = [door.submit(p[0], tenant="acme", max_new_tokens=6),
                door.submit(p[1], tenant="beta", max_new_tokens=5),
                door.submit(p[2], tenant="acme", max_new_tokens=5,
                            adapter="ad1"),
                door.submit(p[3], tenant="plain", max_new_tokens=4)]
        outs = door.run()
        pool.evict("ad1")
        evs = [(e["event"], e["adapter"]) for e in tel.sinks[0].events()
               if e["event"].startswith("serve_lora")]
    return eng, adms, outs, tel, evs


def test_tenant_adapters_equal_reference(sides, lora):
    """Tenants mapped to adapters (and a per-call override) on both
    engines: equal streams, equal ``serve.lora.*`` and per-tenant
    counters, the same load/evict events."""
    j, t = [_lora_door(s, lora) for s in sides]
    assert answers(t[1]) == answers(j[1]) == [(True, None, None)] * 4
    streams_equal(in_order(j[1], j[2]), in_order(t[1], t[2]), t[0].margins)
    assert_same_registry(j[3], t[3])
    snap = t[3].registry.snapshot()
    assert (snap["serve.lora.loads"], snap["serve.lora.evictions"],
            snap["serve.lora.active_adapters"]) == (2, 1, 1)
    assert snap["serve.lora.adapter[ad1].requests"] == 2
    assert t[4] == j[4] == [("serve_lora_load", "ad0"),
                            ("serve_lora_load", "ad1"),
                            ("serve_lora_evict", "ad1")]


def _pooled(sides, **kw):
    side = sides[1]
    pool = LoRAPool(side.model, max_adapters=2, rank=8)
    eng = tserving.Engine(side.model, device="cpu", lora=pool, max_batch=2,
                          **SMALL, **kw).warmup()
    return eng, pool


def test_tenant_adapter_matches_engine_adapter(sides, lora):
    """``TenantPolicy(adapter=)`` decodes exactly what
    ``add_request(adapter=)`` does; an explicit ``adapter=`` overrides the
    policy; an unknown mapping is typed at submit."""
    eng, pool = _pooled(sides)
    for name, w in lora.items():
        pool.load(name, w)
    door = tserving.FrontDoor(eng, policies={
        "t": TenantPolicy(adapter="ad0"),
        "bad": TenantPolicy(adapter="ghost")})
    p = prompts(42, 9, 7)
    a = door.submit(p[0], tenant="t", max_new_tokens=6)
    b = door.submit(p[1], tenant="t", max_new_tokens=5, adapter="ad1")
    outs = door.run()
    ref = {ad: eng.add_request(x, max_new_tokens=n, adapter=ad)
           for x, n, ad in ((p[0], 6, "ad0"), (p[1], 5, "ad1"))}
    refs = eng.run()
    assert outs[a.request_id] == refs[ref["ad0"]]
    assert outs[b.request_id] == refs[ref["ad1"]]
    with pytest.raises(UnknownAdapter):
        door.submit(p[0], tenant="bad")
    bare = tserving.FrontDoor(sides[1].engine(max_batch=2, **SMALL),
                              policies={"t": TenantPolicy(adapter="ad0")})
    with pytest.raises(UnknownAdapter, match="no LoRA pool"):
        bare.submit(p[0], tenant="t")


@pytest.mark.parametrize("max_queue", [None, 1])
def test_admitted_request_pins_adapter_until_retire(sides, lora, max_queue):
    """An admitted answer pins the tenant's adapter until the request
    retires, also when the engine's own queue bound bounces a request
    back to the door (``max_queue=1``: QueueFull at pump, re-queued)."""
    eng, pool = _pooled(sides, max_queue=max_queue)
    pool.load("pinned", lora["ad0"])
    door = tserving.FrontDoor(eng, policies={
        "t": TenantPolicy(adapter="pinned")})
    adms = [door.submit(x, tenant="t", max_new_tokens=3)
            for x in prompts(43, 5, 6, 7)]
    assert all(a.admitted for a in adms)
    if max_queue is not None:
        assert door._total_queued() >= 1
    with pytest.raises(AdapterInUse, match="live"):
        pool.evict("pinned")
    assert len(door.run()) == 3
    pool.evict("pinned")


# -- the HTTP server (port), tokens against the JAX engine --------------------


def jax_streams(sides, items, **geom):
    eng = sides[0].engine(**geom)
    rids = [eng.add_request(p, max_new_tokens=n) for p, n in items]
    outs = eng.run()
    return [(r, outs[r]) for r in rids]


def _post(conn, body):
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    return r, r.read()


def test_server_smoke_stream_drain(sides):
    """Request in, tokens out (whole and SSE), typed 400 and 503 drain
    answers, graceful drain with every KV block reclaimed; tokens equal
    to the JAX engine's."""
    p = prompts(44, 6)[0]
    ref = jax_streams(sides, [(p, 5), (p, 4)], max_batch=2, max_seq_len=64,
                      page_size=8)
    eng = sides[1].engine(max_batch=2, max_seq_len=64, page_size=8)
    srv = tserving.ServingServer(eng, port=0)
    host, port = srv.start()
    got = []
    try:
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        health = json.loads(r.read())
        assert r.status == 200 and health["status"] == "serving"
        assert health["role"] == "both" and "replicas" not in health
        r, raw = _post(conn, {"prompt": p.tolist(), "max_tokens": 5})
        out = json.loads(raw)
        assert r.status == 200
        assert out["choices"][0]["finish_reason"] == "length"
        assert out["usage"]["completion_tokens"] == 5
        got.append((out["id"], out["choices"][0]["token_ids"]))
        r, raw = _post(conn, {"prompt": p.tolist(), "max_tokens": 4,
                              "stream": True})
        assert r.status == 200
        assert r.getheader("Content-Type") == "text/event-stream"
        toks, done, rid = [], False, None
        for line in raw.decode().splitlines():
            if line == "data: [DONE]":
                done = True
            elif line.startswith("data: "):
                chunk = json.loads(line[6:])
                rid = chunk["id"]
                toks.append(chunk["choices"][0]["token_id"])
        assert done
        got.append((rid, toks))
        r, raw = _post(conn, {"prompt": "text, no tokenizer"})
        assert r.status == 400
        srv.begin_drain()
        r, raw = _post(conn, {"prompt": p.tolist(), "max_tokens": 2})
        assert r.status == 503 and r.getheader("Retry-After")
        assert json.loads(raw)["error"]["type"] == "draining"
        assert srv.wait_drained(timeout=30)
    finally:
        srv.close()
    streams_equal(ref, got, eng.margins)
    assert eng.kv_blocks_used == 0


def test_sigterm_graceful_drain(sides):
    """``serve_forever()`` on the main thread under PreemptionGuard: a
    SIGTERM after the in-flight request completes drains the server and
    returns; the tokens equal the JAX engine's."""
    p = prompts(45, 5)[0]
    ref = jax_streams(sides, [(p, 3)], max_batch=2, max_seq_len=64,
                      page_size=8)
    eng = sides[1].engine(max_batch=2, max_seq_len=64, page_size=8)
    srv = tserving.ServingServer(eng, port=0)
    host, port = srv.start()
    result = {}

    def client():
        try:
            conn = http.client.HTTPConnection(host, port, timeout=60)
            conn.request("POST", "/v1/completions",
                         json.dumps({"prompt": p.tolist(), "max_tokens": 3}),
                         {"Content-Type": "application/json"})
            result["out"] = json.loads(conn.getresponse().read())
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    srv.serve_forever()
    t.join(timeout=30)
    out = result["out"]
    streams_equal(ref, [(out["id"], out["choices"][0]["token_ids"])],
                  eng.margins)
    assert eng.kv_blocks_used == 0


def test_shed_maps_to_http_status(sides):
    eng = sides[1].engine(max_batch=1, **SMALL)
    t = [0.0]
    door = tserving.FrontDoor(eng, policies={
        "free": TenantPolicy(rate_tokens_per_s=1.0, burst_tokens=6.0)},
        max_queue_depth=2, clock=lambda: t[0])
    srv = tserving.ServingServer(door, port=0)
    host, port = srv.start()
    try:
        conn = http.client.HTTPConnection(host, port, timeout=60)
        p = prompts(46, 3)[0]
        r, _ = _post(conn, {"prompt": p.tolist(), "max_tokens": 3,
                            "tenant": "free"})
        assert r.status == 200
        r, raw = _post(conn, {"prompt": p.tolist(), "max_tokens": 3,
                              "tenant": "free"})
        assert r.status == 429 and r.getheader("Retry-After")
        assert json.loads(raw)["error"]["type"] == "rate_limited"
        r, raw = _post(conn, {"prompt": prompts(47, 40)[0].tolist(),
                              "max_tokens": 8})
        assert r.status == 400
        assert json.loads(raw)["error"]["type"] == "budget"
    finally:
        srv.begin_drain()
        srv.wait_drained(timeout=30)
        srv.close()
    assert eng.kv_blocks_used == 0
