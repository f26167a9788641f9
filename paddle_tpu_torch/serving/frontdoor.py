"""Multi-tenant SLO front door for the serving engine.

The Engine (engine.py) is a lab-grade batcher: FIFO admission, hard
typed rejection, no notion of who a request belongs to.  ``FrontDoor``
is what a fleet puts in front of it (ROADMAP item 4 — docs/SERVING.md
"Front door"):

- **Per-tenant policy** (:class:`TenantPolicy`): token-bucket rate
  limits (cost = prompt + max_new tokens), a live-request quota, a
  strict priority tier, and a deficit-round-robin weight within the
  tier.
- **Load shedding with typed answers**: a shed request gets an
  :class:`Admission` carrying the reason and a ``retry_after_s``
  estimate — not an exception (an overloaded server answering
  thousands of sheds per second should not pay exception unwinding per
  shed; ``submit(raise_on_shed=True)`` opts into the
  ``serving.errors`` hierarchy instead).  Shedding decisions are driven
  by the live ``serve.*`` telemetry when observability is enabled —
  queue depth, TTFT p95 (``serve.ttft_ms``), KV block occupancy — and
  by the same engine-local signals when it is not.
- **Fairness**: strict priority across tiers (a starving high-priority
  tenant always goes first), weighted deficit round-robin within a tier
  (two equal-priority floods split admissions by their weights instead
  of by arrival order).
- **KV preemption instead of rejection**: when a higher-priority
  request is block-starved at the engine's queue head, the door picks a
  victim (lowest priority, then youngest) and ``Engine.preempt``s it —
  the victim's pages swap to host RAM and it transparently re-admits
  later, token-identical (block_allocator.SwapManager).

Every decision is deterministic given the submission sequence and the
injected ``clock`` — the chaos-serving CI gate and the fairness tests
rely on that.

The port's copy of ``paddle_tpu/serving/frontdoor.py``, in front of the
port's :class:`~paddle_tpu_torch.serving.Engine`: the same policies,
shed reasons, retry hints, metrics and events (a replica set behind the
door waits for ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Set

from .. import observability as obs
from ..observability import _state as _obs_state
from .errors import (AdmissionError, BudgetUnsatisfiable, QueueFull,
                     RateLimited, UnknownAdapter)
from .scheduler import Request, RequestState

__all__ = ["Admission", "FrontDoor", "TenantPolicy", "TokenBucket"]


# requires-lock: _lock — inspects scheduler.waiting
def relieve_block_pressure(engine, priority_of) -> bool:
    """One engine's pool-pressure preemption policy (shared by
    :meth:`FrontDoor._maybe_preempt` and the DP replica set, which
    applies it per replica): when the queue head is BLOCK-starved (a
    slot is free, blocks are not) and outranks a running request,
    preempt one victim — lowest priority first, youngest within a
    priority.  One victim per call: preemption is a pressure valve, not
    a scheduler.  Returns True when a victim was preempted."""
    sch = engine.scheduler
    if not sch.waiting:
        return False
    head = sch.waiting[0]
    if head.swapped is not None:
        # a restore waiting on blocks: preempting someone else to
        # restore a preemptee would thrash
        return False
    if sch._free_slot() is None:
        return False
    if sch.allocator.can_allocate(sch.blocks_needed(head)):
        return False                # it will admit on the next step
    hp = priority_of(head)
    victims = sorted(
        (priority_of(st), -st.submit_t, st.request.request_id)
        for _slot, st in sch.active()
        if priority_of(st) < hp)
    if victims:
        return engine.preempt(victims[0][2], reason="pool_pressure")
    return False


@dataclasses.dataclass
class TenantPolicy:
    """One tenant's admission contract.

    ``priority``: strict tier — all queued work of a higher tier is
    admitted before any lower tier, and under an SLO breach only
    tenants at or above the door's ``slo_priority_floor`` are admitted.
    ``weight``: deficit-round-robin share *within* a tier.
    ``rate_tokens_per_s`` / ``burst_tokens``: token-bucket rate limit
    over the request token cost (prompt + max_new_tokens); None = no
    limit.  ``max_live_requests``: cap on this tenant's queued + active
    requests; None = no quota.  ``adapter``: the tenant's LoRA adapter
    (docs/SERVING.md "Multi-LoRA") — every submission for this tenant
    decodes through that adapter's stacked weights unless the call
    names one explicitly; validated against the engine's
    ``serving.LoRAPool`` at submit (typed
    :class:`~paddle_tpu_torch.serving.errors.UnknownAdapter`)."""

    priority: int = 0
    weight: float = 1.0
    rate_tokens_per_s: Optional[float] = None
    burst_tokens: Optional[float] = None
    max_live_requests: Optional[int] = None
    adapter: Optional[str] = None


class TokenBucket:
    """Deterministic token bucket (``clock`` injectable for tests)."""

    __slots__ = ("rate", "capacity", "level", "clock", "_t")

    def __init__(self, rate: float, capacity: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.capacity = float(capacity)
        self.level = float(capacity)
        self.clock = clock
        self._t = clock()

    def _refill(self) -> None:
        now = self.clock()
        if now > self._t:
            self.level = min(self.capacity,
                             self.level + (now - self._t) * self.rate)
        self._t = now

    def try_take(self, cost: float) -> float:
        """0.0 on success (cost deducted), else seconds until ``cost``
        becomes affordable — inf for a zero-rate bucket OR a cost
        beyond ``capacity`` (the level can never exceed capacity, so a
        finite hint would send the client into an endless retry loop)."""
        self._refill()
        if cost <= self.level + 1e-9:
            self.level -= cost
            return 0.0
        if self.rate <= 0 or cost > self.capacity + 1e-9:
            return float("inf")
        return (cost - self.level) / self.rate


class Admission(NamedTuple):
    """The typed answer to :meth:`FrontDoor.submit` — admitted or shed,
    never an exception (unless ``raise_on_shed``)."""

    admitted: bool
    request_id: Optional[str]
    reason: Optional[str]        # None | "rate_limited" | "quota" |
    #                              "queue_full" | "slo_shed" | "budget" |
    #                              "unknown_adapter" (evicted at pump)
    retry_after_s: Optional[float]


class _Pending(NamedTuple):
    request: Request
    tenant: str
    cost: int                    # prompt + max_new tokens
    submit_t: float              # perf_counter at door submit: TTFT
    #                              must include time queued in the door


class FrontDoor:
    """SLO-aware multi-tenant admission in front of a warmed
    :class:`~paddle_tpu_torch.serving.Engine`.

    ``policies`` maps tenant name → :class:`TenantPolicy`; unknown
    tenants get ``default_policy``.  ``max_queue_depth`` bounds the
    TOTAL queued work (door queues + engine staging); beyond it
    submissions shed with ``reason="queue_full"``.  ``slo_ttft_p95_ms``
    / ``slo_occupancy`` arm telemetry-driven backpressure: when the
    rolling TTFT p95 or the KV-pool occupancy crosses its threshold,
    tenants below ``slo_priority_floor`` shed with
    ``reason="slo_shed"`` until the signal recovers.
    ``enable_preemption`` lets the door preempt lower-priority running
    requests when a higher-priority admission is block-starved.

    The door feeds the engine's FIFO staging queue at most
    ``engine.max_batch`` deep, so ordering decisions stay here — the
    engine only ever sees work the door already sequenced.

    ``engine`` may also be a DP replica set
    (``serving.distributed.EngineReplicaSet``) or a disaggregated one
    (``serving.disagg.DisaggReplicaSet``): the door's policy runs
    unchanged over the set's aggregate surface, the set decides WHICH
    replica each admitted request lands on — for the disaggregated set
    that means the prefill tier, with the prefill→decode handoff
    happening entirely below this admission surface — and
    pool-pressure preemption delegates to its per-replica policy
    (docs/SERVING.md "Sharded serving", "Disaggregated serving").
    """

    def __init__(self, engine, *,
                 policies: Optional[Dict[str, TenantPolicy]] = None,
                 default_policy: Optional[TenantPolicy] = None,
                 max_queue_depth: int = 64,
                 slo_ttft_p95_ms: Optional[float] = None,
                 slo_occupancy: Optional[float] = None,
                 slo_priority_floor: int = 1,
                 drr_quantum: int = 32,
                 enable_preemption: bool = True,
                 retry_after_floor_s: float = 0.05,
                 clock: Callable[[], float] = time.monotonic):
        if max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}")
        self.engine = engine
        self.policies = dict(policies or {})
        self.default_policy = default_policy or TenantPolicy()
        self.max_queue_depth = int(max_queue_depth)
        self.slo_ttft_p95_ms = slo_ttft_p95_ms
        self.slo_occupancy = slo_occupancy
        self.slo_priority_floor = int(slo_priority_floor)
        self.drr_quantum = int(drr_quantum)
        self.enable_preemption = bool(enable_preemption)
        self.retry_after_floor_s = float(retry_after_floor_s)
        self.clock = clock
        # Cross-thread state (HTTP handler threads submit, the
        # engine-loop thread pumps — serving/server.py): guarded by
        # ServingServer._lock; methods marked `# requires-lock:
        # _lock` must be entered with it held (single-threaded
        # callers satisfy that trivially).
        self._queues: Dict[str, "collections.deque[_Pending]"] = \
            {}                                   # guarded_by: _lock
        self._buckets: Dict[str, TokenBucket] = \
            {}                                   # guarded_by: _lock
        self._outstanding: Dict[str, Set[str]] = \
            {}                                   # guarded_by: _lock
        self._deficit: Dict[str, float] = \
            {}                                   # guarded_by: _lock
        self._rr: Dict[int, int] = {}            # guarded_by: _lock
        self.sheds = 0               # lifetime shed count (all reasons)

    # -- policy plumbing ---------------------------------------------------

    def policy(self, tenant: Optional[str]) -> TenantPolicy:
        if tenant is None:
            return self.default_policy
        return self.policies.get(tenant, self.default_policy)

    # requires-lock: _lock — lazily materializes _buckets entries
    def _bucket(self, tenant: str,
                pol: TenantPolicy) -> Optional[TokenBucket]:
        if pol.rate_tokens_per_s is None:
            return None
        b = self._buckets.get(tenant)
        if b is None:
            cap = pol.burst_tokens if pol.burst_tokens is not None \
                else 4.0 * pol.rate_tokens_per_s
            b = self._buckets[tenant] = TokenBucket(
                pol.rate_tokens_per_s, cap, clock=self.clock)
        return b

    # -- live signals (serve.* telemetry when on, engine-local when off) ---

    # requires-lock: _lock
    def queue_depth(self) -> int:
        """Door queues + the engine's staging queue."""
        return sum(len(q) for q in self._queues.values()) \
            + self.engine.scheduler.queue_depth()

    # requires-lock: _lock
    def _total_queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _ttft_p95(self, tenant: Optional[str] = None) -> Optional[float]:
        """Rolling TTFT p95 for the SLO shed decision.  The GLOBAL
        ``serve.ttft_ms`` signal gates: while it is healthy, nobody is
        shed on TTFT.  Once it breaches, the SUBMITTING tenant's own
        aggregate (``serve.tenant[<t>].ttft_ms``, fed by the engine at
        first token) refines the decision — a below-floor tenant whose
        own latency is healthy is not shed for another tenant's breach.
        The global signal must stay the gate: a shed tenant gets no new
        observations of its own, so deciding on the per-tenant window
        alone would freeze a transient spike into a permanent lockout;
        the global window keeps refreshing off admitted traffic and
        un-sheds everyone when the system recovers."""
        reg = obs.get_registry()
        if reg is None:
            return None
        h = reg.get("serve.ttft_ms")
        g = h.percentile(95) if h is not None else None
        if tenant is None or g is None \
                or self.slo_ttft_p95_ms is None \
                or g <= self.slo_ttft_p95_ms:
            return g
        th = reg.get(f"serve.tenant[{tenant}].ttft_ms")
        if th is not None and th.count:
            return th.percentile(95)
        return g

    def _occupancy(self) -> float:
        alloc = self.engine.kv.allocator
        return alloc.used_blocks / max(self.engine.kv.num_blocks, 1)

    # requires-lock: _lock — sums the pending queues
    def _retry_after(self) -> float:
        """Load-proportional retry hint: pending token cost over the
        live aggregate tok/s when telemetry has one, else a queue-depth
        multiple of the floor.  Deterministic given the signals."""
        rate = None
        reg = obs.get_registry()
        if reg is not None:
            g = reg.get("serve.tok_s")
            rate = g.value if g is not None else None
        if rate:
            pending = sum(p.cost for q in self._queues.values() for p in q)
            est = pending / max(float(rate), 1e-6)
        else:
            est = self.retry_after_floor_s * (1 + self.queue_depth())
        return round(max(self.retry_after_floor_s, est), 4)

    # -- admission ---------------------------------------------------------

    def _shed(self, tenant: str, reason: str,
              retry_after_s: Optional[float], raise_on_shed: bool,
              message: str) -> Admission:
        self.sheds += 1
        reg = obs.get_registry()
        if reg is not None:
            reg.counter("serve.shed").inc()
            reg.counter(f"serve.shed[{reason}].count").inc()
        obs.emit_event("serve_shed", tenant=tenant, reason=reason,
                       retry_after_s=retry_after_s)
        if raise_on_shed:
            if reason == "budget":
                raise BudgetUnsatisfiable(message)
            if reason in ("rate_limited", "quota"):
                raise RateLimited(message, retry_after_s or
                                  self.retry_after_floor_s)
            raise QueueFull(message, retry_after_s)
        return Admission(False, None, reason, retry_after_s)

    # requires-lock: _lock — the handler-thread entry point
    def submit(self, prompt_ids, *, tenant: str = "default",
               max_new_tokens: int = 16, temperature: float = 0.0,
               eos_token_id: Optional[int] = None,
               on_token: Optional[Callable] = None,
               request_id: Optional[str] = None,
               adapter: Optional[str] = None,
               raise_on_shed: bool = False) -> Admission:
        """Admit or shed one request; always returns an
        :class:`Admission` (malformed requests — empty prompt, bad
        max_new_tokens, duplicate id, an adapter the engine has not
        loaded — still raise, they are caller bugs, not load).
        ``adapter`` overrides the tenant policy's ``adapter`` mapping
        for this one request."""
        pol = self.policy(tenant)
        eng = self.engine
        ad = adapter if adapter is not None else pol.adapter
        if ad is not None:
            # tenant→model mapping validated at the DOOR, before any
            # queueing: a bad mapping answers typed at submit instead of
            # shedding mysteriously at pump time
            pool = getattr(eng, "lora", None)
            if pool is None:
                raise UnknownAdapter(
                    f"tenant {tenant!r} maps to adapter {ad!r} but the "
                    "engine has no LoRA pool (Engine(lora=...))")
            pool.slot_of(ad)          # raises UnknownAdapter if absent
        req = Request(prompt_ids=prompt_ids,
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature),
                      eos_token_id=eos_token_id, on_token=on_token,
                      request_id=request_id, tenant=tenant, adapter=ad)
        p = int(req.prompt_ids.size)
        cost = p + req.max_new_tokens
        if req.request_id in eng._states or any(
                pnd.request.request_id == req.request_id
                for q in self._queues.values() for pnd in q):
            raise AdmissionError(
                f"request_id {req.request_id!r} is already in use")
        # feasibility bound: the request must fit ONE engine — a replica
        # set exposes its per-replica pool size here, because the summed
        # kv.num_blocks would answer "admitted" for a request no single
        # replica can ever hold (it would then shed silently at pump)
        cap = getattr(eng, "budget_num_blocks", None)
        if cap is None:
            cap = eng.kv.num_blocks
        if cost > eng.max_seq_len or \
                eng.scheduler.blocks_for(cost) > cap:
            return self._shed(
                tenant, "budget", None, raise_on_shed,
                f"prompt {p} + max_new {req.max_new_tokens} can never "
                f"fit this engine (max_seq_len={eng.max_seq_len}, "
                f"{cap} KV blocks)")
        if pol.max_live_requests is not None and \
                self._live_count(tenant) >= pol.max_live_requests:
            return self._shed(
                tenant, "quota", self._retry_after(), raise_on_shed,
                f"tenant {tenant!r} is at its live-request quota "
                f"({pol.max_live_requests})")
        if self.queue_depth() >= self.max_queue_depth:
            return self._shed(
                tenant, "queue_full", self._retry_after(), raise_on_shed,
                f"queue at max_queue_depth={self.max_queue_depth}")
        if pol.priority < self.slo_priority_floor:
            ttft = self._ttft_p95(tenant) \
                if self.slo_ttft_p95_ms is not None else None
            if ttft is not None and ttft > self.slo_ttft_p95_ms:
                return self._shed(
                    tenant, "slo_shed", self._retry_after(),
                    raise_on_shed,
                    f"TTFT p95 {ttft:.1f}ms over SLO "
                    f"{self.slo_ttft_p95_ms}ms; shedding below "
                    f"priority {self.slo_priority_floor}")
            if self.slo_occupancy is not None \
                    and self._occupancy() >= self.slo_occupancy:
                return self._shed(
                    tenant, "slo_shed", self._retry_after(),
                    raise_on_shed,
                    f"KV occupancy {self._occupancy():.2f} over "
                    f"{self.slo_occupancy}; shedding below priority "
                    f"{self.slo_priority_floor}")
        # the token bucket is the LAST gate, so a request shed for any
        # other reason is never charged tokens it got nothing for (a
        # queue_full burst must not morph into a rate_limited lockout)
        bucket = self._bucket(tenant, pol)
        if bucket is not None:
            wait = bucket.try_take(cost)
            if wait == float("inf"):
                # beyond burst capacity: no amount of waiting helps
                return self._shed(
                    tenant, "budget", None, raise_on_shed,
                    f"request cost {cost} tokens exceeds tenant "
                    f"{tenant!r}'s burst capacity {bucket.capacity}")
            if wait > 0:
                wait = round(max(wait, self.retry_after_floor_s), 4)
                return self._shed(
                    tenant, "rate_limited", wait, raise_on_shed,
                    f"tenant {tenant!r} over its token rate "
                    f"({pol.rate_tokens_per_s}/s); retry in {wait}s")
        if ad is not None:
            # hold a door-level reference from ADMISSION (same
            # request-id the engine acquires at add_request, so the
            # overlap is a no-op in the id-keyed set): once answered
            # admitted=True, the adapter cannot be evicted out from
            # under a door-queued request (typed AdapterInUse at the
            # evict) — pump can never strand a vetted request on a
            # vanished adapter
            self.engine.lora.acquire(ad, req.request_id)
        self._queues.setdefault(
            tenant, collections.deque()).append(
                _Pending(req, tenant, cost, time.perf_counter()))
        self._outstanding.setdefault(tenant, set()).add(req.request_id)
        tr = _obs_state.TRACE[0]
        if tr is not None:
            # the trace clock starts HERE: time queued in the door is
            # queue-wait the timeline must attribute (same rule as the
            # submit_t handoff in pump()).  The id comes from the
            # current_trace_id contextvar when a caller (the HTTP
            # server's X-Trace-Id) set one.
            req.trace_id = tr.begin(req.request_id, tenant=tenant,
                                    prompt_len=p,
                                    max_new=req.max_new_tokens)
        reg = obs.get_registry()
        if reg is not None:
            reg.counter(f"serve.tenant[{tenant}].requests").inc()
            reg.gauge("serve.frontdoor_depth").set(self._total_queued())
        self.pump()
        return Admission(True, req.request_id, None, None)

    # requires-lock: _lock
    def _live_count(self, tenant: str) -> int:
        self._gc_outstanding()
        return len(self._outstanding.get(tenant, ()))

    # requires-lock: _lock
    def _gc_outstanding(self) -> None:
        eng = self.engine
        queued = {p.request.request_id
                  for q in self._queues.values() for p in q}
        for rids in self._outstanding.values():
            dead = [r for r in rids if r not in queued
                    and (eng._states.get(r) is None
                         or eng._states[r].finished)]
            for r in dead:
                rids.discard(r)

    # -- scheduling: strict priority tiers + weighted DRR ------------------

    # requires-lock: _lock
    def _engine_room(self) -> bool:
        # queue_depth() == len(waiting) on a plain Engine, and the O(1)
        # aggregate sum on a replica set (whose waiting tuple would be
        # materialized per check otherwise)
        return self.engine.scheduler.queue_depth() < self.engine.max_batch

    # requires-lock: _lock
    def _next_pending(self) -> Optional[_Pending]:
        nonempty = [t for t, q in self._queues.items() if q]
        if not nonempty:
            return None
        tier = max(self.policy(t).priority for t in nonempty)
        tenants = sorted(t for t in nonempty
                         if self.policy(t).priority == tier)
        rr = self._rr.get(tier, 0)
        n = len(tenants)
        # each visit grants quantum*weight deficit; the head admits once
        # its tenant's deficit covers its token cost, so admissions
        # interleave by weight.  Bound: a head costs <= max_seq_len, so
        # within ~cost/quantum visits per tenant someone can pay.
        max_hops = n * (2 + int(self.engine.max_seq_len
                                / max(self.drr_quantum, 1)))
        for hop in range(max_hops):
            t = tenants[(rr + hop) % n]
            q = self._queues[t]
            if not q:
                continue
            pol = self.policy(t)
            self._deficit[t] = self._deficit.get(t, 0.0) \
                + self.drr_quantum * max(pol.weight, 1e-6)
            head = q[0]
            if self._deficit[t] + 1e-9 >= head.cost:
                self._deficit[t] -= head.cost
                q.popleft()
                self._rr[tier] = (rr + hop + 1) % n
                if not q:
                    self._deficit[t] = 0.0   # no banking while idle
                return head
        # unreachable with drr_quantum >= 1 (max_hops covers the largest
        # possible head cost), but never wedge: serve the tier FIFO
        for t in tenants:
            if self._queues[t]:
                return self._queues[t].popleft()
        return None

    # requires-lock: _lock — the loop-thread entry point
    def pump(self) -> int:
        """Feed sequenced work into the engine's staging queue and run
        the preemption policy; returns the number admitted.  Called by
        :meth:`submit` and :meth:`step` — idempotent and cheap when
        there is nothing to do."""
        self._gc_outstanding()
        admitted = 0
        while self._total_queued() and self._engine_room():
            pnd = self._next_pending()
            if pnd is None:
                break
            req = pnd.request
            try:
                self.engine.add_request(
                    req.prompt_ids, max_new_tokens=req.max_new_tokens,
                    temperature=req.temperature,
                    eos_token_id=req.eos_token_id, on_token=req.on_token,
                    request_id=req.request_id, tenant=pnd.tenant,
                    adapter=req.adapter)
            except QueueFull:
                # transient: the engine's own max_queue bound tripped —
                # the request stays OURS (front of its tenant queue) and
                # feeds once the staging drains; it was already answered
                # admitted=True, so it must not be shed as permanent.
                # add_request released the shared id-keyed adapter ref
                # on its way out — re-take it, or the door-queued
                # request loses its evict protection (AdapterInUse)
                if req.adapter is not None:
                    pool = getattr(self.engine, "lora", None)
                    if pool is not None:
                        pool.acquire(req.adapter, req.request_id)
                self._queues[pnd.tenant].appendleft(pnd)
                break
            except AdmissionError as e:
                # an already-vetted request the engine still refused
                # (e.g. an id raced into the retained set): shed it
                # instead of wedging the tenant queue behind it
                self._outstanding.get(pnd.tenant, set()).discard(
                    req.request_id)
                if req.adapter is not None:
                    # the door's admission-time adapter reference must
                    # not outlive the request it protected
                    pool = getattr(self.engine, "lora", None)
                    if pool is not None:
                        pool.release(req.adapter, req.request_id)
                tr = _obs_state.TRACE[0]
                if tr is not None:
                    # the trace begun at door submit must not stay live
                    # forever — tracer retention only reaps DONE traces.
                    # (An id collision shares the rid's trace by
                    # construction; if the colliding request is still
                    # live its trace closes early here — ids are the
                    # caller's uniqueness contract, and bounding the
                    # tracer beats preserving an ambiguous timeline.)
                    tr.retire(req.request_id, reason="shed")
                self._shed(pnd.tenant,
                           "unknown_adapter" if isinstance(
                               e, UnknownAdapter) else "budget",
                           None, False, str(e))
                continue
            # TTFT starts at DOOR submission: time queued here is load
            # the serve.ttft_ms signal (and the SLO shed driven by it)
            # must see
            st = self.engine._states.get(req.request_id)
            if st is not None:
                st.submit_t = pnd.submit_t
            admitted += 1
        if self.enable_preemption:
            self._maybe_preempt()
        reg = obs.get_registry()
        if reg is not None:
            reg.gauge("serve.frontdoor_depth").set(self._total_queued())
        return admitted

    def _priority_of(self, st: RequestState) -> int:
        return self.policy(st.request.tenant).priority

    # requires-lock: _lock — inspects scheduler.waiting
    def _maybe_preempt(self) -> None:
        """Apply :func:`relieve_block_pressure` — directly on a plain
        engine, or delegated when the engine is a replica set
        (``serving.distributed.EngineReplicaSet`` exposes
        ``relieve_pressure`` and applies the policy per healthy
        replica, since each replica's pool starves independently)."""
        relieve = getattr(self.engine, "relieve_pressure", None)
        if relieve is not None:
            relieve(self._priority_of)
            return
        relieve_block_pressure(self.engine, self._priority_of)

    # -- the loop ----------------------------------------------------------

    def has_work(self) -> bool:
        return self._total_queued() > 0 or self.engine.has_work()

    def step(self):
        """One pump + one engine step; returns the engine's events."""
        self.pump()
        return self.engine.step()

    def run(self) -> Dict[str, List[int]]:
        """Drain door + engine; same contract as ``Engine.run()`` —
        {request_id: generated ids} for everything finished since the
        last drain."""
        eng = self.engine
        drained = eng._begin_drain()
        try:
            while self.has_work():
                self.pump()
                if eng.has_work():
                    eng.step()
                elif self._total_queued():
                    break           # safety: cannot make progress
        finally:
            eng._end_drain()
        return drained

    def stream(self):
        """Generator over :class:`TokenEvent`s until door + engine
        drain (submissions may keep arriving mid-stream)."""
        while self.has_work():
            self.pump()
            for ev in self.engine.step():
                yield ev
            if not self.engine.has_work() and not self._total_queued():
                return
