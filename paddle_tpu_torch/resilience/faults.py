"""Deterministic fault injection for chaos testing (a copy of
``paddle_tpu/resilience/faults.py``; the port's serving engine and
``SwapManager`` are the sites that call it so far).

A *fault site* is a named point in the runtime where a failure is
plausible in production: checkpoint I/O, rendezvous-store ops, a
collective, a training step.  Each site does one falsy check against
``_state.FAULTS`` (zero overhead when disabled — the observability
contract, enforced by the ``telemetry-overhead`` CI gate); when an
injector is installed, the site's per-call counter advances and any plan
matching ``(site, call_index)`` raises its exception.

Plans are deterministic and step-indexed: the N-th invocation of a site
fires, never a random one, so a chaos run is exactly reproducible — the
property the ``chaos`` CI gate leans on when it demands bitwise-equal
final params between a faulted and a fault-free run.

Spec grammar (code or the ``PDTPU_FAULTS`` env var)::

    spec    = entry ("," | ";") entry ...
    entry   = site "@" index ["x" times] [":" exc]
    site    = ckpt.save | ckpt.load | collective | step | store.get | store.set
            | serve.admit | serve.prefill | serve.step | serve.cow | serve.swap
            | serve.route | serve.replica | serve.spec
            | serve.xfer.put | serve.xfer.get | serve.gateway
            | cluster.register | cluster.lease | cluster.command
            | cluster.journal | cluster.takeover
    index   = 0-based per-site call counter value at which firing starts
    times   = number of consecutive calls that fire (default 1)
    exc     = InjectedFault | RuntimeError | OSError | ConnectionError
              | TimeoutError | ValueError        (default InjectedFault)

    PDTPU_FAULTS="ckpt.save@1,step@3x2:OSError"

Pure stdlib.
"""

from __future__ import annotations

import os
import re
import threading

from ..observability import _state as _obs_state
from . import _state

__all__ = ["SITES", "InjectedFault", "FaultPlan", "FaultInjector",
           "parse_faults", "install_faults", "clear_faults",
           "install_faults_from_env", "active_injector"]

#: the registered fault sites — a plan for any other name is a spec typo,
#: rejected at parse/construction time rather than silently never firing.
#: The serve.* sites cover the serving engine's host-side request
#: lifecycle (docs/RESILIENCE.md "Serving sites"): admission, per-slot
#: prefill/decode bookkeeping, copy-on-write, and KV page swap I/O —
#: each confined by the engine to retire/re-admit of the ONE affected
#: request (the compiled step and the other slots survive; the
#: ``chaos-serving`` CI gate's contract).  ``serve.route`` /
#: ``serve.replica`` cover the DP replica router
#: (``serving.distributed.EngineReplicaSet``): a route fault leaves the
#: request queued at the door (typed ``QueueFull``, retried next pump);
#: a replica fault fails THAT replica — its in-flight requests evacuate
#: through preempt→swap→restore onto the healthy replicas (the
#: ``serving-dist`` CI gate's contract).  ``serve.spec`` fires in the
#: speculative-decoding draft proposer (``serving/spec.py``): drafting
#: is best-effort, so the fault degrades that slot to ``draft_len = 0``
#: for the step — never the request; a fault during VERIFY is the
#: ``serve.step`` site (per-slot decode bookkeeping), rolled back to
#: the pre-span snapshot like any other isolated failure.
#: ``serve.xfer.put`` / ``serve.xfer.get`` fire per CHUNK of a
#: disaggregated KV-page transfer (``serving/disagg.py KVTransport``):
#: both are wrapped in the transport's ``RetryPolicy``, so a transient
#: fault becomes a logged retry; exhausting the retries is a HARD
#: transfer failure and the replica set degrades that request to a
#: fresh re-prefill on the destination (the ``serving-disagg`` CI
#: gate's contract — greedy outputs stay token-identical either way).
#: The ``cluster.*`` sites cover the serving control plane
#: (``serving/cluster.py`` + ``serving/worker.py``):
#: ``cluster.register`` fires in the worker's register/re-register
#: store transaction, ``cluster.lease`` in its lease-renew CAS, and
#: ``cluster.command`` in the command-apply path — register and renew
#: are retried under the worker's ``RetryPolicy`` (a transient fault is
#: a logged retry; renew exhaustion is treated as a LOST lease, so the
#: worker stops acting on its epoch and rejoins fresh), while a command
#: fault requeues the command for the next loop iteration (commands are
#: idempotent per epoch — the ``serving-cluster`` CI gate's contract).
#: ``cluster.journal`` fires inside the controller's retried
#: admission-journal write (``ClusterController.submit`` CAS-writes
#: ``journal/<rid>`` before returning): a transient fault is a logged
#: retry, exhaustion rejects THAT submission typed — never a silently
#: half-admitted request.  ``cluster.takeover`` fires in the standby
#: controller's takeover path before the lease CAS: a fault aborts the
#: attempt cleanly and the follower retries on its next pump (the
#: zombie fence never depends on takeover succeeding first try).
#: ``serve.gateway`` fires per gateway admission
#: (``serving/gateway.py``), after policy shed checks and before the
#: journal write: a fault sheds that ONE request as a typed 503 —
#: the gateway process and its in-flight streams survive.
SITES = ("ckpt.save", "ckpt.load", "collective", "step",
         "store.get", "store.set",
         "serve.admit", "serve.prefill", "serve.step", "serve.cow",
         "serve.swap", "serve.route", "serve.replica", "serve.spec",
         "serve.xfer.put", "serve.xfer.get", "serve.gateway",
         "cluster.register", "cluster.lease", "cluster.command",
         "cluster.journal", "cluster.takeover")


class InjectedFault(RuntimeError):
    """Raised by the injector at a planned site.  Retryable by default
    (``retry.DEFAULT_RETRYABLE``) so chaos runs exercise the same
    recovery paths a transient production fault would."""


_EXC_NAMES = {
    "InjectedFault": InjectedFault,
    "RuntimeError": RuntimeError,
    "OSError": OSError,
    "IOError": OSError,
    "ConnectionError": ConnectionError,
    "TimeoutError": TimeoutError,
    "ValueError": ValueError,
}

_ENTRY_RE = re.compile(r"^(?P<site>[\w.]+)@(?P<at>\d+)(?:x(?P<times>\d+))?$")


class FaultPlan:
    """One deterministic fault: fire ``times`` consecutive calls of
    ``site`` starting at per-site call index ``at`` (0-based)."""

    __slots__ = ("site", "at", "times", "exc", "message")

    def __init__(self, site, at, times=1, exc=InjectedFault, message=None):
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r}; registered sites: {SITES}")
        if int(times) < 1:
            raise ValueError(f"fault times must be >= 1, got {times}")
        self.site = site
        self.at = int(at)
        self.times = int(times)
        self.exc = exc
        self.message = message

    def __repr__(self):
        return (f"FaultPlan({self.site}@{self.at}x{self.times}"
                f":{self.exc.__name__})")


def parse_faults(spec):
    """Parse a ``PDTPU_FAULTS``-grammar string into ``FaultPlan``s."""
    plans = []
    for entry in re.split(r"[,;]", spec):
        entry = entry.strip()
        if not entry:
            continue
        head, _, exc_name = entry.partition(":")
        exc = InjectedFault
        if exc_name:
            exc_name = exc_name.strip()
            if exc_name not in _EXC_NAMES:
                raise ValueError(
                    f"unknown fault exception {exc_name!r}; allowed: "
                    f"{sorted(_EXC_NAMES)}")
            exc = _EXC_NAMES[exc_name]
        m = _ENTRY_RE.match(head.strip())
        if m is None:
            raise ValueError(
                f"bad fault entry {entry!r}; grammar: "
                "site@index[xTimes][:ExcName]")
        plans.append(FaultPlan(m.group("site"), m.group("at"),
                               times=m.group("times") or 1, exc=exc))
    return plans


class FaultInjector:
    """Per-site call counters + the plans that fire against them.

    Installed via :func:`install_faults`; producers call the injector
    with a site name.  Thread-safe: ckpt faults may fire from the async
    checkpoint writer thread while store faults fire from a heartbeat
    thread."""

    def __init__(self, plans):
        if isinstance(plans, str):
            plans = parse_faults(plans)
        self.plans = list(plans)
        self.fired = []          # [(site, call_index)] — audit log
        self._calls = {}
        self._lock = threading.Lock()

    def calls(self, site):
        """Lifetime invocation count of ``site`` (fired or not)."""
        return self._calls.get(site, 0)

    def __call__(self, site):
        with self._lock:
            n = self._calls.get(site, 0)
            self._calls[site] = n + 1
            plan = next((p for p in self.plans
                         if p.site == site and p.at <= n < p.at + p.times),
                        None)
            if plan is None:
                return
            self.fired.append((site, n))
        _emit_fault(site, n, plan)
        raise plan.exc(plan.message
                       or f"injected fault at {site} (call #{n})")


def _emit_telemetry(event, counters=()):
    """Shared guarded emit for the resilience vocabulary (``fault`` /
    ``retry`` / ``resume`` / ``restart``): one falsy check when telemetry
    is off, counter bumps + event fan-out when on, and never allowed to
    raise — the callers sit inside recovery paths where a telemetry
    failure must not mask (or become) the real exception."""
    emit = _obs_state.EMIT[0]
    if emit is None:
        return
    try:
        from .. import observability as obs
        reg = obs.get_registry()
        if reg is not None:
            for name in counters:
                reg.counter(name).inc()
        emit(event)
    except Exception:
        pass


def _emit_fault(site, index, plan):
    _emit_telemetry({"event": "fault", "site": site, "call": index,
                     "exc": plan.exc.__name__},
                    (f"fault[{site}].count",))


def install_faults(plans):
    """Install an injector (a :class:`FaultInjector`, a plan list, or a
    spec string) into the hook container; returns it."""
    inj = plans if isinstance(plans, FaultInjector) else FaultInjector(plans)
    _state.FAULTS[0] = inj
    return inj


def clear_faults():
    """Remove any installed injector (restores the zero-overhead path)."""
    _state.FAULTS[0] = None


def active_injector():
    """The installed :class:`FaultInjector`, or None."""
    return _state.FAULTS[0]


def install_faults_from_env(var="PDTPU_FAULTS"):
    """Install from the env spec if set; never clobbers an injector that
    is already installed (code-configured plans win).  Returns the active
    injector or None.  Called by the supervisor on entry so a launcher
    can chaos-test a whole job with one env var."""
    if _state.FAULTS[0] is not None:
        return _state.FAULTS[0]
    spec = os.environ.get(var)
    if not spec:
        return None
    return install_faults(spec)
