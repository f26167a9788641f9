"""Hot-path hook containers — the whole disabled-telemetry surface (a copy
of ``paddle_tpu/observability/_state.py``).

``observability.enable()`` / ``disable()`` are the only writers.  The
port installs no step monitor, collective hook or compiled-artifact
ledger (``observability.NOT_PORTED``): ``MONITOR``, ``COLLECTIVE`` and
``LEDGER`` stay ``None`` in it.

Mirrors ``distributed/debug.py``'s zero-overhead contract: a producer on
a hot path does ONE falsy check against a module-level container::

    hook = _obs_state.MONITOR[0]
    if hook is not None:
        ...telemetry path...

With telemetry disabled (the default) every container holds ``None`` and
the check costs ~0.2 µs — no lock, no dict, no registry, no import of
anything heavier than this (stdlib-free) module.

Containers are single-element lists (not bare globals) so hot modules
can bind the list object once at import time and still observe
enable/disable flips.
"""

# StepMonitor instance, or None. Read by jit.TrainStep.__call__,
# jit.to_static dispatch, hapi.Model._train_one.
MONITOR = [None]

# callable(op_name, axes, first_arg) or None. Read by
# distributed.communication's _traced wrapper per collective call.
COLLECTIVE = [None]

# callable(event_dict) (Telemetry.emit) or None. Read by
# launch.preempt's signal handler and distributed.Engine.fit.
EMIT = [None]

# FlightRecorder instance, or None. Read by cold-path breadcrumb
# producers (ckpt save/load, the watchdog, crash hooks); hot paths feed
# it through MONITOR/SPAN so their disabled cost stays one falsy check.
RECORDER = [None]

# spans._SpanHook instance, or None. Read by every ``span(...)`` scope
# (ckpt, Engine.fit epochs, eager collectives, jit AOT export).
SPAN = [None]

# callable(reason=...) -> path|None (flight_recorder.write_postmortem)
# or None. Read by launch.preempt's signal handler so a preempted run
# drains the flight-recorder ring without importing anything inside a
# signal frame.
POSTMORTEM = [None]

# trace.RequestTracer instance, or None. Read by every serving
# request-lifecycle site (FrontDoor.submit, Engine admission/step/
# preempt/restore/retire, EngineReplicaSet routing/evacuation) — the
# per-request timeline producer (observability/trace.py).
TRACE = [None]

# compiled.CompiledArtifactLedger instance, or None. Read by the
# serve/train roofline gauge producers (Engine.step_finish,
# StepMonitor._record) and the HBM gauge publisher (Engine.warmup) —
# the compile-time capture itself rides a method wrap installed only
# while telemetry is enabled, so it has NO disabled-path check at all.
LEDGER = [None]
