"""Fault-injection hook container — the whole disabled-resilience surface
(a copy of ``paddle_tpu/resilience/_state.py``).

Mirrors ``observability/_state.py``'s zero-overhead contract: a producer
at a registered fault site does ONE falsy check against this module-level
container::

    fi = _rs_state.FAULTS[0]
    if fi is not None:
        fi("step")          # raises the planned exception, if any

With no injector installed (the default, always in production) the check
costs ~0.2 µs — no lock, no dict, no import of anything heavier than
this (stdlib-free) module.  ``faults.install_faults`` / ``clear_faults``
are the only writers.  Enforced by the ``telemetry-overhead`` CI gate.

The container is a single-element list (not a bare global) so hot
modules can bind the list object once at import time and still observe
install/clear flips.
"""

# FaultInjector instance, or None.  Read in the port by the serving
# engine's host-side sites ("serve.admit", "serve.cow", "serve.prefill",
# "serve.step", "serve.spec") and by SwapManager ("serve.swap").
FAULTS = [None]
