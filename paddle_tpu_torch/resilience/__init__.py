"""Resilience of the port: deterministic fault injection (``faults.py``)
and retry with backoff (``retry.py``), copies of the reference's
stdlib-only ``paddle_tpu/resilience`` modules.  The serving engine's
``serve.*`` sites call the installed injector; its swap calls run under a
:class:`RetryPolicy`.  The reference's supervisor (auto-resuming training
runs) is not ported yet."""

from .faults import (SITES, FaultInjector, FaultPlan, InjectedFault,
                     active_injector, clear_faults, install_faults,
                     install_faults_from_env, parse_faults)
from .retry import DEFAULT_RETRYABLE, RetryPolicy, retry_call

__all__ = ["DEFAULT_RETRYABLE", "FaultInjector", "FaultPlan",
           "InjectedFault", "RetryPolicy", "SITES", "active_injector",
           "clear_faults", "install_faults", "install_faults_from_env",
           "parse_faults", "retry_call"]
