"""Launch support of the port: so far :class:`PreemptionGuard`, a copy of
``paddle_tpu/launch/preempt.py`` (SIGTERM turned into a flag and one
graceful save or drain).  The reference's launcher, controllers and
TCPStore are not ported yet (ROADMAP.md, queue 1 item 10)."""

from .preempt import PreemptionGuard

__all__ = ["PreemptionGuard"]
