"""Typed admission failures for the serving tier.

``Engine.add_request`` / ``FrontDoor.submit`` reject work for exactly
three reasons, and a production client must tell them apart without
string-matching a message: a *full queue* means "come back shortly", an
*unsatisfiable budget* means "this request can never fit — change it",
and a *rate limit* means "you, specifically, come back after
``retry_after_s``".  Bare ``ValueError``/``RuntimeError`` erased that
distinction, so every rejection is now a subclass of
:class:`AdmissionError`.

``AdmissionError`` deliberately subclasses ``ValueError``: every
pre-existing caller (and test) that caught ``ValueError`` on
``add_request`` keeps working — the hierarchy is additive.

The front door's load-shedding path does NOT raise by default: shed
requests get a typed :class:`~paddle_tpu.serving.frontdoor.Admission`
answer carrying the same reason + ``retry_after_s`` (an overloaded
server answering thousands of shed requests per second should not pay
exception unwinding per shed, and a shed is an expected outcome, not an
error).  ``FrontDoor.submit(raise_on_shed=True)`` opts into raising
these instead.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["AdapterInUse", "AdmissionError", "BudgetUnsatisfiable",
           "QueueFull", "RateLimited", "UnknownAdapter"]


class AdmissionError(ValueError):
    """Base: the serving tier refused to accept a request."""


class QueueFull(AdmissionError):
    """The bounded waiting queue is at capacity — retry later.

    ``retry_after_s`` (when known) is a load-based estimate of when a
    retry is likely to be admitted."""

    def __init__(self, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class BudgetUnsatisfiable(AdmissionError):
    """The request can NEVER be served by this engine geometry
    (prompt + max_new_tokens beyond ``max_seq_len``, or a KV-block
    budget larger than the whole pool).  Retrying cannot help — the
    request or the engine must change."""


class RateLimited(AdmissionError):
    """A tenant exceeded its token-bucket rate limit or quota.

    ``retry_after_s`` is the exact wait until the bucket can cover the
    request's token cost (or a load-based estimate for quota sheds)."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class UnknownAdapter(AdmissionError):
    """The request names a LoRA adapter this engine has not loaded
    (``serving.LoRAPool`` — docs/SERVING.md "Multi-LoRA").  Raised at
    admission (``Engine.add_request`` / ``FrontDoor.submit``), never
    mid-decode: tenant→adapter mapping is validated before any state
    lands, so a bad mapping cannot strand a half-admitted request."""


class AdapterInUse(ValueError):
    """``LoRAPool.evict`` refused: live requests still reference the
    adapter's slot.  Evicting under readers would repoint their slot at
    zeros (or a later adapter's weights) mid-decode — the caller must
    drain or wait, not corrupt."""
