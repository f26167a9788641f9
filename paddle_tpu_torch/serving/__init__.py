"""Serving tier of the port: the paged ragged ``Engine`` (speculative
decoding, preemption with KV pages swapped to host and back, per-request
fault isolation, fp or int8 KV pools, telemetry and ``slo_capture``), its
scheduler, block allocator, prefix cache and swap manager, the n-gram
draft proposer, the multi-LoRA adapter pool, the typed admission errors,
and the production front: ``FrontDoor`` (per-tenant policies, typed shed
answers, fairness, preemption under pool pressure) and ``ServingServer``
(the streaming HTTP process with ``/metrics``, request timelines and a
graceful SIGTERM drain).  Not ported yet (ROADMAP.md): meshes, replica
sets and disaggregated roles."""

from ..resilience.retry import RetryPolicy
from .block_allocator import (BlockAllocator, PagedKVCache, PrefixCache,
                              SwapManager, SwapPayload)
from .engine import Engine, TokenEvent
from .errors import (AdapterInUse, AdmissionError, BudgetUnsatisfiable,
                     QueueFull, RateLimited, UnknownAdapter)
from .frontdoor import Admission, FrontDoor, TenantPolicy, TokenBucket
from .lora import LoRAPool, merge_adapter, random_adapter
from .scheduler import Request, RequestState, Scheduler
from .server import ServingServer
from .spec import NgramProposer

__all__ = ["AdapterInUse", "AdmissionError", "Admission", "BlockAllocator",
           "BudgetUnsatisfiable", "Engine", "FrontDoor", "LoRAPool",
           "NgramProposer", "PagedKVCache", "PrefixCache", "QueueFull",
           "RateLimited", "Request", "RequestState", "RetryPolicy",
           "Scheduler", "ServingServer", "SwapManager", "SwapPayload",
           "TenantPolicy", "TokenBucket", "TokenEvent", "UnknownAdapter",
           "merge_adapter", "random_adapter"]
