"""Serving tier of the port: the paged ragged ``Engine`` (speculative
decoding, preemption with KV pages swapped to host and back, per-request
fault isolation, fp or int8 KV pools), its scheduler, block allocator,
prefix cache and swap manager, the n-gram draft proposer, the multi-LoRA
adapter pool, and the typed admission errors.  Not ported yet
(ROADMAP.md): telemetry, meshes, disaggregated roles and the front
door."""

from ..resilience.retry import RetryPolicy
from .block_allocator import (BlockAllocator, PagedKVCache, PrefixCache,
                              SwapManager, SwapPayload)
from .engine import Engine, TokenEvent
from .errors import (AdapterInUse, AdmissionError, BudgetUnsatisfiable,
                     QueueFull, UnknownAdapter)
from .lora import LoRAPool, merge_adapter, random_adapter
from .scheduler import Request, RequestState, Scheduler
from .spec import NgramProposer

__all__ = ["AdapterInUse", "AdmissionError", "BlockAllocator",
           "BudgetUnsatisfiable", "Engine", "LoRAPool", "NgramProposer",
           "PagedKVCache", "PrefixCache", "QueueFull", "Request",
           "RequestState", "RetryPolicy", "Scheduler", "SwapManager",
           "SwapPayload", "TokenEvent", "UnknownAdapter", "merge_adapter",
           "random_adapter"]
