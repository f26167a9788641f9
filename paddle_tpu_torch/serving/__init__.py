"""Serving tier of the port: the paged ragged ``Engine``, its scheduler,
block allocator and prefix cache, the multi-LoRA adapter pool, and the
typed admission errors."""

from .block_allocator import BlockAllocator, PagedKVCache, PrefixCache
from .engine import Engine, TokenEvent
from .errors import (AdapterInUse, AdmissionError, BudgetUnsatisfiable,
                     QueueFull, UnknownAdapter)
from .lora import LoRAPool, merge_adapter, random_adapter
from .scheduler import Request, RequestState, Scheduler

__all__ = ["AdapterInUse", "AdmissionError", "BlockAllocator",
           "BudgetUnsatisfiable", "Engine", "LoRAPool", "PagedKVCache",
           "PrefixCache", "QueueFull", "Request", "RequestState",
           "Scheduler", "TokenEvent", "UnknownAdapter", "merge_adapter",
           "random_adapter"]
