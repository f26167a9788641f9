"""Serving tier of the port: the paged ragged ``Engine``, its scheduler,
block allocator and prefix cache, and the typed admission errors."""

from .block_allocator import BlockAllocator, PagedKVCache, PrefixCache
from .engine import Engine, TokenEvent
from .errors import AdmissionError, BudgetUnsatisfiable, QueueFull
from .scheduler import Request, RequestState, Scheduler

__all__ = ["AdmissionError", "BlockAllocator", "BudgetUnsatisfiable",
           "Engine", "PagedKVCache", "PrefixCache", "QueueFull", "Request",
           "RequestState", "Scheduler", "TokenEvent"]
