"""Block allocator + paged KV pools + prefix cache — the serving
engine's memory layer.

Reference capability: vLLM-style paged KV management with hash-based
prefix caching (PAPERS.md "Ragged Paged Attention" describes the TPU
kernel shape this feeds).  The pool is ONE global
``(num_blocks, page, H_kv, D)`` k/v array pair per decoder layer;
requests address disjoint-or-shared block-id sets through per-request
block tables, so `max_batch` concurrent sequences share the HBM a dense
`(B, S_max, ...)` cache would burn on padding — and requests repeating
the same prompt prefix share the SAME physical blocks.

Block lifecycle (docs/SERVING.md has the diagram)::

    free ──allocate──▶ owned (ref 1) ──share──▶ shared (ref N)
      ▲                    │    ▲                   │
      │                    │    └──── CoW copy ◀────┘  (write to shared)
      │              free/deref
      │                    ▼
      └──evict(LRU)── cached (ref 0, registered, content intact)

Invariants (enforced here, relied on by the engine):

- every live block has refcount >= 1; ``free`` releases ONE reference —
  freeing an unknown id or a block with no outstanding references
  raises instead of silently corrupting the free list;
- a refcount-0 block REGISTERED in the prefix cache keeps its content
  and becomes evictable (LRU); eviction deregisters it before reuse;
- the engine reserves every block a request can ever WRITE at admission
  (cache-hit pages it will only read are borrowed via ``share``), so a
  running request never fails mid-decode on pool exhaustion;
- at drain (no waiting, no active requests) ``used_blocks == 0`` — all
  refcounts back to zero; cached blocks linger only as evictable
  capacity (checked by the `serving-smoke` CI gate).
"""

from __future__ import annotations

import collections
import hashlib
import json
import math
import struct
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.cuda.ragged_attention import int8_pools, pool_pair
from ..resilience import _state as _rs_state

__all__ = ["BlockAllocator", "PagedKVCache", "PrefixCache", "SwapManager",
           "SwapPayload"]


class BlockAllocator:
    """Refcounted free-list allocation over block ids ``[0, num_blocks)``
    with an LRU pool of evictable (refcount-0, prefix-cached) blocks."""

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        # pop() takes from the tail → low ids hand out first (stable
        # tests and readable block tables)
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        # refcount-0 blocks whose content the prefix cache still indexes,
        # in LRU order (oldest first) — reused only when the free list
        # runs dry, via on_evict so the cache drops its hash entry
        self._evictable: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._cached_key: Dict[int, object] = {}   # block → cache key
        self.on_evict: Optional[Callable[[int, object], None]] = None
        self.evictions = 0

    @property
    def free_blocks(self) -> int:
        """Immediately allocatable blocks (free list + evictable)."""
        return len(self._free) + len(self._evictable)

    @property
    def used_blocks(self) -> int:
        """Blocks with at least one outstanding reference."""
        return len(self._ref)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks kept alive by the prefix cache (evictable)."""
        return len(self._evictable)

    def refcount(self, block_id: int) -> int:
        return self._ref.get(int(block_id), 0)

    def can_allocate(self, n: int) -> bool:
        return n <= self.free_blocks

    def allocate(self, n: int) -> List[int]:
        if n > self.free_blocks:
            raise RuntimeError(
                f"KV pool exhausted: asked for {n} blocks, "
                f"{self.free_blocks} free of {self.num_blocks} — admission "
                "should have gated this request (serving/scheduler.py)")
        ids = []
        for _ in range(n):
            if self._free:
                i = self._free.pop()
            else:
                # LRU eviction: oldest cached block loses its hash entry
                i, _ = self._evictable.popitem(last=False)
                key = self._cached_key.pop(i)
                self.evictions += 1
                if self.on_evict is not None:
                    self.on_evict(i, key)
            self._ref[i] = 1
            ids.append(i)
        return ids

    def share(self, block_id: int) -> None:
        """Take one more reference on a live or cached block (a prefix-
        cache hit borrowing the block into another request's table).
        Reviving a cached block removes it from the evictable pool but
        keeps its registration — future lookups still hit it."""
        i = int(block_id)
        if i in self._ref:
            self._ref[i] += 1
        elif i in self._evictable:
            del self._evictable[i]
            self._ref[i] = 1
        else:
            raise ValueError(
                f"share of block {i} which is neither live nor cached")

    def free(self, ids: Sequence[int]) -> None:
        """Release ONE reference per id.  A block reaching refcount 0
        returns to the free list — or, if the prefix cache registered
        it, to the evictable LRU pool with its content intact."""
        for i in ids:
            i = int(i)
            if not 0 <= i < self.num_blocks:
                raise ValueError(
                    f"free of unknown KV block {i} — valid ids are "
                    f"[0, {self.num_blocks})")
            if i not in self._ref:
                raise ValueError(
                    f"double free of KV block {i} — a request's block "
                    "list was reclaimed twice, or the id was never "
                    "allocated")
            self._ref[i] -= 1
            if self._ref[i] == 0:
                del self._ref[i]
                if i in self._cached_key:
                    self._evictable[i] = None       # MRU end
                else:
                    self._free.append(i)

    # -- prefix-cache bookkeeping (called by PrefixCache) ------------------

    def _mark_cached(self, block_id: int, key: object) -> None:
        self._cached_key[int(block_id)] = key

    def _is_cached(self, block_id: int) -> bool:
        return int(block_id) in self._cached_key


class PrefixCache:
    """Hash-based prefix cache: page-aligned prompt prefixes → pool
    blocks, with refcounted sharing and LRU eviction (the host half;
    copy-on-write copies run through
    :func:`incubate.nn.functional.paged_copy_blocks`).

    Keys are CHAINED content digests: page ``i``'s key is
    ``blake2b(key[i-1] || tokens[i*page:(i+1)*page])``, so a hit on page
    ``i`` implies every earlier token matches too — one dict probe per
    page, no collision risk at 16-byte digests.  Only FULL prompt pages
    are registered (a partial page's tail would diverge per request).
    """

    def __init__(self, allocator: BlockAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = int(page_size)
        self._blocks: Dict[bytes, int] = {}     # key → block id
        self.hits = 0          # pages served from cache
        self.misses = 0        # hashable pages that missed
        allocator.on_evict = self._on_evict

    @staticmethod
    def page_keys(prompt_ids, page_size: int,
                  salt: bytes = b"") -> List[bytes]:
        """Chained digests for every FULL page of ``prompt_ids``.

        ``salt`` seeds the chain: pages written under different salts
        never share, however identical their tokens.  Multi-LoRA uses
        the adapter name here (scheduler.submit) — an adapter's q/k/v
        deltas change the KV CONTENT at every position, so a page
        prefilled under adapter A must never be borrowed by a request
        on adapter B (or the base model), and the chained digest is
        exactly the right place to encode that: one seed, every
        downstream page key diverges."""
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        keys, prev = [], bytes(salt)
        for p in range(ids.size // page_size):
            h = hashlib.blake2b(digest_size=16)
            h.update(prev)
            h.update(ids[p * page_size:(p + 1) * page_size].tobytes())
            prev = h.digest()
            keys.append(prev)
        return keys

    def lookup(self, keys: Sequence[bytes]) -> List[int]:
        """Block ids for the longest cached prefix of ``keys``.  Pure
        peek — the caller commits the hit with ``allocator.share`` per
        block plus one :meth:`record` call (admission is
        single-threaded, so peek-then-commit is atomic; a blocked
        admission retried every step must not inflate the stats)."""
        out: List[int] = []
        for k in keys:
            bid = self._blocks.get(k)
            if bid is None:
                break
            out.append(bid)
        return out

    def record(self, hits: int, misses: int) -> None:
        """Count one committed admission's page hits/misses."""
        self.hits += int(hits)
        self.misses += int(misses)

    def register(self, key: bytes, block_id: int) -> bool:
        """Index ``block_id`` (a fully-written prompt page owned by the
        caller) under ``key``.  First writer wins: if the key is already
        cached (two identical prompts prefilled concurrently), the
        duplicate block stays a normal private block."""
        if key in self._blocks:
            return False
        self._blocks[key] = int(block_id)
        self.allocator._mark_cached(int(block_id), key)
        return True

    def _on_evict(self, block_id: int, key: object) -> None:
        self._blocks.pop(key, None)

    def __len__(self) -> int:
        return len(self._blocks)

    def stats(self) -> Dict[str, float]:
        probes = self.hits + self.misses
        # "registered_pages" counts hash-indexed pages whether live or
        # evictable — deliberately NOT named like the serve.cached_blocks
        # gauge, which is the refcount-0 evictable pool only
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": (self.hits / probes) if probes else 0.0,
                "registered_pages": len(self._blocks),
                "evictions": self.allocator.evictions}



class PagedKVCache:
    """Per-layer paged k/v pools + their allocator.

    ``caches`` is a list (one entry per decoder layer) of pool tuples in
    the ``incubate.nn.functional`` cache-arity convention: fp ``(k, v)``
    of shape ``(num_blocks, page, H_kv, D)`` on ``device`` -- the layout
    the kernels and the plain versions share -- or, with ``dtype="int8"``
    (any spelling: ``"int8"``, ``"paddle.int8"``, ``np.int8``,
    ``torch.int8``), quantized ``(k_i8, v_i8, k_scale, v_scale)`` with
    ``(num_blocks, page, H_kv)`` f32 scales (``quantize_kv``, the formula
    of the dense int8 caches).  The engine's step writes them IN PLACE.
    Each tuple is an ``ops.cuda.ragged_attention.PoolPair`` whose storage
    holds ``spare_rows`` hidden rows behind each pool, scales included:
    with at least B x C of them (the engine asks for its step's), the
    span write sends dead rows there instead of masking them on the host,
    so the step never syncs.  The pools keep a fresh tensor's strides;
    values start at zero, scales at one.  The tensor-parallel layout is
    not ported yet (ROADMAP.md).
    """

    def __init__(self, num_layers: int, num_blocks: int, page_size: int,
                 num_kv_heads: int, head_dim: int, dtype=torch.float32,
                 device=None, spare_rows: int = 0):
        from ..models.generation import _is_int8
        from ..models.llama import torch_dtype
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.quantized = _is_int8(dtype)
        if not self.quantized:
            dtype = torch_dtype(dtype)
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.page_size = int(page_size)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        geom = (self.num_blocks, self.page_size, self.num_kv_heads,
                self.head_dim, int(spare_rows))
        self.caches = [int8_pools(*geom, device) if self.quantized
                       else pool_pair(*geom, dtype, device)
                       for _ in range(self.num_layers)]
        self.allocator = BlockAllocator(self.num_blocks)

    @property
    def oob_block(self) -> int:
        """The out-of-range block-id sentinel: the span write and the page
        copy mask entries carrying it out, and the attention kernel never
        reads a table entry past a slot's last live page, so a table row
        full of it makes a slot inert."""
        return self.num_blocks

    def nbytes(self) -> int:
        """Bytes of every layer's pools, the int8 scales included (the
        spare rows behind them not)."""
        per_layer = sum(a.numel() * a.element_size() for a in self.caches[0])
        return per_layer * self.num_layers


class SwapPayload(list):
    """A :meth:`SwapManager.swap_out` payload: one tuple of host tensors
    per decoder layer, one (n, page, H_kv, D) tensor per pool of the layer
    (pinned memory when the pools live on the card).  ``ready`` is the
    CUDA event recorded after the device-to-host copies (None on the
    CPU): the copies run asynchronously, so read the tensors only after
    :meth:`synchronize`."""

    ready: Optional[torch.cuda.Event] = None

    def synchronize(self) -> "SwapPayload":
        """Wait until the copies that fill the payload have finished."""
        if self.ready is not None:
            self.ready.synchronize()
        return self

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for layer in self for t in layer)


class SwapManager:
    """Host-RAM swap space for preempted requests' KV pages
    (``paddle_tpu/serving/block_allocator.py`` ``SwapManager``
    counterpart).

    Instead of rejecting work when the pool is tight, the engine picks a
    victim, ``swap_out``s the content of its allocated pages -- every
    layer's rows of every pool of the layer -- into host buffers, frees
    the blocks, and later ``swap_in``s the bytes into freshly allocated
    blocks so the request resumes token-identical.  Each pool tuple is
    walked generically, so pools with scale tensors beside k and v ride
    the same code.

    Both directions work in chunks of ``chunk`` pages: a gather of the
    chunk's rows (``index_select``) and its copy to host, or the copy to
    the card and an in-place ``index_copy_`` into the same pool tensors.
    An int8 layer's scales are pools of its tuple, so they ride the same
    copies.
    The pools never move (a captured step reads them by address) and the
    spare rows behind them (``PagedKVCache(spare_rows=)``) are never
    touched.  On the card the host buffers are pinned and the copies are
    ``non_blocking`` on the current stream, in stream order after the
    step that wrote the pages; the payload's ``ready`` event marks their
    end (:class:`SwapPayload`).

    Refcount discipline: swap only COPIES content -- shared prefix-cache
    pages a victim borrowed are read, never mutated, so they are never
    swapped out from under the other slots (or cache entries) still
    referencing them; the victim merely drops its references and
    re-materializes private copies at restore.
    """

    def __init__(self, kv: PagedKVCache, chunk: int = 8):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.kv = kv
        self.chunk = int(chunk)
        self.pages_out = 0           # lifetime pages swapped to host
        self.pages_in = 0            # lifetime pages restored

    @property
    def device(self) -> torch.device:
        return self.kv.caches[0][0].device

    def _ids(self, block_ids: Sequence[int]) -> torch.Tensor:
        ids = np.asarray(block_ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.kv.num_blocks):
            raise ValueError(
                f"swap of KV blocks {ids.tolist()} outside [0, "
                f"{self.kv.num_blocks})")
        return torch.from_numpy(ids).to(self.device)

    def swap_out(self, block_ids: Sequence[int]) -> SwapPayload:
        """Copy ``block_ids``'s rows from every layer's pools to host;
        returns the payload ``swap_in`` takes.  Read-only on the pools."""
        fi = _rs_state.FAULTS[0]
        if fi is not None:
            fi("serve.swap")
        ids = self._ids(block_ids)
        n = int(ids.numel())
        pin = self.device.type == "cuda"
        host = self._host_buffers(n, pin)
        for lo in range(0, n, self.chunk):
            sel = ids[lo:lo + self.chunk]
            for layer, hlayer in zip(self.kv.caches, host):
                for c, h in zip(layer, hlayer):
                    h[lo:lo + self.chunk].copy_(c.index_select(0, sel),
                                                non_blocking=pin)
        if pin:
            host.ready = torch.cuda.Event()
            host.ready.record()
        self.pages_out += n
        return host

    def _host_buffers(self, n: int, pin: bool) -> SwapPayload:
        """Host tensors for ``n`` pages of every pool, views of ONE
        allocation (pinned on the card: one page-locking call per
        payload, not one per pool), each piece 16-byte aligned."""
        shapes = [[((n,) + tuple(c.shape[1:]), c.dtype) for c in layer]
                  for layer in self.kv.caches]
        sizes = [math.prod(shape) * torch.empty((), dtype=dt).element_size()
                 for layer in shapes for shape, dt in layer]
        buf = torch.empty(sum(-(-b // 16) * 16 for b in sizes),
                          dtype=torch.uint8, pin_memory=pin)
        host, off, it = SwapPayload(), 0, iter(sizes)
        for layer in shapes:
            views = []
            for shape, dt in layer:
                b = next(it)
                views.append(buf[off:off + b].view(dt).view(shape))
                off += -(-b // 16) * 16
            host.append(tuple(views))
        return host

    def swap_in(self, block_ids: Sequence[int], host: SwapPayload) -> None:
        """Write a ``swap_out`` payload into ``block_ids`` (freshly
        allocated blocks) across every layer's pools, in place."""
        fi = _rs_state.FAULTS[0]
        if fi is not None:
            fi("serve.swap")
        ids = self._ids(block_ids)
        n = int(ids.numel())
        if len(host) != len(self.kv.caches) or any(
                len(hl) != len(cl) or int(h.shape[0]) != n
                or h.shape[1:] != c.shape[1:] or h.dtype != c.dtype
                for hl, cl in zip(host, self.kv.caches)
                for h, c in zip(hl, cl)):
            raise ValueError(
                f"swap payload does not match {n} pages of this engine's "
                "pools (layers, pools per layer, page geometry, dtype)")
        pin = self.device.type == "cuda"
        if pin and host.ready is not None:
            # the payload's own copies first, whatever stream made them
            torch.cuda.current_stream(self.device).wait_event(host.ready)
        for lo in range(0, n, self.chunk):
            sel = ids[lo:lo + self.chunk]
            for layer, hlayer in zip(self.kv.caches, host):
                for c, h in zip(layer, hlayer):
                    c.index_copy_(0, sel, h[lo:lo + self.chunk].to(
                        self.device, non_blocking=pin))
        self.pages_in += n
