"""Continuous-batching scheduler: admission queue + fixed-shape ragged
slots.

The whole point of this module is that the compiled serving step NEVER
retraces: the batch is always ``max_batch`` slots with static array
shapes — ``tokens (B, C)``, ``block_tables (B, MB)``,
``span_starts (B,)``, ``span_lens (B,)``, ``temps (B,)`` — and requests
join/leave a running batch purely by editing the VALUES in those arrays:

- a slot mid-PREFILL carries its next ≤C-token prompt chunk starting at
  ``kv_len`` (chunked prefill — no per-length bucket programs, no
  head-of-line stall while a long prompt prefills);
- a DECODING slot carries its single pending token (span length 1);
- an idle/inactive slot carries span length 0 and the out-of-range
  block sentinel (scatters drop) — its lane computes garbage the engine
  discards, which on TPU is cheaper than a recompile by ~5 orders of
  magnitude (see the recompile sentinel's storm warning).

Admission reserves every block a request can ever WRITE up front
(``ceil((prompt + max_new) / page)`` minus read-only prefix-cache hits),
so decode can never die on pool exhaustion — a full pool only delays the
waiting queue.  Prefix-cache hits map shared blocks into the new table
and reserve only the remainder; a hit covering the WHOLE prompt keeps
the last matched page borrowed, re-prefills its final token, and
reserves a private replacement for the copy-on-write the engine performs
before that write (serving/block_allocator.py has the lifecycle).

Per-step chunk budgeting: ``plan_spans(chunk, budget)`` caps the TOTAL
prefill tokens scheduled per step and round-robins the budget across
prefilling slots, so on TPU (where the ragged kernel skips dead pages) a
burst of admissions cannot stretch one step's latency unboundedly —
decode slots always advance.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .block_allocator import PrefixCache

__all__ = ["Request", "RequestState", "Scheduler"]

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One user request: prompt + decode policy."""

    prompt_ids: np.ndarray
    max_new_tokens: int = 16
    temperature: float = 0.0        # 0 = greedy, >0 = sampling
    eos_token_id: Optional[int] = None
    on_token: Optional[Callable] = None   # cb(request_id, token_id, text)
    request_id: Optional[str] = None
    tenant: Optional[str] = None    # front-door attribution (telemetry)
    # request-lifecycle trace id (observability/trace.py): filled by the
    # tracer at submit when tracing is on; riding the Request keeps the
    # id with the state through preempt/restore and replica migration
    trace_id: Optional[str] = None
    # multi-LoRA (docs/SERVING.md "Multi-LoRA"): the adapter NAME is the
    # request's portable identity (it rides preempt/restore, replica
    # migration and the disagg wire format); adapter_slot is the
    # engine-local stack index the admitting engine resolves via its
    # LoRAPool — 0 (the exact no-op) for base-model requests
    adapter: Optional[str] = None
    adapter_slot: int = 0

    def __post_init__(self):
        self.prompt_ids = np.asarray(self.prompt_ids, np.int32).reshape(-1)
        if self.prompt_ids.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.request_id is None:
            self.request_id = f"req-{next(_ids)}"


class RequestState:
    """A request occupying a slot (or still waiting)."""

    __slots__ = ("request", "slot", "blocks", "table", "kv_len",
                 "pending_token", "output_ids", "text_len", "detok_offset",
                 "submit_t", "first_token_t", "finished", "finish_reason",
                 "drained", "num_shared", "num_cowed", "cached_tokens",
                 "borrowed", "cow_spare", "page_keys", "swapped",
                 "preempts", "handoffs", "sample_seed", "draft",
                 "spec_proposed", "spec_accepted")

    def __init__(self, request: Request):
        self.request = request
        self.slot: Optional[int] = None
        self.blocks: List[int] = []
        self.table: Optional[np.ndarray] = None   # (MB,) int32
        self.kv_len = 0              # tokens whose KV sits in the pool
        self.pending_token: Optional[int] = None  # emitted, KV not written
        self.output_ids: List[int] = []
        self.text_len = 0            # chars already streamed from the
        self.detok_offset = 0        # ...detok window starting here
        self.submit_t = time.perf_counter()
        self.first_token_t: Optional[float] = None
        self.finished = False
        self.finish_reason: Optional[str] = None
        self.drained = False         # returned by an Engine.run() already
        self.num_shared = 0          # prefix-cache pages borrowed
        self.num_cowed = 0           # of those, privatized by CoW since
        self.cached_tokens = 0       # prompt tokens skipped via the cache
        self.borrowed: Set[int] = set()   # shared pages we may yet write
        self.cow_spare: Dict[int, int] = {}   # page → reserved CoW block
        self.page_keys: List[bytes] = []      # full-prompt-page digests
        # preemption: (pages, host payload) while swapped to host RAM —
        # admission takes the restore path instead of a fresh prefill
        self.swapped: Optional[tuple] = None
        self.preempts = 0            # times this request was preempted
        self.handoffs = 0            # prefill→decode replica transfers
        #                              (disaggregated serving, disagg.py)
        # per-request sampling stream seed (finalized in
        # Scheduler.submit, which folds in its per-engine submission
        # ordinal): the temperature stream depends only on (engine key,
        # prompt, submission index, emit index) — reproducible across
        # identical engines and the speculative/non-speculative split,
        # while DUPLICATE prompts in one engine still sample distinct
        # streams (best-of-n must not collapse to n copies).  Stored on
        # the state, so it survives preempt→restore, replica migration,
        # and hard re-prefill resets (engine._sample).
        self.sample_seed = zlib.crc32(
            request.prompt_ids.tobytes()) & 0x7FFFFFFF
        # speculative decoding (serving/spec.py): this step's draft
        # tokens (transient — set by the engine before planning, never
        # part of any snapshot) and lifetime acceptance accounting
        self.draft: List[int] = []
        self.spec_proposed = 0       # draft tokens sent to verification
        self.spec_accepted = 0       # of those, accepted

    @property
    def total_len(self) -> int:
        return int(self.request.prompt_ids.size) + self.request.max_new_tokens

    @property
    def prefilling(self) -> bool:
        return self.kv_len < int(self.request.prompt_ids.size)


class Scheduler:
    """Waiting queue + the fixed slot bucket."""

    def __init__(self, max_batch: int, page_size: int,
                 max_blocks_per_seq: int, allocator, oob_block: int,
                 prefix_cache: Optional[PrefixCache] = None):
        self.max_batch = int(max_batch)
        self.page_size = int(page_size)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.allocator = allocator
        self.oob_block = int(oob_block)
        self.prefix_cache = prefix_cache
        # Cross-thread when driven through a ServingServer: handler
        # threads observe the queue via FrontDoor while the loop
        # thread admits from it — serialized by ServingServer._lock
        # (pdtpu-lint lock-discipline; single-threaded drivers
        # trivially hold it).
        self.waiting: "collections.deque[RequestState]" = \
            collections.deque()                  # guarded_by: _lock
        self.slots: List[Optional[RequestState]] = [None] * self.max_batch
        self._rr = 0   # round-robin origin for the prefill token budget
        self._submits = 0   # submission ordinal folded into sample seeds

    # -- admission ---------------------------------------------------------

    # requires-lock: _lock
    def submit(self, request: Request,
               page_keys: Optional[List[bytes]] = None) -> RequestState:
        st = RequestState(request)
        # fold the submission ordinal into the sampling seed: identical
        # prompts submitted twice must draw DISTINCT temperature
        # streams (best-of-n), while the same engine driven the same
        # way stays reproducible (RequestState.sample_seed)
        st.sample_seed = (st.sample_seed ^ (self._submits * 0x9E3779B1)
                          ) & 0x7FFFFFFF
        self._submits += 1
        if self.prefix_cache is not None:
            # hash the prompt's pages ONCE here: admit_next runs every
            # step, and a request parked at the queue head under
            # pool-exhaustion backpressure must not re-run O(prompt)
            # blake2b chains per retry.  A caller that already hashed
            # them (the replica router's affinity probe) passes them in.
            # The adapter name salts the chain: adapter deltas change
            # the KV content, so prefix sharing is PER ADAPTER.
            st.page_keys = page_keys if page_keys is not None else \
                PrefixCache.page_keys(
                    request.prompt_ids, self.page_size,
                    salt=request.adapter.encode()
                    if request.adapter else b"")
        self.waiting.append(st)
        return st

    # requires-lock: _lock
    def queue_depth(self) -> int:
        return len(self.waiting)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def blocks_for(self, total_len: int) -> int:
        """Blocks a ``total_len``-token sequence reserves: ceil(len/page).
        The ONE place this formula lives — Engine.add_request's
        unsatisfiable-budget rejection must agree with admission."""
        return -(-int(total_len) // self.page_size)

    def blocks_needed(self, st: RequestState) -> int:
        return self.blocks_for(st.total_len)

    # requires-lock: _lock
    def admit_next(self) -> Optional[RequestState]:
        """Move the head of the waiting queue into a slot.  FIFO
        head-of-line: a large head request waits for blocks rather than
        being starved by later small ones.  With a prefix cache, hit
        pages are borrowed (refcount shared) and only the remainder is
        reserved; prefill resumes at the cached length.  Returns the
        admitted state, or None (no slot / no blocks / no waiters)."""
        if not self.waiting:
            return None
        slot = self._free_slot()
        if slot is None:
            return None
        st = self.waiting[0]
        if st.swapped is not None:
            # RESTORE path: a preempted request re-enters with its KV
            # bytes parked on host.  Every page is re-materialized as a
            # PRIVATE block (no prefix borrowing: the cached entry that
            # backed a borrowed page may have been evicted since, and
            # the host payload is the authoritative content) — the
            # engine swap_ins pages [0, ceil(kv_len/page)) right after
            # this returns, then prefill/decode resumes at kv_len.
            total = self.blocks_needed(st)
            if not self.allocator.can_allocate(total):
                return None
            self.waiting.popleft()
            st.slot = slot
            st.blocks = self.allocator.allocate(total)
            st.table = np.full((self.max_blocks_per_seq,), self.oob_block,
                               np.int32)
            st.table[:total] = st.blocks
            self.slots[slot] = st
            return st
        plen = int(st.request.prompt_ids.size)
        total = self.blocks_needed(st)
        keys = st.page_keys                    # hashed once at submit()
        hit_blocks: List[int] = []
        if self.prefix_cache is not None:
            hit_blocks = self.prefix_cache.lookup(keys)
        shared = len(hit_blocks)
        # physical capacity: reviving a refcount-0 cached hit consumes a
        # unit of free capacity too (can_allocate counts evictable blocks
        # as free, but share() takes them out of that pool), and a fully
        # cached prompt's CoW spare needs one block beyond
        # blocks_for(total) — so the full hit may not fit even when the
        # no-hit path would.  Degrade the hit page by page until it
        # fits; shared == 0 is the plain path, eventually satisfiable
        # because add_request guarantees total <= num_blocks.
        while True:
            # always leave >= 1 prompt token to prefill: the first
            # output token needs the last prompt position's logits, and
            # a fully cached prompt would otherwise skip the forward
            first_write = min(shared * self.page_size, plen - 1)
            ro_pages = first_write // self.page_size   # never written
            need_private = total - ro_pages
            revive = sum(1 for bid in hit_blocks[:shared]
                         if self.allocator.refcount(bid) == 0)
            if self.allocator.can_allocate(need_private + revive):
                break
            if shared == 0:
                return None
            shared -= 1
        hit_blocks = hit_blocks[:shared]
        for bid in hit_blocks:                     # commit the hit
            self.allocator.share(bid)
        priv = self.allocator.allocate(need_private)
        if self.prefix_cache is not None and keys:
            self.prefix_cache.record(shared, len(keys) - shared)
        self.waiting.popleft()
        st.slot = slot
        st.blocks = list(hit_blocks) + priv        # one reference each
        st.table = np.full((self.max_blocks_per_seq,), self.oob_block,
                           np.int32)
        st.table[:shared] = hit_blocks
        tail = total - shared                      # pages past the hit
        st.table[shared:total] = priv[:tail]
        # leftover private blocks are CoW replacements for borrowed
        # pages the prefill will write into (at most one: the last
        # matched page of a fully-cached prompt)
        st.cow_spare = {pg: priv[tail + k]
                        for k, pg in enumerate(range(ro_pages, shared))}
        st.borrowed = set(range(ro_pages, shared))
        st.num_shared = shared
        st.cached_tokens = first_write
        st.kv_len = first_write
        self.slots[slot] = st
        return st

    # -- the running batch -------------------------------------------------

    def active(self) -> List[Tuple[int, RequestState]]:
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    # requires-lock: _lock — advances the _rr round-robin origin
    def plan_spans(self, chunk: int, budget: Optional[int] = None
                   ) -> List[Tuple[int, "RequestState", int, bool]]:
        """Decide each active slot's span for this step: ``(slot, state,
        span_len, is_prefill)``.  Decode slots get their pending token
        plus any speculative draft the engine attached (``st.draft`` —
        span ``1 + len(draft)``, still ≤ chunk by the engine's draft
        cap); prefilling slots split ``budget`` prefill tokens (default:
        no cap) in ≤``chunk`` chunks, round-robined across steps so a
        tight budget starves nobody.  Slots left out idle this step
        (span 0).  The engine runs copy-on-write for spans that land in
        borrowed pages BEFORE materializing the batch arrays
        (span_arrays) — draft positions included."""
        c = int(chunk)
        left = int(budget) if budget is not None else self.max_batch * c
        self._rr = (self._rr + 1) % max(self.max_batch, 1)
        order = sorted(self.active(),
                       key=lambda t: (t[0] - self._rr) % self.max_batch)
        plan = []
        for i, st in order:
            if st.prefilling:
                plen = int(st.request.prompt_ids.size)
                n = min(c, plen - st.kv_len, left)
                if n <= 0:
                    continue                       # budget spent: idle
                left -= n
                plan.append((i, st, n, True))
            else:
                # draft tokens are NOT prefill work: they ride the
                # decode slot's lane for free (the ragged kernel skips
                # dead rows either way) and never touch the budget
                plan.append((i, st, 1 + min(len(st.draft), c - 1), False))
        plan.sort(key=lambda t: t[0])
        return plan

    def span_arrays(self, plan, chunk: int, spec_emit: bool = False):
        """The fixed-shape ragged step inputs for a span plan:
        ``(tokens (B,C), tables (B,MB), starts (B,), lens (B,),
        temps (B,), seeds (B,), emit (B,), adapters (B,))`` as numpy
        arrays.  Idle/empty slots get the inert sentinel values —
        shapes NEVER depend on occupancy (a draft miss is ``len 1``,
        never a new shape; an adapter change is a new VALUE in
        ``adapters``, never a new program).  Call AFTER copy-on-write
        has patched the tables.

        ``seeds``/``emit`` drive the per-emitted-token-index PRNG key
        derivation (``engine._sample``): ``emit[i]`` is the emit index
        of the slot's FIRST sampled position — for the speculative step
        (``spec_emit=True``, which samples every span position) a
        completing prefill span is rebased so its LAST position lands
        on emit index ``len(output_ids)``."""
        b, mb, c = self.max_batch, self.max_blocks_per_seq, int(chunk)
        tokens = np.zeros((b, c), np.int32)
        tables = np.full((b, mb), self.oob_block, np.int32)
        starts = np.zeros((b,), np.int32)
        lens = np.zeros((b,), np.int32)
        temps = np.zeros((b,), np.float32)
        seeds = np.zeros((b,), np.int32)
        emit = np.zeros((b,), np.int32)
        adapters = np.zeros((b,), np.int32)   # 0 = base no-op slot
        for i, st, n, is_prefill in plan:
            req = st.request
            if is_prefill:
                tokens[i, :n] = req.prompt_ids[st.kv_len:st.kv_len + n]
            else:
                tokens[i, 0] = st.pending_token
                if n > 1:
                    tokens[i, 1:n] = st.draft[:n - 1]
            tables[i] = st.table
            starts[i] = st.kv_len
            lens[i] = n
            temps[i] = req.temperature
            seeds[i] = st.sample_seed
            emit[i] = len(st.output_ids) - \
                ((n - 1) if (spec_emit and is_prefill) else 0)
            adapters[i] = req.adapter_slot
        return tokens, tables, starts, lens, temps, seeds, emit, adapters

    def finish(self, st: RequestState, reason: str) -> None:
        """Release the slot and drop every block reference (shared pages
        decref; private pages return to the free list or, if registered
        in the prefix cache, to the evictable LRU pool)."""
        st.finished = True
        st.finish_reason = reason
        self.release_slot(st)

    def release_slot(self, st: RequestState) -> None:
        """Vacate ``st``'s slot and drop every block reference WITHOUT
        finishing it — the preemption/isolation half of ``finish``.
        Shared pages decref (never touched under other readers); CoW
        spares and private pages return to the pool.  The caller
        requeues the state for restoration."""
        if st.slot is not None:
            self.slots[st.slot] = None
            st.slot = None
        if st.blocks:
            self.allocator.free(st.blocks)
            st.blocks = []
        st.table = None
        st.borrowed = set()
        st.cow_spare = {}
        # unaccepted speculative tokens never outlive the slot: a
        # preempt/finish snapshot carries only accepted state (kv_len
        # covers exactly pending + accepted; the draft was transient)
        st.draft = []

    # requires-lock: _lock
    def requeue(self, st: RequestState, head: bool = False) -> None:
        """Put a preempted/isolated request back on the waiting queue —
        at the head for fault isolation (it was mid-flight; resume
        ASAP), at the tail for front-door preemption (the preemptor is
        already queued ahead of it, plain FIFO restores the victim once
        the pressure passes)."""
        if head:
            self.waiting.appendleft(st)
        else:
            self.waiting.append(st)

    # requires-lock: _lock
    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)
