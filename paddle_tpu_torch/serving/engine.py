"""Continuous-batching serving engine over the paged KV cache
(``paddle_tpu/serving/engine.py`` counterpart).

``Engine`` keeps ``max_batch`` slots running through ONE fixed-shape
ragged step and admits/retires requests between steps.  Every step runs a
single ``(B, C)`` batch of per-slot token SPANS -- chunked-prefill
segments and single decode tokens side by side -- through the model's
paged forward over a global block pool shared by all requests.  Repeated
prompt prefixes share physical blocks through the hash-based prefix cache
(``block_allocator.PrefixCache``); the step copy-on-writes any borrowed
page before writing into it.

Step anatomy (one :meth:`step` call):

1. **admit**: waiting requests move into free slots while blocks last;
   prefix-cache hits skip straight to their first uncached token;
2. **plan + CoW**: each active slot gets its span (next prefill chunk,
   bounded by the per-step token budget, or its pending decode token);
   spans landing in borrowed pages trigger the page copy;
3. **one ragged step**: every span's KV is written at its positions,
   every query row attends its prefix, one token is sampled per slot --
   consumed only by slots that completed their prompt or decoded;
4. **retire**: EOS / max-token requests leave their slot; their private
   full-prompt pages stay indexed in the prefix cache (evictable LRU),
   everything else returns to the free list.

On the card each Llama decoder layer of the step launches the three
hand-written kernels (``ops/cuda``), each GPT layer the ragged-attention
and fused GELU-MLP kernels; under ``fused_ops="mega"`` the
decode megakernel and the fused MLP kernel instead; with ``weight_quant``
the projections and the LM head launch the int8/int4 matmul kernel
instead of the fused QKV/MLP kernels; with ``lora`` (multi-LoRA) the
layers take the unfused branch and each projection adds the grouped-BGMV
delta of its slot's adapter.  On the CPU (``device="cpu"``) the same step
runs their plain versions.  :meth:`launches_per_step` counts the kernel
launches (on the CPU the plain calls) of the last step.  The step's
shapes never depend on occupancy, as in the reference.  Not ported yet
(ROADMAP.md): speculative decoding, meshes, disaggregated roles,
preemption/swap, int8 KV pools, telemetry and fault sites.
"""

from __future__ import annotations

import collections
import hashlib
import itertools
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops import cuda as _kernels
from .block_allocator import PagedKVCache, PrefixCache
from .errors import AdmissionError, BudgetUnsatisfiable, UnknownAdapter
from .scheduler import Request, RequestState, Scheduler

__all__ = ["Engine", "TokenEvent"]


class TokenEvent(NamedTuple):
    """One emitted token, as returned by ``step()``/``stream()``."""

    request_id: str
    token_id: int
    text: Optional[str]          # detokenized text (not ported: None)
    finished: bool
    finish_reason: Optional[str]  # "eos" | "length" when finished


def _kv_geometry(model):
    """(num_layers, kv_heads, head_dim) from a CausalLM config."""
    cfg = model.cfg
    kv = getattr(cfg, "num_key_value_heads", None) or \
        cfg.num_attention_heads
    return cfg.num_hidden_layers, kv, cfg.head_dim


def _paged_supported(model) -> bool:
    mdl = getattr(model, "model", None)
    if mdl is None or getattr(model.cfg, "pipeline_stages", 1) != 1:
        return False
    cls = getattr(type(mdl), "decoder_layer_cls", None)
    return cls is not None and getattr(cls, "supports_paged", False)


def _draw_seed(key: int, seed: int, emit: int) -> int:
    """The generator seed of one temperature draw: a pure function of
    (engine seed, request sample seed, emit index), so a stream is
    reproducible within the port whatever else shares the batch."""
    h = hashlib.blake2b(digest_size=8)
    h.update(np.asarray([key, seed, emit], np.int64).tobytes())
    return int.from_bytes(h.digest(), "little") & 0x7FFFFFFFFFFFFFFF


def _sample(logits, temps, key: int, seeds, emit):
    """Per-slot greedy (temp == 0) or temperature sampling.  ``logits``
    (B, V) on the engine's device; ``temps``/``seeds``/``emit`` host
    numpy.  Greedy is the argmax of the f32 logits; a temperature slot
    draws from ``softmax(logits / temp)`` with a CPU ``torch.Generator``
    seeded per (engine seed, request seed, emit index) -- reproducible
    within the port, not bit-equal to the reference's jax PRNG draws.
    Returns (B,) int64 on the logits' device."""
    lg = logits.float()
    out = torch.argmax(lg, dim=-1)
    for b in np.nonzero(temps > 0.0)[0]:
        gen = torch.Generator().manual_seed(
            _draw_seed(key, int(seeds[b]), int(emit[b])))
        probs = torch.softmax(lg[b].cpu() / max(float(temps[b]), 1e-6),
                              dim=-1)
        out[b] = int(torch.multinomial(probs, 1, generator=gen))
    return out


class Engine:
    """Continuous-batching serving engine (docs/SERVING.md).

    ``model`` is a port ``LlamaForCausalLM`` or ``GPTForCausalLM`` (any
    CausalLM whose decoder layers support the paged path) whose
    parameters live on ``device`` (default: the CUDA card; raises
    without one unless ``device="cpu"``).  ``prefill_chunk``: span width C of the unified
    step (default ``min(16, max_seq_len)``).  ``prefill_token_budget``
    caps the total prefill tokens scheduled per step (default unbounded).
    ``enable_prefix_caching``: hash-based sharing of page-aligned prompt
    prefixes across requests, with copy-on-write.  ``keep_finished``: how
    many finished requests stay queryable via :meth:`output_ids`.

    A model lists in ``engine_options_not_ported`` the options the port
    does not serve for it yet (GPT: ``weight_quant`` and ``lora``); they
    raise ``NotImplementedError``.

    ``weight_quant``: ``"int8"``, ``"int4"`` or an ``nn.quant`` algo
    name swaps the model's Linears for weight-only quantized ones IN
    PLACE (``nn.quant.quantize_linears``), after every validation here
    (a rejected construction leaves the caller's model untouched), so
    every projection and the LM head stream int8 or packed int4.

    ``lora``: a :class:`serving.LoRAPool` built for ``model`` makes the
    engine multi-LoRA: each request may name a resident adapter at
    ``add_request(adapter=...)``, and a mixed batch of adapters and base
    requests shares the one step (it does not compose with
    ``weight_quant``).

    ``margins``: set it to a dict to record, per request id, the top-2
    logit margin of every emitted token (the near-tie rule of the
    token-identity checks); None (the default) records nothing.
    """

    def __init__(self, model, *, max_batch: int = 8,
                 max_seq_len: int = 256, page_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None,
                 enable_prefix_caching: bool = True, seed: int = 0,
                 keep_finished: int = 1024,
                 weight_quant: Optional[str] = None, lora=None,
                 device=None):
        self.device = resolve_device(device)
        if not _paged_supported(model):
            raise NotImplementedError(
                f"{type(model).__name__} does not support the paged "
                "serving path (needs supports_paged decoder layers and "
                "pipeline_stages == 1)")
        # buffers too: a quantized model keeps its codes and scales there
        mdevs = {t.device for t in itertools.chain(model.parameters(),
                                                   model.buffers())}
        if mdevs != {self.device}:
            raise ValueError(
                f"model tensors are on {sorted(map(str, mdevs))}, the "
                f"engine runs on {self.device}")
        n_layers, kv_heads, head_dim = _kv_geometry(model)
        if max_batch < 1 or max_seq_len < page_size:
            raise ValueError(
                f"bad geometry: max_batch={max_batch}, "
                f"max_seq_len={max_seq_len}, page_size={page_size}")
        if prefill_chunk is None:
            prefill_chunk = min(16, int(max_seq_len))
        if not 1 <= prefill_chunk <= max_seq_len:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must be in "
                f"[1, max_seq_len={max_seq_len}]")
        max_pos = getattr(model.cfg, "max_position_embeddings", None)
        if max_pos is not None and max_seq_len > max_pos:
            raise ValueError(
                f"max_seq_len={max_seq_len} exceeds the model's "
                f"max_position_embeddings={max_pos}")
        todo = getattr(model, "engine_options_not_ported", ())
        for opt, val in (("weight_quant", weight_quant), ("lora", lora)):
            if val is not None and opt in todo:
                raise NotImplementedError(
                    f"Engine({opt}=...) for {type(model).__name__} is not "
                    "ported yet (ROADMAP.md, queue 1)")
        if weight_quant is not None and lora is not None:
            # the stacked deltas target the float 2-D projection weights;
            # quantized layers keep int codes and separate scales
            raise ValueError(
                "Engine(lora=...) does not compose with weight_quant "
                "yet — serve LoRA adapters on the float decode path")
        if lora is not None:
            lora.validate(model)
        if weight_quant is not None:
            from ..nn.quant import quantize_linears
            algo = {"int8": "weight_only_int8",
                    "int4": "weight_only_int4"}.get(weight_quant,
                                                    weight_quant)
            quantize_linears(model, algo=algo)
        model.eval()
        self.model = model
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len)
        self.page_size = int(page_size)
        self.prefill_chunk = int(prefill_chunk)
        # a zero/negative budget would idle every prefilling slot forever
        self.prefill_token_budget = None if prefill_token_budget is None \
            else max(1, int(prefill_token_budget))
        self.max_blocks_per_seq = -(-self.max_seq_len // self.page_size)
        if num_blocks is None:
            # enough for every slot to run a full-length sequence
            num_blocks = self.max_batch * self.max_blocks_per_seq
        dtype = next(model.parameters()).dtype
        self.kv = PagedKVCache(n_layers, num_blocks, self.page_size,
                               kv_heads, head_dim, dtype=dtype,
                               device=self.device)
        self.prefix_cache = PrefixCache(self.kv.allocator, self.page_size) \
            if enable_prefix_caching else None
        self.scheduler = Scheduler(self.max_batch, self.page_size,
                                   self.max_blocks_per_seq,
                                   self.kv.allocator, self.kv.oob_block,
                                   prefix_cache=self.prefix_cache)
        self._key = int(seed)
        self._states: Dict[str, RequestState] = {}
        # only the `keep_finished` most recently finished requests stay
        # queryable via output_ids(): a long-running engine's per-request
        # state stays bounded
        self.keep_finished = int(keep_finished)
        self._finished_order: "collections.deque[str]" = \
            collections.deque()
        # set by run() while draining: finish-time output capture that
        # eviction can't outrun
        self._drain_capture: Optional[Dict[str, List[int]]] = None
        self._cow_copies = 0
        self.tokens_emitted = 0
        self.steps = 0               # non-empty steps dispatched
        self.margins: Optional[Dict[str, List[float]]] = None
        self.lora = lora
        self._last_launches: Optional[Dict[str, int]] = None

    # -- the device step ---------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @torch.no_grad()
    def _step_fn(self, tokens, tables, starts, lens, adapters):
        """The ONE serving step: every slot's span writes its KV and
        attends in a single ragged pass; the last REAL span position's
        hidden state of each slot goes through the LM head.  ``adapters``
        (B,) int32 are the slots' LoRA stack indices (0: base).  Returns
        the (B, V) logits."""
        lora = None if self.lora is None else \
            (self.lora.device_stacks(), adapters)
        hidden, caches = self.model.model(
            tokens, caches=self.kv.caches, seq_lens=lens,
            block_tables=tables, span_starts=starts, lora=lora)
        self.kv.caches = caches
        idx = torch.clamp(lens.long() - 1, 0, tokens.shape[1] - 1)
        h_last = hidden[torch.arange(hidden.shape[0],
                                     device=hidden.device), idx]
        return self.model.logits(h_last[:, None])[:, 0]

    @torch.no_grad()
    def _cow_fn(self, src, dst):
        """Copy-on-write page copies src[i] -> dst[i] in every layer's
        pools; padded entries carry the OOB sentinel (masked out)."""
        from ..incubate.nn.functional import paged_copy_blocks
        self.kv.caches = [paged_copy_blocks(c, src, dst)
                          for c in self.kv.caches]

    def warmup(self) -> "Engine":
        """Run the ragged step and the CoW copy once with all-out-of-range
        block tables and zero span lengths: the kernels build and load,
        and nothing touches the pools or the allocator."""
        b, mb, c = self.max_batch, self.max_blocks_per_seq, \
            self.prefill_chunk
        oob = np.full((b, mb), self.kv.oob_block, np.int32)
        zeros_i = np.zeros((b,), np.int32)
        self._step_fn(self._tensor(np.zeros((b, c), np.int32)),
                      self._tensor(oob), self._tensor(zeros_i),
                      self._tensor(zeros_i), self._tensor(zeros_i))
        pad = self._tensor(np.full((b,), self.kv.oob_block, np.int32))
        self._cow_fn(pad, pad)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # -- request lifecycle -------------------------------------------------

    def add_request(self, prompt_ids, max_new_tokens: int = 16,
                    temperature: float = 0.0,
                    eos_token_id: Optional[int] = None,
                    request_id: Optional[str] = None,
                    adapter: Optional[str] = None) -> str:
        """Queue one request; returns its id.  It joins the running batch
        at the next ``step()`` with a free slot and enough free blocks for
        its budget (prompt + max_new_tokens, minus any prefix-cache hit).
        ``adapter`` names a LoRA adapter resident in this engine's pool;
        the request then decodes through ``W + A_k B_k``.  Rejections are
        typed (``serving.errors``): :class:`UnknownAdapter` for an
        adapter the pool has not loaded (or an engine without a pool)."""
        req = Request(prompt_ids=prompt_ids,
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature),
                      eos_token_id=eos_token_id, request_id=request_id,
                      adapter=adapter)
        if adapter is not None:
            if self.lora is None:
                raise UnknownAdapter(
                    f"request names adapter {adapter!r} but this engine "
                    "has no LoRA pool (Engine(lora=serving.LoRAPool(...)))")
            req.adapter_slot = self.lora.slot_of(adapter)
            # pinned from the moment the slot resolves, released on any
            # rejection below
            self.lora.acquire(adapter, req.request_id)
        try:
            self._admission_checks(req)
        except Exception:
            if adapter is not None:
                self.lora.release(adapter, req.request_id)
            raise
        return req.request_id

    def _admission_checks(self, req: Request) -> None:
        if req.request_id in self._states:
            raise AdmissionError(
                f"request_id {req.request_id!r} is already in use by a "
                "live or retained request")
        p = int(req.prompt_ids.size)
        if p + req.max_new_tokens > self.max_seq_len:
            raise BudgetUnsatisfiable(
                f"prompt ({p}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds max_seq_len={self.max_seq_len}")
        need = self.scheduler.blocks_for(p + req.max_new_tokens)
        if need > self.kv.num_blocks:
            raise BudgetUnsatisfiable(
                f"request needs {need} KV blocks (prompt {p} + "
                f"max_new_tokens {req.max_new_tokens} @ page "
                f"{self.page_size}) but the pool has only "
                f"{self.kv.num_blocks} — raise num_blocks or lower the "
                "budget")
        self._states[req.request_id] = self.scheduler.submit(req)

    def output_ids(self, request_id: str) -> List[int]:
        return list(self._states[request_id].output_ids)

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    @property
    def kv_blocks_used(self) -> int:
        return self.kv.allocator.used_blocks

    def prefix_stats(self) -> Dict[str, float]:
        """Prefix-cache counters (hits/misses/hit_rate/registered_pages/
        evictions) plus the CoW copy count -- zeros when prefix caching
        is disabled."""
        s = self.prefix_cache.stats() if self.prefix_cache is not None \
            else {"hits": 0, "misses": 0, "hit_rate": 0.0,
                  "registered_pages": 0, "evictions": 0}
        s["cow_copies"] = self._cow_copies
        return s

    def lora_stats(self) -> Dict[str, float]:
        """Multi-LoRA pool counters (active_adapters/max_adapters/rank/
        loads/evictions/live_refs) -- zeros when no pool is attached."""
        if self.lora is None:
            return {"active_adapters": 0, "max_adapters": 0, "rank": 0,
                    "loads": 0, "evictions": 0, "live_refs": 0}
        return self.lora.stats()

    def launches_per_step(self) -> Optional[Dict[str, int]]:
        """Kernel launches of the last non-empty step, by kernel
        (``ops.cuda.KERNELS``): the ``KERNEL.launches`` deltas on the card,
        the plain-version calls on the CPU -- the port's counterpart of
        the reference's ``dispatches_per_step``.  None before the first
        step."""
        return None if self._last_launches is None \
            else dict(self._last_launches)

    # -- the loop ----------------------------------------------------------

    def _admit_all(self) -> None:
        while self.scheduler.waiting:
            if self.scheduler.admit_next() is None:
                break

    def _run_cow(self, plan) -> None:
        """Copy-on-write: any span about to write into a borrowed (shared)
        page gets a private copy first -- the reserved spare block takes
        the page's content via one fixed-shape copy, the table is
        repointed, and the shared reference is dropped."""
        copies = []
        for _i, st, n, _is_prefill in plan:
            if not st.borrowed:
                continue
            first = st.kv_len // self.page_size
            last = (st.kv_len + n - 1) // self.page_size
            for pg in range(first, last + 1):
                if pg not in st.borrowed:
                    continue
                src = int(st.table[pg])
                dst = st.cow_spare.pop(pg)
                st.table[pg] = dst
                st.borrowed.discard(pg)
                st.num_cowed += 1
                st.blocks.remove(src)
                self.kv.allocator.free([src])   # drop OUR shared ref
                copies.append((src, dst))
        k = self.max_batch
        for lo in range(0, len(copies), k):
            src = np.full((k,), self.kv.oob_block, np.int32)
            dst = np.full((k,), self.kv.oob_block, np.int32)
            for j, (s_, d_) in enumerate(copies[lo:lo + k]):
                src[j], dst[j] = s_, d_
            self._cow_fn(self._tensor(src), self._tensor(dst))
        self._cow_copies += len(copies)

    def _register_prefix(self, st: RequestState) -> None:
        """Index this request's freshly written full prompt pages so later
        requests with the same prefix hit them (first writer wins)."""
        if self.prefix_cache is None:
            return
        for pg, key in enumerate(st.page_keys):
            self.prefix_cache.register(key, int(st.table[pg]))

    def _emit(self, st: RequestState, token: int, margin,
              events: List[TokenEvent]) -> None:
        req = st.request
        st.output_ids.append(token)
        if self.margins is not None:
            self.margins.setdefault(req.request_id, []).append(margin)
        done_eos = (req.eos_token_id is not None
                    and token == req.eos_token_id)
        done_len = len(st.output_ids) >= req.max_new_tokens
        if done_eos or done_len:
            self.scheduler.finish(st, "eos" if done_eos else "length")
            if self.lora is not None and req.adapter is not None:
                # the adapter's slot becomes evictable once its last
                # live reader retires
                self.lora.release(req.adapter, req.request_id)
            if self._drain_capture is not None:
                # BEFORE the eviction below: more requests than
                # keep_finished may retire in one step
                self._drain_capture[req.request_id] = list(st.output_ids)
                st.drained = True
            self._finished_order.append(req.request_id)
            while len(self._finished_order) > self.keep_finished:
                self._states.pop(self._finished_order.popleft(), None)
        else:
            st.pending_token = token
        events.append(TokenEvent(req.request_id, token, None, st.finished,
                                 st.finish_reason))

    def step(self) -> List[TokenEvent]:
        """Admit what fits, run ONE unified ragged step (prefill chunks +
        decode tokens together), retire what finished.  Returns the
        tokens emitted (one per decoded / prompt-completed request)."""
        self._admit_all()
        plan = self.scheduler.plan_spans(self.prefill_chunk,
                                         self.prefill_token_budget)
        events: List[TokenEvent] = []
        if not plan:
            return events
        self._run_cow(plan)
        (tokens, tables, starts, lens, temps, seeds, emit,
         adapters) = self.scheduler.span_arrays(plan, self.prefill_chunk)
        before = _kernels.counts(self.device.type)
        logits = self._step_fn(self._tensor(tokens), self._tensor(tables),
                               self._tensor(starts), self._tensor(lens),
                               self._tensor(adapters))
        after = _kernels.counts(self.device.type)
        self._last_launches = {k: after[k] - before[k] for k in after}
        nxt = _sample(logits, temps, self._key, seeds, emit).cpu().numpy()
        margins = None
        if self.margins is not None:
            top2 = torch.topk(logits.float(), 2, dim=-1).values
            margins = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        self.steps += 1
        for i, st, n, is_prefill in plan:
            m = None if margins is None else float(margins[i])
            if not is_prefill:
                st.kv_len += 1
                self._emit(st, int(nxt[i]), m, events)
                continue
            st.kv_len += n
            if st.prefilling:
                continue             # mid-prefill: sample discarded
            # prompt complete: this sample is the request's first token
            self._register_prefix(st)
            self._emit(st, int(nxt[i]), m, events)
        self.tokens_emitted += len(events)
        return events

    def stream(self):
        """Generator: run ``step()`` until drained, yielding each
        :class:`TokenEvent` as it is produced.  More requests may be added
        while streaming -- they join the running batch."""
        while self.has_work():
            for ev in self.step():
                yield ev

    def run(self) -> Dict[str, List[int]]:
        """Drain everything; returns {request_id: generated token ids} for
        every request finished since the last ``run()`` -- including
        requests that finished during manual ``step()`` calls before this
        one.  Outputs are captured at finish time."""
        drained: Dict[str, List[int]] = {}
        for rid, st in self._states.items():
            if st.finished and not st.drained:
                st.drained = True
                drained[rid] = list(st.output_ids)
        self._drain_capture = drained
        try:
            while self.has_work():
                self.step()
        finally:
            self._drain_capture = None
        return drained
