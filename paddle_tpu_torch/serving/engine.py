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
shapes never depend on occupancy, as in the reference.

On the card the step is captured once into a CUDA graph at
:meth:`warmup` (or at the first :meth:`step` without one) and replayed
on every step (``serving.graph.StepGraph``): each step copies its
inputs into static buffers and replays, and :attr:`captures` stays 1
while :attr:`replays` counts the steps.  The span write sends dead rows
to spare rows behind the pools, so the step never syncs the host; the
copy-on-write page copy, sampling and the margins run eagerly around
the replay, in stream order.  On the CPU the same step runs eagerly on
the same static buffers.

Robustness, as in the reference: :meth:`preempt` swaps a running
request's KV pages to host memory (``SwapManager``) instead of rejecting
new work, and re-admission restores them in place, token-identical; a
host-side failure in one request's bookkeeping -- or an injected fault
at the ``serve.admit`` / ``serve.cow`` / ``serve.prefill`` /
``serve.step`` / ``serve.swap`` sites (``resilience.faults``) -- is
confined to THAT request (rewind, preempt, re-admit).  The sites fire on
the host around the replay, never inside it: a fault never reaches the
captured graph or makes the engine capture again.

Speculative decoding (``spec_decode``): a host-side n-gram proposer
(``serving/spec.py``) drafts up to ``draft_depth`` tokens per greedy
decode slot, and the SAME captured step verifies each
``[pending, d_1..d_k]`` span like a prefill chunk; the step then returns
the LM head over every span position and the host keeps the longest
accepted prefix plus one bonus token.  Draft length is span-length data:
every depth 0..K rides the one capture.

int8 KV pools (``kv_cache_dtype="int8"``): the pools hold int8 values and
f32 scales per (position, head) (``PagedKVCache``, ``quantize_kv``), about
half the bytes per token of bf16 pools.  The step writes them quantized
and attends them through the reference's gather+dequant composition
(``incubate.nn.functional.ragged_paged_attend``), inside the same
captured step; the ragged-attention kernel and the megakernel make no
launch there.  Prefix sharing, copy-on-write and preemption move the
scales with the values.  :meth:`hbm_stats` counts the card's bytes.

Telemetry, as in the reference (``observability``): with
``observability.enable()`` the engine feeds the ``serve.*`` counters,
gauges and histograms, the ``serve_*`` events, the ``serve.warmup`` /
``serve.step`` / ``serve.step.finish`` spans and each request's trace
(submit, admit, prefill chunks, first token, preempt, restore, isolate,
retire); ``slo_capture`` arms a ``torch.profiler`` window on a TTFT
breach.  Every site is host code around the replay, reading the
scheduler's numbers and the tokens the step already copied to the host:
no site adds a device sync, and with telemetry off each costs one falsy
check.  Not ported (ROADMAP.md, queue 1 item 11): the
``serve.roofline.*`` and ``serve.dispatches_per_step`` gauges, which read
the reference's compiled-artifact ledger.

Not ported yet (ROADMAP.md): meshes and disaggregated roles.
"""

from __future__ import annotations

import collections
import itertools
import time
import traceback
import warnings
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .. import observability as obs
from ..core.device import resolve_device
from ..core.random import fold_in
from ..observability import _state as _obs_state
from ..observability.spans import span
from ..ops import cuda as _kernels
from ..resilience import _state as _rs_state
from ..resilience.retry import RetryPolicy
from .block_allocator import PagedKVCache, PrefixCache, SwapManager
from .errors import (AdmissionError, BudgetUnsatisfiable, QueueFull,
                     UnknownAdapter)
from .graph import StepGraph
from .scheduler import Request, RequestState, Scheduler

__all__ = ["Engine", "TokenEvent"]

# Incremental detokenization re-runs the tokenizer over a bounded tail
# window of this many tokens (re-anchoring at half-window), keeping
# streaming-text cost linear in output length instead of quadratic.
_DETOK_WINDOW = 64


class TokenEvent(NamedTuple):
    """One emitted token, as returned by ``step()``/``stream()``."""

    request_id: str
    token_id: int
    text: Optional[str]          # incremental detokenized text, if enabled
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
        out[b] = _draw(lg[b], float(temps[b]), key, int(seeds[b]),
                       int(emit[b]))
    return out


def _draw(row, temp: float, key: int, seed: int, index: int) -> int:
    """One temperature draw from the (V,) logits ``row`` at emit index
    ``index``: ``softmax(row / temp)`` with a CPU generator seeded per
    (engine seed, request seed, emit index)."""
    gen = torch.Generator().manual_seed(fold_in(key, seed, index))
    probs = torch.softmax(row.float().cpu() / max(temp, 1e-6), dim=-1)
    return int(torch.multinomial(probs, 1, generator=gen))


def _sample_span(logits, temps, key: int, seeds, emit, draws):
    """Per-POSITION sampling over a whole ``(B, C, V)`` span -- the
    speculative verify step's sampler (the reference's ``_sample_span``).
    Greedy is the argmax of every position, on the logits' device.  A
    temperature slot ``b`` draws only at the positions ``draws[b]`` the
    host consumes, position ``j`` at emit index ``emit[b] + j`` through
    :func:`_draw`, so the token drawn at a given emit index is
    :func:`_sample`'s, whatever mix of spans produced it.  Returns (B, C)
    int64 numpy."""
    out = torch.argmax(logits, dim=-1).cpu()
    for b, positions in draws.items():
        for j in positions:
            out[b, j] = _draw(logits[b, j], float(temps[b]), key,
                              int(seeds[b]), int(emit[b]) + j)
    return out.numpy()


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

    ``detokenize``: optional ``callable(list[int]) -> str``; when given,
    token events and ``on_token`` callbacks carry the incremental text,
    computed over a sliding tail window of the output (the last
    ``_DETOK_WINDOW`` tokens), so a tokenizer whose suffix output differs
    from the suffix of the full output may show a seam at a re-anchor.

    ``max_queue``: bound on the waiting queue; beyond it ``add_request``
    raises :class:`serving.errors.QueueFull` (default unbounded).
    ``retry``: the :class:`resilience.RetryPolicy` around the preemption
    swaps (default 3 attempts, 20 ms base backoff).

    ``spec_decode``: self-speculative decoding with n-gram drafts of up
    to ``draft_depth`` tokens per greedy decode slot (temperature slots
    never draft).  Greedy outputs stay token-identical to the engine
    without it, and a temperature stream draws the same tokens (keys per
    emitted-token index).  It widens the step's span to
    ``max(prefill_chunk, draft_depth + 1)`` before the step is built, so
    the engine still captures one step.  It does not compose with
    ``lora`` yet.

    ``kv_cache_dtype``: the KV pools' dtype, default the model's; a float
    dtype (``torch.bfloat16``, ``"float32"``, ...; on the card the
    ragged-attention kernel takes pools of the activations' dtype only,
    and raises on others) or ``"int8"`` (also ``"paddle.int8"``,
    ``np.int8``, ``torch.int8``) for the quantized pools, which compose
    with every option above.

    ``slo_capture``: an :class:`observability.SLOCapture`; every non-empty
    step calls its ``on_step`` (host-side counters until a TTFT breach
    arms its bounded ``torch.profiler`` window over the next steps).

    ``margins``: set it to a dict to record, per request id, the top-2
    logit margin of every emitted token (the near-tie rule of the
    token-identity checks; under ``spec_decode`` the margin at the span
    position the token came from); None (the default) records nothing.
    """

    def __init__(self, model, *, max_batch: int = 8,
                 max_seq_len: int = 256, page_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None,
                 enable_prefix_caching: bool = True,
                 detokenize: Optional[Callable] = None, seed: int = 0,
                 keep_finished: int = 1024,
                 max_queue: Optional[int] = None,
                 retry: Optional[RetryPolicy] = None,
                 weight_quant: Optional[str] = None,
                 spec_decode: bool = False, draft_depth: int = 4,
                 lora=None, kv_cache_dtype=None, slo_capture=None,
                 device=None, _eager_step: bool = False):
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
        self.spec = None
        self.draft_depth = 0
        if spec_decode:
            if not 1 <= int(draft_depth) <= max_seq_len - 1:
                raise ValueError(
                    f"draft_depth={draft_depth} must be in "
                    f"[1, max_seq_len-1={max_seq_len - 1}]")
            if lora is not None:
                raise NotImplementedError(
                    "Engine(spec_decode=True, lora=...) is not ported yet "
                    "(ROADMAP.md, queue 1)")
            self.draft_depth = int(draft_depth)
            from .spec import NgramProposer
            self.spec = NgramProposer(self.draft_depth)
            # the verify span [pending, d_1..d_K] must fit the one (B, C)
            # step: widen C once, HERE, before the step is built -- every
            # draft depth 0..K then rides the capture as span-length data
            prefill_chunk = max(int(prefill_chunk), self.draft_depth + 1)
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
        dtype = kv_cache_dtype if kv_cache_dtype is not None else \
            next(model.parameters()).dtype
        b, c = self.max_batch, self.prefill_chunk
        # what the card held before this engine's own buffers (the model,
        # a LoRA pool, other tenants): hbm_stats' baseline
        self._alloc_before = torch.cuda.memory_allocated(self.device) \
            if self.device.type == "cuda" else 0
        # one spare row per (slot, span row): the span write's dead rows
        self.kv = PagedKVCache(n_layers, num_blocks, self.page_size,
                               kv_heads, head_dim, dtype=dtype,
                               device=self.device, spare_rows=b * c)
        self._pool_ptrs = self._ptrs(self.kv.caches)
        self.prefix_cache = PrefixCache(self.kv.allocator, self.page_size) \
            if enable_prefix_caching else None
        self.scheduler = Scheduler(self.max_batch, self.page_size,
                                   self.max_blocks_per_seq,
                                   self.kv.allocator, self.kv.oob_block,
                                   prefix_cache=self.prefix_cache)
        # preemption/restore: host-memory page swap plus the retry policy
        # around it, so a transient (or injected) fault becomes a retry,
        # not a dead request
        self.max_queue = None if max_queue is None else int(max_queue)
        self._retry = retry if retry is not None else \
            RetryPolicy(max_attempts=3, backoff_s=0.02)
        self._swap = SwapManager(self.kv, chunk=self.max_blocks_per_seq)
        self._detokenize = detokenize
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
        self._slo_capture = slo_capture
        self._last_launches: Optional[Dict[str, int]] = None
        # the step's static inputs and output ((B, V) logits, (B, C, V)
        # under spec_decode); captured on the card unless built eager (a
        # switch for in-process comparisons, never taken on a failure)
        self._graph = StepGraph(
            self._step_fn, {"tokens": (b, c),
                            "tables": (b, self.max_blocks_per_seq),
                            "starts": (b,), "lens": (b,), "adapters": (b,)},
            self.device, capture=self.device.type == "cuda"
            and not _eager_step)

    # -- the device step ---------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @staticmethod
    def _ptrs(caches) -> List[int]:
        return [t.data_ptr() for pair in caches for t in pair]

    def _check_pools(self, caches) -> None:
        """A captured graph holds the pools' addresses: the step and the
        page copy must hand back the very same pool tensors."""
        if self._ptrs(caches) != self._pool_ptrs:
            raise RuntimeError("the KV pools moved: the step and the page "
                               "copy must write them in place")

    @torch.no_grad()
    def _step_fn(self, tokens, tables, starts, lens, adapters):
        """The ONE serving step: every slot's span writes its KV and
        attends in a single ragged pass; the last REAL span position's
        hidden state of each slot goes through the LM head.  ``adapters``
        (B,) int32 are the slots' LoRA stack indices (0: base).  Returns
        the (B, V) logits; a speculative engine's step returns the LM head
        over EVERY span position, (B, C, V): position ``j``'s argmax is
        the model's token after consuming draft ``j``, so verifying needs
        no second step."""
        lora = None if self.lora is None else \
            (self.lora.device_stacks(), adapters)
        hidden, caches = self.model.model(
            tokens, caches=self.kv.caches, seq_lens=lens,
            block_tables=tables, span_starts=starts, lora=lora)
        self._check_pools(caches)
        if self.spec is not None:
            return self.model.logits(hidden)
        idx = torch.clamp(lens.long() - 1, 0, tokens.shape[1] - 1)
        h_last = hidden[torch.arange(hidden.shape[0],
                                     device=hidden.device), idx]
        return self.model.logits(h_last[:, None])[:, 0]

    @torch.no_grad()
    def _cow_fn(self, src, dst):
        """Copy-on-write page copies src[i] -> dst[i] in every layer's
        pools; padded entries carry the OOB sentinel (masked out).  Eager,
        before the step in stream order (its mask syncs the host)."""
        from ..incubate.nn.functional import paged_copy_blocks
        self._check_pools([paged_copy_blocks(c, src, dst)
                           for c in self.kv.caches])

    def warmup(self) -> "Engine":
        """Prepare the ragged step on all-out-of-range block tables and
        zero span lengths -- one eager run that builds and loads the
        kernels, then, on the card, the one capture of the step's CUDA
        graph -- and run the CoW copy once on padding.  Nothing touches
        the pools or the allocator.  Later calls only repeat the CoW
        copy: the step is captured once."""
        with span("serve.warmup"):
            b, mb, c = self.max_batch, self.max_blocks_per_seq, \
                self.prefill_chunk
            zeros_i = np.zeros((b,), np.int32)
            self._graph.load({"tokens": np.zeros((b, c), np.int32),
                              "tables": np.full((b, mb), self.kv.oob_block,
                                                np.int32),
                              "starts": zeros_i, "lens": zeros_i,
                              "adapters": zeros_i})
            self._graph.prepare()
            pad = self._tensor(np.full((b,), self.kv.oob_block, np.int32))
            self._cow_fn(pad, pad)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        reg = obs.get_registry()
        if reg is not None:
            # the reference's post-warmup gauge block (its roofline and
            # dispatch gauges read a compiled-artifact ledger: not ported)
            for k, v in self.hbm_stats().items():
                reg.gauge(f"serve.hbm.{k}").set(v)
        return self

    # -- request lifecycle -------------------------------------------------

    def add_request(self, prompt_ids, max_new_tokens: int = 16,
                    temperature: float = 0.0,
                    eos_token_id: Optional[int] = None,
                    on_token: Optional[Callable] = None,
                    request_id: Optional[str] = None,
                    tenant: Optional[str] = None,
                    adapter: Optional[str] = None) -> str:
        """Queue one request; returns its id.  It joins the running batch
        at the next ``step()`` with a free slot and enough free blocks for
        its budget (prompt + max_new_tokens, minus any prefix-cache hit).
        ``on_token(request_id, token_id, text)`` is called for every
        emitted token (a callback that raises is warned about, never
        tears down the step); ``tenant`` is carried on the request.
        ``adapter`` names a LoRA adapter resident in this engine's pool;
        the request then decodes through ``W + A_k B_k``.  Rejections are
        typed (``serving.errors``, all ``ValueError`` subclasses):
        :class:`QueueFull` when ``max_queue`` waiting requests are queued
        already, :class:`BudgetUnsatisfiable` when the request can never
        fit this engine, :class:`UnknownAdapter` for an adapter the pool
        has not loaded (or an engine without a pool), plain
        :class:`AdmissionError` for a duplicate ``request_id``."""
        req = Request(prompt_ids=prompt_ids,
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature),
                      eos_token_id=eos_token_id, on_token=on_token,
                      request_id=request_id, tenant=tenant,
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
        tr = _obs_state.TRACE[0]
        if tr is not None:
            # get-or-create: a door-submitted request already began its
            # trace at door submit (queue time there is queue time here)
            req.trace_id = tr.begin(
                req.request_id, tenant=req.tenant, trace_id=req.trace_id,
                prompt_len=int(req.prompt_ids.size),
                max_new=req.max_new_tokens)
        reg = obs.get_registry()
        if reg is not None:
            reg.counter("serve.requests").inc()
            reg.gauge("serve.queue_depth").set(self.scheduler.queue_depth())
            if adapter is not None:
                reg.counter(
                    f"serve.lora.adapter[{adapter}].requests").inc()
        return req.request_id

    def _admission_checks(self, req: Request) -> None:
        if req.request_id in self._states:
            raise AdmissionError(
                f"request_id {req.request_id!r} is already in use by a "
                "live or retained request")
        if self.max_queue is not None \
                and self.scheduler.queue_depth() >= self.max_queue:
            raise QueueFull(
                f"waiting queue is at max_queue={self.max_queue} -- retry "
                "later")
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

    def spec_stats(self) -> Dict[str, float]:
        """Speculative-decoding counters (proposed/accepted/accept_rate/
        verifies/draft_hits/draft_misses/errors/tracked_requests) --
        zeros when ``spec_decode`` is off."""
        if self.spec is None:
            return {"proposed": 0, "accepted": 0, "accept_rate": 0.0,
                    "verifies": 0, "draft_hits": 0, "draft_misses": 0,
                    "errors": 0, "tracked_requests": 0}
        return self.spec.stats()

    def lora_stats(self) -> Dict[str, float]:
        """Multi-LoRA pool counters (active_adapters/max_adapters/rank/
        loads/evictions/live_refs) -- zeros when no pool is attached."""
        if self.lora is None:
            return {"active_adapters": 0, "max_adapters": 0, "rank": 0,
                    "loads": 0, "evictions": 0, "live_refs": 0}
        return self.lora.stats()

    def hbm_stats(self) -> Dict[str, int]:
        """Bytes the engine holds on its device: ``kv_pool_bytes`` (the
        paged pools, int8 scales included), ``lora_pool_bytes`` (the
        stacked adapter pools), ``param_bytes`` (the model's parameters
        and buffers: a quantized model's codes and scales), and
        ``peak_temp_bytes``, the card's peak of allocated bytes
        (``torch.cuda.max_memory_allocated``, since the process started
        or ``torch.cuda.reset_peak_memory_stats()`` was last called) less
        what was allocated when the engine was built and less the pools'
        storage (spare rows included): the high-water mark of the
        temporaries of the warmup, the captured step's memory pool, the
        page copies and sampling, when that peak was reached during the
        engine's life; 0 on the CPU."""
        held = {"kv_pool_bytes": int(self.kv.nbytes()),
                "lora_pool_bytes": 0 if self.lora is None
                else int(self.lora.nbytes()),
                "param_bytes": sum(
                    t.numel() * t.element_size() for t in itertools.chain(
                        self.model.parameters(), self.model.buffers()))}
        peak = 0
        if self.device.type == "cuda":
            pools = sum(r.numel() * r.element_size()
                        for layer in self.kv.caches for r in layer.rows)
            peak = max(0, torch.cuda.max_memory_allocated(self.device)
                       - self._alloc_before - pools)
        return {**held, "peak_temp_bytes": int(peak)}

    @property
    def captures(self) -> int:
        """CUDA graph captures of the step: 1 after warmup on the card,
        and no more whatever the traffic; 0 when the step runs eagerly
        (the CPU)."""
        return self._graph.captures

    @property
    def replays(self) -> int:
        """Replays of the captured step: one per non-empty step."""
        return self._graph.replays

    def launches_per_step(self) -> Optional[Dict[str, int]]:
        """Kernel launches of the last non-empty step, by kernel
        (``ops.cuda.KERNELS``): the ``KERNEL.launches`` deltas on the card,
        the plain-version calls on the CPU -- the port's counterpart of
        the reference's ``dispatches_per_step``.  None before the first
        step."""
        return None if self._last_launches is None \
            else dict(self._last_launches)

    # -- preemption / restore / fault isolation ----------------------------

    def preempt(self, request_id: str, *, requeue_head: bool = False,
                reason: str = "preempted") -> bool:
        """Swap a RUNNING request's KV pages to host memory, free its
        blocks and slot, and requeue it for transparent restoration (at
        the queue head with ``requeue_head``) -- the alternative to
        rejecting new work when the pool is tight.  ``reason`` rides the
        ``serve_preempt`` event and the request's trace (the front door
        passes ``"pool_pressure"``).

        Returns False when the request is not in a slot (waiting, already
        preempted, finished, or unknown).  The restored request resumes
        token-identical: the swap round-trips the exact page bytes, and
        shared prefix pages are only COPIED -- never pulled out from
        under the other slots referencing them."""
        st = self._states.get(request_id)
        if st is None or st.finished or st.slot is None:
            return False
        self._preempt_state(st, head=requeue_head, reason=reason)
        return True

    def _preempt_state(self, st: RequestState, head: bool,
                       reason: str) -> None:
        pages = -(-st.kv_len // self.page_size)
        host = None
        if pages:
            ids = [int(b) for b in st.table[:pages]]
            host = self._retry.run(self._swap.swap_out, ids,
                                   site="serve.swap")
        self.scheduler.release_slot(st)
        # everything comes back private at restore: the borrowed pages
        # count as privatized from here on
        st.num_cowed = st.num_shared
        st.swapped = (pages, host)
        st.preempts += 1
        self.scheduler.requeue(st, head=head)
        tr = _obs_state.TRACE[0]
        if tr is not None:
            tr.transition(st.request.request_id, "queue", event="preempt",
                          reason=reason, pages=pages, kv_len=st.kv_len)
        reg = obs.get_registry()
        if reg is not None:
            reg.counter("serve.preemptions").inc()
            if pages:
                reg.counter("serve.swapped_pages").inc(pages)
        obs.emit_event("serve_preempt", id=st.request.request_id,
                       tenant=st.request.tenant, pages=pages,
                       kv_len=st.kv_len, reason=reason,
                       preempts=st.preempts)

    def _restore(self, st: RequestState) -> None:
        """Write a freshly re-admitted request's host payload into its new
        (all-private) blocks; prefill/decode resumes at kv_len."""
        pages, host = st.swapped
        if pages:
            ids = [int(b) for b in st.table[:pages]]
            self._retry.run(self._swap.swap_in, ids, host,
                            site="serve.swap")
        st.swapped = None
        tr = _obs_state.TRACE[0]
        if tr is not None:
            tr.point(st.request.request_id, "restore", pages=pages,
                     kv_len=st.kv_len)
        reg = obs.get_registry()
        if reg is not None:
            reg.counter("serve.restores").inc()
        obs.emit_event("serve_restore", id=st.request.request_id,
                       tenant=st.request.tenant, pages=pages,
                       kv_len=st.kv_len)

    def _isolate(self, st: RequestState, exc: Exception) -> None:
        """Confine a failing request to ITS slot: the captured step and
        the batch's other requests survive; the victim is preempted to
        host and re-admitted at the queue head (it was mid-flight).
        Greedy outputs stay token-identical because the caller rewound
        the host bookkeeping to the pre-span snapshot and re-running a
        span is idempotent (same values, same positions)."""
        rid = st.request.request_id
        warnings.warn(
            f"request {rid!r} failed host-side and was "
            f"isolated (preempt + re-admit; {type(exc).__name__}: {exc})",
            RuntimeWarning, stacklevel=3)
        reg = obs.get_registry()
        if reg is not None:
            reg.counter("serve.isolated_failures").inc()
        obs.emit_event("serve_isolated_failure", id=rid,
                       tenant=st.request.tenant,
                       exc=type(exc).__name__, message=str(exc)[:200])
        tr = _obs_state.TRACE[0]
        if tr is not None:
            tr.point(rid, "isolated", exc=type(exc).__name__)
        self._preempt_state(st, head=True, reason="isolated_failure")

    # -- the loop ----------------------------------------------------------

    def _admit_all(self) -> None:
        """Admission with the ``serve.admit`` fault site: a fault here
        leaves the queue intact (nothing is allocated yet) and admission
        resumes next step.  A preempted request is restored right after
        its re-admission."""
        fi = _rs_state.FAULTS[0]
        while self.scheduler.waiting:
            if fi is not None:
                try:
                    fi("serve.admit")
                except Exception as e:  # noqa: BLE001 -- retried next step
                    reg = obs.get_registry()
                    if reg is not None:
                        reg.counter("serve.isolated_failures").inc()
                    obs.emit_event(
                        "serve_isolated_failure", id=None, tenant=None,
                        exc=type(e).__name__, message=str(e)[:200],
                        site="serve.admit")
                    break
            st = self.scheduler.admit_next()
            if st is None:
                break
            tr = _obs_state.TRACE[0]
            if tr is not None:
                # queue->slot transition: closes the queue-wait segment
                # (first admission AND each post-preempt re-admission)
                tr.transition(
                    st.request.request_id,
                    "prefill" if st.prefilling else "decode",
                    event="admit", slot=st.slot, kv_len=st.kv_len,
                    cached_tokens=st.cached_tokens)
            if st.swapped is not None:
                self._restore(st)

    def _run_cow(self, plan):
        """Copy-on-write: any span about to write into a borrowed (shared)
        page gets a private copy first -- the reserved spare block takes
        the page's content via one fixed-shape copy, the table is
        repointed, and the shared reference is dropped.  Returns the plan
        minus any request isolated by a ``serve.cow`` fault (fired BEFORE
        that request's table is touched)."""
        fi = _rs_state.FAULTS[0]
        copies = []
        dropped = []
        for i, st, n, _is_prefill in plan:
            if not st.borrowed:
                continue
            first = st.kv_len // self.page_size
            last = (st.kv_len + n - 1) // self.page_size
            pgs = [pg for pg in range(first, last + 1) if pg in st.borrowed]
            if not pgs:
                continue
            if fi is not None:
                try:
                    fi("serve.cow")
                except Exception as e:  # noqa: BLE001
                    # nothing mutated for this request yet this step
                    self._isolate(st, e)
                    dropped.append(i)
                    continue
            for pg in pgs:
                src = int(st.table[pg])
                dst = st.cow_spare.pop(pg)
                st.table[pg] = dst
                st.borrowed.discard(pg)
                st.num_cowed += 1
                st.blocks.remove(src)
                self.kv.allocator.free([src])   # drop OUR shared ref
                copies.append((src, dst))
        if dropped:
            plan = [it for it in plan if it[0] not in dropped]
        k = self.max_batch
        for lo in range(0, len(copies), k):
            src = np.full((k,), self.kv.oob_block, np.int32)
            dst = np.full((k,), self.kv.oob_block, np.int32)
            for j, (s_, d_) in enumerate(copies[lo:lo + k]):
                src[j], dst[j] = s_, d_
            self._cow_fn(self._tensor(src), self._tensor(dst))
        self._cow_copies += len(copies)
        if copies:
            reg = obs.get_registry()
            if reg is not None:
                reg.counter("serve.cow_copies").inc(len(copies))
        return plan

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
        text = None
        if self._detokenize is not None:
            # linear-cost streaming: detokenize only a bounded tail
            # window, emit its growth, and re-anchor at half-window so
            # per-token work never scales with the full output length
            w = st.detok_offset
            full = self._detokenize(list(st.output_ids[w:]))
            text = full[st.text_len:]
            st.text_len = len(full)
            if len(st.output_ids) - w >= _DETOK_WINDOW:
                st.detok_offset = len(st.output_ids) - _DETOK_WINDOW // 2
                st.text_len = len(self._detokenize(
                    list(st.output_ids[st.detok_offset:])))
        done_eos = (req.eos_token_id is not None
                    and token == req.eos_token_id)
        done_len = len(st.output_ids) >= req.max_new_tokens
        if done_eos or done_len:
            self.scheduler.finish(st, "eos" if done_eos else "length")
            if self.lora is not None and req.adapter is not None:
                # the adapter's slot becomes evictable once its last
                # live reader retires
                self.lora.release(req.adapter, req.request_id)
            if self.spec is not None:
                # bounded proposer retention: the n-gram index dies with
                # the request (it rebuilds lazily if the id is reused)
                self.spec.drop(req.request_id)
            tr = _obs_state.TRACE[0]
            if tr is not None:
                spec_kw = {} if self.spec is None else {
                    "spec_proposed": st.spec_proposed,
                    "spec_accepted": st.spec_accepted}
                tr.retire(req.request_id, reason=st.finish_reason,
                          tokens=len(st.output_ids), **spec_kw)
            if self._drain_capture is not None:
                # BEFORE the eviction below: more requests than
                # keep_finished may retire in one step
                self._drain_capture[req.request_id] = list(st.output_ids)
                st.drained = True
            self._finished_order.append(req.request_id)
            while len(self._finished_order) > self.keep_finished:
                self._states.pop(self._finished_order.popleft(), None)
            if _obs_state.EMIT[0] is not None:
                reg = obs.get_registry()
                if reg is not None:
                    reg.counter("serve.finished").inc()
                obs.emit_event(
                    "serve_finish", id=req.request_id,
                    reason=st.finish_reason, tokens=len(st.output_ids),
                    ms=round((time.perf_counter() - st.submit_t) * 1e3, 3))
        else:
            st.pending_token = token
        events.append(TokenEvent(req.request_id, token, text, st.finished,
                                 st.finish_reason))
        if req.on_token is not None:
            try:
                req.on_token(req.request_id, token, text)
            except Exception:  # noqa: BLE001
                # a raising callback must not tear down the whole step:
                # the batch's other requests already produced events
                warnings.warn(
                    f"on_token callback for request {req.request_id!r} "
                    f"raised; continuing "
                    f"({traceback.format_exc(limit=3).strip()})",
                    RuntimeWarning, stacklevel=2)

    def _propose_drafts(self) -> None:
        """Attach this step's n-gram draft to every eligible decode slot
        (``serving/spec.py``).  Drafting is best-effort: a failed
        proposal -- an injected ``serve.spec`` fault included -- drops
        THAT slot to ``draft_len = 0`` (a plain decode through the same
        step) and counts in ``spec_stats()["errors"]``.  The cap keeps
        speculative KV inside the pages the request reserved at admission
        and accepted tokens inside its output budget, so rollback is
        ``kv_len`` bookkeeping only."""
        fi = _rs_state.FAULTS[0]
        for _i, st in self.scheduler.active():
            st.draft = []
            if st.prefilling or st.request.temperature > 0.0:
                continue             # greedy slots only
            cap = min(self.draft_depth,
                      st.total_len - (st.kv_len + 1),
                      st.request.max_new_tokens - len(st.output_ids) - 1)
            if cap < 1:
                continue
            try:
                if fi is not None:
                    fi("serve.spec")
                st.draft = self.spec.propose(st, cap)
            except Exception as e:  # noqa: BLE001 -- degrade, never isolate
                self.spec.errors += 1
                reg = obs.get_registry()
                if reg is not None:
                    reg.counter("serve.spec.draft_errors").inc()
                obs.emit_event("serve_spec_error",
                               id=st.request.request_id,
                               exc=type(e).__name__,
                               message=str(e)[:200])
                st.draft = []

    def step(self) -> List[TokenEvent]:
        """Admit what fits, run ONE unified ragged step (prefill chunks,
        decode tokens and verify spans together), retire what finished.
        Returns the tokens emitted (one per decoded / prompt-completed
        request, more for an accepted speculative span).

        A host-side failure in one request's bookkeeping (admission, CoW,
        prefill/decode post-processing, or an injected ``serve.*`` fault)
        never tears down the step or the other slots: the victim is
        rewound to its pre-span snapshot, preempted to host memory and
        re-admitted; everyone else's events are delivered normally.

        With telemetry on, a non-empty step feeds the ``serve.*`` metrics
        from host numbers and the ``serve_step`` event, and ticks the
        ``slo_capture``."""
        t0 = time.perf_counter()
        events: List[TokenEvent] = []
        with span("serve.step", emit=False):
            self._admit_all()
            if self.spec is not None:
                self._propose_drafts()
            plan = self.scheduler.plan_spans(self.prefill_chunk,
                                             self.prefill_token_budget)
            if not plan:
                return events
            if not self._graph.ready:
                self.warmup()        # the one capture, as the reference's
            plan = self._run_cow(plan)
            if not plan:
                return events
            spec = self.spec is not None
            (tokens, tables, starts, lens, temps, seeds, emit,
             adapters) = self.scheduler.span_arrays(
                plan, self.prefill_chunk, spec_emit=spec)
            self._graph.load({"tokens": tokens, "tables": tables,
                              "starts": starts, "lens": lens,
                              "adapters": adapters})
            before = _kernels.counts(self.device.type)
            logits = self._graph.run()
            after = _kernels.counts(self.device.type)
            self._last_launches = {k: after[k] - before[k] for k in after}
        # own span, as the reference's: the host's wait for the replay
        # (at sampling) and the post-processing
        with span("serve.step.finish", emit=False):
            if spec:
                # a temperature slot draws only where the host consumes:
                # its decode positions, or a completing prefill's last one
                draws = {i: [n - 1] if is_prefill else range(n)
                         for i, st, n, is_prefill in plan
                         if temps[i] > 0.0 and not (
                             is_prefill and st.kv_len + n
                             < st.request.prompt_ids.size)}
                nxt = _sample_span(logits, temps, self._key, seeds, emit,
                                   draws)
            else:
                nxt = _sample(logits, temps, self._key, seeds,
                              emit).cpu().numpy()
            margins = None
            if self.margins is not None:
                top2 = torch.topk(logits.float(), 2, dim=-1).values
                margins = (top2[..., 0] - top2[..., 1]).cpu().numpy()
            self.steps += 1
            self._finish_events(plan, nxt, margins, events)
        self.tokens_emitted += len(events)
        if _obs_state.EMIT[0] is not None or self._slo_capture is not None:
            self._step_telemetry(plan, events, time.perf_counter() - t0)
        return events

    def _step_telemetry(self, plan, events: List[TokenEvent],
                        dt: float) -> None:
        """The reference's per-step metrics, event and SLO tick of a
        non-empty step: Python numbers from the scheduler and the events,
        never a tensor."""
        reg = obs.get_registry()
        n_tok = len(events)
        live_tokens = sum(n for _, _, n, _ in plan)
        if reg is not None:
            reg.counter("serve.tokens").inc(n_tok)
            if self.lora is not None:
                # per-adapter token accounting AFTER isolation filtered
                # the events, one inc per adapter
                per_ad: Dict[str, int] = {}
                for ev in events:
                    est = self._states.get(ev.request_id)
                    ad = est.request.adapter if est is not None else None
                    if ad is not None:
                        per_ad[ad] = per_ad.get(ad, 0) + 1
                for ad, n in per_ad.items():
                    reg.counter(
                        f"serve.lora.adapter[{ad}].tokens").inc(n)
            reg.gauge("serve.tok_s").set(round(n_tok / max(dt, 1e-9), 1))
            reg.gauge("serve.queue_depth").set(self.scheduler.queue_depth())
            reg.gauge("serve.kv_blocks_used").set(
                self.kv.allocator.used_blocks)
            reg.gauge("serve.active_requests").set(
                len(self.scheduler.active()))
            reg.histogram("serve.step_ms").observe(dt * 1e3)
            # how full the ragged step ran: real span tokens over the
            # (B, C) capacity
            reg.histogram("serve.ragged_occupancy").observe(
                live_tokens / (self.max_batch * self.prefill_chunk))
            reg.gauge("serve.cached_blocks").set(
                self.kv.allocator.cached_blocks)
            # pages still physically shared: admission hits minus the
            # ones CoW has since privatized
            reg.gauge("serve.shared_blocks").set(
                sum(s.num_shared - s.num_cowed
                    for _, s in self.scheduler.active()))
        obs.emit_event("serve_step", ms=round(dt * 1e3, 3),
                       tokens=n_tok, span_tokens=live_tokens,
                       active=len(self.scheduler.active()),
                       queue=self.scheduler.queue_depth(),
                       kv_blocks_used=self.kv.allocator.used_blocks)
        cap = self._slo_capture
        if cap is not None:
            # host-side counters only, until a breach arms the profiler
            cap.on_step()

    def _finish_events(self, plan, nxt, margins,
                       events: List[TokenEvent]) -> None:
        fi = _rs_state.FAULTS[0]
        tr = _obs_state.TRACE[0]
        for i, st, n, is_prefill in plan:
            rid = st.request.request_id
            # pre-span snapshot: isolation rewinds to here, and re-running
            # the span after restore is idempotent (the step already wrote
            # this span's KV; the re-run rewrites identical bytes, and
            # kv_len only ever covered the accepted prefix)
            snap = (st.kv_len, st.pending_token, len(st.output_ids),
                    st.text_len, st.detok_offset, st.spec_proposed,
                    st.spec_accepted,
                    len(self.margins.get(rid, ())) if self.margins is not None
                    else 0)
            try:
                if fi is not None:
                    fi("serve.prefill" if is_prefill else "serve.step")
                if not is_prefill:
                    # decode: a single token, or the speculative verify
                    # span (mid-verify faults land in the rollback below)
                    self._consume_decode(st, i, n, nxt, margins, events)
                    continue
                st.kv_len += n
                if tr is not None:
                    tr.point(st.request.request_id, "prefill_chunk",
                             tokens=n, kv_len=st.kv_len)
                if st.prefilling:
                    continue         # mid-prefill: sample discarded
                # prompt complete: this sample is the request's first
                # token (TTFT stops here: the host holds it); a
                # speculative step samples every span position, and the
                # prompt's last position carries it
                pos = (i,) if nxt.ndim == 1 else (i, n - 1)
                tok = int(nxt[pos])
                margin = None if margins is None else float(margins[pos])
                self._register_prefix(st)
                if tr is not None:
                    # prefill->decode; a re-completion after isolation
                    # keeps `first_token` exactly-once per request
                    tr.transition(
                        st.request.request_id, "decode",
                        event="first_token" if st.first_token_t is None
                        else "re_prefilled")
                if st.first_token_t is not None:
                    self._emit(st, tok, margin, events)
                    continue
                st.first_token_t = time.perf_counter()
                if _obs_state.EMIT[0] is not None:
                    self._first_token_telemetry(st)
                self._emit(st, tok, margin, events)
            except Exception as e:  # noqa: BLE001 -- isolate the request
                st.kv_len, st.pending_token = snap[0], snap[1]
                del st.output_ids[snap[2]:]
                st.text_len, st.detok_offset = snap[3], snap[4]
                st.spec_proposed, st.spec_accepted = snap[5], snap[6]
                if self.margins is not None and rid in self.margins:
                    del self.margins[rid][snap[7]:]
                # a speculative span may have emitted part of its
                # acceptance before failing: those tokens were rewound and
                # re-emit after restore, so their events must not ALSO be
                # delivered from this step
                events[:] = [ev for ev in events if ev.request_id != rid]
                self._isolate(st, e)

    def _first_token_telemetry(self, st: RequestState) -> None:
        """TTFT (global and per tenant), prefix hit/miss pages and the
        ``serve_request`` event, once per request."""
        req = st.request
        reg = obs.get_registry()
        if reg is not None:
            ttft = (st.first_token_t - st.submit_t) * 1e3
            reg.histogram("serve.ttft_ms").observe(ttft)
            if req.tenant:
                # the per-tenant aggregate the FrontDoor SLO policy reads
                reg.histogram(
                    f"serve.tenant[{req.tenant}].ttft_ms").observe(ttft)
            if st.num_shared:
                reg.counter("serve.prefix_hits").inc(st.num_shared)
            misses = len(st.page_keys) - st.num_shared
            if misses:
                reg.counter("serve.prefix_misses").inc(misses)
        obs.emit_event(
            "serve_request", id=req.request_id, tenant=req.tenant,
            adapter=req.adapter, prompt_len=int(req.prompt_ids.size),
            slot=st.slot, blocks=len(st.blocks),
            cached_tokens=st.cached_tokens)

    def _consume_decode(self, st: RequestState, i: int, n: int, nxt,
                        margins, events: List[TokenEvent]) -> None:
        """Consume a decode slot's sample(s): a plain single-token decode
        (the engine without ``spec_decode``, or a slot with no draft), or
        the speculative VERIFY -- greedy acceptance takes the longest
        draft prefix the per-position samples reproduce, plus one bonus
        token (a total miss still emits one token).  Rolling back the
        rejected tail is ``kv_len`` bookkeeping ONLY: the speculative
        writes sit in pages the request reserved, beyond the new kv_len,
        where the next span overwrites them and attention never reads."""
        if nxt.ndim == 1:
            st.kv_len += 1
            self._emit(st, int(nxt[i]),
                       None if margins is None else float(margins[i]),
                       events)
            return
        row = nxt[i]
        req = st.request
        k = n - 1
        a = 0
        while a < k and int(row[a]) == st.draft[a]:
            a += 1
        # eos-aware emission length, decided BEFORE emitting: an accepted
        # token that IS the eos finishes the request there and the rest of
        # the accepted span is dropped (the draft cap already keeps a + 1
        # inside the max_new budget)
        will = a + 1
        if req.eos_token_id is not None:
            for j in range(will):
                if int(row[j]) == req.eos_token_id:
                    will = j + 1
                    break
        acc = will - 1                  # drafts actually consumed
        st.kv_len += 1 + acc
        if k:
            # per-request accounting lands BEFORE emission (the last token
            # may retire the request); it is part of the rollback snapshot
            st.spec_proposed += k
            st.spec_accepted += acc
        for j in range(will):
            self._emit(st, int(row[j]),
                       None if margins is None else float(margins[i, j]),
                       events)
            if st.finished:
                break                   # safety net: must match `will`
        if k:
            # engine-wide counters land AFTER emission: they are not in
            # the snapshot, so counting before an _emit that raises would
            # count this span twice when isolation re-runs it
            sp = self.spec
            sp.verifies += 1
            sp.proposed += k
            sp.accepted += acc
            reg = obs.get_registry()
            if reg is not None:
                reg.counter("serve.spec.proposed").inc(k)
                if acc:
                    reg.counter("serve.spec.accepted").inc(acc)
                reg.histogram("serve.spec.accept_len").observe(acc)

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
        drained = self._begin_drain()
        try:
            while self.has_work():
                self.step()
        finally:
            self._end_drain()
        return drained

    def _begin_drain(self) -> Dict[str, List[int]]:
        """Start a drain capture (shared by :meth:`run` and
        ``FrontDoor.run``): collect requests already finished since the
        last drain, and arm finish-time capture so eviction under
        ``keep_finished`` cannot outrun the drain dict.  Pair with
        :meth:`_end_drain` in a finally."""
        drained: Dict[str, List[int]] = {}
        for rid, st in self._states.items():
            if st.finished and not st.drained:
                st.drained = True
                drained[rid] = list(st.output_ids)
        self._drain_capture = drained
        return drained

    def _end_drain(self) -> None:
        self._drain_capture = None
