"""Autoregressive generation over dense KV caches
(``paddle_tpu/models/generation.py`` counterpart), shared by the Llama
and GPT families.

Design:
- the prompt prefills the caches in one eager forward (the flash forward
  kernel on the card);
- the reference's compiled ``lax.scan`` decode loop becomes fixed-shape
  one-token steps: :class:`DecodeGraph` owns the caches and the step's
  static int32 inputs (``tokens`` (B, 1), ``lens`` (B,)) and its f32
  (B, V) logits, and on the card captures the step once into a CUDA
  graph (``serving.graph.StepGraph``) and replays it for every token.
  The model keeps one such holder, keyed by (batch, capacity, dtype)
  and by the weights and config the graph has built in, as the
  reference keeps one compiled loop: calls of one shape on an unchanged
  model capture once, whatever their sampling options, since sampling
  runs eagerly after each replay, in stream order, with no host round
  trip;
- configs without cache support recompute the full prefix per token
  (``use_cache=False``), the greedy oracle of the cached path.

``kv_cache_dtype="int8"`` gives the reference's quantized dense caches,
4-tuples ``(k_i8, v_i8, k_scale, v_scale)`` (``make_dense_caches``),
written and attended by ``incubate.nn.functional``'s int8 branches; the
captured decode step holds them like the fp pair.  Beam search raises
``NotImplementedError`` (ROADMAP.md).  Temperature draws use a
``torch.Generator`` on the logits' device, seeded per (call seed, emit
index), the call seed drawn from ``core.random``'s global stream:
reproducible after ``seed(s)``, not bit-equal to the reference's jax
draws.

Host model contract: ``self.model.init_cache(b, total, dtype=None)``;
the cached forward ``self.model(ids, caches=..., seq_lens=...) ->
(hidden, caches)``, caches written in place; ``self.logits(hidden)``;
``self._cache_supported()``.
"""

from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Optional

import numpy as np
import torch

from ..core import random as prandom

__all__ = ["CachedGenerationMixin", "DecodeGraph", "filter_logits",
           "make_dense_caches", "run_cached_layers"]

_NOT_PORTED = " is not ported yet (ROADMAP.md, queue 1 item 2a)"


def _is_int8(dtype) -> bool:
    """Every spelling of int8 -- ``"int8"``, ``"paddle.int8"``,
    ``np.int8``, ``torch.int8`` -- so none silently allocates raw UNSCALED
    int8 caches (the reference's ``_is_int8``, plus torch's dtype)."""
    if dtype is None:
        return False
    if dtype is torch.int8 or str(dtype) in ("int8", "paddle.int8"):
        return True
    try:
        return np.dtype(dtype) == np.int8
    except TypeError:
        return False


def _cache_dtype(dtype) -> torch.dtype:
    """The torch dtype of dense caches of ``dtype``: ``torch.int8`` for
    the quantized 4-tuple caches, else the float dtype."""
    from .llama import torch_dtype
    return torch.int8 if _is_int8(dtype) else torch_dtype(dtype)


def make_dense_caches(n_layers, batch, max_len, kv_heads, head_dim, dtype,
                      device=None):
    """Per-layer dense (k, v) cache pairs of (batch, max_len, kv_heads,
    head_dim) zeros.  ``dtype="int8"`` (any spelling, :func:`_is_int8`)
    gives the reference's QUANTIZED caches instead: 4-tuples ``(k_i8,
    v_i8, k_scale, v_scale)``, int8 zeros and (batch, max_len, kv_heads)
    f32 scales of ones."""
    shape = (batch, max_len, kv_heads, head_dim)
    dt = _cache_dtype(dtype)
    if dt == torch.int8:
        return [tuple(torch.zeros(shape, dtype=dt, device=device)
                      for _ in range(2)) +
                tuple(torch.ones(shape[:3], dtype=torch.float32,
                                 device=device) for _ in range(2))
                for _ in range(n_layers)]
    return [(torch.zeros(shape, dtype=dt, device=device),
             torch.zeros(shape, dtype=dt, device=device))
            for _ in range(n_layers)]


def run_cached_layers(layers, x, caches, call):
    """Thread (x, per-layer cache) through the decoder stack."""
    layers = list(layers)
    if len(layers) != len(caches):
        raise ValueError(
            f"cache list has {len(caches)} entries for {len(layers)} "
            f"decoder layers — was it built by a different config?")
    new_caches = []
    for layer, cache in zip(layers, caches):
        x, cache = call(layer, x, cache)
        new_caches.append(cache)
    return x, new_caches


def filter_logits(lg, top_k: int = 0, top_p: float = 1.0,
                  repetition_penalty: float = 1.0, seen=None,
                  temperature: float = 1.0):
    """Decode-strategy logit transforms, in the reference's order: penalty
    on the raw logits -> temperature -> top-k -> top-p, the nucleus taken
    on the temperature-scaled, top-k-filtered distribution.  One
    descending sort serves both filters; the top token is always kept.
    ``seen``: (B, V) counts of emitted tokens (prompt included) for the
    penalty, or None.  Returns the temperature-scaled logits, filtered
    entries ``-inf``."""
    if repetition_penalty != 1.0 and seen is not None:
        pen = torch.where(lg > 0, lg / repetition_penalty,
                          lg * repetition_penalty)
        lg = torch.where(seen > 0, pen, lg)
    if temperature > 0 and temperature != 1.0:
        lg = lg / temperature
    if (top_k and top_k > 0) or top_p < 1.0:
        srt = torch.sort(lg, dim=-1, descending=True).values
        if top_k and top_k > 0:
            kth = srt[..., int(top_k) - 1:int(top_k)]
            lg = lg.masked_fill(lg < kth, float("-inf"))
            # TopP sees the TopK-filtered distribution
            ar = torch.arange(srt.shape[-1], device=srt.device)
            srt = srt.masked_fill(ar >= int(top_k), float("-inf"))
        if top_p < 1.0:
            probs = torch.softmax(srt, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep = (cum - probs) < top_p
            kth = torch.where(keep, srt, float("inf")).amin(
                dim=-1, keepdim=True)
            lg = lg.masked_fill(lg < kth, float("-inf"))
    return lg


def _seen_counts(ids, vocab_size):
    """(B, V) int32 counts of each token in ``ids`` (B, S)."""
    seen = torch.zeros((ids.shape[0], vocab_size), dtype=torch.int32,
                       device=ids.device)
    return seen.scatter_add_(1, ids.long(),
                             torch.ones_like(ids, dtype=torch.int32))


def _draw(logits, gen):
    """One token per row from ``softmax(logits)`` by the exponential race
    (``torch.multinomial``'s one-sample method, without its host-side
    check of the probabilities)."""
    probs = torch.softmax(logits, dim=-1)
    race = torch.empty_like(probs).exponential_(generator=gen)
    return torch.argmax(probs / race, dim=-1)


class DecodeGraph:
    """The one-token decode step of ``model`` at (batch, capacity, dtype):
    the dense caches, written in place by the prefill and every step, and
    the step on static buffers (:attr:`graph`: ``tokens`` (B, 1) and
    ``lens`` (B,) int32 in, the last position's f32 (B, V) logits out),
    captured once on the card and replayed, run eagerly on the CPU.

    ``captures`` is 1 once a step ran on the card, ``replays`` counts the
    replays; a replay credits each kernel's launches (``graph.launches``
    is one step's)."""

    def __init__(self, model, batch: int, capacity: int, dtype,
                 device: torch.device):
        from ..serving.graph import StepGraph
        self.key = (batch, capacity, dtype)
        self.caches = caches = model.model.init_cache(batch, capacity,
                                                      dtype=dtype)
        mref = weakref.ref(model)     # the model holds this holder

        def step(tokens, lens):
            m = mref()
            hidden, _ = m.model(tokens, caches=caches, seq_lens=lens)
            return m.logits(hidden[:, -1]).float()

        self.graph = StepGraph(step, {"tokens": (batch, 1),
                                      "lens": (batch,)}, device,
                               capture=device.type == "cuda")

    @property
    def captures(self) -> int:
        return self.graph.captures

    @property
    def replays(self) -> int:
        return self.graph.replays

    def step(self, tokens, eager: bool = False) -> torch.Tensor:
        """Decode ``tokens`` (B,) at positions ``lens`` and advance
        ``lens``; returns the static logits (valid until the next step).
        The first step on the card captures the graph; ``eager`` runs
        the same function without it (the in-process eager twin)."""
        g = self.graph
        g.inputs["tokens"].copy_(tokens[:, None])
        if g.capture and not eager:
            g.prepare()
        out = g.run(eager=eager)
        g.inputs["lens"].add_(1)
        return out


class CachedGenerationMixin:
    def _cache_supported(self) -> bool:
        return False  # families opt in

    @property
    def decode_graph(self) -> Optional[DecodeGraph]:
        """The memoized decode-step holder of the last cached
        ``generate()`` (None before one)."""
        memo = self.__dict__.get("_decode_graph_memo")
        return None if memo is None else memo[1]

    def _decode_holder(self, batch, capacity, dtype, device) -> DecodeGraph:
        """The one memo slot, keyed by (batch, capacity, dtype) and by
        what the captured graph has built in: the address, dtype and
        shape of every parameter and buffer, and the config (the path).
        Any other key -- a new shape, ``quantize_linears``, ``.to()``, a
        ``p.data`` swap, a changed ``fused_ops`` -- frees the old graph and
        caches before allocating new ones."""
        key = (batch, capacity, _cache_dtype(dtype))
        model = (dataclasses.astuple(self.cfg),
                 tuple((t.data_ptr(), t.dtype, t.shape) for t in
                       itertools.chain(self.parameters(), self.buffers())))
        memo = self.__dict__.get("_decode_graph_memo")
        if memo is not None and memo[0] == (key, model):
            return memo[1]
        self.__dict__.pop("_decode_graph_memo", None)
        del memo        # the old holder's last reference
        holder = DecodeGraph(self, *key, device)
        self.__dict__["_decode_graph_memo"] = ((key, model), holder)
        return holder

    def _sample(self, logits, temperature, top_k, top_p,
                repetition_penalty, seen, gen):
        """Greedy (temperature 0) or a draw with ``gen`` from the filtered
        logits."""
        logits = filter_logits(logits, top_k, top_p, repetition_penalty,
                               seen, temperature)
        if temperature > 0:
            return _draw(logits, gen)
        return torch.argmax(logits, dim=-1)

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 use_cache=True, max_len=None, top_k=0, top_p=1.0,
                 repetition_penalty=1.0, decode_strategy=None,
                 num_beams=1, eos_token_id=None, pad_token_id=None,
                 kv_cache_dtype=None, _eager_step: bool = False):
        """Autoregressive generation.  ``input_ids`` (B, S) (a tensor or
        array) -> (B, S + max_new_tokens) on the model's device, in the
        input's integer dtype.

        ``use_cache=True`` prefills dense KV caches of capacity
        ``max_len`` (default S + max_new_tokens) once, then decodes one
        token per step through the model's :class:`DecodeGraph` (captured
        once and replayed on the card).  ``use_cache=False`` recomputes
        the full prefix each step; under greedy decoding the two are
        token-identical.  ``top_k``/``top_p``/``repetition_penalty``
        (the penalty counts the prompt too) and ``decode_strategy``
        ("greedy_search" forces temperature 0, "sampling" a temperature
        > 0) follow the reference.  ``eos_token_id``: a row that emits it
        keeps emitting ``pad_token_id`` (default: the eos id); the output
        length stays fixed.  ``kv_cache_dtype`` sets the caches' dtype
        (default the model's); ``"int8"`` quantizes them (per-position,
        per-head scales) and needs the cached path: the recompute path
        raises ``ValueError`` on any ``kv_cache_dtype``.  Beam search
        (``num_beams > 1``) raises ``NotImplementedError``.
        ``_eager_step`` runs the decode steps without the graph, on the
        same caches and buffers (the smoke's in-process eager twin)."""
        if decode_strategy not in (None, "greedy_search", "sampling",
                                   "beam_search"):
            raise ValueError(
                f"unsupported decode_strategy {decode_strategy!r}")
        if num_beams > 1:
            if decode_strategy is None:
                decode_strategy = "beam_search"
            elif decode_strategy != "beam_search":
                raise ValueError(
                    f"num_beams={num_beams} requires "
                    f"decode_strategy='beam_search', got {decode_strategy!r}")
        dev = self.model.embed_tokens.weight.device
        ids = torch.as_tensor(input_ids, device=dev)
        prompt_len = ids.shape[1]
        total = max_len if max_len is not None else \
            (prompt_len + max_new_tokens)
        if total < prompt_len + max_new_tokens:
            raise ValueError(
                f"max_len={total} < prompt ({prompt_len}) + max_new_tokens "
                f"({max_new_tokens}): the cache would silently drop keys")
        if decode_strategy == "beam_search":
            if num_beams <= 1:
                raise ValueError(
                    "beam_search needs num_beams > 1 (reference semantics; "
                    "num_beams=1 IS greedy_search)")
            raise NotImplementedError("beam search" + _NOT_PORTED)
        if decode_strategy == "greedy_search":
            temperature = 0.0
        elif decode_strategy == "sampling" and temperature <= 0:
            temperature = 1.0
        if max_new_tokens <= 0:
            return ids
        pad_id = pad_token_id if pad_token_id is not None else eos_token_id
        seen = _seen_counts(ids, self.cfg.vocab_size) \
            if repetition_penalty != 1.0 else None
        b = ids.shape[0]
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        draw_seed = prandom.next_key() if temperature > 0 else 0
        gen = torch.Generator(device=dev) if temperature > 0 else None

        def emit(logits, i):
            """Token ``i`` of every row: sample, freeze finished rows,
            count it."""
            nonlocal seen, done
            if gen is not None:
                gen.manual_seed(prandom.fold_in(draw_seed, i))
            nxt = self._sample(logits, temperature, top_k, top_p,
                               repetition_penalty, seen, gen)
            if eos_token_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
                done = done | (nxt == eos_token_id)
            if seen is not None:
                seen[torch.arange(b, device=dev), nxt] += 1
            return nxt.to(ids.dtype)

        with torch.no_grad():
            if not (use_cache and self._cache_supported()):
                if kv_cache_dtype is not None:
                    # a full-precision recompute would let the caller
                    # believe they validated a quantized cache
                    raise ValueError(
                        "kv_cache_dtype set but this call uses the "
                        "recompute path (use_cache=False or no cache "
                        "support) — there is no cache to quantize")
                out = ids
                for i in range(max_new_tokens):
                    nxt = emit(self(out)[:, -1].float(), i)
                    out = torch.cat([out, nxt[:, None]], dim=1)
                return out
            dtype = kv_cache_dtype if kv_cache_dtype is not None else \
                self.cfg.dtype
            holder = self._decode_holder(b, total, dtype, dev)
            hidden, _ = self.model(ids, caches=holder.caches)
            toks = [emit(self.logits(hidden[:, -1]).float(), 0)]
            holder.graph.inputs["lens"].fill_(prompt_len)
            for i in range(1, max_new_tokens):
                toks.append(emit(holder.step(toks[-1], eager=_eager_step),
                                 i))
            return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)
