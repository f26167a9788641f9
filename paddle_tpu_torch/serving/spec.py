"""Self-speculative decoding: n-gram drafting for the ragged serving step
(a copy of ``paddle_tpu/serving/spec.py``).

Decode at small batch is memory-bandwidth-bound — every step streams the
full weight set to emit ONE token per slot.  Speculative decoding spends
spare flops to buy tokens: draft K cheap guesses, score them all in one
forward pass, keep the longest prefix the model agrees with.  This
module is the DRAFTING half (host-side, model-free); the VERIFY half is
the engine's existing unified ragged step, which scores a slot's
``[pending, d_1 .. d_k]`` span exactly like a chunked-prefill segment —
one dispatch, same kernel, same ``(B, C)`` shapes (docs/SERVING.md
"Speculative decoding").

Why n-gram self-drafting first (no second model): serving traffic is
full of local repetition — code, templated prose, quoted context, JSON
— where the request's OWN token history predicts its continuation.  The
proposer keeps, per request, an incremental index of every
``min_ngram..max_ngram``-gram in ``prompt + emitted`` tokens; a draft is
the historical continuation of the longest indexed suffix match.  Cost
per step is O(new tokens · n-gram sizes) dict work and zero device
traffic, so a miss costs (almost) nothing and the engine simply runs
that slot at ``draft_len = 0`` through the same compiled program.

Acceptance is GREEDY in v1: the verified step samples every span
position; the accepted length is the longest prefix where the model's
argmax reproduces the draft, plus one bonus token (the model's own next
token — emitted even on a total miss, so a verify step never does worse
than a plain decode step).  Greedy outputs are therefore TOKEN-IDENTICAL
to the non-speculative engine by construction.  Temperature slots ride
the same program with ``draft_len = 0`` (v1); their sampled streams
stay reproducible either way because the engine derives PRNG keys per
EMITTED-TOKEN INDEX, never per step (``engine._sample``).

Rollback is kv_len bookkeeping ONLY: speculative KV lands in pages the
request already reserved at admission (the draft cap enforces it), so
rejecting ``k - a`` drafts just means not advancing ``kv_len`` past the
accepted prefix — the garbage KV beyond it is overwritten by the next
span and never read (attention masks at ``kv_len``).  No page frees, no
copies, and prefix-cache digests only ever chain over accepted pages
(registration happens at prefill completion, before any drafting).

State is REBUILDABLE by design: the index is a pure function of
``prompt + output_ids``, so preempt→swap→restore snapshots carry no
draft state (unaccepted speculative tokens are excluded because they
are never in ``output_ids``), and a request migrating to another
replica after an evacuation just rebuilds its index lazily on the
destination's proposer.  A rollback that truncated ``output_ids``
(fault isolation) is detected by the consumed-token watermark and the
index is rebuilt from scratch.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

__all__ = ["NgramProposer"]


class _SpecState:
    """Per-request incremental n-gram index over ``prompt + emitted``."""

    __slots__ = ("ctx", "consumed", "indexed", "index")

    def __init__(self):
        self.ctx: List[int] = []     # prompt + emitted tokens, as ints
        self.consumed = 0            # tokens of (prompt+output) in ctx
        self.indexed = 0             # ngram endings < indexed are in index
        self.index: Dict[Tuple[int, ...], int] = {}   # ngram -> last end pos


class NgramProposer:
    """Suffix-match n-gram draft proposer (one per speculative engine).

    ``propose(st, cap)`` returns up to ``min(depth, cap)`` draft tokens
    for a request state: the tokens that FOLLOWED the most recent
    earlier occurrence of the longest (``max_ngram`` down to
    ``min_ngram``) suffix of the request's context.  Returns ``[]`` on
    a miss — the engine runs the slot at ``draft_len = 0``.

    Retention is bounded: entries drop at request retirement
    (``drop``), and ``max_requests`` LRU-evicts stragglers (a preempted
    request whose entry was evicted rebuilds lazily — correctness never
    depends on the index surviving).
    """

    def __init__(self, depth: int, min_ngram: int = 1, max_ngram: int = 4,
                 max_requests: int = 4096):
        if depth < 1:
            raise ValueError(f"draft depth must be >= 1, got {depth}")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"[{min_ngram}, {max_ngram}]")
        self.depth = int(depth)
        self.min_ngram = int(min_ngram)
        self.max_ngram = int(max_ngram)
        self.max_requests = int(max_requests)
        self._requests: "collections.OrderedDict[str, _SpecState]" = \
            collections.OrderedDict()
        # lifetime telemetry (Engine.spec_stats / the serve.spec.* twins)
        self.proposed = 0            # draft tokens sent to verification
        self.accepted = 0            # of those, accepted by the model
        self.verifies = 0            # verify spans scored (draft_len > 0)
        self.draft_hits = 0          # propose() calls returning a draft
        self.draft_misses = 0        # propose() calls with no match
        self.errors = 0              # propose() failures (degraded to 0)

    # -- index maintenance -------------------------------------------------

    def _get(self, st) -> _SpecState:
        rid = st.request.request_id
        prompt = st.request.prompt_ids
        plen = int(prompt.size)
        target = plen + len(st.output_ids)
        s = self._requests.get(rid)
        if s is None or s.consumed > target:
            # unknown request (fresh, migrated, or LRU-evicted) or a
            # context that SHRANK (fault-isolation rewind truncated
            # output_ids): rebuild from the authoritative token lists
            s = _SpecState()
            self._requests[rid] = s
        self._requests.move_to_end(rid)
        while len(self._requests) > self.max_requests:
            self._requests.popitem(last=False)
        if s.consumed < target:
            if s.consumed < plen:
                s.ctx.extend(int(t) for t in prompt[s.consumed:])
                s.consumed = plen
            s.ctx.extend(st.output_ids[s.consumed - plen:])
            s.consumed = target
        # index every n-gram ENDING strictly before the last position:
        # the suffix lookup below must only ever match an EARLIER
        # occurrence, so the current suffix is deliberately not indexed
        L = len(s.ctx)
        for p in range(s.indexed, L - 1):
            hi = p + 1
            for n in range(self.min_ngram, self.max_ngram + 1):
                if hi >= n:
                    # FIRST occurrence wins: on looping content the
                    # earliest match leaves the longest historical
                    # continuation to draft from (measured: more
                    # accepted tokens per verify step than most-recent
                    # indexing, which tends to match just behind the
                    # cursor and truncate the draft)
                    s.index.setdefault(tuple(s.ctx[hi - n:hi]), p)
        s.indexed = max(s.indexed, L - 1)
        return s

    # -- the proposer surface ----------------------------------------------

    def propose(self, st, cap: int) -> List[int]:
        """Draft up to ``min(depth, cap)`` tokens for ``st`` (a decode
        slot).  ``cap`` is the engine's budget bound: speculative KV
        must land in the request's already-reserved pages and accepted
        tokens must fit the remaining ``max_new_tokens`` budget."""
        cap = min(int(cap), self.depth)
        if cap < 1:
            return []
        s = self._get(st)
        ctx = s.ctx
        L = len(ctx)
        # longest n-gram with a FULL-depth continuation wins; otherwise
        # the longest continuation any matching n offers (a long match
        # ending near the cursor can only draft a token or two — a
        # shorter suffix matching further back often drafts the whole
        # cap, and the verify pass prices both the same)
        best = None
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            p = s.index.get(tuple(ctx[L - n:]))
            if p is not None:
                cont = list(ctx[p + 1:p + 1 + cap])
                if len(cont) == cap:
                    self.draft_hits += 1
                    return cont
                if best is None or len(cont) > len(best):
                    best = cont
        if best:
            self.draft_hits += 1
            return best
        self.draft_misses += 1
        return []

    def drop(self, request_id: str) -> None:
        """Forget a retired request's index (bounded retention)."""
        self._requests.pop(request_id, None)

    def __len__(self) -> int:
        return len(self._requests)

    def stats(self) -> Dict[str, float]:
        """Lifetime drafting/acceptance counters plus the acceptance
        rate (accepted / proposed draft tokens)."""
        return {"proposed": self.proposed, "accepted": self.accepted,
                "accept_rate": (self.accepted / self.proposed)
                if self.proposed else 0.0,
                "verifies": self.verifies,
                "draft_hits": self.draft_hits,
                "draft_misses": self.draft_misses,
                "errors": self.errors,
                "tracked_requests": len(self._requests)}
