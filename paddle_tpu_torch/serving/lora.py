"""Batched multi-LoRA serving: stacked adapter pools for the one ragged
step (``paddle_tpu/serving/lora.py`` counterpart).

One engine holds every resident adapter's low-rank deltas STACKED along a
leading adapter axis -- per LoRA-targeted projection ``p`` of every
decoder layer, ``a[p]`` is ``(max_adapters + 1, d_in, r)`` and ``b[p]`` is
``(max_adapters + 1, r, d_out)`` -- and each batch slot carries its
adapter INDEX as per-slot data (``scheduler.span_arrays``), so a mixed
batch of tenants rides the same ``(B, C)`` step the base model uses.  The
grouped BGMV (``incubate.nn.functional.lora_bgmv``, the
``ops/cuda/lora_matmul`` kernel on the card) gathers each slot's
``A_i``/``B_i`` by that index and adds ``x @ A_i @ B_i`` to the base
projection.

The device stacks are allocated once, at construction, on the model's
device and in its dtype.  ``load`` and ``evict`` write one slot's rows in
place and never reallocate: the tensors the step reads keep their
addresses for the pool's lifetime (the reference's zero-recompile
contract; a captured CUDA graph stays valid).  Slot 0 is the reserved
exact no-op (all-zero ``A``/``B``): a base request's delta is exactly
0.0 and its outputs stay bitwise those of a LoRA-less engine on the same
(unfused) path.

Lifecycle, as in the reference: adapters are registered by NAME
(``load``), mapped to slots on a free list, and refcounted by the live
request ids using them (``acquire``/``release`` -- the Engine calls
these at admission and retirement).  ``evict`` of a referenced adapter
raises the typed :class:`errors.AdapterInUse`.  ``alpha / rank`` is
folded into ``B`` at load, so the serving delta is the plain chain
``x @ A @ B`` and the merged-weight reference is ``W + A @ (B *
alpha/r)`` (:func:`merge_adapter`).  The host mirror (float32 numpy) is
authoritative.  With telemetry on, loads and evictions feed the
reference's ``serve.lora.*`` metrics and ``serve_lora_load`` /
``serve_lora_evict`` events.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .. import observability as obs
from ..models.llama import torch_dtype
from .errors import AdapterInUse, UnknownAdapter

__all__ = ["LoRAPool", "merge_adapter", "random_adapter"]


def _decoder_layers(model) -> list:
    """The decoder-layer list of a paged-serving CausalLM
    (``model.model.layers``)."""
    mdl = getattr(model, "model", None)
    if mdl is None:
        raise ValueError(
            f"{type(model).__name__} is not a CausalLM (no .model)")
    ll = getattr(mdl, "layers", None)
    if ll is None or not hasattr(ll, "__iter__"):
        raise ValueError(f"{type(mdl).__name__} has no decoder-layer list "
                         "(expected .layers)")
    return list(ll)


def _targets(layer) -> Dict[str, Tuple[int, int]]:
    """LoRA-targeted projections of one decoder layer: every 2-D weight
    parameter (q/k/v/o and gate/up/down on Llama; norms are 1-D), keyed by
    its dotted path minus ``.weight`` -- the key the model forwards index
    the per-layer pack by."""
    out = {}
    for path, p in layer.named_parameters():
        if path.endswith(".weight") and p.ndim == 2:
            out[path[:-len(".weight")]] = (int(p.shape[0]), int(p.shape[1]))
    if not out:
        raise ValueError(
            f"{type(layer).__name__} exposes no 2-D projection weights "
            "to target (is the model already weight-quantized? build "
            "the LoRAPool BEFORE Engine(weight_quant=...))")
    return out


class LoRAPool:
    """Stacked multi-adapter LoRA weights for one model geometry.

    ``max_adapters`` named adapters can be resident at once (slot 0 is
    the reserved base no-op on top of that).  ``rank`` is the shared LoRA
    rank r; ``alpha`` the scaling numerator (default ``rank``, i.e. scale
    1.0) folded into ``B`` at load.  ``dtype`` defaults to the model's
    config dtype; the stacks live on the model's device."""

    def __init__(self, model, *, max_adapters: int = 8, rank: int = 8,
                 alpha: Optional[float] = None, dtype=None):
        if max_adapters < 1:
            raise ValueError(f"max_adapters must be >= 1, got "
                             f"{max_adapters}")
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        layers = _decoder_layers(model)
        self.targets = _targets(layers[0])
        for i, l in enumerate(layers[1:], 1):
            if _targets(l) != self.targets:
                raise ValueError(
                    f"decoder layer {i} exposes different projections "
                    "than layer 0 — heterogeneous stacks are not "
                    "supported")
        self.num_layers = len(layers)
        self.max_adapters = int(max_adapters)
        self.rank = int(rank)
        self.alpha = float(alpha) if alpha is not None else float(rank)
        self.dtype = torch_dtype(dtype if dtype is not None else
                                 getattr(model.cfg, "dtype", "float32"))
        self.device = next(model.parameters()).device
        n = self.max_adapters + 1      # +1: slot 0 = exact no-op
        # host mirror: per layer, per projection, f32 zero stacks
        self._host: List[Dict[str, Dict[str, np.ndarray]]] = [
            {p: {"a": np.zeros((n, di, self.rank), np.float32),
                 "b": np.zeros((n, self.rank, do), np.float32)}
             for p, (di, do) in self.targets.items()}
            for _ in range(self.num_layers)]
        # device stacks: allocated once, written slot by slot in place
        self._device = [
            {p: {k: torch.zeros(arr.shape, dtype=self.dtype,
                                device=self.device)
                 for k, arr in ab.items()}
             for p, ab in pack.items()}
            for pack in self._host]
        self._slots: Dict[str, int] = {}          # name -> slot (>= 1)
        self._free: List[int] = list(range(n - 1, 0, -1))  # pop() -> 1..
        # live refs: adapter name -> request ids decoding with it
        self._refs: Dict[str, Set[str]] = {}
        self.loads = 0
        self.evictions = 0

    # -- registry ----------------------------------------------------------

    def has(self, name: str) -> bool:
        return name in self._slots

    def adapters(self) -> Dict[str, int]:
        """{name: slot} for every resident adapter."""
        return dict(self._slots)

    @property
    def active_adapters(self) -> int:
        return len(self._slots)

    def slot_of(self, name: str) -> int:
        """Resolve an adapter name to its stack slot; typed
        :class:`UnknownAdapter` when it is not resident."""
        slot = self._slots.get(name)
        if slot is None:
            known = sorted(self._slots) or ["<none>"]
            raise UnknownAdapter(
                f"adapter {name!r} is not loaded in this pool "
                f"(resident: {', '.join(known)}) — LoRAPool.load it "
                "before admission")
        return slot

    def refcount(self, name: str) -> int:
        return len(self._refs.get(name, ()))

    # -- refcounts (the Engine calls these; request-id keyed) --------------

    def acquire(self, name: str, request_id: str) -> None:
        """Pin ``name`` for ``request_id`` (idempotent); typed
        :class:`UnknownAdapter` when the adapter is not resident."""
        self.slot_of(name)
        self._refs.setdefault(name, set()).add(request_id)

    def release(self, name: str, request_id: str) -> None:
        refs = self._refs.get(name)
        if refs is not None:
            refs.discard(request_id)

    # -- load / evict (slot writes in place) -------------------------------

    def load(self, name: str, weights: Sequence[Dict[str, tuple]]) -> int:
        """Load (or hot-reload) adapter ``name``; returns its slot.

        ``weights`` is a per-layer sequence of ``{proj: (A, B)}`` dicts
        of numpy arrays or tensors (``A (d_in, r)``, ``B (r, d_out)``;
        projections an adapter does not target may be omitted -- their
        delta stays zero).  Every row is validated before any pool state
        changes, so a failed load leaks no slot and leaves a resident
        adapter intact.  Reloading a resident name overwrites its slot in
        place."""
        if len(weights) != self.num_layers:
            raise ValueError(
                f"adapter {name!r} carries {len(weights)} layers, pool "
                f"expects {self.num_layers}")
        scale = self.alpha / self.rank
        rows = []
        for li, pack in enumerate(weights):
            unknown = set(pack or {}) - set(self.targets)
            if unknown:
                raise ValueError(
                    f"adapter {name!r} layer {li} targets unknown "
                    f"projection(s) {sorted(unknown)} — this pool "
                    f"targets {sorted(self.targets)}")
            for proj, (di, do) in self.targets.items():
                entry = (pack or {}).get(proj)
                if entry is None:
                    rows.append((li, proj, None, None))
                    continue
                a, b = (_numpy_f32(t) for t in entry)
                if a.shape != (di, self.rank) or \
                        b.shape != (self.rank, do):
                    raise ValueError(
                        f"adapter {name!r} layer {li} {proj}: A{a.shape}"
                        f"/B{b.shape} do not match ({di}, {self.rank})/"
                        f"({self.rank}, {do})")
                rows.append((li, proj, a, b * scale))
        slot = self._slots.get(name)
        if slot is None:
            if not self._free:
                raise ValueError(
                    f"pool is full ({self.max_adapters} adapters) — "
                    f"evict one before loading {name!r}")
            slot = self._free.pop()
        for li, proj, a, b in rows:
            self._host[li][proj]["a"][slot] = 0.0 if a is None else a
            self._host[li][proj]["b"][slot] = 0.0 if b is None else b
        self._slots[name] = slot
        self._write_device_slot(slot)
        self.loads += 1
        reg = obs.get_registry()
        if reg is not None:
            reg.counter("serve.lora.loads").inc()
            reg.gauge("serve.lora.active_adapters").set(
                self.active_adapters)
        obs.emit_event("serve_lora_load", adapter=name, slot=slot,
                       rank=self.rank)
        return slot

    def evict(self, name: str) -> None:
        """Free ``name``'s slot (zeroing its rows).  Typed
        :class:`AdapterInUse` while live requests still reference it."""
        slot = self.slot_of(name)
        refs = self._refs.get(name)
        if refs:
            raise AdapterInUse(
                f"adapter {name!r} is referenced by {len(refs)} live "
                f"request(s) (e.g. {sorted(refs)[0]!r}) — drain before "
                "evicting")
        for pack in self._host:
            for ab in pack.values():
                ab["a"][slot] = 0.0
                ab["b"][slot] = 0.0
        del self._slots[name]
        self._refs.pop(name, None)
        self._free.append(slot)
        self._write_device_slot(slot)
        self.evictions += 1
        reg = obs.get_registry()
        if reg is not None:
            reg.counter("serve.lora.evictions").inc()
            reg.gauge("serve.lora.active_adapters").set(
                self.active_adapters)
        obs.emit_event("serve_lora_evict", adapter=name, slot=slot)

    def _write_device_slot(self, slot: int) -> None:
        """Copy ONE slot's host rows into the device stacks, in place."""
        with torch.no_grad():
            for hpack, dpack in zip(self._host, self._device):
                for proj, ab in hpack.items():
                    for k in ("a", "b"):
                        dpack[proj][k][slot].copy_(
                            torch.from_numpy(ab[k][slot]))

    def _restore(self, host, adapters: Dict[str, int]) -> None:
        """Replace the whole pool state by ``host`` (a host mirror of this
        geometry: per layer ``{proj: {"a", "b"}}`` f32 arrays, alpha/r
        already folded into ``b``) with the registry ``adapters`` ({name:
        slot}); refcounts are cleared.  ``models.convert`` carries a JAX
        pool across with it."""
        if len(host) != self.num_layers:
            raise ValueError(f"host mirror has {len(host)} layers, pool "
                             f"expects {self.num_layers}")
        n = self.max_adapters + 1
        if any(not 1 <= s < n for s in adapters.values()) or \
                len(set(adapters.values())) != len(adapters):
            raise ValueError(f"bad adapter slots {adapters} for a pool of "
                             f"{self.max_adapters}")
        for li, (mine, theirs) in enumerate(zip(self._host, host)):
            if set(theirs) != set(mine):
                raise KeyError(f"layer {li} projections differ: "
                               f"{sorted(theirs)} vs {sorted(mine)}")
            for proj, ab in mine.items():
                for k in ("a", "b"):
                    arr = np.asarray(theirs[proj][k], np.float32)
                    if arr.shape != ab[k].shape:
                        raise ValueError(
                            f"layer {li} {proj}.{k}: {arr.shape} != "
                            f"{ab[k].shape}")
        for mine, theirs in zip(self._host, host):
            for proj, ab in mine.items():
                for k in ("a", "b"):
                    ab[k][...] = np.asarray(theirs[proj][k], np.float32)
        self._slots = dict(adapters)
        self._free = [s for s in range(n - 1, 0, -1)
                      if s not in self._slots.values()]
        self._refs = {}
        for slot in range(n):
            self._write_device_slot(slot)

    # -- what the step reads -----------------------------------------------

    def device_stacks(self):
        """Per-layer ``{proj: {"a": (N, d_in, r), "b": (N, r, d_out)}}``
        tensors on the model's device in the pool dtype, the same tensors
        for the pool's lifetime."""
        return self._device

    def nbytes(self) -> int:
        """Bytes of the device stacks."""
        return sum(t.numel() * t.element_size() for pack in self._device
                   for ab in pack.values() for t in ab.values())

    def validate(self, model) -> None:
        """Geometry check at Engine construction: a pool built for one
        model shape must not serve another."""
        layers = _decoder_layers(model)
        if len(layers) != self.num_layers or \
                _targets(layers[0]) != self.targets:
            raise ValueError(
                "LoRAPool geometry does not match this model "
                f"({self.num_layers} layers × {sorted(self.targets)} "
                "vs the engine's) — build the pool for the model the "
                "engine serves")
        dev = next(model.parameters()).device
        if dev != self.device:
            raise ValueError(f"LoRAPool stacks are on {self.device}, the "
                             f"model on {dev}")

    def stats(self) -> Dict[str, float]:
        """Pool counters."""
        return {"active_adapters": self.active_adapters,
                "max_adapters": self.max_adapters,
                "rank": self.rank, "loads": self.loads,
                "evictions": self.evictions,
                "live_refs": sum(len(v) for v in self._refs.values())}


def _numpy_f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def random_adapter(model, *, rank: int = 8, rng=None, scale: float = 0.05,
                   projs: Optional[Sequence[str]] = None):
    """Random adapter weights for tests and smoke runs: per-layer
    ``{proj: (A, B)}`` float32 numpy with ``A ~ N(0, scale)`` and ``B ~
    N(0, scale)`` (non-zero B, so the adapter visibly changes outputs).
    ``projs`` restricts the targeted projections (default: all)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    layers = _decoder_layers(model)
    targets = _targets(layers[0])
    keys = list(targets) if projs is None else list(projs)
    out = []
    for _ in layers:
        pack = {}
        for p in keys:
            di, do = targets[p]
            pack[p] = (rng.normal(0.0, scale, (di, rank)).astype(np.float32),
                       rng.normal(0.0, scale, (rank, do)).astype(np.float32))
        out.append(pack)
    return out


def merge_adapter(model, weights, *, alpha: Optional[float] = None) -> int:
    """Fold adapter ``weights`` into ``model``'s projection weights IN
    PLACE: ``W = (W_f32 + A @ B * (alpha/r))`` cast back to W's dtype --
    the merged-weight reference the multi-LoRA identity tests compare the
    batched path against.  Returns the number of projections merged."""
    layers = _decoder_layers(model)
    if len(weights) != len(layers):
        raise ValueError(
            f"adapter carries {len(weights)} layers, model has "
            f"{len(layers)}")
    merged = 0
    with torch.no_grad():
        for layer, pack in zip(layers, weights):
            params = dict(layer.named_parameters())
            for proj, (a, b) in (pack or {}).items():
                a, b = _numpy_f32(a), _numpy_f32(b)
                r = a.shape[1]
                scale = (float(alpha) if alpha is not None else float(r)) / r
                w = params[proj + ".weight"]
                delta = torch.from_numpy((a @ (b * scale)).astype(np.float32))
                w.copy_((w.float() + delta.to(w.device)).to(w.dtype))
                merged += 1
    return merged
