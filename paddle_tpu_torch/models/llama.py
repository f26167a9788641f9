"""Llama model family in PyTorch (``paddle_tpu/models/llama.py``
counterpart).

Ported:
- the uncached forward (``LlamaModel.forward`` without caches) and
  ``LlamaForCausalLM.forward`` with ``labels`` (the ``valid``-masked mean
  cross entropy), with ``causal_lm_loss`` for ``jit.TrainStep``: per
  decoder layer ``fused_rms_rope_qkv`` (the input norm folded in),
  ``scaled_dot_product_attention`` (the flash-attention kernels) and
  ``fused_swiglu_mlp``, all differentiable;
- the paged ragged serving forward (``LlamaModel.forward`` with
  ``caches``, ``block_tables`` and ``span_starts``): ``fused_rms_rope_qkv``,
  ``ragged_paged_attend`` and ``fused_swiglu_mlp``, and
  ``LlamaForCausalLM.logits``;
- the paged bucket-prefill/decode forward (``caches`` and
  ``block_tables`` without ``span_starts``): a prefill writes
  ``[0, seq_lens)`` with ``paged_prefill_write`` and attends causally
  (``scaled_dot_product_attention``, the flash kernel on the card) at
  positions ``arange(S)``; a one-token decode (S == 1 with ``seq_lens``)
  runs ``paged_decode_attend`` (the paged-attention kernel on the card)
  at position ``seq_lens`` (``incubate.nn.functional.paged_attend`` and
  ``paged_positions`` choose the branch and the positions, for GPT too);
- the unfused branch of both (``fused_ops="off"``, and wherever a
  projection is weight-only quantized, as ``_use_fused`` decides): the
  input norm, ``q_proj``/``k_proj``/``v_proj`` and
  ``apply_rotary_pos_emb``; ``down_proj(swiglu(gate_proj(x),
  up_proj(x)))``;
- the dense-cache forward (``caches`` without ``block_tables``): a
  prefill at positions ``arange(S)`` written at ``[0, S)`` of the dense
  caches (``prefill_write_cache``) and attended causally (the flash
  kernel on the card), or a one-token decode at position ``seq_lens``
  (``decode_attend_cache``: the paged-attention kernel over the cache
  read as one page per slot on the card), and ``generate()``
  (``models/generation.py``: greedy, top-k/top-p sampling, repetition
  penalty, EOS freezing, recompute; the decode step captured once into
  a CUDA graph on the card and replayed);
- ``fused_ops="mega"`` (``_use_mega``): on the paged ragged step (only
  there, as in the reference) the decoder layer's whole attention block is ``mega_decode_layer`` (the
  decode megakernel on the card), the MLP after it the fused SwiGLU;
- multi-LoRA: the ``lora`` pair ``(per-layer stack packs, per-slot
  adapter ids)`` threads through the cached forward; each layer then
  takes the unfused branch and adds ``lora_delta`` to q/k/v (before
  RoPE), o, gate, up and down;
- int8 KV caches (``init_cache(dtype="int8")``, the Engine's and
  ``PagedKVCache``'s int8 pools): the 4-tuples thread through every
  cached path unchanged, ``incubate.nn.functional`` choosing the int8
  branch by the tuple's arity; the megakernel is vetoed for them
  (``_use_mega``).
Beam search, context/model parallelism, the
chunked loss and ``fuse_qkv_mlp`` raise ``NotImplementedError``
(ROADMAP.md lists them as still to port).  ``"auto"`` resolves to
``"on"``: in the port every fused entry point serves (the kernel on the
card, the plain version on the CPU); the megakernel is taken only under
``"mega"``.
Parameters are trainable; serving runs under ``torch.no_grad()``.

``named_parameters()`` gives the reference's dotted names
(``model.layers.0.self_attn.q_proj.weight``, ...) with its layouts, so
``models.convert.params_from_numpy`` loads a JAX model's parameters
unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..core.device import resolve_device
from ..nn import functional as F
from ..nn.layers import Embedding, Linear
from .generation import (CachedGenerationMixin, make_dense_caches,
                         run_cached_layers)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "PRESETS",
           "causal_lm_loss", "llama"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    use_recompute: bool = False
    recompute_policy: Optional[str] = None  # full recompute; "dots" saves s×s attn probs = OOM at long seq
    recompute_num_layers: Optional[int] = None  # Megatron-style partial remat: only the first N layers
    sequence_parallel: bool = False
    context_parallel: Optional[str] = None  # None | "ring" | "ulysses" (sep axis)
    pipeline_stages: int = 1        # >1: stacked pp-sharded decoder body
    num_microbatches: Optional[int] = None  # default: pipeline_stages
    virtual_pp_degree: int = 1      # interleaved-schedule chunks per stage
    loss_seq_chunks: int = 1        # >1: rematerialized seq-chunked vocab CE
    fuse_qkv_mlp: bool = False      # trace-time concat of qkv / gate+up kernels
    # fused-kernel library (docs/KERNELS.md): "on" routes norm+rope+qkv
    # and the swiglu MLP through incubate's fused entry points (Pallas
    # kernels on TPU, the equivalent XLA composition elsewhere); "mega"
    # is "on" plus the decode megakernel — the whole decoder-layer
    # attention block (norm→qkv→rope→ragged attention→o_proj+residual)
    # as ONE dispatch on the ragged serving step
    # (ops/pallas/mega_decode.py; XLA composition off-TPU and wherever
    # its supported() gate declines); "auto" fuses only where a kernel
    # will actually serve (TPU, no mesh, not vetoed by
    # tools/tuned_configs.json) so CPU behavior is unchanged; "off"
    # keeps the unfused projections.  Takes precedence over
    # fuse_qkv_mlp where both apply.
    fused_ops: str = "auto"
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def num_params(self) -> int:
        h, i, v, l = (self.hidden_size, self.intermediate_size,
                      self.vocab_size, self.num_hidden_layers)
        kvh = self.num_key_value_heads * self.head_dim
        per_layer = h * h + 2 * h * kvh + h * h + 3 * h * i + 2 * h
        embed = v * h * (1 if self.tie_word_embeddings else 2)
        return l * per_layer + embed + h


PRESETS = {
    "llama2-7b": LlamaConfig(),
    "llama2-13b": LlamaConfig(hidden_size=5120, intermediate_size=13824,
                              num_hidden_layers=40, num_attention_heads=40,
                              num_key_value_heads=40),
    "llama2-70b": LlamaConfig(hidden_size=8192, intermediate_size=28672,
                              num_hidden_layers=80, num_attention_heads=64,
                              num_key_value_heads=8),
    "llama-1b": LlamaConfig(hidden_size=2048, intermediate_size=5504,
                            num_hidden_layers=16, num_attention_heads=16,
                            num_key_value_heads=16, vocab_size=32000),
    "llama-350m": LlamaConfig(hidden_size=1024, intermediate_size=2816,
                              num_hidden_layers=24, num_attention_heads=16,
                              num_key_value_heads=16),
    # same parameter count as llama-350m but 8 heads of head_dim 128 — the
    # north-star's (Llama-2-7B) attention geometry, where qk/sv matmuls
    # fill the 128-wide MXU instead of running K/N=64 at half occupancy
    "llama-350m-hd128": LlamaConfig(hidden_size=1024, intermediate_size=2816,
                                    num_hidden_layers=24,
                                    num_attention_heads=8,
                                    num_key_value_heads=8),
    "tiny": LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, max_position_embeddings=128),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_TODO = " is not ported yet (ROADMAP.md, queue 1)"


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]


class _Init:
    """Where and how parameters are made: device, dtype, generator (a
    Llama or GPT config: its ``dtype`` and ``initializer_range``)."""

    def __init__(self, cfg, device, generator):
        self.device = device
        self.dtype = torch_dtype(cfg.dtype)
        self.generator = generator
        self.std = cfg.initializer_range

    def linear(self, fan_in, fan_out, bias: bool = False):
        return Linear(fan_in, fan_out, bias=bias, std=self.std,
                      device=self.device, dtype=self.dtype,
                      generator=self.generator)


def _use_fused(cfg: LlamaConfig, layers) -> bool:
    """Whether a fused entry point serves the projections ``layers``:
    not under ``fused_ops="off"``, and never for a weight-only quantized
    projection -- its ``.weight`` holds int codes with the scale in a
    separate buffer, which the fused entries (reading ``.weight``
    directly) would drop; its fusion is the int8/int4 matmul kernel in
    the layer's own forward instead (the reference's ``_use_fused``)."""
    if any(hasattr(l, "weight_scale") for l in layers):
        return False
    return cfg.fused_ops != "off"


class LlamaRMSNorm(nn.Module):
    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        self.eps = cfg.rms_norm_eps
        self.weight = nn.Parameter(
            torch.ones(cfg.hidden_size, device=init.device, dtype=init.dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        h, hd = cfg.hidden_size, cfg.head_dim
        kv = cfg.num_key_value_heads * hd
        self.q_proj = init.linear(h, cfg.num_attention_heads * hd)
        self.k_proj = init.linear(h, kv)
        self.v_proj = init.linear(h, kv)
        self.o_proj = init.linear(cfg.num_attention_heads * hd, h)

    def forward(self, x, cos, sin, norm_weight, attn_mask=None, cache=None,
                seq_lens=None, block_tables=None, span_starts=None,
                lora=None):
        """With ``norm_weight``, ``x`` is the UN-normed residual stream and
        the input layernorm folds into the fused norm->qkv->rope kernel;
        without it (the unfused branch) ``x`` is already normed and goes
        through the three projections and ``apply_rotary_pos_emb``.
        cos/sin are (S, head_dim) or per-slot (B, S, head_dim).  Without
        a cache: causal attention over the sequence, returns
        ``o_proj(attn)``.  With a cache returns ``(o_proj(attn), cache)``.
        Dense caches (no ``block_tables``): one-token decode with S == 1
        and ``seq_lens``, else a prefill written at ``[0, S)``.  Paged
        pools: the ragged serving branch with ``span_starts``; one-token
        decode with S == 1 and ``seq_lens`` (the tokens already cached);
        else the bucket prefill, written at ``[0, seq_lens)`` (all S rows
        without ``seq_lens``).  ``lora`` (unfused branch only)
        adds each slot's adapter delta to the q/k/v projections before
        RoPE and to the O projection."""
        from ..incubate.nn.functional import (fused_rms_rope_qkv,
                                              lora_delta, paged_attend)
        cfg = self.cfg
        b, s = x.shape[:2]
        hd = cfg.head_dim
        if norm_weight is not None:
            c2, s2 = (cos, sin) if cos.ndim == 3 else \
                (t[None].expand(b, s, hd) for t in (cos, sin))
            q, k, v = fused_rms_rope_qkv(
                x.reshape(b * s, cfg.hidden_size), norm_weight,
                self.q_proj.weight, self.k_proj.weight, self.v_proj.weight,
                c2.reshape(b * s, hd), s2.reshape(b * s, hd), hd,
                cfg.rms_norm_eps)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
            if lora is not None:
                # slot 0 rows add an exact 0.0: base requests unchanged
                dq = lora_delta(lora, x, "self_attn.q_proj")
                dk = lora_delta(lora, x, "self_attn.k_proj")
                dv = lora_delta(lora, x, "self_attn.v_proj")
                q = q if dq is None else q + dq
                k = k if dk is None else k + dk
                v = v if dv is None else v + dv
        q = q.reshape(b, s, cfg.num_attention_heads, hd)
        k = k.reshape(b, s, cfg.num_key_value_heads, hd)
        v = v.reshape(b, s, cfg.num_key_value_heads, hd)
        if norm_weight is None:
            q, k = F.apply_rotary_pos_emb(q, k, cos, sin)
        if cache is None:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None)
            return self.o_proj(out.reshape(b, s, cfg.num_attention_heads
                                           * hd))
        out, cache = paged_attend(cache, q, k, v, block_tables, seq_lens,
                                  span_starts)
        out = out.reshape(b, s, cfg.num_attention_heads * hd)
        y = self.o_proj(out)
        d = lora_delta(lora, out, "self_attn.o_proj")
        return (y if d is None else y + d), cache


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = init.linear(h, i)
        self.up_proj = init.linear(h, i)
        self.down_proj = init.linear(i, h)

    def forward(self, x, lora=None):
        from ..incubate.nn.functional import fused_swiglu_mlp, lora_delta
        if lora is not None:
            # the gate/up deltas need x and the down delta the swiglu
            # intermediate, which the one-pass fused kernel never
            # materializes: the LoRA path is the unfused composition
            g, u = self.gate_proj(x), self.up_proj(x)
            dg = lora_delta(lora, x, "mlp.gate_proj")
            du = lora_delta(lora, x, "mlp.up_proj")
            g = g if dg is None else g + dg
            u = u if du is None else u + du
            h = F.swiglu(g, u)
            y = self.down_proj(h)
            dd = lora_delta(lora, h, "mlp.down_proj")
            return y if dd is None else y + dd
        if not _use_fused(self.cfg, (self.gate_proj, self.up_proj,
                                     self.down_proj)):
            return self.down_proj(F.swiglu(self.gate_proj(x),
                                           self.up_proj(x)))
        h = self.cfg.hidden_size
        lead = x.shape[:-1]
        y = fused_swiglu_mlp(x.reshape(-1, h), self.gate_proj.weight,
                             self.up_proj.weight, self.down_proj.weight)
        return y.reshape(*lead, h)


class LlamaDecoderLayer(nn.Module):
    supports_paged = True   # paged-pool serving path (serving.Engine)
    supports_cache = True   # dense KV caches (generate())

    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = LlamaRMSNorm(cfg, init)
        self.self_attn = LlamaAttention(cfg, init)
        self.post_attention_layernorm = LlamaRMSNorm(cfg, init)
        self.mlp = LlamaMLP(cfg, init)

    def _attn_input(self, x):
        """(attention input, norm_weight): under the fused qkv op the
        layernorm folds into the attention projection -- hand the raw
        residual stream and the norm weight down instead of norming
        here."""
        attn = self.self_attn
        if _use_fused(self.cfg, (attn.q_proj, attn.k_proj, attn.v_proj)):
            return x, self.input_layernorm.weight
        return self.input_layernorm(x), None

    def _use_mega(self, cache) -> bool:
        """Whether the paged step's attention block is the one
        ``mega_decode_layer`` entry: only under ``fused_ops="mega"``, never
        for quantized projections (``_use_fused``'s veto) and never for
        int8 KV pools (the 4-tuple ``cache``), which the megakernel does
        not read -- in the reference it declines them too
        (``ops/pallas/mega_decode.py``), so their layer runs the fused
        QKV kernel, the int8 ragged composition and ``o_proj``.  On the
        card the kernel then serves or raises; the LoRA path never
        reaches here (the caller pins the unfused branch)."""
        attn = self.self_attn
        return self.cfg.fused_ops == "mega" and len(cache) == 2 and \
            _use_fused(
            self.cfg, (attn.q_proj, attn.k_proj, attn.v_proj, attn.o_proj))

    def forward(self, x, cos, sin, attn_mask=None, cache=None,
                seq_lens=None, block_tables=None, span_starts=None,
                lora=None):
        """Without a cache returns ``x``; with the paged pools returns
        ``(x, cache)``."""
        if cache is not None and span_starts is not None and lora is None \
                and self._use_mega(cache):
            from ..incubate.nn.functional import mega_decode_layer
            cfg = self.cfg
            b, s = x.shape[:2]
            hd = cfg.head_dim
            c2, s2 = (cos, sin) if cos.ndim == 3 else \
                (t[None].expand(b, s, hd).contiguous() for t in (cos, sin))
            attn = self.self_attn
            x, cache = mega_decode_layer(
                x, self.input_layernorm.weight, attn.q_proj.weight,
                attn.k_proj.weight, attn.v_proj.weight, attn.o_proj.weight,
                c2, s2, cache, block_tables, span_starts, seq_lens, hd,
                cfg.rms_norm_eps)
            x = x + self.mlp(self.post_attention_layernorm(x))
            return x, cache
        if lora is None:
            attn_in, nw = self._attn_input(x)
        else:
            # LoRA deltas land before RoPE, which the fused
            # norm->qkv->rope pass cannot expose: the unfused branch
            attn_in, nw = self.input_layernorm(x), None
        if cache is None:
            attn = self.self_attn(attn_in, cos, sin, nw, attn_mask)
        else:
            attn, cache = self.self_attn(attn_in, cos, sin, nw, cache=cache,
                                         seq_lens=seq_lens,
                                         block_tables=block_tables,
                                         span_starts=span_starts, lora=lora)
        x = x + attn
        x = x + self.mlp(self.post_attention_layernorm(x), lora=lora)
        return x if cache is None else (x, cache)


class LlamaModel(nn.Module):
    decoder_layer_cls = LlamaDecoderLayer

    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size,
                                      std=init.std, device=init.device,
                                      dtype=init.dtype,
                                      generator=init.generator)
        self.layers = nn.ModuleList(
            [type(self).decoder_layer_cls(cfg, init)
             for _ in range(cfg.num_hidden_layers)])
        self.norm = LlamaRMSNorm(cfg, init)

    def init_cache(self, batch, max_len, dtype=None):
        """Per-layer dense (k, v) caches for cached generation on the
        model's device; dtype defaults to the config's, and ``"int8"``
        gives the quantized 4-tuples (``make_dense_caches``)."""
        cfg = self.cfg
        return make_dense_caches(
            cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads,
            cfg.head_dim, dtype if dtype is not None else cfg.dtype,
            device=self.embed_tokens.weight.device)

    def forward(self, input_ids, attn_mask=None, position_ids=None,
                caches=None, seq_lens=None, block_tables=None,
                span_starts=None, lora=None):
        if caches is None:
            cfg = self.cfg
            x = self.embed_tokens(input_ids)
            cos, sin = F.rope_cos_sin(input_ids.shape[1], cfg.head_dim,
                                      base=cfg.rope_theta, dtype=x.dtype,
                                      position_ids=position_ids,
                                      device=x.device)
            for layer in self.layers:
                x = layer(x, cos, sin, attn_mask)
            return self.norm(x)
        if attn_mask is not None or position_ids is not None:
            raise NotImplementedError(
                "cached forward supports causal spans only — "
                "attn_mask/position_ids would be silently ignored")
        return self._forward_cached(input_ids, caches, seq_lens,
                                    block_tables, span_starts, lora)

    def _forward_cached(self, input_ids, caches, seq_lens,
                        block_tables=None, span_starts=None, lora=None):
        """The cached forward.  Without ``block_tables`` the caches are
        dense (``init_cache``): S == 1 with ``seq_lens`` is one decode
        token per slot at position ``seq_lens``; otherwise a prefill at
        positions ``arange(S)``, written at ``[0, S)``.  With them the
        paged pools: with ``span_starts`` the unified RAGGED step: per-slot
        spans (chunked prefill or decode tokens) at positions
        ``[start, start+len)``, ``seq_lens`` carrying the span lengths;
        without it the bucket-prefill/decode path: S == 1 with
        ``seq_lens`` is one decode token per slot at position
        ``seq_lens``; otherwise a prefill at positions ``arange(S)``,
        ``seq_lens`` the prompt lengths.  ``lora`` is the multi-LoRA pair
        (per-layer stacked adapter packs, per-slot adapter ids): each
        decoder layer gets its own pack.  Returns ``(hidden, caches)``;
        the caches are written in place."""
        cfg = self.cfg
        if lora is not None and len(lora[0]) != len(self.layers):
            raise ValueError(
                f"LoRA packs for {len(lora[0])} layers, the model has "
                f"{len(self.layers)}")
        x = self.embed_tokens(input_ids)
        from ..incubate.nn.functional import paged_positions
        s = input_ids.shape[1]
        pos = paged_positions(s, seq_lens, span_starts, input_ids.device)
        cos, sin = F.rope_cos_sin(s, cfg.head_dim, base=cfg.rope_theta,
                                  dtype=x.dtype, position_ids=pos,
                                  device=x.device)
        # each layer its own LoRA pack, in stack order
        packs = iter(lora[0]) if lora is not None else None
        x, new_caches = run_cached_layers(
            self.layers, x, caches,
            lambda layer, x, cache: layer(
                x, cos, sin, cache=cache, seq_lens=seq_lens,
                block_tables=block_tables, span_starts=span_starts,
                lora=None if packs is None else (next(packs), lora[1])))
        return self.norm(x), new_caches


class LlamaForCausalLM(CachedGenerationMixin, nn.Module):
    model_cls = LlamaModel

    def __init__(self, cfg: LlamaConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mode = getattr(cfg, "fused_ops", "auto")
        if mode not in ("on", "auto", "off", "mega"):
            raise ValueError(f"fused_ops={mode!r}: expected on|off|auto|mega")
        if cfg.fuse_qkv_mlp:
            raise NotImplementedError("fuse_qkv_mlp" + _TODO)
        if cfg.pipeline_stages != 1 or cfg.sequence_parallel \
                or cfg.context_parallel:
            raise NotImplementedError("model parallelism" + _TODO)
        if cfg.use_recompute:
            raise NotImplementedError("use_recompute" + _TODO)
        self.cfg = cfg
        init = _Init(cfg, resolve_device(device), generator)
        self.model = type(self).model_cls(cfg, init)
        if not cfg.tie_word_embeddings:
            self.lm_head = init.linear(cfg.hidden_size, cfg.vocab_size)

    def logits(self, hidden):
        if self.cfg.tie_word_embeddings:
            w = self.model.embed_tokens.weight
            return hidden @ w.to(hidden.dtype).T
        return self.lm_head(hidden)

    def _cache_supported(self) -> bool:
        return getattr(type(self.model).decoder_layer_cls, "supports_cache",
                       False)

    def forward(self, input_ids, labels=None, attn_mask=None,
                position_ids=None):
        """Logits, or with ``labels`` the mean cross entropy over the
        labels that are not -100 (f32)."""
        hidden = self.model(input_ids, attn_mask, position_ids)
        if labels is None:
            return self.logits(hidden)
        if self.cfg.loss_seq_chunks > 1:
            raise NotImplementedError("loss_seq_chunks > 1" + _TODO)
        logits = self.logits(hidden)
        loss = F.cross_entropy(logits.float(), labels, reduction="none",
                               ignore_index=-100)
        valid = labels != -100
        return (loss * valid).sum() / torch.clamp(valid.sum(), min=1)


def llama(name_or_config="tiny", *, device=None, seed: int = 0,
          **overrides) -> LlamaForCausalLM:
    """Build a Llama from a preset name or a config, with random weights
    drawn from ``torch.Generator(device).manual_seed(seed)`` on
    ``device`` (default: the CUDA card; raises without one unless
    ``device="cpu"``)."""
    cfg = (PRESETS[name_or_config] if isinstance(name_or_config, str)
           else name_or_config)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return LlamaForCausalLM(cfg, device=dev, generator=gen)


def causal_lm_loss(model, batch):
    """Standard loss_fn for TrainStep."""
    return model(batch["input_ids"], labels=batch["labels"])
