"""GPT / ERNIE-style decoder family in PyTorch (``paddle_tpu/models/gpt.py``
counterpart): learned absolute position embeddings (no RoPE), full
multi-head attention with a packed, biased ``qkv_proj``, LayerNorm with
biases, and the GELU 4h FFN.

Ported:
- the uncached forward and ``GPTForCausalLM.forward`` with ``labels``
  (the ``valid``-masked mean cross entropy);
- the paged serving forward (``GPTModel.forward`` with ``caches`` and
  ``block_tables``), in its three branches: the ragged step
  (``span_starts``: ``ragged_paged_attend``), which ``serving.Engine``
  drives; the bucket prefill (``paged_prefill_write`` and causal
  ``scaled_dot_product_attention``, the flash-attention kernel on the
  card); and the one-token decode (``paged_decode_attend``, the
  paged-attention kernel on the card);
- the dense-cache forward (``caches`` without ``block_tables``) and
  ``generate()`` (``models/generation.py``), as for the port's Llama;
  the caches hold ``num_attention_heads`` heads (no GQA);
- ``GPTMLP`` fused (``fused_gelu_mlp``, the fused GELU-MLP kernel on the
  card) and unfused (``fc_out(gelu(fc_in(x)))``).  ``"auto"`` resolves
  to ``"on"``, as for the port's Llama: ``"on"``, ``"auto"`` and
  ``"mega"`` (whose megakernel is Llama's) take the fused entry, which
  launches the kernel on the card or raises naming the shape or dtype it
  cannot take (H and F multiples of 128, f32 or bf16), and runs the
  plain version on the CPU; ``"off"`` and weight-only quantized
  projections (``_use_fused``'s veto) take the unfused branch;
- int8 KV caches, dense and paged, as for the port's Llama.
Pipeline stages, sequence parallelism, recompute, dropout, multi-LoRA
and beam search raise ``NotImplementedError``
(ROADMAP.md lists them as still to port).

Learned positions past the table.  The ragged step gives each slot's
span rows the positions ``start + j``; a slot's padding rows near the end
of a sequence run past ``max_position_embeddings``.  The reference's
``jnp.take`` fills those rows with NaN, rows nobody reads; a torch index
past the table raises (a device-side assert on the card), so positions
are clamped to the table's last row.

``named_parameters()`` gives the reference's dotted names
(``model.h.0.attn.qkv_proj.weight``, ...) with its layouts, so
``models.convert.params_from_numpy`` loads a JAX GPT unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..core.device import resolve_device
from ..nn import functional as F
from ..nn.layers import Embedding, LayerNorm
from .generation import (CachedGenerationMixin, make_dense_caches,
                         run_cached_layers)
from .llama import _TODO, _Init, _use_fused

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "PRESETS", "gpt"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    intermediate_size: Optional[int] = None      # default 4h
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    use_recompute: bool = False
    recompute_policy: Optional[str] = None
    recompute_num_layers: Optional[int] = None  # Megatron-style partial remat
    sequence_parallel: bool = False
    pipeline_stages: int = 1
    num_microbatches: Optional[int] = None
    virtual_pp_degree: int = 1
    # GPT's qkv is already one matmul and its norm is LayerNorm, so the
    # flag routes only the 4h GELU FFN through incubate.fused_gelu_mlp
    # (the fused GELU-MLP kernel on the card, its plain version on the
    # CPU); "auto" is "on", "off" keeps the unfused composition.
    fused_ops: str = "auto"
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size


PRESETS = {
    # GPT-3 ladder (PaddleNLP gpt3 configs)
    "gpt2-345m": GPTConfig(),
    "gpt3-1.3b": GPTConfig(hidden_size=2048, num_hidden_layers=24,
                           num_attention_heads=32,
                           max_position_embeddings=2048),
    "gpt3-6.7b": GPTConfig(hidden_size=4096, num_hidden_layers=32,
                           num_attention_heads=32,
                           max_position_embeddings=2048),
    # BASELINE configs[1]: 13B decoder for TP+PP
    "gpt3-13b": GPTConfig(hidden_size=5120, num_hidden_layers=40,
                          num_attention_heads=40,
                          max_position_embeddings=2048),
    # ERNIE-style base (ernie-3.0 dense decoder shape)
    "ernie-base": GPTConfig(vocab_size=40000, hidden_size=768,
                            num_hidden_layers=12, num_attention_heads=12,
                            max_position_embeddings=2048),
    "tiny": GPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, max_position_embeddings=128),
}


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.qkv_proj = init.linear(h, 3 * h, bias=True)
        self.out_proj = init.linear(h, h, bias=True)

    def forward(self, x, attn_mask=None, cache=None, seq_lens=None,
                block_tables=None, span_starts=None):
        """``x`` is ln_1-normed.  Without a cache: causal (or masked)
        attention over the sequence, returns ``out_proj(attn)``.  With
        the dense caches or the paged pools returns ``(out_proj(attn),
        cache)``, the branch chosen by
        ``incubate.nn.functional.paged_attend``."""
        from ..incubate.nn.functional import paged_attend
        cfg = self.cfg
        b, s = x.shape[:2]
        qkv = self.qkv_proj(x).reshape(b, s, 3, cfg.num_attention_heads,
                                       cfg.head_dim)
        q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
        if cache is None:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None,
                dropout_p=cfg.attention_dropout, training=self.training)
            return self.out_proj(out.reshape(b, s, cfg.hidden_size))
        out, cache = paged_attend(cache, q, k, v, block_tables, seq_lens,
                                  span_starts)
        return self.out_proj(out.reshape(b, s, cfg.hidden_size)), cache


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        self.fc_in = init.linear(cfg.hidden_size, cfg.ffn_size, bias=True)
        self.fc_out = init.linear(cfg.ffn_size, cfg.hidden_size, bias=True)

    def forward(self, x):
        from ..incubate.nn.functional import fused_gelu_mlp
        if not _use_fused(self.cfg, (self.fc_in, self.fc_out)):
            return self.fc_out(F.gelu(self.fc_in(x)))
        h = self.cfg.hidden_size
        y = fused_gelu_mlp(x.reshape(-1, h), self.fc_in.weight,
                           self.fc_in.bias, self.fc_out.weight,
                           self.fc_out.bias)
        return y.reshape(*x.shape[:-1], h)


class GPTDecoderLayer(nn.Module):
    supports_paged = True   # paged-pool serving path (serving.Engine)
    supports_cache = True   # dense KV caches (generate())

    def __init__(self, cfg: GPTConfig, init: _Init):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.ln_1 = LayerNorm(cfg.hidden_size, epsilon=eps,
                              device=init.device, dtype=init.dtype)
        self.attn = GPTAttention(cfg, init)
        self.ln_2 = LayerNorm(cfg.hidden_size, epsilon=eps,
                              device=init.device, dtype=init.dtype)
        self.mlp = GPTMLP(cfg, init)

    def forward(self, x, attn_mask=None, cache=None, seq_lens=None,
                block_tables=None, span_starts=None):
        """Without a cache returns ``x``; with the paged pools returns
        ``(x, cache)``."""
        if cache is None:
            x = x + self.attn(self.ln_1(x), attn_mask)
            return x + self.mlp(self.ln_2(x))
        attn, cache = self.attn(self.ln_1(x), attn_mask, cache=cache,
                                seq_lens=seq_lens, block_tables=block_tables,
                                span_starts=span_starts)
        x = x + attn
        return x + self.mlp(self.ln_2(x)), cache


class GPTModel(nn.Module):
    decoder_layer_cls = GPTDecoderLayer

    def __init__(self, cfg: GPTConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        emb = dict(std=init.std, device=init.device, dtype=init.dtype,
                   generator=init.generator)
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size, **emb)
        self.embed_positions = Embedding(cfg.max_position_embeddings,
                                         cfg.hidden_size, **emb)
        self.h = nn.ModuleList(
            [type(self).decoder_layer_cls(cfg, init)
             for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                              device=init.device, dtype=init.dtype)

    def _embed(self, input_ids, pos):
        """Token plus learned position embeddings; positions clamped to
        the table (see the module note)."""
        pos = pos.clamp(0, self.cfg.max_position_embeddings - 1)
        return self.embed_tokens(input_ids) + self.embed_positions(pos)

    def init_cache(self, batch, max_len, dtype=None):
        """Per-layer dense (k, v) caches for cached generation on the
        model's device (``"int8"``: the quantized 4-tuples of
        ``make_dense_caches``).  A capacity past the learned position
        table raises."""
        cfg = self.cfg
        if max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_len {max_len} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings} (learned positions)")
        return make_dense_caches(
            cfg.num_hidden_layers, batch, max_len, cfg.num_attention_heads,
            cfg.head_dim, dtype if dtype is not None else cfg.dtype,
            device=self.embed_tokens.weight.device)

    def forward(self, input_ids, attn_mask=None, position_ids=None,
                caches=None, seq_lens=None, block_tables=None,
                span_starts=None, lora=None):
        if caches is not None:
            if attn_mask is not None or position_ids is not None:
                raise NotImplementedError(
                    "cached forward supports causal spans only — "
                    "attn_mask/position_ids would be silently ignored")
            return self._forward_cached(input_ids, caches, seq_lens,
                                        block_tables, span_starts, lora)
        s = input_ids.shape[1]
        if s > self.cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {s} exceeds "
                f"max_position_embeddings={self.cfg.max_position_embeddings}")
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None, :]
        x = self._embed(input_ids, position_ids)
        for layer in self.h:
            x = layer(x, attn_mask)
        return self.ln_f(x)

    def _forward_cached(self, input_ids, caches, seq_lens,
                        block_tables=None, span_starts=None, lora=None):
        """The cached forward, over dense caches without
        ``block_tables`` or the paged pools with them: with
        ``span_starts`` the ragged step (spans at ``[start, start +
        len)``, ``seq_lens`` the span lengths); with S == 1 and
        ``seq_lens`` one decode token per slot at position ``seq_lens``;
        else a prefill at positions ``arange(S)`` (paged: ``seq_lens``
        the prompt lengths).  Returns ``(hidden, caches)``; the caches
        are written in place."""
        if lora is not None:
            raise NotImplementedError("multi-LoRA GPT serving" + _TODO)
        from ..incubate.nn.functional import paged_positions
        s = input_ids.shape[1]
        pos = paged_positions(s, seq_lens, span_starts, input_ids.device)
        if pos is None:
            pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self._embed(input_ids, pos)
        x, new_caches = run_cached_layers(
            self.h, x, caches,
            lambda layer, x, cache: layer(
                x, cache=cache, seq_lens=seq_lens,
                block_tables=block_tables, span_starts=span_starts))
        return self.ln_f(x), new_caches


class GPTForCausalLM(CachedGenerationMixin, nn.Module):
    model_cls = GPTModel
    # Engine options the port does not serve for GPT yet (ROADMAP.md)
    engine_options_not_ported = ("weight_quant", "lora")

    def __init__(self, cfg: GPTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mode = getattr(cfg, "fused_ops", "auto")
        if mode not in ("on", "auto", "off", "mega"):
            raise ValueError(f"fused_ops={mode!r}: expected on|off|auto|mega")
        if cfg.pipeline_stages != 1:
            raise NotImplementedError("pipeline_stages > 1" + _TODO)
        if cfg.sequence_parallel:
            raise NotImplementedError("sequence_parallel" + _TODO)
        if cfg.use_recompute:
            raise NotImplementedError("use_recompute" + _TODO)
        if cfg.hidden_dropout or cfg.attention_dropout:
            raise NotImplementedError("dropout" + _TODO)
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
        return self.cfg.pipeline_stages == 1

    def forward(self, input_ids, labels=None, attn_mask=None,
                position_ids=None):
        """Logits, or with ``labels`` the mean cross entropy over the
        labels that are not -100 (f32)."""
        logits = self.logits(self.model(input_ids, attn_mask, position_ids))
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.float(), labels, reduction="none",
                               ignore_index=-100)
        valid = labels != -100
        return (loss * valid).sum() / torch.clamp(valid.sum(), min=1)


def gpt(name_or_config="tiny", *, device=None, seed: int = 0,
        **overrides) -> GPTForCausalLM:
    """Build a GPT from a preset name or a config, with random weights
    drawn from ``torch.Generator(device).manual_seed(seed)`` on
    ``device`` (default: the CUDA card; raises without one unless
    ``device="cpu"``)."""
    cfg = (PRESETS[name_or_config] if isinstance(name_or_config, str)
           else name_or_config)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return GPTForCausalLM(cfg, device=dev, generator=gen)
