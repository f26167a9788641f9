"""``paddle_tpu.incubate.nn.functional`` counterpart: the fused entry
points of the serving path, with the reference's signatures.

``fused_rms_rope_qkv``, ``fused_swiglu_mlp``, ``fused_gelu_mlp``,
``ragged_paged_attend``, ``paged_attention`` (and ``paged_decode_attend``
through it), ``mega_decode_layer`` and ``lora_bgmv`` launch their
hand-written kernels (``ops/cuda``) on CUDA tensors and run the plain
versions on CPU tensors.  The ``_..._ref``/``_paged_*``/
``_attend_dense_gqa`` names are the plain versions under the reference's
names.  ``_paged_span_write``, ``write_paged_kv``, ``paged_prefill_write``
and ``paged_copy_blocks`` are plain indexed tensor code here as in the
reference, where they are not Pallas kernels either.

The dense-cache pair ``prefill_write_cache`` / ``decode_attend_cache``
(``masked_multihead_attention``) serves ``generate()``: the reference
attends the dense cache by composition, the port by the paged-attention
kernel over the cache read as one page per slot
(``ops/cuda/paged_attention.dense_attention``) on the card, and by the
composition's twin ``_attend_dense_gqa`` on the CPU.  The one-token write
is one fixed-shape ``index_copy_`` per cache, so a captured decode step
never syncs the host.

int8 KV caches.  A cache tuple of four -- ``(k_i8, v_i8, k_scale,
v_scale)``, f32 scales per (position, head) from :func:`quantize_kv` --
is the reference's quantized layout, dense or paged; every entry point
here chooses its branch by the tuple's arity, as the reference does.  The
reference's attention kernels read fp caches only, so it attends int8
caches through a gather+dequant composition on every backend, and so does
the port, on the card too: the paged and ragged steps gather the pages
and dequantize K and V in f32 (``_paged_gather_dense``), the dense decode
dequantizes K in bf16 and V in f32 (``masked_multihead_attention``), each
as the reference does.  The kernel wrappers raise on int8 pools.  The
quantized writes run the same fixed-shape index code as the fp ones (the
scales are two more pools), so the captured steps stay sync-free.

``fused_swiglu_mlp``, ``fused_gelu_mlp`` and ``fused_rms_rope_qkv`` are
differentiable: each
is a ``torch.autograd.Function`` whose forward is the kernel (the plain
version on the CPU) and whose backward recomputes through the plain
composition under autograd, exactly as the reference's ``custom_vjp``
takes ``jax.vjp`` of its ``_ref``.  The reference has no backward kernel
for either op, so gradients come from the plain arithmetic.  Its products
are f32 (``a.float() @ b.float()``).  For bf16 inputs (amp O2) the
backward runs them at TF32 on the card: bf16 operands are exact in TF32,
and f32 intermediate gradients (the cotangents, ``silu(x Wg)`` and the
like) are rounded to TF32's 10-bit mantissa.  That is finer than the
reference's own arithmetic on its home chip, whose default-precision f32
products take single bf16 passes (8 bits).  With f32 inputs the backward
keeps PyTorch's global setting (full f32 by default).

Out-of-range block ids.  The serving scheduler makes dead slots and
warmup inert by pointing block tables at the sentinel id ``num_blocks``.
JAX drops out-of-range scatters and clamps gathers; PyTorch raises (and a
CUDA device-side assert kills the process).  So the span write, the
decode write and the page copy mask dead entries out before indexing,
and the gather clamps.  Unlike the reference, the writes update the pools
IN PLACE (the engine owns exactly one copy of its pools) and return the
same tensors.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from ...ops.cuda import fused_gelu_mlp as _fg
from ...ops.cuda import fused_mlp as _fm
from ...ops.cuda import fused_norm_qkv as _fq
from ...ops.cuda import lora_matmul as _lm
from ...ops.cuda import mega_decode as _md
from ...ops.cuda import paged_attention as _pa
from ...ops.cuda import ragged_attention as _ra
from ...ops.cuda._common import dot_f32

__all__ = ["decode_attend_cache", "dense_attend", "fused_gelu_mlp",
           "fused_rms_rope_qkv", "fused_swiglu_mlp", "lora_bgmv", "lora_delta",
           "masked_multihead_attention", "mega_decode_layer",
           "paged_attend", "paged_attention", "paged_copy_blocks",
           "paged_decode_attend", "paged_positions", "paged_prefill_write",
           "prefill_write_cache", "quantize_kv", "ragged_paged_attend",
           "read_cache_prefix", "write_paged_kv"]

_fused_swiglu_mlp_ref = _fm.plain
_fused_gelu_mlp_ref = _fg.plain
_fused_rms_rope_qkv_ref = _fq.plain
_lora_bgmv_ref = _lm.plain
_paged_gather_dense = _ra.paged_gather_dense
_ragged_attend_dense = _ra.ragged_attend_dense
_attend_dense_gqa = _pa.attend_dense_gqa


@contextlib.contextmanager
def _backward_precision(dtype: torch.dtype):
    """TF32 products on the card for 16-bit ``dtype``, restored after;
    no change for f32 (see the module note)."""
    if dtype not in (torch.bfloat16, torch.float16):
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _vjp_of_plain(ctx, plain_fn, cts):
    """Gradients of ``plain_fn(*saved)`` for the inputs that need them,
    recomputed under autograd (the reference's ``jax.vjp(_ref, ...)``)."""
    saved = ctx.saved_tensors
    ins = [t.detach().requires_grad_(need)
           for t, need in zip(saved, ctx.needs_input_grad)]
    wanted = [t for t in ins if t.requires_grad]
    with torch.enable_grad(), _backward_precision(saved[0].dtype):
        outs = plain_fn(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        grads = iter(torch.autograd.grad(outs, wanted, cts,
                                         allow_unused=True)
                     if wanted else ())
    return [next(grads) if t.requires_grad else None for t in ins]


class _FusedSwigluMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down):
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        dt = x.dtype
        return _fm.fused_swiglu_mlp(x, w_gate.to(dt), w_up.to(dt),
                                    w_down.to(dt))

    @staticmethod
    def backward(ctx, ct):
        return tuple(_vjp_of_plain(ctx, _fm.plain, (ct,)))


class _FusedGeluMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        dt = x.dtype
        return _fg.fused_gelu_mlp(x, w1.to(dt), b1, w2.to(dt), b2)

    @staticmethod
    def backward(ctx, ct):
        return tuple(_vjp_of_plain(ctx, _fg.plain, (ct,)))


class _FusedRmsRopeQkv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, norm_weight, w_q, w_k, w_v, cos, sin, head_dim,
                eps):
        ctx.save_for_backward(x, norm_weight, w_q, w_k, w_v, cos, sin)
        ctx.head_dim, ctx.eps = head_dim, eps
        dt = x.dtype
        return _fq.fused_rms_rope_qkv(x, norm_weight.to(dt), w_q.to(dt),
                                      w_k.to(dt), w_v.to(dt), cos.to(dt),
                                      sin.to(dt), head_dim, eps)

    @staticmethod
    def backward(ctx, cq, ck, cv):
        grads = _vjp_of_plain(
            ctx, lambda *a: _fq.plain(*a, ctx.head_dim, ctx.eps),
            (cq, ck, cv))
        return (*grads, None, None)


def fused_swiglu_mlp(x, w_gate, w_up, w_down):
    """``silu(x @ Wg) * (x @ Wu) @ Wd`` in one kernel.  x: (T, H);
    returns (T, H) in x.dtype."""
    return _FusedSwigluMLP.apply(x, w_gate, w_up, w_down)


def fused_gelu_mlp(x, w1, b1, w2, b2):
    """``gelu(x @ W1 + b1) @ W2 + b2`` in one kernel (GPT's 4h FFN).
    x: (T, H); w1 (H, F); b1 (F,); w2 (F, H); b2 (H,); returns (T, H) in
    x.dtype."""
    return _FusedGeluMLP.apply(x, w1, b1, w2, b2)


def fused_rms_rope_qkv(x, norm_weight, w_q, w_k, w_v, cos, sin,
                       head_dim: int, eps: float = 1e-5):
    """rms_norm -> q/k/v projections -> rotate-half rope on q/k in one
    kernel.  x: (T, H); norm_weight: (H,); w_q: (H, Nq); w_k/w_v:
    (H, Nk); cos/sin: (T, head_dim).  Returns ``(q, k, v)`` in x.dtype."""
    return _FusedRmsRopeQkv.apply(x, norm_weight, w_q, w_k, w_v, cos, sin,
                                  head_dim, eps)


def quantize_kv(x):
    """THE int8 KV quantizer: symmetric, per (..., head) over the last
    axis.  ``s = max|x| / 127 + 1e-12`` in f32, values ``round(x / s)``
    (half to even, as ``jnp.round``) as int8.  Returns ``(int8 values,
    f32 scales)``.  Both divisions are by tensors, never by a Python
    scalar that a backend may turn into a reciprocal multiply, so the
    codes and scales are IEEE f32 quotients on the CPU and the card."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = amax / torch.full_like(amax, 127.0) + 1e-12
    return torch.round(xf / s[..., None]).to(torch.int8), s


def _kv_sources(cache, k, v):
    """What a write puts into each pool of ``cache``: ``(k, v)`` for fp
    pools, ``(k_i8, v_i8, k_scale, v_scale)`` (:func:`quantize_kv`) for
    the int8 4-tuple."""
    if len(cache) == 4:
        k_q, k_s = quantize_kv(k)
        v_q, v_s = quantize_kv(v)
        return k_q, v_q, k_s, v_s
    return k, v


def _paged_span_write(cache, k, v, block_tables, span_starts, span_lens):
    """Write a token span ``k``/``v`` (B, C, H_kv, D) into the layer's
    pools ``cache`` -- the fp pair, or the int8 4-tuple, whose values and
    scales are :func:`quantize_kv` of the span -- at positions
    ``[span_starts, span_starts + span_lens)`` of each slot
    (``ops/cuda/ragged_attention.write_spans``: dead rows and sentinel
    table entries never touch the pools; a ``PoolPair`` with spare rows
    takes the write that never syncs the host).  In place; returns
    ``cache`` itself."""
    _ra.write_spans(tuple(cache), _kv_sources(cache, k, v), block_tables,
                    span_starts, span_lens, rows=getattr(cache, "rows", None))
    return cache


def paged_attention(q, k_cache, v_cache, block_tables, context_lens,
                    scale: Optional[float] = None):
    """Decode attention over a PAGED KV pool: q (B, H, D) attends
    positions ``[0, context_lens)`` of each slot through its block table
    (B, MB) int32; pools (NB, page, H_kv, D).  The paged-attention kernel
    on CUDA tensors, its plain version on CPU tensors; both give zeros
    for a slot with ``context_lens == 0``, as the TPU kernel does (the
    reference's dense fallback gives NaN there)."""
    return _pa.paged_attention(q, k_cache, v_cache, block_tables,
                               context_lens, scale=scale)


def write_paged_kv(k_cache, v_cache, new_k, new_v, block_tables,
                   context_lens):
    """Write this step's (B, H_kv, D) k/v into the paged pools at
    position ``context_lens - 1`` of each slot.  A slot whose position
    has no table entry, or whose entry is out of range (the scheduler's
    dead-slot sentinel), is masked out before indexing -- JAX drops that
    scatter.  In place; returns the pools."""
    nb, bs = k_cache.shape[:2]
    mb = block_tables.shape[1]
    pos = context_lens.long() - 1
    pg = torch.div(pos, bs, rounding_mode="floor")
    ok = (pos >= 0) & (pg < mb)
    rows = ok.nonzero(as_tuple=True)[0]
    blk = block_tables.long()[rows, pg[rows]]
    keep = (blk >= 0) & (blk < nb)
    rows, blk = rows[keep], blk[keep]
    off = pos[rows] % bs
    k_cache[blk, off] = new_k[rows].to(k_cache.dtype)
    v_cache[blk, off] = new_v[rows].to(v_cache.dtype)
    return k_cache, v_cache


def paged_decode_attend(cache, q, new_k, new_v, block_tables, write_pos,
                        scale: Optional[float] = None):
    """One decode step against the paged pools: this token's (B, H_kv, D)
    k/v is written at ``write_pos`` (the tokens already cached) of each
    slot (:func:`write_paged_kv`), then q (B, H, D) attends
    ``write_pos + 1`` positions (:func:`paged_attention`).  A dead slot's
    sentinel table drops its write and gives a finite output the caller
    discards.  The int8 4-tuple writes the quantized token as a one-row
    span (:func:`_paged_span_write`) and attends through the
    reference's composition: its pages gathered and dequantized in f32
    (``_paged_gather_dense``), then ``_attend_dense_gqa``.  Returns
    ``(out, cache)``, the pools updated in place."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    ctx = (write_pos + 1).to(torch.int32)
    if len(cache) == 4:
        cache = _paged_span_write(cache, new_k[:, None], new_v[:, None],
                                  block_tables, write_pos,
                                  torch.ones_like(write_pos))
        kd, vd = _paged_gather_dense(cache[0], cache[1], block_tables,
                                     cache[2], cache[3])
        return _attend_dense_gqa(q, kd, vd, ctx, scale), cache
    kc, vc = write_paged_kv(cache[0], cache[1], new_k, new_v, block_tables,
                            ctx)
    return paged_attention(q, kc, vc, block_tables, ctx, scale=scale), \
        (kc, vc)


def paged_prefill_write(cache, k, v, block_tables, prompt_lens):
    """Write a prefill chunk ``k``/``v`` (B, S, H_kv, D) into the paged
    pools at positions ``[0, prompt_lens)`` of each slot: the span write
    with every span starting at 0 (the bucket-prefill path).  In place;
    returns ``cache``."""
    starts = torch.zeros_like(prompt_lens)
    return _paged_span_write(cache, k, v, block_tables, starts, prompt_lens)


def paged_attend(cache, q, k, v, block_tables, seq_lens=None,
                 span_starts=None):
    """One decoder layer's attention against its KV cache ``cache``, the
    branch chosen as both model families' cached forward chooses it.
    Without ``block_tables`` the dense cache pair (:func:`dense_attend`).
    With them the paged pool pair: with ``span_starts`` the ragged step
    (:func:`ragged_paged_attend`, ``seq_lens`` the span lengths); with
    S == 1 and ``seq_lens`` a one-token decode written at ``seq_lens``
    (:func:`paged_decode_attend`); else the bucket prefill, written at
    ``[0, seq_lens)`` (all S rows without ``seq_lens``) and attended
    causally.  q/k/v (B, S, H|H_kv, D); returns ``(out (B, S, H, D),
    cache)``.  :func:`paged_positions` gives the matching positions."""
    from ...nn.functional import scaled_dot_product_attention
    b, s = q.shape[:2]
    if block_tables is None:
        return dense_attend(cache, q, k, v, seq_lens)
    if span_starts is not None:
        return ragged_paged_attend(cache, q, k, v, block_tables,
                                   span_starts, seq_lens)
    if s == 1 and seq_lens is not None:
        out, cache = paged_decode_attend(cache, q[:, 0], k[:, 0], v[:, 0],
                                         block_tables, seq_lens)
        return out[:, None], cache
    plens = seq_lens if seq_lens is not None else torch.full(
        (b,), s, dtype=torch.int32, device=q.device)
    cache = paged_prefill_write(cache, k, v, block_tables, plens)
    return scaled_dot_product_attention(q, k, v, is_causal=True), cache


def dense_attend(cache, q, k, v, seq_lens=None):
    """One decoder layer's attention against its dense cache pair: with
    S == 1 and ``seq_lens`` a one-token decode written at ``seq_lens``
    (:func:`decode_attend_cache`); else a prefill written at ``[0, S)``
    (:func:`prefill_write_cache`) and attended causally
    (``scaled_dot_product_attention``, the flash kernel on the card).
    Returns ``(out (B, S, H, D), cache)``."""
    from ...nn.functional import scaled_dot_product_attention
    if q.shape[1] == 1 and seq_lens is not None:
        out, cache = decode_attend_cache(cache, q[:, 0], k[:, 0], v[:, 0],
                                         seq_lens)
        return out[:, None], cache
    cache = prefill_write_cache(cache, k, v)
    return scaled_dot_product_attention(q, k, v, is_causal=True), cache


def paged_positions(s: int, seq_lens=None, span_starts=None, device=None):
    """The token positions of a paged forward over S tokens per slot, by
    :func:`paged_attend`'s rule: ``span_starts + arange(S)`` (B, S) on the
    ragged step, ``seq_lens`` (B, 1) for a one-token decode, and None for
    the bucket prefill, whose positions are ``arange(S)``."""
    if span_starts is not None:
        return span_starts.long()[:, None] + \
            torch.arange(s, device=device)[None, :]
    if s == 1 and seq_lens is not None:
        return seq_lens.long()[:, None]
    return None


def ragged_paged_attend(cache, q, new_k, new_v, block_tables, span_starts,
                        span_lens, scale: Optional[float] = None):
    """ONE serving step for a ragged batch of token spans: the span's k/v
    is written at ``[start, start + len)`` of each slot, then query row
    ``j`` attends pool positions ``[0, start + j]``.  ``q``/``new_k``/
    ``new_v`` are (B, C, H|H_kv, D); ``cache`` is the layer's (k, v) pool
    pair (NB, page, H_kv, D), which the ragged-attention kernel attends,
    or the int8 4-tuple, attended as the reference attends it on every
    backend: the slots' pages gathered and dequantized in f32
    (``_paged_gather_dense``), then ``_ragged_attend_dense`` -- fixed
    shapes, no host sync, so the captured step takes it as it is.
    Returns ``(out (B, C, H, D), cache)``."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    cache = _paged_span_write(cache, new_k, new_v, block_tables,
                              span_starts, span_lens)
    if len(cache) == 4:
        kd, vd = _paged_gather_dense(cache[0], cache[1], block_tables,
                                     cache[2], cache[3])
        return _ragged_attend_dense(q, kd, vd, span_starts, scale), cache
    kc, vc = cache
    out = _ra.ragged_paged_attention(q, kc, vc, block_tables, span_starts,
                                     span_lens, scale=scale)
    return out, cache


def _mega_decode_layer_ref(x, norm_weight, w_q, w_k, w_v, w_o, cos, sin,
                           cache, block_tables, span_starts, span_lens,
                           head_dim, eps, scale):
    """The decode megakernel's numerical contract: the fused entry points
    chained -- :func:`fused_rms_rope_qkv` -> :func:`ragged_paged_attend`
    (span write included) -> the O projection accumulated in f32 and
    rounded to x.dtype -> the residual add.  Returns ``(out, cache)``,
    the pools updated in place."""
    b, c, h = x.shape
    q, k, v = fused_rms_rope_qkv(
        x.reshape(b * c, h), norm_weight, w_q, w_k, w_v,
        cos.reshape(b * c, head_dim), sin.reshape(b * c, head_dim),
        head_dim, eps)
    nh = q.shape[-1] // head_dim
    nkh = k.shape[-1] // head_dim
    attn, cache = ragged_paged_attend(
        cache, q.reshape(b, c, nh, head_dim),
        k.reshape(b, c, nkh, head_dim), v.reshape(b, c, nkh, head_dim),
        block_tables, span_starts, span_lens, scale=scale)
    y = dot_f32(attn.reshape(b * c, nh * head_dim), w_o.to(x.dtype))
    return x + y.to(x.dtype).reshape(b, c, h), cache


def mega_decode_layer(x, norm_weight, w_q, w_k, w_v, w_o, cos, sin, cache,
                      block_tables, span_starts, span_lens, head_dim: int,
                      eps: float = 1e-5, scale: Optional[float] = None):
    """One decoder layer's whole ragged attention block -- rms_norm ->
    q/k/v projections -> rotate-half rope -> ragged paged attention (span
    write included) -> O projection -> residual -- as one entry point.

    x: (B, C, H) residual-stream span batch (un-normed); norm_weight
    (H,); w_q (H, Nq); w_k/w_v (H, Nk); w_o (Nq, H); cos/sin (B, C,
    head_dim); ``cache``/``block_tables``/``span_starts``/``span_lens`` as
    :func:`ragged_paged_attend`.  Returns ``(x + o_proj(attend), cache)``,
    the pools updated in place.

    ``ops/cuda/mega_decode`` computes the output and the span k/v -- one
    launch of the decode megakernel on CUDA tensors (a geometry it does
    not take raises: nothing falls back), its plain version, the
    composition :func:`_mega_decode_layer_ref` on copies of the pools, on
    CPU tensors -- then the one shared span write puts the span k/v into
    the pools, exactly as the composition writes them.  The int8 4-tuple
    is the composition itself, as in the reference, whose megakernel
    declines int8 pools: the model families veto the megakernel for them
    before they get here.  Forward only (serving): the outputs carry no
    gradient."""
    if len(cache) == 4:
        return _mega_decode_layer_ref(x, norm_weight, w_q, w_k, w_v, w_o,
                                      cos, sin, cache, block_tables,
                                      span_starts, span_lens, head_dim, eps,
                                      scale)
    dt = x.dtype
    out, k_new, v_new = _md.mega_decode(
        x, norm_weight.to(dt), w_q.to(dt), w_k.to(dt), w_v.to(dt),
        w_o.to(dt), cos, sin, cache[0], cache[1], block_tables, span_starts,
        span_lens, head_dim, eps, scale)
    b, c = k_new.shape[:2]
    nkh = k_new.shape[-1] // head_dim
    cache = _paged_span_write(cache, k_new.reshape(b, c, nkh, head_dim),
                              v_new.reshape(b, c, nkh, head_dim),
                              block_tables, span_starts, span_lens)
    return out, cache


def lora_bgmv(x, a, b, idx):
    """Grouped batched-gather matrix-vector product -- the multi-LoRA
    serving delta ``x[s] @ A[idx[s]] @ B[idx[s]]`` per batch slot.  ``x``
    (B, C, d_in); ``a``/``b`` the stacked adapter pools (N, d_in, r) /
    (N, r, d_out) (``serving.LoRAPool.device_stacks``); ``idx`` (B,)
    int32.  Index 0 is the reserved exact no-op.  The grouped-BGMV kernel
    on CUDA tensors, :func:`_lora_bgmv_ref` on CPU tensors.  Serving
    only: no gradient."""
    return _lm.grouped_bgmv(x, a, b, idx)


def lora_delta(lora, inp, key):
    """The adapter delta of projection ``key`` under the threaded
    ``(layer pack, adapter ids)`` pair: :func:`lora_bgmv` on its stacks,
    or ``None`` when no pack is threaded or the pool does not target
    ``key`` (the caller then skips the add)."""
    if lora is None:
        return None
    lpack, laids = lora
    e = lpack.get(key)
    if e is None:
        return None
    return lora_bgmv(inp, e["a"], e["b"], laids)


def prefill_write_cache(cache, k, v, offset: int = 0):
    """Write a prefill chunk ``k``/``v`` (B, S, H_kv, D) at positions
    ``[offset, offset + S)`` of the dense cache tuple ``cache``: the fp
    pair ((B, S_max, H_kv, D) each), or the int8 4-tuple, which takes
    :func:`quantize_kv` of the chunk, values and (B, S_max, H_kv) scales.
    In place; returns ``cache``."""
    s = k.shape[1]
    for dst, src in zip(cache, _kv_sources(cache, k, v)):
        dst[:, offset:offset + s] = src.to(dst.dtype)
    return cache


def read_cache_prefix(cache, length: int, dtype):
    """Positions ``[0, length)`` of a dense cache tuple as ``dtype`` K/V:
    the int8 4-tuple dequantized through its scales, in ``dtype``, as the
    reference's chunked prefill reads the cached prefix."""
    if len(cache) == 4:
        kc, vc, ks, vs = cache
        return (kc[:, :length].to(dtype) * ks[:, :length, :, None].to(dtype),
                vc[:, :length].to(dtype) * vs[:, :length, :, None].to(dtype))
    kc, vc = cache
    return kc[:, :length].to(dtype), vc[:, :length].to(dtype)


def decode_attend_cache(cache, q, new_k, new_v, seq_lens):
    """One decode step against a dense cache tuple -- the fp pair or the
    int8 4-tuple: the cache-arity dispatch shared by the model families.
    Returns ``(out, cache)``, the cache updated in place."""
    if len(cache) == 4:
        kc, vc, ks, vs = cache
        out, kc, vc, ks, vs = masked_multihead_attention(
            q, kc, vc, seq_lens, new_k, new_v, k_scale=ks, v_scale=vs)
        return out, (kc, vc, ks, vs)
    out, kc, vc = masked_multihead_attention(q, cache[0], cache[1],
                                             seq_lens, new_k, new_v)
    return out, (kc, vc)


def _write_at(cache, new, seq_lens):
    """``cache[b, seq_lens[b]] = new[b]`` as one ``index_copy_`` over the
    (B * S_max) rows; a slot whose position is past the cache keeps its
    row, as the reference drops that write.  Nothing syncs the host."""
    b, s_max = cache.shape[:2]
    pos = seq_lens.long()
    rows = torch.arange(b, device=cache.device) * s_max + \
        pos.clamp(max=s_max - 1)
    flat = cache.view(b * s_max, *cache.shape[2:])
    past = (pos < s_max).view(b, *([1] * (new.dim() - 1)))
    val = torch.where(past, new.to(cache.dtype), flat.index_select(0, rows))
    flat.index_copy_(0, rows, val)


def masked_multihead_attention(q, k_cache, v_cache, seq_lens, new_k=None,
                               new_v=None, scale: Optional[float] = None,
                               k_scale=None, v_scale=None):
    """Single-step decode attention against a dense KV cache.

    q (B, H, D), the new token's query; k_cache/v_cache (B, S_max, H_kv,
    D), updated in place; seq_lens (B,), the tokens already cached (the
    new token's position); new_k/new_v (B, H_kv, D), written at
    ``seq_lens`` when given.  q attends positions ``[0, seq_lens]``, the
    new token included.  On CUDA tensors the paged-attention kernel reads
    the caches as one page per slot (a cache it cannot take raises), on
    CPU tensors :func:`_attend_dense_gqa` runs.  Returns ``(out, k_cache,
    v_cache)``.

    int8 caches come with ``k_scale``/``v_scale`` (B, S_max, H_kv) f32:
    the new token is written quantized (:func:`quantize_kv`), values and
    scales, and q attends the caches through the reference's
    composition on every device -- K dequantized in bf16
    (``k_cache.bf16 * k_scale.bf16``), V in f32, then
    :func:`_attend_dense_gqa` -- and ``(out, k_cache, v_cache, k_scale,
    v_scale)`` is returned."""
    quantized = k_scale is not None
    if new_k is not None:
        caches = (k_cache, v_cache) + ((k_scale, v_scale) if quantized
                                       else ())
        for dst, src in zip(caches, _kv_sources(caches, new_k, new_v)):
            _write_at(dst, src, seq_lens)
    ctx = (seq_lens + 1).to(torch.int32)
    if not quantized:
        out = _pa.dense_attention(q, k_cache, v_cache, ctx, scale)
        return out, k_cache, v_cache
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    k_read = k_cache.to(torch.bfloat16) * \
        k_scale.to(torch.bfloat16)[..., None]
    v_read = v_cache.float() * v_scale[..., None]
    out = _attend_dense_gqa(q, k_read, v_read, ctx, scale)
    return out, k_cache, v_cache, k_scale, v_scale


def paged_copy_blocks(cache, src_blocks, dst_blocks):
    """Copy whole pages ``src_blocks[i] -> dst_blocks[i]`` inside every
    pool of ``cache`` -- k and v, and an int8 4-tuple's scales with them
    (the device half of copy-on-write).  Entries whose
    destination is out of range (the ``num_blocks`` padding sentinel) are
    dropped before indexing.  In place; returns ``cache``."""
    nb = cache[0].shape[0]
    dst = dst_blocks.long()
    keep = (dst >= 0) & (dst < nb)
    src = src_blocks.long()[keep].clamp(0, nb - 1)
    dst = dst[keep]
    for a in cache:
        a[dst] = a[src]
    return cache
