#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the run on its own (nothing is caught):

1. build: compiles the eleven CUDA kernel sources from
   paddle_tpu_torch/csrc for sm_90a, one nvcc per source, all at once
   (timed as set-up);
2. kernels: holds each kernel against its plain PyTorch version on the
   card, in bf16 and f32 (the flash kernels also in f16, each flash row
   with its achieved TFLOP/s, and two calls of each at the main shapes
   bit-equal: no atomics), at the serving path's llama2-7b shapes (T = B*C
   = 128 tokens; ragged attention B=8, C=16, page 16, contexts up to 512),
   the training path's (flash attention B=2, S=2048, 32 heads of 128,
   causal; fused AdamW over the 4-layer llama2-7b parameter list, bf16
   grads and parameters beside f32 master/moments, or all f32) and at the
   llama2-70b geometry (64 q heads over 8 kv heads; flash B=1, S=2048);
   prints each max error beside its tolerance, the kernel's median time,
   its bound from this card's memory rate and peak, the plain version's
   time and the time of a PyTorch yardstick call (cuBLAS matmul chains,
   scaled_dot_product_attention forward and forward+backward,
   torch.optim.AdamW(fused=True).step()) that the port never calls; the
   QKV and MLP kernels also at the training path's T = 4096; AdamW's
   moments and update held per element (the decay to 1/30 of itself); the
   MLP kernels' scratch from their plan (h and the f32 split partials:
   at most 16 MiB at T <= 257, none at T = 4096), error and time, SwiGLU
   at T = 128 and 4096 and GELU at T = 1, 8, 128 and 257; both MLP
   kernels at T = 1, 8, 63, 65 and 257 and the llama2-70b SwiGLU at T = 1
   and 257, bf16 and f32, each MLP row's two calls bit-equal; the QKV
   kernel at T = 1, 8, 63, 65 and 257, head dim 64, the llama2-70b GQA
   geometry at T = 1 and 257 and a hidden size of 4128 (qkv_edges lines,
   bf16 and f32, two calls bit-equal) and the QKV, int8, int4 and
   megakernel plans at the main shapes (qkv_plan, int8_plan, int4_plan,
   mega_plan lines); ragged attention's rows with their device time,
   host time per call and plan (path, tiles, splits, stages per split,
   grid blocks, partial bytes), dead rows zeros and two calls bit-equal,
   and its edge cases (ragged_edges: head dims 64, 72, 100, 128 and 256,
   page 16 and 64, GQA groups 1-8, C = 1, a chunk across the plan's first
   split, a decode row at the table's last position, the idle slot,
   sentinel-padded tables; bf16 and f32; f16 and an f32 head dim of 512
   must raise); grouped BGMV's rows with their plan (cluster, slice,
   tiles, grid blocks) and host time, two calls bit-equal, rank 65 and
   f16 raising; and
   the flash kernels off those shapes in bf16, f32 and f16 (causal
   Sq < Sk, ragged lengths and the 128-row tile's edges, head dims 18,
   64, 80, 256, a GQA group of 8); the int8 and int4 weight-only matmul
   kernels at the four shapes of the quantized llama2-7b engine step (128
   rows through 4096x4096, 4096x11008 and 11008x4096 weights, 8 rows
   through the 4096x32000 LM head; bf16, f32 and f16, each row with its
   device time and the host's time per call) with a cuBLAS yardstick over
   the widened weight, each kind's sum over one step's 225 calls, and
   their
   edge cases (M 1/8/257, K 100/102, N 200, f16, an unaligned x, every
   int8 code and every packed int4 byte); the fused GELU MLP at the
   gpt3-6.7b engine step (T = 128, H 4096, F 16384), gpt3-13b's H 5120 /
   F 20480 and T = 1 and 257 (library: addmm -> gelu -> addmm), and paged
   decode attention at the gpt3-6.7b decode shape (B = 8, 32 heads of
   128, page 16, ragged lengths up to 512), at the llama2-70b GQA shape
   and at edge cases (lengths 1, a page multiple, 512, a zero-length
   slot that must give zeros, head dims 128 and 64; library: SDPA over
   the gathered KV), in bf16 and f32 and (gpt3-6.7b and the edges) f16,
   each row with its device time, host time per call and plan (path,
   spans, stages per span, grid blocks) and two calls bit-equal; an f16
   head dim of 80 must raise; and the paged kernel on generate()'s
   dense-cache view (dense_decode_view rows: dense (B, 192, H_kv, 128)
   caches read as one page per slot, B = 8, llama2-7b and the llama2-70b
   GQA shape, bf16 and f32, contexts in [1, 192], held against
   attend_dense_gqa, two calls bit-equal, library SDPA over the dense
   cache; a strided cache must raise, a cache of another dtype than q
   is read with q cast to it);
3. engine: llama2-7b in bf16, all 32 layers, random weights drawn on the
   card from a seeded generator, behind Engine(max_batch=8,
   max_seq_len=512, page_size=16): 8 staggered greedy requests, two of
   them sharing a 64-token prefix after a first one finished (prefix
   hits and copy-on-write); checks that all finished, the pool drained
   and each kernel's launch count equals layers x non-empty steps;
   spec_engine: the same model behind Engine(spec_decode=True,
   draft_depth=4) (C stays 16) and a spec-off engine, both captured, in
   turns in one process: 8 requests filling the 8 slots, each prompt
   its own seeded 32-token phrase 4 times (128 tokens), 64 new tokens,
   6 greedy (one repeats another's prompt after its prefill: a prefix
   hit with copy-on-write) and 2 at temperature 0.8; each kernel's
   launches (layers x steps) in the counted run, launches per step equal
   on and off, greedy streams equal to spec-off's under the near-tie
   rule, temperature streams equal, one capture each; spec_stats,
   steps, tokens per step, step ms, decode tokens/s and replay ms by
   CUDA events in turns (on, off, off, on);
   preempt: on both engines, fresh phrases and a late 300-token prompt
   at step 16, with the request that borrows the shared prefix
   preempted at step 16 and the late prompt at step 24 (prefilling),
   against the same traffic without preemption: greedy streams under the
   near-tie rule, temperature streams equal across the two engines,
   pages swapped out and in with ms and GB/s per swap (CUDA events),
   the borrowed pages' refcounts before and after, the pools'
   addresses unchanged, one capture, prefix hits afterwards;
   kv8_engine: the engine phase's model, geometry and traffic behind
   Engine(kv_cache_dtype="int8") (int8 pools with f32 scales per
   position and head, attended through the reference's gather+dequant
   composition inside the captured step): per step 32 QKV and 32
   SwiGLU launches and no ragged-attention or megakernel launch, one
   capture, streams equal to an eager twin's under the near-tie rule,
   pools drained, prefix hits and copy-on-write, hbm_stats'
   kv_pool_bytes (D + 4) / (2 D) = 0.515625 of the bf16 engine's; step,
   replay and host ms and tokens/s beside the bf16 engine's;
   then the engine phase's model, engine and traffic with Engine(weight_quant=
   "int8") and again "int4": the quantized kernel launched 225 times per
   step (7 projections x 32 layers + the LM head), ragged attention 32,
   the fused QKV/MLP kernels 0; weight bytes on the card against bf16;
   then gpt3-6.7b in bf16, all 32 layers, behind the same engine and
   traffic (gpt_engine: 32 fused GELU-MLP and 32 ragged-attention
   launches per step, none of the Llama kernels); the mega and
   multi-LoRA engines (mega_engine, lora_engine) likewise.  Every one of
   these six engines replays its step from the CUDA graph captured at
   warmup: each must show one capture after warmup and after its
   traffic, one replay per step, the launch counts above (a replay
   credits the launches recorded at capture), and streams equal, under
   the near-tie rule with at most one request exempt (its step and
   margin printed), to an eager twin on the same model
   (Engine(_eager_step=True)) that serves the same traffic; each line's
   "graph" block then holds both engines' step ms in turns (captured,
   eager, eager, captured, no profiler), the replays' device ms by CUDA
   events and the host's ms per step outside them, and both engines'
   8-step profiles (device busy ms and idle share, the captured one
   cross-checked by events around its replays); gpt3-6.7b also runs on
   the bucket-prefill/decode path, uncaptured (gpt_paged: pools from PagedKVCache,
   tables from its allocator padded with the sentinel; the 8 prompts in
   one prefill call through the flash forward kernel, then 32 greedy
   decode calls of 32 paged-attention launches each; how many leading
   tokens equal the gpt_engine streams is reported, not gated, and at
   each request's first differing token the paged path's top-2 margin
   of its f32 logits and the engine's (its eager twin's), classed
   against the bf16 tolerance at that logit: "near_tie" or "fault",
   not gated), and 8 more decode calls under torch.profiler;
   generate: llama2-7b bf16 fused, 32 layers, model.generate() over 8
   prompts of 128 tokens, 64 new tokens, greedy: the prefill in one
   eager forward, then the one-token decode step captured once into a
   CUDA graph and replayed (captures 1, replays 63, each replay
   crediting 32 QKV, 32 SwiGLU and 32 paged-attention launches; the
   launch totals of the call asserted); prefill ms, decode ms per step
   captured and eager (the same caches and buffers without the graph)
   in turns (captured, eager, eager, captured), the replays' device ms
   by CUDA events, decode tokens/s, greedy streams equal between the
   two; a second call of the same shape with 32 tokens and top-k/top-p
   sampling, reproducible from seed(), leaves captures at 1;
   kv8_generate: the same model and prompts with
   generate(kv_cache_dtype="int8"): a new decode graph over the int8
   dense 4-tuple caches, captured once (replays 63), per step 32 QKV and
   32 SwiGLU launches and no paged-attention launch (the dense int8
   composition), prefill ms, decode ms per step captured and eager in
   turns, replay device ms, decode tokens/s beside the bf16 call's,
   captured and eager streams equal;
4. cross-check: a 2-layer model at full llama2-7b width in f32, the same
   weights on both sides, kernels on the card against the plain versions
   on the CPU: greedy streams must be equal under the near-tie rule; the
   same for int8 and int4, whose codes and scales quantized on the card
   must equal the CPU's bit for bit; gpt2-345m cut to 2 layers (biases
   and LayerNorms randomised), the Engine's streams under the same rule,
   and the paged prefill + 4 decode calls' logits within f32 tolerance,
   the same paged check for llama-350m-hd128 cut to 2 layers;
   generate() on llama-350m-hd128 and gpt2-345m cut to 2 layers, f32,
   card against CPU: greedy tokens equal under the near-tie rule, and a
   sampled call on the card reproducible from seed(); spec_cross_check:
   llama-350m-hd128 cut to 2 layers, f32, the speculative engine on the
   card against the same engine on the CPU, with one preemption and one
   injected serve.step fault (isolation) on both sides: greedy streams
   equal with 0 exempt, equal draft and acceptance counts, verify spans
   run, one capture; kv8_cross_check: llama-350m-hd128 cut to 2 layers,
   f32, int8 KV pools, card against CPU on three engines (int8 KV; with
   weight_quant="int8", codes bit-equal; with spec_decode=True and one
   preemption): streams equal under the near-tie rule, prefix stats
   equal, one capture and no ragged-attention launch each; and the bucket
   path over int8 PagedKVCache pools (prefill + 4 decode calls, the card
   fed the CPU's tokens: greedy tokens equal under the near-tie rule);
5. train: llama2-7b width cut to 4 layers, amp O2 (bf16 parameters, f32
   master weights), AdamW + ClipGradByGlobalNorm through TrainStep, batch
   2 x 2048, 5 steps on one fixed batch, PyTorch's default precision:
   losses finite and falling, each kernel's launch count (flash forward
   = backward = qkv = MLP = layers x steps, fused AdamW = steps), step
   ms, tokens/s, model TFLOP/s and its
   share of the bf16 peak, peak memory, and a 2-step torch.profiler
   window (device busy/idle, kernel time by name, the flash kernels' ms
   per step);
6. train cross-check: llama-350m-hd128 cut to 2 layers, f32, batch
   2 x 256, 2 steps, kernels on the card against the plain versions on
   the CPU from the same weights and batch: losses, moments and each
   parameter's update must agree (decay-only elements to 4 f32 units).

Prints each measurement as a JSON line (kernel, mlp_scratch, mlp_edges,
qkv_edges, qkv_plan, int8_plan, int4_plan, mega_plan, flash_edges,
quant_edges, mega_edges, bgmv_edges, ragged_edges, engine, spec_engine,
preempt, kv8_engine, generate, kv8_generate, quant_engine, gpt_engine,
gpt_paged, cross_check, quant_cross_check, gpt_cross_check,
generate_cross_check, spec_cross_check, kv8_cross_check, train,
train_cross_check; smoke: the run's wall seconds from the build's start
and each phase's), the card's name and power limit, a
{"kernels": [...]} line, and last the {"ok": true, "device": {...}}
line.  The QKV, SwiGLU, int8, int4, megakernel, BGMV and ragged attention
rows carry `device_ms`, the card's time per call with the host out of
the way (CUDA events around calls queued behind a sleep kernel), beside
the CUDA-event `ms` of calls as the host launches them; the int8, int4,
BGMV and ragged attention rows also `host_us`, the host's wall time per
call of 200 calls without a synchronize.  The engine and train phases'
device busy times are the union of the kernels' intervals in a
profiler trace (the MLP kernels' dependent launches overlap the kernel
before them).  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch import amp, optimizer, seed
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import PRESETS, causal_lm_loss, gpt, llama
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn import quant as Q
from paddle_tpu_torch.ops.cuda import KERNELS as CUDA_KERNELS
from paddle_tpu_torch.ops.cuda import _build, counts
from paddle_tpu_torch.ops.cuda._compare import (device_events, device_ms,
                                                union_ms)
from paddle_tpu_torch.ops.cuda import flash_attention as FA
from paddle_tpu_torch.ops.cuda import fused_adamw as AD
from paddle_tpu_torch.ops.cuda import fused_gelu_mlp as FG
from paddle_tpu_torch.ops.cuda import fused_mlp as FM
from paddle_tpu_torch.ops.cuda import fused_norm_qkv as FQ
from paddle_tpu_torch.ops.cuda import int4_matmul as I4
from paddle_tpu_torch.ops.cuda import int8_matmul as I8
from paddle_tpu_torch.ops.cuda import lora_matmul as LM
from paddle_tpu_torch.ops.cuda import mega_decode as MD
from paddle_tpu_torch.ops.cuda.int4_plan import (
    MAX_PARTIAL_BYTES as INT4_MAX_PARTIAL_BYTES, int4_plan)
from paddle_tpu_torch.ops.cuda.int8_plan import int8_plan
from paddle_tpu_torch.ops.cuda.mega_plan import mega_plan
from paddle_tpu_torch.ops.cuda.mlp_plan import (MAX_PARTIAL_BYTES, mlp_plan,
                                                sm_count)
from paddle_tpu_torch.ops.cuda.paged_plan import paged_plan
from paddle_tpu_torch.ops.cuda.qkv_plan import qkv_plan
from paddle_tpu_torch.ops.cuda.ragged_plan import ragged_plan
from paddle_tpu_torch.ops.cuda.bgmv_plan import bgmv_plan
from paddle_tpu_torch.ops.cuda import paged_attention as PA
from paddle_tpu_torch.ops.cuda import ragged_attention as RA
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.nn import functional as NF
from paddle_tpu_torch.resilience import clear_faults, install_faults
from paddle_tpu_torch.serving import (Engine, LoRAPool, PagedKVCache,
                                      random_adapter)
from paddle_tpu_torch.serving.graph import launch_delta

# H100 SXM, NVIDIA's data sheet (dense): memory rate and peak by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
# kernel vs plain on the card: |kernel - plain| <= atol + rtol * |plain|.
# f32: the same arithmetic in another summation order.  bf16: the same
# rounding points, where an f32 sum on a rounding boundary can move an
# intermediate or the output by one bf16 unit (2**-8 relative).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2),
       torch.float16: (1e-2, 1e-2)}
# near-tie rule: a greedy token may differ only where the reference's
# top-2 logit margin is below this (f32 logits here differ by ~1e-5)
TIE = 1e-3
# (name in ops.cuda.KERNELS, source, TPU kernel it replaces)
KERNELS = [
    ("fused_rms_rope_qkv",
     "paddle_tpu_torch/csrc/fused_norm_qkv.cu",
     "paddle_tpu/ops/pallas/fused_norm_qkv.py:158"),
    ("fused_swiglu_mlp", "paddle_tpu_torch/csrc/fused_mlp.cu",
     "paddle_tpu/ops/pallas/fused_mlp.py:148"),
    ("ragged_paged_attention",
     "paddle_tpu_torch/csrc/ragged_attention.cu",
     "paddle_tpu/ops/pallas/ragged_attention.py:137"),
    ("flash_attention_fwd",
     "paddle_tpu_torch/csrc/flash_attention.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:161"),
    ("flash_attention_bwd",
     "paddle_tpu_torch/csrc/flash_attention.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:412"),
    ("fused_adamw", "paddle_tpu_torch/csrc/fused_adamw.cu",
     "paddle_tpu/ops/pallas/fused_adamw.py:89"),
    ("int8_matmul", "paddle_tpu_torch/csrc/int8_matmul.cu",
     "paddle_tpu/ops/pallas/int8_matmul.py:92"),
    ("int4_matmul", "paddle_tpu_torch/csrc/int4_matmul.cu",
     "paddle_tpu/ops/pallas/int4_matmul.py:143"),
    ("mega_decode", "paddle_tpu_torch/csrc/mega_decode.cu",
     "paddle_tpu/ops/pallas/mega_decode.py:261"),
    ("grouped_bgmv", "paddle_tpu_torch/csrc/lora_matmul.cu",
     "paddle_tpu/ops/pallas/lora_matmul.py:109"),
    ("fused_gelu_mlp", "paddle_tpu_torch/csrc/fused_gelu_mlp.cu",
     "paddle_tpu/ops/pallas/fused_mlp.py:181"),
    ("paged_attention", "paddle_tpu_torch/csrc/paged_attention.cu",
     "paddle_tpu/ops/pallas/decode_attention.py:124"),
]
SERVING = ("fused_rms_rope_qkv", "fused_swiglu_mlp", "ragged_paged_attention")
QUANT = {"int8": ("int8_matmul", I8.int8_matmul, I8.plain),
         "int4": ("int4_matmul", I4.int4_matmul, I4.plain)}
# the weight-only llama2-7b engine step: (rows, K, N, calls per step) of
# every quantized projection -- q, k, v, o; gate, up; down (T = B*C = 128
# rows, 32 layers) -- and the LM head (one row per slot)
QUANT_STEP = [(128, 4096, 4096, 4 * 32), (128, 4096, 11008, 2 * 32),
              (128, 11008, 4096, 32), (8, 4096, 32000, 1)]
TRAINING = ("fused_rms_rope_qkv", "fused_swiglu_mlp", "flash_attention_fwd",
            "flash_attention_bwd", "fused_adamw")
# the multi-LoRA llama2-7b engine step: (d_in, d_out, calls per step) of
# every adapted projection -- q, k, v, o; gate, up; down -- at T = B*C =
# 8 x 16 rows, rank 16, 32 layers
LORA_STEP = [(4096, 4096, 4 * 32), (4096, 11008, 2 * 32),
             (11008, 4096, 32)]
LORA_RANK = 16
# the ragged attention rows: (B, C, H, H_kv, D, page, contexts up to) of
# the llama2-7b engine step and of the llama2-70b GQA geometry
RAGGED = {"llama2-7b": (8, 16, 32, 32, 128, 16, 512),
          "llama2-70b-gqa": (8, 16, 64, 8, 128, 16, 512)}
# the generate phase: llama2-7b bf16, 8 prompts of 128 tokens, 64 new
# tokens each, dense caches of 128 + 64 positions
GENERATE = {"batch": 8, "prompt": 128, "new": 64, "capacity": 192}
# the random adapters' N(0, scale) entries: the delta x @ A @ B of a
# normed 4096-wide row then has a std of ~4096**0.5 * 16**0.5 * scale**2
# = 0.64, half the base projection's (~1.28), so adapters change greedy
# streams while bf16 logits stay finite
LORA_SCALE = 0.05


def llama_cfg(name, **overrides):
    return dataclasses.replace(PRESETS[name], **overrides)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 5, reps: int = 5, warmup: int = 2) -> float:
    """Time of one ``fn()`` in ms: the median over ``iters`` CUDA-event
    windows, each around ``reps`` back-to-back calls, divided by
    ``reps`` -- the card's time per call, not the host's time to launch
    one call into an idle card."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    tb = nbytes / HBM_BYTES_S * 1e3
    to = ops / PEAK_OPS_S[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def compare(name, got, want, dtype, rows=None) -> float:
    """Max |got - want| (over ``rows`` if given); raises past tolerance."""
    g, w = got.float(), want.float()
    if rows is not None:
        g, w = g[rows], w[rows]
    err = (g - w).abs()
    atol, rtol = TOL[dtype]
    excess = float((err - atol - rtol * w.abs()).max())
    mx = float(err.max())
    if not math.isfinite(mx) or excess > 0:
        raise AssertionError(f"{name}: max |err| {mx} beyond atol {atol} "
                             f"rtol {rtol} ({dtype})")
    return mx


def rand(shape, dtype, gen, std=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)


# -- kernel phase ------------------------------------------------------------

def qkv_case(t, h, nq, nk, hd, dtype, gen):
    x = rand((t, h), dtype, gen)
    g = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
    wq, wk, wv = (rand((h, n), dtype, gen, 0.02) for n in (nq, nk, nk))
    ang = torch.rand((t, hd // 2), generator=gen, device="cuda") * 500
    ang = torch.cat([ang, ang], -1)
    args = (x, g, wq, wk, wv, ang.cos().to(dtype), ang.sin().to(dtype), hd,
            1e-5)
    wcat = torch.cat([wq, wk, wv], 1)

    def library():
        nx = F.rms_norm(x, (h,), g, 1e-5)
        y = nx @ wcat
        q, k = y[:, :nq].view(t, -1, hd), y[:, nq:nq + nk].view(t, -1, hd)
        c, s = args[5][:, None], args[6][:, None]
        rot = lambda u: torch.cat([-u[..., hd // 2:], u[..., :hd // 2]], -1)
        return q * c + rot(q) * s, k * c + rot(k) * s, y[:, nq + nk:]

    it = x.element_size()
    nbytes = it * (t * h + h + h * (nq + 2 * nk) + 2 * t * hd
                   + t * (nq + 2 * nk))
    ops = 2.0 * t * h * (nq + 2 * nk)
    kern = lambda: FQ.fused_rms_rope_qkv(*args)
    plain = lambda: FQ.plain(*args)
    err = max(compare(f"qkv[{i}]", a, b, dtype)
              for i, (a, b) in enumerate(zip(kern(), plain())))
    return err, kern, plain, library, nbytes, ops


def mlp_case(t, h, i, dtype, gen):
    """The fused SwiGLU MLP at (T, H, I), two calls bit-equal.  Library:
    cuBLAS x @ Wg, x @ Wu, silu, product, @ Wd."""
    kern, plain, library = mlp_inputs("swiglu", t, h, i, dtype, gen)
    nbytes = torch.finfo(dtype).bits // 8 * (2 * t * h + 3 * h * i)
    got = kern()
    err = compare("mlp", got, plain(), dtype)
    assert torch.equal(got, kern()), f"mlp t={t}: two calls differ"
    return err, kern, plain, library, nbytes, 6.0 * t * h * i


def attn_case(b, c, h, hkv, d, page, max_ctx, dtype, gen, rng):
    mb = max_ctx // page
    nb = b * mb
    q = rand((b, c, h, d), dtype, gen)
    kp, vp = rand((nb, page, hkv, d), dtype, gen), \
        rand((nb, page, hkv, d), dtype, gen)
    # decode tokens deep in their context, prefill chunks, an idle slot
    starts = np.zeros(b, np.int32)
    lens = np.zeros(b, np.int32)
    for s in range(b):
        kind = s % 4
        if kind == 0:
            starts[s], lens[s] = rng.integers(300, max_ctx - 1), 1
        elif kind == 1:
            starts[s], lens[s] = rng.integers(0, max_ctx - c), c
        elif kind == 2:
            starts[s], lens[s] = rng.integers(16, 200), rng.integers(2, c)
    lens[b - 1] = 0                                   # idle slot
    tables = np.full((b, mb), nb, np.int32)           # OOB padding
    perm = rng.permutation(nb)
    used = 0
    for s in range(b):
        n = -(-(starts[s] + lens[s]) // page)
        tables[s, :n] = perm[used:used + n]
        used += n
    tt, st, ln = (torch.from_numpy(a).cuda() for a in (tables, starts, lens))
    kern = lambda: RA.ragged_paged_attention(q, kp, vp, tt, st, ln)
    plain = lambda: RA.plain(q, kp, vp, tt, st, ln)
    g = h // hkv

    def library():
        k, v = RA.paged_gather_dense(kp, vp, tt)
        k = k.transpose(1, 2).repeat_interleave(g, 1)
        v = v.transpose(1, 2).repeat_interleave(g, 1)
        pos = st.long()[:, None] + torch.arange(c, device="cuda")
        mask = torch.arange(k.shape[2], device="cuda") <= pos[..., None]
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=mask[:, None])

    rows = torch.arange(c, device="cuda")[None, :] < ln[:, None]
    got = kern()
    err = compare("attn", got, plain(), dtype, rows)
    assert bool((got[~rows] == 0).all()), "attn: dead rows not zeros"
    assert torch.equal(got, kern()), "attn: two calls differ"
    it = q.element_size()
    live_rows = int(lens.sum())
    pages = sum(-(-(int(starts[s]) + int(lens[s])) // page)
                for s in range(b) if lens[s])
    nbytes = it * (2 * live_rows * h * d + 2 * pages * page * hkv * d) \
        + 4 * (b * mb + 2 * b)
    ctx = sum(int(starts[s]) + j + 1 for s in range(b)
              for j in range(int(lens[s])))
    return err, kern, plain, library, nbytes, 4.0 * ctx * d * h


def causal_pairs(sq, sk):
    """(query, key) pairs a bottom-right causal mask keeps."""
    return sum(min(sk, i + 1 + sk - sq) for i in range(sq))


def flash_inputs(b, s, h, hkv, d, dtype, gen):
    return (rand((b, s, h, d), dtype, gen), rand((b, s, hkv, d), dtype, gen),
            rand((b, s, hkv, d), dtype, gen), rand((b, s, h, d), dtype, gen))


def flash_fwd_case(b, s, h, hkv, d, dtype, gen):
    q, k, v, _ = flash_inputs(b, s, h, hkv, d, dtype, gen)
    scale = d ** -0.5
    kern = lambda: FA.flash_fwd(q, k, v, scale, True)
    plain = lambda: FA.plain(q, k, v, True, scale)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=hkv != h)
    (o, lse), (po, plse) = kern(), plain()
    err = max(compare("flash out", o, po, dtype),
              compare("flash lse", lse, plse, torch.float32))
    o2, lse2 = kern()
    assert torch.equal(o, o2) and torch.equal(lse, lse2), \
        "flash forward differs between two calls"
    it = q.element_size()
    nbytes = it * 2 * (q.numel() + k.numel()) + 4 * b * h * s
    ops = 4.0 * b * h * d * causal_pairs(s, s)
    return err, kern, plain, library, nbytes, ops


def flash_bwd_case(b, s, h, hkv, d, dtype, gen):
    q, k, v, do = flash_inputs(b, s, h, hkv, d, dtype, gen)
    scale = d ** -0.5
    out, lse = FA.flash_fwd(q, k, v, scale, True)
    kern = lambda: FA.flash_bwd(q, k, v, out, lse, do, scale, True)
    plain = lambda: FA.plain_bwd(q, k, v, out, lse, do, True, scale)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def library():          # forward + backward: SDPA keeps no lse to reuse
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=hkv != h)
        return torch.autograd.grad(o, (qt, kt, vt), dot)

    got = kern()
    err = max(compare(f"flash d{n}", a, w, dtype)
              for n, a, w in zip("qkv", got, plain()))
    assert all(torch.equal(a, b) for a, b in zip(got, kern())), \
        "flash backward differs between two calls"
    it = q.element_size()
    # read q, k, v, out, dO, lse; write dq, dk, dv
    nbytes = it * (5 * q.numel() + 4 * k.numel()) + 4 * b * h * s
    # recompute s, then dp, dv, dk, dq: five products per visible pair
    ops = 10.0 * b * h * d * causal_pairs(s, s)
    return err, kern, plain, library, nbytes, ops


def flash_edge_checks(gen):
    """The flash kernels against their plain versions off the main path's
    shapes: causal with Sq < Sk (a bottom-right offset), lengths that are
    not tile multiples (130: two rows past a 128-row tile; 200 / 328),
    GQA (a group of 8 at head dim 64), and head dims other than 128: 64,
    80 and 256 (16-byte loads, columns past the head dim zero; 256 in a
    64-row tile at Sq 80 and 130) and 18 (element loads)."""
    errs = {}
    for b, sq, sk, h, hkv, d, causal in ((1, 100, 260, 4, 2, 128, True),
                                        (2, 70, 70, 2, 2, 64, False),
                                        (1, 90, 90, 4, 1, 80, True),
                                        (1, 80, 150, 2, 2, 256, True),
                                        (2, 40, 40, 2, 1, 18, False),
                                        (1, 130, 130, 4, 2, 128, True),
                                        (1, 200, 328, 4, 2, 128, True),
                                        (1, 130, 130, 2, 1, 256, False),
                                        (1, 256, 256, 8, 1, 64, True)):
        for dt in (torch.bfloat16, torch.float32, torch.float16):
            q, do = rand((b, sq, h, d), dt, gen), rand((b, sq, h, d), dt, gen)
            k, v = rand((b, sk, hkv, d), dt, gen), rand((b, sk, hkv, d), dt,
                                                       gen)
            dlse = rand((b, h, sq), torch.float32, gen)
            out, lse = FA.flash_fwd(q, k, v, d ** -0.5, causal)
            po, plse = FA.plain(q, k, v, causal, d ** -0.5)
            got = FA.flash_bwd(q, k, v, out, lse, do, d ** -0.5, causal, dlse)
            want = FA.plain_bwd(q, k, v, out, lse, do, causal, d ** -0.5,
                                dlse)
            key = f"{sq}x{sk} h{h}/{hkv} d{d} causal={causal} {dt}"
            errs[key] = max([compare("edge out", out, po, dt),
                             compare("edge lse", lse, plse, torch.float32)]
                            + [compare("edge grad", a, w, dt)
                               for a, w in zip(got, want)])
    log("flash_edges " + json.dumps(errs))


def train_shapes(cfg):
    """Parameter shapes of a llama config, in named_parameters order."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    layer = [(h,), (h, h), (h, kv), (h, kv), (h, h), (h,), (h, i), (h, i),
             (i, h)]
    return ([(v, h)] + layer * cfg.num_hidden_layers + [(h,)]
            + [(h, v)])


def within(name, got, want, allow) -> float:
    """Elementwise |got - want| <= allow; returns max |got - want|."""
    err = (got.float() - want.float()).abs()
    bad = int((err > allow).sum())
    if bad or not torch.isfinite(err).all():
        raise AssertionError(f"{name}: {bad} of {err.numel()} elements "
                             f"beyond their allowance, max |err| "
                             f"{float(err.max())}")
    return float(err.max())


# AdamW hyper-parameters of the training path
ADAMW = dict(beta1=0.9, beta2=0.999, eps=1e-8)
ADAMW_LR, ADAMW_WD = 3e-4, 0.1


def adamw_check(ka, pa, grads, lows, plows, wds, lr, c1, c2):
    """One kernel update of the whole list, then the plain update of each
    tensor from the same state, held per element:
    - m and v within 1e-6 of the terms they sum (beta1 |m0| +
      (1 - beta1) |g|, beta2 v0 + (1 - beta2) g^2): 8 f32 units;
    - the update p - p0 within 1e-10 + 1e-6 |p0| + 1e-4 |plain update|.
      The decoupled decay lr wd |p0| alone is 3e-5 |p0|, 30 times the
      allowance, so a kernel that drops or misscales it fails; Adam's term
      is held to 1e-4 of itself.
    - under O2 the bf16 parameter equals the rounded f32 one.
    Returns the largest |err| over p, m, v."""
    b1, b2 = ADAMW["beta1"], ADAMW["beta2"]
    p0 = [p.clone() for p in ka[0]]
    AD.fused_adamw_update(ka[0], grads, ka[1], ka[2], lr, c1, c2, wds=wds,
                          lows=lows, **ADAMW)
    errs = []
    for i, (g, wd) in enumerate(zip(grads, wds)):
        p, m, v = pa[0][i], pa[1][i], pa[2][i]
        gf = g.float()
        m_allow = 1e-6 * (b1 * m.abs() + (1 - b1) * gf.abs())
        v_allow = 1e-6 * (b2 * v + (1 - b2) * gf.square())
        AD.plain(p, g, m, v, lr, c1, c2, wd=wd, low=plows[i], **ADAMW)
        du = p - p0[i]
        errs.append(within(f"adamw m[{i}]", ka[1][i], m, m_allow))
        errs.append(within(f"adamw v[{i}]", ka[2][i], v, v_allow))
        errs.append(within(f"adamw update[{i}]", ka[0][i] - p0[i], du,
                           1e-10 + 1e-6 * p0[i].abs() + 1e-4 * du.abs()))
        if lows[i] is not None:
            assert torch.equal(lows[i], ka[0][i].to(torch.bfloat16)), i
        del m_allow, v_allow, du
    return max(errs)


def adamw_case(shapes, dtype, gen):
    """O2 when dtype is bf16 (bf16 grads, f32 master and moments, the bf16
    parameter written from the same pass); all f32 otherwise.  The state
    of a later step (t = 10: m and v nonzero), held by adamw_check."""
    def state():
        return ([rand(sh, torch.float32, gen, 0.02) for sh in shapes],
                [rand(sh, torch.float32, gen, 1e-3) for sh in shapes],
                [torch.rand(sh, generator=gen, device="cuda") * 2e-6
                 for sh in shapes])
    grads = [rand(sh, dtype, gen, 1e-3) for sh in shapes]
    lowp = dtype == torch.bfloat16
    ka = state()
    pa = tuple([t.clone() for t in ts] for ts in ka)
    lows = ([p.to(torch.bfloat16) for p in ka[0]] if lowp
            else [None] * len(shapes))
    plows = [t.clone() if t is not None else None for t in lows]
    wds = [0.0 if len(sh) == 1 else ADAMW_WD for sh in shapes]
    lr, (c1, c2) = ADAMW_LR, AD.bias_corrections(9, 0.9, 0.999)
    # the kernel's inputs as f32 parameters with f32 grads for the
    # yardstick: torch.optim.AdamW(fused=True) takes one dtype
    lparams = [torch.nn.Parameter(p.detach().clone()) for p in ka[0]]
    for p, g in zip(lparams, grads):
        p.grad = g.float()
    lib_opt = torch.optim.AdamW(lparams, lr=lr, weight_decay=ADAMW_WD,
                                fused=True)
    library = lib_opt.step
    err = adamw_check(ka, pa, grads, lows, plows, wds, lr, c1, c2)

    def kern():
        AD.fused_adamw_update(ka[0], grads, ka[1], ka[2], lr, c1, c2,
                              wds=wds, lows=lows, **ADAMW)

    def plain():
        for p, g, m, v, wd, low in zip(*pa, grads, wds, plows):
            AD.plain(p, g, m, v, lr, c1, c2, wd=wd, low=low, **ADAMW)

    n = sum(p.numel() for p in ka[0])
    nbytes = n * (4 * 6 + grads[0].element_size() + (2 if lowp else 0))
    return err, kern, plain, library, nbytes, 15.0 * n


def split_i_partial_bytes(t, h, inter):
    """The f32 partials of the former split-I design, for comparison: one
    (Tpad, H) partial per I split, 128-wide chunks, splits capped at
    32768 / Tpad rows (Tpad a multiple of 64)."""
    tpad = -(-t // 64) * 64
    chunks = inter // 128
    cps = -(-chunks // max(1, 32768 // tpad))
    return 4 * (-(-chunks // cps)) * tpad * h


def plan_fields(kind, t, h, inter, dtype):
    p = mlp_plan(t, h, inter, dtype, kind, sm_count(torch.device("cuda")))
    return {"up_bn": p.up_bn, "splits": p.splits, "up_blocks": p.up_blocks,
            "down_blocks": p.down_blocks, "h_bytes": p.h_bytes,
            "partial_bytes": p.partial_bytes,
            "scratch_bytes": p.scratch_bytes}


def mlp_inputs(kind, t, h, inter, dtype, gen):
    """(kernel, plain, library) closures of one MLP kind at (T, H, I)."""
    x = rand((t, h), dtype, gen)
    if kind == "swiglu":
        wg, wu = (rand((h, inter), dtype, gen, 0.02) for _ in range(2))
        wd = rand((inter, h), dtype, gen, 0.02)
        return (lambda: FM.fused_swiglu_mlp(x, wg, wu, wd),
                lambda: FM.plain(x, wg, wu, wd),
                lambda: (F.silu(x @ wg) * (x @ wu)) @ wd)
    w1, b1 = rand((h, inter), dtype, gen, 0.02), rand((inter,), dtype, gen,
                                                      0.1)
    w2, b2 = rand((inter, h), dtype, gen, 0.02), rand((h,), dtype, gen, 0.1)
    return (lambda: FG.fused_gelu_mlp(x, w1, b1, w2, b2),
            lambda: FG.plain(x, w1, b1, w2, b2),
            lambda: torch.addmm(b2, F.gelu(torch.addmm(b1, x, w1)), w2))


def mlp_scratch_rows(gen):
    """The bf16 MLP kernels' scratch from the plan (h in bf16, f32 split
    partials), error against plain and time: SwiGLU at llama2-7b widths at
    the serving and the training token counts, GELU at gpt3-6.7b widths at
    T = 1, 8, 128 and 257.  The partials must stay within 16 MiB at T <=
    257 and be 0 at T = 4096."""
    rows = []
    for kind, t, h, inter in (("swiglu", 128, 4096, 11008),
                              ("swiglu", 4096, 4096, 11008),
                              ("gelu", 1, 4096, 16384),
                              ("gelu", 8, 4096, 16384),
                              ("gelu", 128, 4096, 16384),
                              ("gelu", 257, 4096, 16384)):
        kern, plain, _ = mlp_inputs(kind, t, h, inter, torch.bfloat16, gen)
        row = {"kind": kind, "t": t, "shape": [t, h, inter],
               **plan_fields(kind, t, h, inter, torch.bfloat16),
               "split_i_partial_bytes": split_i_partial_bytes(t, h, inter),
               "max_abs_err": compare(f"{kind} t={t}", kern(), plain(),
                                      torch.bfloat16),
               "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain)}
        if t <= 257:
            assert row["partial_bytes"] <= MAX_PARTIAL_BYTES, row
        if t == 4096:
            assert row["partial_bytes"] == 0, row
        rows.append(row)
        log("mlp_scratch " + json.dumps(row))
        del kern, plain
        torch.cuda.empty_cache()
    return rows


def mlp_edge_rows(gen):
    """Both MLP kernels at token counts off the tiles (T = 1, 8, 63, 65,
    257: one row, a partial 128-row tile, either side of 64, three row
    tiles) and the llama2-70b SwiGLU at T = 1 and 257, bf16 and f32:
    error against plain, two calls bit-equal, the plan, and the bf16
    kernel's and library's times."""
    rows = []
    cases = [("swiglu", "llama2-7b", t, 4096, 11008)
             for t in (1, 8, 63, 65, 257)]
    cases += [("gelu", "gpt3-6.7b", t, 4096, 16384)
              for t in (1, 8, 63, 65, 257)]
    cases += [("swiglu", "llama2-70b", t, 8192, 28672) for t in (1, 257)]
    for kind, geom, t, h, inter in cases:
        for dt in (torch.bfloat16, torch.float32):
            kern, plain, library = mlp_inputs(kind, t, h, inter, dt, gen)
            got = kern()
            row = {"kind": kind, "geometry": geom, "shape": [t, h, inter],
                   "dtype": str(dt).replace("torch.", ""),
                   "max_abs_err": compare(f"{kind} {geom} t={t}", got,
                                          plain(), dt),
                   "tol": TOL[dt], "equal": bool(torch.equal(got, kern())),
                   **plan_fields(kind, t, h, inter, dt)}
            assert row["equal"], f"{kind} t={t}: two calls differ"
            if dt == torch.bfloat16:
                row["ms"] = cuda_ms(kern)
                row["library_ms"] = cuda_ms(library)
            rows.append(row)
            log("mlp_edges " + json.dumps(row))
            del kern, plain, library, got
            torch.cuda.empty_cache()
    return rows


QKV_GEOMS = {"llama2-7b": (4096, 4096, 4096, 128),
             "llama2-70b-gqa": (8192, 8192, 1024, 128)}


def qkv_plan_fields(t, h, nq, nk, hd, dtype):
    p = qkv_plan(t, h, nq, nk, hd, dtype, sm_count(torch.device("cuda")))
    return {"tiles": p.tiles, "splits": p.splits, "blocks": p.blocks,
            "nx_bytes": p.nx_bytes, "partial_bytes": p.partial_bytes,
            "scratch_bytes": p.scratch_bytes}


def qkv_edge_rows(gen):
    """The QKV kernel off the main shapes, bf16 and f32: llama2-7b at T =
    1, 8, 63, 65 and 257 (one row, a partial tile, either side of 64,
    three row tiles), head dim 64 at T = 128, llama2-70b GQA at T = 1 and
    257, and a hidden size of 4128 (a 32-wide contraction tail): error
    against plain, two calls bit-equal, the plan, and the bf16 kernel's
    and library's times."""
    cases = [("llama2-7b", t, *QKV_GEOMS["llama2-7b"])
             for t in (1, 8, 63, 65, 257)]
    cases += [("llama2-7b hd64", 128, 4096, 4096, 4096, 64)]
    cases += [("llama2-70b-gqa", t, *QKV_GEOMS["llama2-70b-gqa"])
              for t in (1, 257)]
    cases += [("h4128", 128, 4128, 4096, 4096, 128)]
    rows = []
    for geom, t, h, nq, nk, hd in cases:
        for dt in (torch.bfloat16, torch.float32):
            err, kern, plain, library, _, _ = qkv_case(t, h, nq, nk, hd, dt,
                                                       gen)
            a, b = kern(), kern()
            row = {"geometry": geom, "shape": [t, h, nq, nk, hd],
                   "dtype": str(dt).replace("torch.", ""),
                   "max_abs_err": err, "tol": TOL[dt],
                   "equal": all(torch.equal(x, y) for x, y in zip(a, b)),
                   **qkv_plan_fields(t, h, nq, nk, hd, dt)}
            assert row["equal"], f"qkv {geom} t={t}: two calls differ"
            if dt == torch.bfloat16:
                row["ms"] = cuda_ms(kern)
                row["library_ms"] = cuda_ms(library)
            rows.append(row)
            log("qkv_edges " + json.dumps(row))
            del kern, plain, library, a, b
            torch.cuda.empty_cache()
    return rows


def plan_lines():
    """The QKV, int8, int4 and megakernel plans at the main path's shapes:
    tiles, splits and scratch bytes (the f32 partials at most 16 MiB, none
    at T = 4096 or at the LM head)."""
    qkv = {}
    for geom, t in (("llama2-7b", 128), ("llama2-70b-gqa", 128),
                    ("llama2-7b", 4096)):
        for dt in (torch.bfloat16, torch.float32):
            f = qkv_plan_fields(t, *QKV_GEOMS[geom], dt)
            assert f["partial_bytes"] <= MAX_PARTIAL_BYTES, (geom, t, f)
            if t == 4096:
                assert f["partial_bytes"] == 0, f
            qkv[f"{geom} t={t} {str(dt).replace('torch.', '')}"] = f
    log("qkv_plan " + json.dumps(qkv))
    i8 = {}
    for m, k, n, _ in QUANT_STEP:
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            p = int8_plan(m, k, n, dt, sm_count(torch.device("cuda")))
            if dt != torch.float32:
                assert p.partial_bytes <= MAX_PARTIAL_BYTES, p
            i8[f"{m}x{k}x{n} {str(dt).replace('torch.', '')}"] = {
                "tiles": p.tiles, "splits": p.splits, "blocks": p.blocks,
                "partial_bytes": p.partial_bytes}
    log("int8_plan " + json.dumps(i8))
    sms = sm_count(torch.device("cuda"))
    i4 = {}
    for m, k, n in [s[:3] for s in QUANT_STEP] + [
            (1, 4096, 4096), (8, 4096, 4096), (257, 4096, 4096)]:
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            p = int4_plan(m, k, n, dt, sms)
            if dt != torch.float32:
                assert p.partial_bytes <= INT4_MAX_PARTIAL_BYTES, p
                assert m > 8 or p.bm == 8, p
            i4[f"{m}x{k}x{n} {str(dt).replace('torch.', '')}"] = {
                "bm": p.bm, "bn": p.bn, "tiles": p.tiles, "splits": p.splits,
                "blocks": p.blocks, "partial_bytes": p.partial_bytes}
    log("int4_plan " + json.dumps(i4))
    mg = {}
    for geom in ("llama2-7b", "llama2-70b-gqa"):
        for dt in (torch.bfloat16, torch.float32):
            p = mega_plan(128, *QKV_GEOMS[geom], dt, sms)
            assert p.partial_bytes <= MAX_PARTIAL_BYTES, p
            mg[f"{geom} {str(dt).replace('torch.', '')}"] = {
                "phases": p.phases, "qkv_tiles": p.qkv_tiles,
                "qkv_splits": p.qkv_splits, "o_tiles": p.o_tiles,
                "o_splits": p.o_splits, "scratch_bytes": p.scratch_bytes}
    log("mega_plan " + json.dumps(mg))
    return qkv, i8


def quant_case(kind, m, k, n, dtype, gen):
    """A weight-only matmul of a random (K, N) weight quantized on the
    card, x (M, K) in ``dtype``.  Library: torch.matmul over the weight
    already widened to x's dtype, times the scale -- what an unquantized
    cuBLAS layer costs; it reads 2 (int8) or 4 (int4) times the kernel's
    weight bytes."""
    _, fn, plain_fn = QUANT[kind]
    x = rand((m, k), dtype, gen)
    w = rand((k, n), torch.float32, gen, 0.02)
    q, s = Q.weight_quantize(w, "weight_only_" + kind)
    del w
    wide = (q if kind == "int8" else I4.unpack_int4(q)).to(dtype)
    kern = lambda: fn(x, q, s)
    plain = lambda: plain_fn(x, q, s)
    library = lambda: torch.matmul(x, wide) * s
    err = compare(f"{kind} {m}x{k}x{n}", kern(), plain(), dtype)
    nbytes = q.numel() + x.element_size() * (m * k + m * n) + 4 * n
    return err, kern, plain, library, nbytes, 2.0 * m * k * n, (x, q, s)


def int8pack_ms(x, q, s):
    """Time of torch._weight_int8pack_mm (x @ W.T * s, W (N, K) int8, the
    scales in x's dtype) on the same inputs where this PyTorch has it for
    CUDA tensors, else None.  A yardstick only: the port never calls
    it."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None
    wt, s = q.t().contiguous(), s.to(x.dtype)
    try:
        fn(x, wt, s)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"_weight_int8pack_mm unavailable for {x.dtype}: "
            f"{str(e).splitlines()[0][:120]}")
        return None
    return cuda_ms(lambda: fn(x, wt, s))


def step_sum(part, key):
    """A per-call measurement summed over one step's calls, or None where
    a row has none (the profiler recorded no device activity)."""
    if any(r[key] is None for r in part):
        return None
    return sum(r[key] * r["calls_per_step"] for r in part)


def host_us(fn, calls: int = 200) -> float:
    """The host's wall time per call, in microseconds, of ``calls``
    back-to-back calls without a synchronize: what a call costs the host
    (the wrapper and its launches) while the card works through them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def quant_kernel_rows(gen):
    """int8 and int4, bf16, f32 and f16, at the weight-only engine step's
    four shapes (the kernel's device time and host time per call beside
    its CUDA-event time); then each kind's sum over one step's 225
    calls."""
    rows = []
    for kind in QUANT:
        for m, k, n, calls in QUANT_STEP:
            for dt in (torch.bfloat16, torch.float32, torch.float16):
                err, kern, plain, library, nbytes, ops, ins = quant_case(
                    kind, m, k, n, dt, gen)
                torch.cuda.synchronize()
                bms, by = bound_ms(nbytes, ops, dt)
                row = {"name": QUANT[kind][0], "geometry": "llama2-7b",
                       "shape": [m, k, n], "calls_per_step": calls,
                       "dtype": str(dt).replace("torch.", ""),
                       "max_abs_err": err, "tol": TOL[dt],
                       "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
                       "library_ms": cuda_ms(library), "bound_ms": bms,
                       "bound_by": by,
                       "int8pack_ms": int8pack_ms(*ins)
                       if kind == "int8" else None,
                       "device_ms": device_ms(kern), "host_us": host_us(kern)}
                rows.append(row)
                log("kernel " + json.dumps(row))
                del kern, plain, library, ins
                torch.cuda.empty_cache()
    for kind in QUANT:
        part = [r for r in rows if r["name"] == QUANT[kind][0]
                and r["dtype"] == "bfloat16"]
        step = {"name": QUANT[kind][0], "geometry": "llama2-7b-step",
                "dtype": "bfloat16",
                "calls_per_step": sum(r["calls_per_step"] for r in part),
                "max_abs_err": max(r["max_abs_err"] for r in part)}
        for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                    "host_us"):
            step[key] = step_sum(part, key)
        by_bytes = sum(r["bound_ms"] * r["calls_per_step"] for r in part
                       if r["bound_by"] == "bytes")
        step["bound_by"] = "bytes" if by_bytes >= step["bound_ms"] / 2 \
            else "operations"
        rows.append(step)
        log("kernel " + json.dumps(step))
    return rows


def quant_edge_checks(gen):
    """The int8/int4 kernels against their plain versions off the main
    path's shapes: M in {1, 8, 257} with K = 100 (int8) / 102 (int4) and
    N = 200 (element loads, partial tiles), in bf16, f16 and f32; aligned
    shapes with K and N tails inside a tile (K = 4160, N = 272); an x
    that starts 2 bytes past a 16-byte boundary; and every byte value:
    an identity x (bf16, f16, f32) through all 256 int8 codes, and
    through all 256 packed bytes, must give the codes and the
    sign-extended nibbles exactly."""
    errs = {}
    for kind in QUANT:
        name, fn, plain_fn = QUANT[kind]
        k = 100 if kind == "int8" else 102
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            for m, kk, n in ((1, k, 200), (8, k, 200), (257, k, 200),
                             (257, 4160, 272)):
                x = rand((m, kk), dt, gen)
                q, s = Q.weight_quantize(
                    rand((kk, n), torch.float32, gen, 0.02),
                    "weight_only_" + kind)
                errs[f"{kind} {m}x{kk}x{n} {dt}"] = compare(
                    f"{kind} edge", fn(x, q, s), plain_fn(x, q, s), dt)
        flat = rand((8 * 4160 + 1,), torch.bfloat16, gen)
        x = flat[1:].view(8, 4160)                  # 2 bytes off alignment
        q, s = Q.weight_quantize(rand((4160, 272), torch.float32, gen, 0.02),
                                 "weight_only_" + kind)
        errs[f"{kind} unaligned x"] = compare(
            f"{kind} unaligned", fn(x, q, s), plain_fn(x, q, s),
            torch.bfloat16)
    every = torch.arange(-128, 128, dtype=torch.int8, device="cuda")
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        codes = every.view(16, 16)
        got = I8.int8_matmul(torch.eye(16, dtype=dt, device="cuda"), codes,
                             torch.ones(16, device="cuda"))
        assert torch.equal(got.float(), codes.float()), "int8 codes"
        got = I4.int4_matmul(torch.eye(32, dtype=dt, device="cuda"), codes,
                             torch.ones(16, device="cuda"))
        assert torch.equal(got.float(), I4.unpack_int4(codes).float()), \
            "int4 nibbles"
    errs["all 256 bytes"] = 0.0
    log("quant_edges " + json.dumps(errs))
    return errs


def ragged_batch(b, c, page, max_ctx, rng, idle=True):
    """Per-slot starts/lens of a serving step mixing decode rows deep in
    their context, a fresh prefill chunk, a chunk whose start straddles a
    page, partial chunks and (``idle``) an idle last slot; block tables
    of a random permutation of the pool, padded with the out-of-range
    sentinel.  Returns (starts, lens, tables, nb)."""
    mb = max_ctx // page
    nb = b * mb
    starts = np.zeros(b, np.int32)
    lens = np.zeros(b, np.int32)
    for s in range(b):
        kind = s % 6
        if kind == 0:
            starts[s], lens[s] = rng.integers(300, max_ctx - 1), 1
        elif kind == 1:
            starts[s], lens[s] = 0, c
        elif kind == 2:
            starts[s], lens[s] = 3 * page + page // 2 + 1, c
        elif kind == 3:
            starts[s], lens[s] = rng.integers(16, 200), rng.integers(1, c + 1)
        elif kind == 4:
            starts[s], lens[s] = rng.integers(17, 300), 1
        else:
            starts[s], lens[s] = rng.integers(0, max_ctx - c), c
    if idle:
        lens[b - 1] = 0
    tables = np.full((b, mb), nb, np.int32)
    perm = rng.permutation(nb)
    used = 0
    for s in range(b):
        n = -(-(int(starts[s]) + int(lens[s])) // page)
        tables[s, :n] = perm[used:used + n]
        used += n
    return starts, lens, tables, nb


def mega_inputs(b, c, h, nq, nk, hd, page, max_ctx, dtype, gen, rng,
                idle=True):
    starts, lens, tables, nb = ragged_batch(b, c, page, max_ctx, rng, idle)
    hkv = nk // hd
    x = rand((b, c, h), dtype, gen)
    g = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
    wq, wk, wv = (rand((h, n), dtype, gen, 0.02) for n in (nq, nk, nk))
    wo = rand((nq, h), dtype, gen, 0.02)
    kp = rand((nb, page, hkv, hd), dtype, gen)
    vp = rand((nb, page, hkv, hd), dtype, gen)
    tt, st, ln = (torch.from_numpy(a).cuda() for a in (tables, starts, lens))
    pos = st.long()[:, None] + torch.arange(c, device="cuda")
    cos, sin = NF.rope_cos_sin(c, hd, dtype=dtype, position_ids=pos)
    args = (x, g, wq, wk, wv, wo, cos, sin, kp, vp, tt, st, ln, hd, 1e-5)
    return args, starts, lens


def mega_check(args, dtype, tag="mega"):
    """Kernel against plain: the output on live rows, span k/v on every
    row; returns the larger error."""
    (x, *_rest) = args
    ln = args[12]
    got, want = MD.mega_decode(*args), MD.plain(*args)
    rows = torch.arange(x.shape[1], device="cuda")[None, :] < ln[:, None]
    return max(compare(f"{tag} out", got[0], want[0], dtype, rows),
               compare(f"{tag} span k", got[1], want[1], dtype),
               compare(f"{tag} span v", got[2], want[2], dtype))


def mega_case(b, c, h, nq, nk, hd, page, max_ctx, dtype, gen, rng):
    """The decode megakernel at a serving step's shape.  Composition: the
    port's chain it replaces on the card (QKV kernel, span write, ragged
    kernel, cuBLAS O projection, residual add).  Library: the same chain
    in plain PyTorch calls with cuBLAS products and no SDPA (rms_norm,
    x @ [Wq|Wk|Wv], RoPE, the span write, gathered pages, einsum scores,
    softmax, einsum values, O projection, add)."""
    args, starts, lens = mega_inputs(b, c, h, nq, nk, hd, page, max_ctx,
                                     dtype, gen, rng)
    (x, g, wq, wk, wv, wo, cos, sin, kp, vp, tt, st, ln, _, eps) = args
    err = mega_check(args, dtype)
    kern = lambda: MD.mega_decode(*args)
    plain = lambda: MD.plain(*args)
    t, hkv, grp = b * c, nk // hd, nq // nk
    wcat = torch.cat([wq, wk, wv], 1)

    def composition():
        q, k, v = FQ.fused_rms_rope_qkv(
            x.reshape(t, h), g, wq, wk, wv, cos.reshape(t, hd),
            sin.reshape(t, hd), hd, eps)
        attn, _ = IF.ragged_paged_attend(
            (kp, vp), q.view(b, c, -1, hd), k.view(b, c, hkv, hd),
            v.view(b, c, hkv, hd), tt, st, ln)
        return x + (attn.reshape(t, nq) @ wo).view(b, c, h)

    def library():
        nx = F.rms_norm(x, (h,), g, eps)
        y = nx @ wcat
        rot = lambda u: torch.cat([-u[..., hd // 2:], u[..., :hd // 2]], -1)
        cc, ss = cos[:, :, None], sin[:, :, None]
        q = y[..., :nq].view(b, c, -1, hd)
        k = y[..., nq:nq + nk].view(b, c, hkv, hd)
        q, k = q * cc + rot(q) * ss, k * cc + rot(k) * ss
        RA.span_write(kp, vp, k, y[..., nq + nk:].view(b, c, hkv, hd), tt,
                      st, ln)
        kd, vd = RA.paged_gather_dense(kp, vp, tt)
        sc = torch.einsum("bckgd,bskd->bckgs",
                          q.view(b, c, hkv, grp, hd), kd).float() * hd ** -0.5
        pos = st.long()[:, None] + torch.arange(c, device="cuda")
        mask = torch.arange(kd.shape[1], device="cuda") <= pos[..., None]
        pr = torch.softmax(sc.masked_fill(~mask[:, :, None, None],
                                          float("-inf")), -1).to(x.dtype)
        att = torch.einsum("bckgs,bskd->bckgd", pr, vd).reshape(t, nq)
        return x + (att @ wo).view(b, c, h)

    it = x.element_size()
    prefix_pages = sum(-(-int(s_) // page) for s_, n in zip(starts, lens)
                       if n)
    # read weights, norm, x, cos/sin and the live prefix pages; write out
    # and span k/v
    nbytes = it * (h * (nq + 2 * nk) + nq * h + h + 2 * t * hd + 2 * t * h
                   + 2 * t * nk + 2 * prefix_pages * page * hkv * hd) \
        + 4 * (tt.numel() + 2 * b)
    ctx = sum(int(s_) + j + 1 for s_, n in zip(starts, lens)
              for j in range(int(n)))
    ops = 2.0 * t * h * (nq + 2 * nk) + 2.0 * t * nq * h \
        + 4.0 * ctx * hd * (nq // hd)
    return err, kern, plain, library, nbytes, ops, composition


def mega_edge_checks(gen, rng):
    """The megakernel off the main path's shapes: a decode-only batch (C =
    1), a single live slot, head dims 64 and 256, GQA 4 and 2, page 64,
    in bf16 and f32."""
    errs = {}
    cases = (("C=1", 8, 1, 4096, 4096, 4096, 128, 16),
             ("one live slot", 4, 16, 4096, 4096, 4096, 128, 16),
             ("hd 64 gqa 4", 4, 16, 1024, 1024, 256, 64, 16),
             ("hd 256 gqa 2", 4, 8, 2048, 2048, 1024, 256, 16),
             ("page 64", 4, 16, 1024, 1024, 1024, 128, 64))
    for key, b, c, h, nq, nk, hd, page in cases:
        for dt in (torch.bfloat16, torch.float32):
            args, starts, lens = mega_inputs(b, c, h, nq, nk, hd, page, 512,
                                             dt, gen, rng)
            if key == "one live slot":          # slot 0: a decode row
                args[12][1:] = 0
            errs[f"{key} {dt}"] = mega_check(args, dt, key)
    log("mega_edges " + json.dumps(errs))
    return errs


def bgmv_inputs(bsz, c, d_in, d_out, r, dtype, gen, idx, n=5):
    x = rand((bsz, c, d_in), dtype, gen)
    a = rand((n, d_in, r), dtype, gen, LORA_SCALE)
    b = rand((n, r, d_out), dtype, gen, LORA_SCALE)
    a[0] = 0
    b[0] = 0
    return x, a, b, torch.tensor(idx, dtype=torch.int32, device="cuda")


def bgmv_check(x, a, b, ix, dtype, tag="bgmv"):
    """Kernel against plain; index-0 rows must be exactly 0."""
    got = LM.grouped_bgmv(x, a, b, ix)
    err = compare(tag, got, LM.plain(x, a, b, ix), dtype)
    base = ix == 0
    assert bool((got[base] == 0).all()), f"{tag}: index-0 rows not 0"
    assert torch.equal(got, LM.grouped_bgmv(x, a, b, ix)), \
        f"{tag}: two calls differ"
    return err


def bgmv_case(d_in, d_out, dtype, gen, bsz=8, c=16, r=LORA_RANK):
    """Grouped BGMV at one projection of the multi-LoRA step: 8 slots of
    16 rows, adapters 1-4 and two base slots.  Library: the gathered
    torch.bmm shrink and expand over index_select'ed stacks."""
    idx = [0, 1, 2, 3, 0, 4, 1, 2]
    x, a, b, ix = bgmv_inputs(bsz, c, d_in, d_out, r, dtype, gen, idx)
    err = bgmv_check(x, a, b, ix, dtype)
    kern = lambda: LM.grouped_bgmv(x, a, b, ix)
    plain = lambda: LM.plain(x, a, b, ix)
    library = lambda: torch.bmm(torch.bmm(x, a.index_select(0, ix.long())),
                                b.index_select(0, ix.long()))
    it = x.element_size()
    live = sum(1 for i in idx if i)
    distinct = len({i for i in idx if i})
    nbytes = it * (x.numel() + bsz * c * d_out
                   + distinct * r * (d_in + d_out)) + 4 * bsz
    ops = 2.0 * live * c * r * (d_in + d_out)
    return err, kern, plain, library, nbytes, ops


def bgmv_edge_checks(gen):
    """Grouped BGMV off the main path's shapes: rank 8, 24, 48 and 64, C
    = 1 and 40 (three row passes), a single live slot, d_in and d_out not
    multiples of the slice, tile or stripe (100, 1000), in bf16 and f32,
    two calls bit-equal; then rank 65 and f16 on the card must raise."""
    errs = {}
    cases = (("rank 8", 8, 16, 4096, 4096, 8, [0, 1, 2, 3, 0, 4, 1, 2]),
             ("rank 24", 4, 16, 1000, 700, 24, [2, 0, 4, 1]),
             ("rank 64", 4, 16, 4096, 4096, 64, [1, 2, 0, 3]),
             ("C=1", 8, 1, 4096, 11008, 16, [0, 1, 2, 3, 0, 4, 1, 2]),
             ("one live slot", 8, 16, 4096, 4096, 16, [0, 0, 0, 3, 0, 0, 0,
                                                       0]),
             ("d_in 100 d_out 1000", 3, 5, 100, 1000, 16, [1, 0, 2]),
             ("rank 48 C=40", 4, 40, 2048, 1000, 48, [3, 1, 0, 2]))
    for key, bsz, c, d_in, d_out, r, idx in cases:
        for dt in (torch.bfloat16, torch.float32):
            x, a, b, ix = bgmv_inputs(bsz, c, d_in, d_out, r, dt, gen, idx)
            errs[f"{key} {dt}"] = bgmv_check(x, a, b, ix, dt, key)
    # card tensors the kernel cannot take raise, never fall back
    for r, dt in ((65, torch.bfloat16), (16, torch.float16)):
        z = lambda *shape: torch.zeros(shape, dtype=dt, device="cuda")
        if not raises(lambda: LM.grouped_bgmv(
                z(2, 16, 256), z(3, 256, r), z(3, r, 256),
                torch.ones(2, dtype=torch.int32, device="cuda"))):
            raise AssertionError(f"grouped_bgmv took rank {r} {dt}")
    log("bgmv_edges " + json.dumps(errs))
    return errs


def ragged_plan_fields(b, c, h, hkv, d, page, max_ctx, dtype):
    p = ragged_plan(b, c, h, hkv, d, page, max_ctx // page, dtype,
                    sm_count(torch.device("cuda")))
    return {"path": p.path, "tiles": p.tiles, "splits": p.splits,
            "stages_per_split": p.per, "grid_blocks": p.grid_blocks,
            "partial_bytes": p.partial_bytes}


def bgmv_plan_fields(bsz, c, d_in, r, d_out, dtype):
    p = bgmv_plan(bsz, c, d_in, r, d_out, dtype)
    return {"path": p.path, "cluster": p.cluster, "slice": p.slice,
            "tiles": p.tiles, "grid_blocks": p.grid_blocks}


def raises(fn) -> bool:
    try:
        fn()
    except (TypeError, ValueError):
        return True
    return False


def ragged_edge_checks(gen, rng, b=6):
    """Ragged attention off the main path's shapes: head dims 64, 128 and
    256 (and 72, padded on the tensor cores, and 100, bf16's SIMT path),
    page 16 and 64, GQA groups 1, 2, 4 and 8, C = 1.  Each case's 6 slots:
    a decode row at the table's last position, a chunk from position 0, a
    chunk across the boundary of the plan's first split, a partial chunk,
    a short decode row and an idle slot, tables padded with the
    out-of-range sentinel.  bf16 and f32: the kernel against plain on live
    rows, dead rows zeros, two calls bit-equal.  Then card tensors the
    kernel cannot take (f16; f32 head dim 512, whose page needs more
    shared memory than a block has) must raise."""
    errs, plans = {}, {}
    cases = (("hd 64 G 4", 16, 16, 4, 64, 16, 512),
             ("hd 128 G 8 page 64", 16, 64, 8, 128, 64, 1024),
             ("hd 256 G 1", 16, 8, 8, 256, 16, 512),
             ("hd 128 G 1 page 64 C=1", 1, 32, 32, 128, 64, 512),
             ("hd 128 G 8 C=1", 1, 64, 8, 128, 16, 512),
             ("hd 72 G 2", 8, 8, 4, 72, 16, 256),
             ("hd 100 G 1", 8, 4, 4, 100, 16, 256))
    for key, c, h, hkv, d, page, max_ctx in cases:
        mb = max_ctx // page
        for dt in (torch.bfloat16, torch.float32):
            plan = ragged_plan_fields(b, c, h, hkv, d, page, max_ctx, dt)
            edge = plan["stages_per_split"] * 64 if plan["splits"] > 1 \
                else max_ctx // 2
            starts = np.array([max_ctx - 1, 0,
                               max(0, min(edge - c // 2, max_ctx - c)),
                               5, 37, 0], np.int32)
            lens = np.array([1, c, c, max(1, c // 2), 1, 0], np.int32)
            nb = b * mb
            tables = np.full((b, mb), nb, np.int32)
            perm = rng.permutation(nb)
            used = 0
            for s_ in range(b):
                n = -(-(int(starts[s_]) + int(lens[s_])) // page)
                tables[s_, :n] = perm[used:used + n]
                used += n
            q = rand((b, c, h, d), dt, gen)
            kp, vp = rand((nb, page, hkv, d), dt, gen), \
                rand((nb, page, hkv, d), dt, gen)
            tt, st, ln = (torch.from_numpy(a).cuda()
                          for a in (tables, starts, lens))
            rows = torch.arange(c, device="cuda")[None, :] < ln[:, None]
            got = RA.ragged_paged_attention(q, kp, vp, tt, st, ln)
            errs[f"{key} {dt}"] = compare(
                key, got, RA.plain(q, kp, vp, tt, st, ln), dt, rows)
            assert bool((got[~rows] == 0).all()), f"{key}: dead rows"
            assert torch.equal(got, RA.ragged_paged_attention(
                q, kp, vp, tt, st, ln)), f"{key}: two calls differ"
            plans[f"{key} {dt}"] = plan
    raised = []
    for dt, d in ((torch.float16, 128), (torch.float32, 512)):
        z = lambda *shape: torch.zeros(shape, dtype=dt, device="cuda")
        i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device="cuda")
        if not raises(lambda: RA.ragged_paged_attention(
                z(1, 1, 1, d), z(1, 16, 1, d), z(1, 16, 1, d), i32([0]),
                i32(0), i32(1))):
            raise AssertionError(f"ragged_paged_attention took {dt} "
                                 f"head_dim {d}")
        raised.append(f"{dt} head_dim {d}")
    log("ragged_edges " + json.dumps({"max_abs_err": errs, "plans": plans,
                                      "raised": raised}))
    return errs


def timed_row(name, geom, dt, case, extra=None):
    err, kern, plain, library, nbytes, ops, *more = case
    torch.cuda.synchronize()
    bms, by = bound_ms(nbytes, ops, dt)
    row = {"name": name, "geometry": geom,
           "dtype": str(dt).replace("torch.", ""), "max_abs_err": err,
           "tol": TOL[dt], "ms": cuda_ms(kern), "device_ms": device_ms(kern),
           "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
           "library_device_ms": device_ms(library), "bound_ms": bms,
           "bound_by": by}
    if more:
        row["composition_ms"] = cuda_ms(more[0])
    row.update(extra or {})
    log("kernel " + json.dumps(row))
    return row


def new_kernel_rows(gen, rng):
    """The decode megakernel at the llama2-7b engine step (B=8, C=16,
    page 16, contexts up to 512) and at the llama2-70b GQA geometry; the
    grouped BGMV at the multi-LoRA step's three geometries and its sum
    over one step's 224 calls; then the megakernel's, BGMV's and ragged
    attention's edge checks."""
    rows = []
    for geom, (h, nq, nk) in (("llama2-7b", (4096, 4096, 4096)),
                              ("llama2-70b-gqa", (8192, 8192, 1024))):
        for dt in (torch.bfloat16, torch.float32):
            plan = mega_plan(128, h, nq, nk, 128, dt,
                             sm_count(torch.device("cuda")))
            grid = MD.grid_blocks(8, 16, h, nq, nk, 16, nk // 128, 128,
                                  plan.qkv_splits, plan.o_splits,
                                  _build.dtype_code(dt))
            rows.append(timed_row(
                "mega_decode", geom, dt,
                mega_case(8, 16, h, nq, nk, 128, 16, 512, dt, gen, rng),
                {"grid_blocks": grid, "qkv_splits": plan.qkv_splits,
                 "o_splits": plan.o_splits, "phases": plan.phases}))
            torch.cuda.empty_cache()
    for d_in, d_out, calls in LORA_STEP:
        for dt in (torch.bfloat16, torch.float32):
            case = bgmv_case(d_in, d_out, dt, gen)
            rows.append(timed_row(
                "grouped_bgmv", "llama2-7b", dt, case,
                {"shape": [d_in, d_out, LORA_RANK], "calls_per_step": calls,
                 "host_us": host_us(case[1]),
                 **bgmv_plan_fields(8, 16, d_in, LORA_RANK, d_out, dt)}))
    part = [r for r in rows if r["name"] == "grouped_bgmv"
            and r["dtype"] == "bfloat16"]
    step = {"name": "grouped_bgmv", "geometry": "llama2-7b-step",
            "dtype": "bfloat16",
            "calls_per_step": sum(r["calls_per_step"] for r in part),
            "max_abs_err": max(r["max_abs_err"] for r in part)}
    for key in ("ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "host_us"):
        step[key] = step_sum(part, key)
    by_bytes = sum(r["bound_ms"] * r["calls_per_step"] for r in part
                   if r["bound_by"] == "bytes")
    step["bound_by"] = "bytes" if by_bytes >= step["bound_ms"] / 2 \
        else "operations"
    rows.append(step)
    log("kernel " + json.dumps(step))
    mega_edge_checks(gen, rng)
    bgmv_edge_checks(gen)
    ragged_edge_checks(gen, rng)
    return rows


def kernel_phase():
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the training kernels draw from their own generator, so the serving
    # kernels see the same inputs as in earlier runs of this script
    tgen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(0)
    shapes = {
        "llama2-7b": [
            ("fused_rms_rope_qkv", lambda dt: qkv_case(128, 4096, 4096,
                                                       4096, 128, dt, gen)),
            ("fused_swiglu_mlp", lambda dt: mlp_case(128, 4096, 11008, dt,
                                                     gen)),
            ("ragged_paged_attention", lambda dt: attn_case(
                *RAGGED["llama2-7b"], dt, gen, rng)),
            ("flash_attention_fwd", lambda dt: flash_fwd_case(
                2, 2048, 32, 32, 128, dt, tgen)),
            ("flash_attention_bwd", lambda dt: flash_bwd_case(
                2, 2048, 32, 32, 128, dt, tgen)),
            ("fused_adamw", lambda dt: adamw_case(
                train_shapes(llama_cfg("llama2-7b", num_hidden_layers=4)),
                dt, tgen))],
        "llama2-70b-gqa": [
            ("fused_rms_rope_qkv", lambda dt: qkv_case(128, 8192, 8192,
                                                       1024, 128, dt, gen)),
            ("fused_swiglu_mlp", lambda dt: mlp_case(128, 8192, 28672, dt,
                                                     gen)),
            ("ragged_paged_attention", lambda dt: attn_case(
                *RAGGED["llama2-70b-gqa"], dt, gen, rng)),
            ("flash_attention_fwd", lambda dt: flash_fwd_case(
                1, 2048, 64, 8, 128, dt, tgen)),
            ("flash_attention_bwd", lambda dt: flash_bwd_case(
                1, 2048, 64, 8, 128, dt, tgen))],
        # the training path's token count, T = B x S = 4096: the MLP
        # kernel gives each block several I chunks here (not at T = 128)
        "llama2-7b-train": [
            ("fused_rms_rope_qkv", lambda dt: qkv_case(4096, 4096, 4096,
                                                       4096, 128, dt, tgen)),
            ("fused_swiglu_mlp", lambda dt: mlp_case(4096, 4096, 11008, dt,
                                                     tgen))],
    }
    rows = []
    for geom, cases in shapes.items():
        for name, make in cases:
            flash = name.startswith("flash")
            for dt in (torch.bfloat16, torch.float32) + (
                    (torch.float16,) if flash else ()):
                err, kern, plain, library, nbytes, ops = make(dt)
                torch.cuda.synchronize()
                bms, by = bound_ms(nbytes, ops, dt)
                row = {"name": name, "geometry": geom,
                       "dtype": str(dt).replace("torch.", ""),
                       "max_abs_err": err, "tol": TOL[dt],
                       "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
                       "library_ms": cuda_ms(library), "bound_ms": bms,
                       "bound_by": by}
                if flash:
                    row["tflop_s"] = ops / row["ms"] * 1e-9
                if name in ("fused_swiglu_mlp", "fused_rms_rope_qkv",
                            "ragged_paged_attention"):
                    row["device_ms"] = device_ms(kern)
                if name == "ragged_paged_attention":
                    row["library_device_ms"] = device_ms(library)
                    row["host_us"] = host_us(kern)
                    row.update(ragged_plan_fields(*RAGGED[geom], dt))
                rows.append(row)
                log("kernel " + json.dumps(row))
                del kern, plain, library
                torch.cuda.empty_cache()
    mlp_scratch_rows(tgen)
    mlp_edge_rows(torch.Generator(device="cuda").manual_seed(5))
    qkv_edge_rows(torch.Generator(device="cuda").manual_seed(6))
    plan_lines()
    flash_edge_checks(tgen)
    # the weight-only kernels draw from their own generator, so the
    # earlier cases keep their inputs
    qgen = torch.Generator(device="cuda").manual_seed(2)
    rows += quant_kernel_rows(qgen)
    quant_edge_checks(qgen)
    # the megakernel and grouped-BGMV cases: a generator of their own
    rows += new_kernel_rows(torch.Generator(device="cuda").manual_seed(3),
                            np.random.default_rng(3))
    # the GPT path's kernels: a generator of their own
    rows += gpt_kernel_rows(torch.Generator(device="cuda").manual_seed(4),
                            np.random.default_rng(4))
    # generate()'s dense decode view: a generator of its own
    rows += dense_view_rows(torch.Generator(device="cuda").manual_seed(8),
                            np.random.default_rng(8))
    return rows


# -- engine phase ------------------------------------------------------------

def serve(eng, rng, n_plain, prompt_lo, prompt_hi, new_lo, new_hi):
    """Staggered greedy traffic: plain requests and a 64-token shared
    prefix, whose later requests arrive after its first one finished (one
    of them the bare prefix: fully cached, so copy-on-write).  Returns
    {request id: (prompt, max_new)} and the outputs."""
    prefix = rng.integers(0, 32000, size=64)
    reqs = {}

    def add(rid, prompt):
        n = int(rng.integers(new_lo, new_hi + 1))
        reqs[rid] = (prompt, n)
        eng.add_request(prompt, max_new_tokens=n, request_id=rid)

    first = n_plain // 2
    for i in range(first):
        add(f"r{i}", rng.integers(0, 32000, size=int(
            rng.integers(prompt_lo, prompt_hi + 1))))
    add("p0", np.concatenate([prefix, rng.integers(0, 32000, size=20)]))
    out = {}
    for _ in range(3):
        eng.step()
    for i in range(first, n_plain):                   # join a running batch
        add(f"r{i}", rng.integers(0, 32000, size=int(
            rng.integers(prompt_lo, prompt_hi + 1))))
    while len(eng.output_ids("p0")) < reqs["p0"][1]:
        eng.step()
    add("p1", np.concatenate([prefix, rng.integers(0, 32000, size=30)]))
    add("p2", prefix.copy())
    out.update(eng.run())
    return reqs, out


def reset_launches(device_type: str = "cuda"):
    """Set every kernel's launch count (``"cuda"``) or plain-version call
    count (``"cpu"``) to 0."""
    attr = "launches" if device_type == "cuda" else "plain_calls"
    for kern in CUDA_KERNELS.values():
        setattr(kern, attr, 0)


def kernel_launches():
    return counts("cuda")


def profile_steps(eng, rng, n_steps: int = 8, adapters=(None,)):
    """Device busy time and kernel time by name over ``n_steps`` steps of
    a fresh full batch (8 prompts of 17-300 tokens, their adapters taken
    in turn from ``adapters``), traced with torch.profiler after the
    counted run; None where the trace shows no device activity."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(8):
        eng.add_request(rng.integers(0, 32000, size=int(
            rng.integers(17, 301))), max_new_tokens=32,
            request_id=f"prof{i}", adapter=adapters[i % len(adapters)])
    eng.step()
    torch.cuda.synchronize()
    graph = eng._graph
    graph.replay_events = [] if graph.capture else None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events, graph.replay_events = graph.replay_events, None
    eng.run()
    res = profile_summary(prof, wall_ms, n_steps)
    res["captured"] = graph.capture
    if events:
        # the graph's device time by CUDA events around each replay: a
        # check on the trace's busy time, which has lost kernels before
        res["replay_events_ms_per_step"] = replay_ms(events) / n_steps
    return res


def replay_ms(events) -> float:
    return sum(start.elapsed_time(end) for start, end in events)


def timed_window(eng, seed, n_steps=8, adapters=(None,)):
    """Step ms over ``n_steps`` steps of a fresh full batch (profile_steps'
    traffic, drawn from ``seed``) after one untimed step, no profiler;
    for a captured engine also the replays' device ms (CUDA events) and
    the host's ms per step outside them (step ms less the replay's device
    ms: the host waits for the replay at sampling)."""
    rng = np.random.default_rng(seed)
    for i in range(8):
        eng.add_request(rng.integers(0, 32000, size=int(
            rng.integers(17, 301))), max_new_tokens=32,
            request_id=f"turn{seed}_{i}", adapter=adapters[i % len(adapters)])
    eng.step()
    torch.cuda.synchronize()
    graph = eng._graph
    graph.replay_events = [] if graph.capture else None
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    row = {"step_ms": (time.perf_counter() - t0) * 1e3 / n_steps}
    events, graph.replay_events = graph.replay_events, None
    eng.run()
    if events:
        row["replay_device_ms"] = replay_ms(events) / n_steps
        row["host_ms_outside_replay"] = row["step_ms"] - \
            row["replay_device_ms"]
    return row


def streams_vs_eager(ref, got, margins):
    """Every request's stream of the captured engine against the eager
    engine's under the near-tie rule, at most one request exempt; the
    exempt request's first differing step and the eager margin there."""
    exempt = {}
    assert sorted(got) == sorted(ref), (sorted(got), sorted(ref))
    for rid in ref:
        if near_tie_equal(ref[rid], got[rid], margins[rid]) == "exempt":
            i = next(i for i, (r, g) in enumerate(zip(ref[rid], got[rid]))
                     if r != g)
            exempt[rid] = {"step": i, "margin": margins[rid][i]}
    assert len(exempt) <= 1, exempt
    return {"requests": len(ref), "equal": len(ref) - len(exempt),
            "exempt": exempt}


def graph_vs_eager(eng, eager, steps, replays, out, eager_out,
                   adapters=(None,), seed=20):
    """The captured engine after its counted traffic (``steps`` steps,
    ``replays`` replays) against an eager twin (the same model,
    ``Engine(_eager_step=True)``) that served the same traffic with
    margins on: one capture, a replay per step, the same launches per
    step, equal streams; then step ms of both in turns (captured, eager,
    eager, captured; each pair on one fresh batch)."""
    assert eng.captures == 1, eng.captures
    assert replays == steps, (replays, steps)
    assert (eager.captures, eager.replays) == (0, 0)
    assert eager.launches_per_step() == eng.launches_per_step(), \
        (eager.launches_per_step(), eng.launches_per_step())
    res = {"captured": eng._graph.capture, "captures": eng.captures,
           "replays": steps,
           "streams_vs_eager": streams_vs_eager(eager_out, out,
                                                eager.margins)}
    turns = []
    for i, (tag, e) in enumerate((("captured", eng), ("eager", eager),
                                  ("eager", eager), ("captured", eng))):
        row = timed_window(e, seed + i // 2, adapters=adapters)
        turns.append({"engine": tag, **row})
    assert eng.captures == 1, eng.captures
    mean = lambda tag, key: statistics.mean(r[key] for r in turns
                                            if r["engine"] == tag)
    res.update({"turns": turns,
                "captured_step_ms": mean("captured", "step_ms"),
                "eager_step_ms": mean("eager", "step_ms"),
                "replay_device_ms": mean("captured", "replay_device_ms"),
                "host_ms_outside_replay":
                    mean("captured", "host_ms_outside_replay")})
    return res


def eager_twin(model, serve_fn, **kw):
    """An eager engine (``Engine(_eager_step=True)``, margins on) on
    ``model`` through ``serve_fn``'s traffic; returns it and its
    outputs."""
    eager = Engine(model, max_batch=8, max_seq_len=512, page_size=16,
                   _eager_step=True, **kw).warmup()
    eager.margins = {}
    return eager, serve_fn(eager)


def graph_phase(res, eng, eager, steps, replays, out, eager_out,
                adapters=(None,), eager_profile=True):
    """``res`` gains the captured-against-eager block (graph_vs_eager) and
    the captured engine's profile over one fresh batch, and with
    ``eager_profile`` the eager twin's too."""
    res["graph"] = graph_vs_eager(eng, eager, steps, replays, out,
                                  eager_out, adapters=adapters)
    res["profile"] = profile_steps(eng, np.random.default_rng(3),
                                   adapters=adapters)
    if eager_profile:
        res["graph"]["eager_profile"] = profile_steps(
            eager, np.random.default_rng(3), adapters=adapters)
    assert eng.captures == 1, eng.captures


# the fused MLP kernels' names in a trace: the up kernels of
# csrc/fused_mlp.cu and csrc/fused_gelu_mlp.cu, and csrc/mlp_gemm.cuh's
# down projection and split sum (namespace mlp)
MLP_KERNEL_NAMES = ("up16_kernel", "up32_kernel", "mlp::")


def device_ms_by_kernel(prof):
    """Summed durations by kernel name, in ms (a dependent launch's
    duration includes its wait for the kernel before it)."""
    by_name = {}
    for ev in device_events(prof):
        by_name[ev.name] = by_name.get(ev.name, 0.0) + \
            ev.time_range.elapsed_us() / 1e3
    return by_name


def profile_summary(prof, wall_ms, n_steps, top=10):
    """Device busy time (the union of the kernels' intervals), idle share,
    the largest kernels by summed duration and the fused MLP kernels'
    busy time of a trace over ``n_steps`` steps of ``wall_ms``; None where
    the trace shows no device activity."""
    events = device_events(prof)
    busy = union_ms(events)
    largest = sorted(device_ms_by_kernel(prof).items(),
                     key=lambda kv: -kv[1])[:top]
    mlp = [ev for ev in events if any(m in ev.name for m in MLP_KERNEL_NAMES)]
    return {"steps": n_steps, "wall_ms": wall_ms,
            "device_busy_ms": busy if busy else None,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "top_kernels_ms": [[k[:80], v] for k, v in largest],
            "mlp_ms_per_step": union_ms(mlp) / n_steps}


def engine_phase():
    t0 = time.perf_counter()
    model = llama("llama2-7b", dtype="bfloat16", seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(model, max_batch=8, max_seq_len=512, page_size=16).warmup()
    setup_s = time.perf_counter() - t0
    assert (eng.captures, eng.replays) == (1, 0)
    rng = np.random.default_rng(1)
    reset_launches()
    steps0, replays0 = eng.steps, eng.replays
    t1 = time.perf_counter()
    reqs, out = serve(eng, rng, 5, 17, 300, 16, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    hbm = eng.hbm_stats()
    launches = {k: v for k, v in kernel_launches().items() if k in SERVING}
    steps, replays = eng.steps - steps0, eng.replays - replays0
    layers = model.cfg.num_hidden_layers
    stats = eng.prefix_stats()
    assert len(reqs) == 8 and sorted(out) == sorted(reqs), sorted(out)
    for rid, (_, n) in reqs.items():
        assert len(out[rid]) == n, (rid, len(out[rid]), n)
    assert eng.kv_blocks_used == 0, eng.kv_blocks_used
    assert stats["hits"] > 0 and stats["cow_copies"] > 0, stats
    for name, n in launches.items():
        assert n == layers * steps, (name, n, layers, steps)
    res = {"setup_s": setup_s, "steps": steps, "wall_s": wall,
           "tokens": eng.tokens_emitted,
           "tok_s": eng.tokens_emitted / wall,
           "step_ms": wall / steps * 1e3, "prefix": stats,
           "launches": launches, "layers": layers, "hbm": hbm,
           "prompt_tokens": int(sum(len(p) for p, _ in reqs.values()))}
    eager, (_, eager_out) = eager_twin(model, lambda e: serve(
        e, np.random.default_rng(1), 5, 17, 300, 16, 32))
    graph_phase(res, eng, eager, steps, replays, out, eager_out)
    log("engine " + json.dumps(res))
    res["streams"] = out
    del eng, eager
    torch.cuda.empty_cache()
    return res, model


# -- int8 KV pools and caches ---------------------------------------------------

def leading_equal(ref, got):
    """How many leading tokens of ``got`` equal ``ref``'s."""
    n = 0
    while n < min(len(ref), len(got)) and int(got[n]) == int(ref[n]):
        n += 1
    return n


def kv8_engine_phase(model, bf16):
    """The engine phase's model, engine geometry and traffic behind
    Engine(kv_cache_dtype="int8"): int8 pools with f32 scales per
    (position, head), written quantized and attended through the
    reference's gather+dequant composition inside the captured step.
    Per step 32 QKV and 32 SwiGLU launches, no ragged-attention or
    megakernel launch; one capture; streams equal to an eager twin's
    under the near-tie rule; pools drained, prefix hits and CoW;
    hbm_stats' kv_pool_bytes (D + 4) / (2 D) of the bf16 engine's
    (``bf16``: the engine phase's result); step, replay and host ms and
    tokens/s beside the bf16 engine's, and how many leading tokens of
    each stream equal the bf16 engine's (reported, not gated)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(model, max_batch=8, max_seq_len=512, page_size=16,
                 kv_cache_dtype="int8").warmup()
    setup_s = time.perf_counter() - t0
    assert (eng.captures, eng.replays) == (1, 0)
    assert eng.kv.quantized and len(eng.kv.caches[0]) == 4
    reset_launches()
    steps0, replays0 = eng.steps, eng.replays
    t1 = time.perf_counter()
    reqs, out = serve(eng, np.random.default_rng(1), 5, 17, 300, 16, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    hbm = eng.hbm_stats()
    launches = kernel_launches()
    steps, replays = eng.steps - steps0, eng.replays - replays0
    layers = model.cfg.num_hidden_layers
    stats = eng.prefix_stats()
    assert len(reqs) == 8 and sorted(out) == sorted(reqs), sorted(out)
    for rid, (_, n) in reqs.items():
        assert len(out[rid]) == n, (rid, len(out[rid]), n)
    assert eng.kv_blocks_used == 0, eng.kv_blocks_used
    assert stats["hits"] > 0 and stats["cow_copies"] > 0, stats
    per_step = {"fused_rms_rope_qkv": layers, "fused_swiglu_mlp": layers,
                "ragged_paged_attention": 0, "mega_decode": 0,
                "paged_attention": 0}
    got = {k: eng.launches_per_step()[k] for k in per_step}
    assert got == per_step, (got, per_step)
    totals = {k: launches[k] for k in per_step}
    assert totals == {k: v * steps for k, v in per_step.items()}, totals
    d = model.cfg.head_dim
    bf16_kv = bf16["hbm"]["kv_pool_bytes"]
    assert hbm["kv_pool_bytes"] * 2 * d == bf16_kv * (d + 4), \
        (hbm["kv_pool_bytes"], bf16_kv)
    res = {"kv_cache_dtype": "int8", "setup_s": setup_s, "steps": steps,
           "wall_s": wall, "tokens": eng.tokens_emitted,
           "tok_s": eng.tokens_emitted / wall,
           "step_ms": wall / steps * 1e3, "prefix": stats,
           "launches_per_step": got, "launches": totals, "layers": layers,
           "hbm": hbm, "bf16_hbm": bf16["hbm"],
           "kv_pool_bytes_vs_bf16": hbm["kv_pool_bytes"] / bf16_kv,
           "leading_equal_vs_bf16": {
               rid: [leading_equal(bf16["streams"][rid], out[rid]),
                     len(out[rid])] for rid in sorted(out)}}
    eager, (_, eager_out) = eager_twin(model, lambda e: serve(
        e, np.random.default_rng(1), 5, 17, 300, 16, 32),
        kv_cache_dtype="int8")
    # the eager twin's profile is left out: its steps cost ~0.1 s each
    graph_phase(res, eng, eager, steps, replays, out, eager_out,
                eager_profile=False)
    g, gb = res["graph"], bf16["graph"]
    res["vs_bf16"] = {
        key: {"int8": g[key], "bf16": gb[key]}
        for key in ("captured_step_ms", "eager_step_ms", "replay_device_ms",
                    "host_ms_outside_replay")}
    res["vs_bf16"]["tok_s"] = {"int8": res["tok_s"], "bf16": bf16["tok_s"]}
    res["phase_s"] = time.perf_counter() - t0
    log("kv8_engine " + json.dumps(res))
    del eng, eager
    torch.cuda.empty_cache()
    return res


# -- speculative decoding and preemption ---------------------------------------

# the spec phases' traffic: 8 requests of 128-token prompts (a request's
# own 32-token phrase, 4 times), 64 new tokens each; 6 greedy, 2 at
# temperature 0.8; the preempt phase's late prompt of 300 tokens
SPEC_TRAFFIC = {"phrase": 32, "reps": 4, "new": 64, "temperature": 0.8,
                "late": 300}
SPEC_DEPTH = 4


def spec_traffic(seed, tag):
    """[(request id, prompt, temperature, step it joins)]: greedy g0-g4
    and temperature t0, t1 at step 0; g5, g0's prompt again, at step 8,
    when g0's 128 prompt tokens are written (8 chunks of 16): a full
    prefix hit whose last page is copied on write."""
    rng = np.random.default_rng(seed)
    t = SPEC_TRAFFIC
    phrases = [rng.integers(0, 32000, size=t["phrase"]) for _ in range(7)]
    reqs = [(f"{tag}g{i}", np.tile(phrases[i], t["reps"]), 0.0, 0)
            for i in range(5)]
    reqs += [(f"{tag}t{i}", np.tile(phrases[5 + i], t["reps"]),
              t["temperature"], 0) for i in range(2)]
    reqs.append((f"{tag}g5", np.tile(phrases[0], t["reps"]), 0.0, 8))
    return reqs


def spec_run(eng, reqs, on_step=None, new=SPEC_TRAFFIC["new"]):
    """Serve ``reqs`` (spec_traffic's form) to the end, step by step;
    ``on_step(eng, i)`` runs before step ``i``.  Returns the streams and,
    per run: steps, tokens, wall ms per step (each step ends in the
    host's read of its samples), decode tokens/s over the steps in which
    no request was prefilling or waiting, and the replays' device ms per
    step (CUDA events)."""
    pending = sorted(reqs, key=lambda r: r[3])
    steps0, tokens0 = eng.steps, eng.tokens_emitted
    graph = eng._graph
    graph.replay_events = []
    walls, decode_steps, decode_ms, decode_tokens, i = [], 0, 0.0, 0, 0
    t_run = time.perf_counter()
    while pending or eng.has_work():
        while pending and pending[0][3] <= i:
            rid, prompt, temp, _ = pending.pop(0)
            eng.add_request(prompt, max_new_tokens=new, temperature=temp,
                            request_id=rid)
        if on_step is not None:
            on_step(eng, i)
        decode = not eng.scheduler.waiting and not any(
            st.prefilling for _, st in eng.scheduler.active())
        t0 = time.perf_counter()
        n = len(eng.step())
        ms = (time.perf_counter() - t0) * 1e3
        walls.append(ms)
        if decode:
            decode_steps += 1
            decode_ms += ms
            decode_tokens += n
        i += 1
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t_run) * 1e3
    events, graph.replay_events = graph.replay_events, None
    steps, tokens = eng.steps - steps0, eng.tokens_emitted - tokens0
    out = {rid: eng.output_ids(rid) for rid, *_ in reqs}
    for rid, *_ in reqs:
        assert len(out[rid]) == new, (rid, len(out[rid]))
    return out, {"steps": steps, "tokens": tokens,
                 "tokens_per_step": tokens / steps,
                 "step_ms": statistics.mean(walls), "wall_ms": wall_ms,
                 "decode_steps": decode_steps,
                 "decode_tok_s": decode_tokens / decode_ms * 1e3
                 if decode_ms else None,
                 "replay_device_ms": replay_ms(events) / len(events)
                 if events else None}


def spec_engine_phase(model):
    """The engine phase's llama2-7b behind a speculative engine
    (draft_depth 4, so C stays 16) and a spec-off engine, both captured,
    in turns in one process: the counted run with each kernel's launches
    (layers x steps), greedy streams of the spec engine equal to spec-
    off's under the near-tie rule, temperature streams equal token for
    token, launches per step equal on and off, one capture each; then
    step ms, tokens per step, decode tokens/s and replay ms in turns (on,
    off, off, on; each pair on fresh traffic)."""
    layers = model.cfg.num_hidden_layers
    geom = dict(max_batch=8, max_seq_len=512, page_size=16)
    t0 = time.perf_counter()
    engines = {"on": Engine(model, spec_decode=True, draft_depth=SPEC_DEPTH,
                            **geom).warmup(),
               "off": Engine(model, **geom).warmup()}
    setup_s = time.perf_counter() - t0
    for eng in engines.values():
        assert (eng.captures, eng.replays) == (1, 0)
        assert eng.prefill_chunk == 16, eng.prefill_chunk
    reqs = spec_traffic(40, "c")
    engines["off"].margins = {}
    runs, outs = {}, {}
    for tag in ("off", "on"):
        eng = engines[tag]
        reset_launches()
        outs[tag], run = spec_run(eng, reqs)
        launches = {k: v for k, v in kernel_launches().items()
                    if k in SERVING}
        for name, n in launches.items():
            assert n == layers * run["steps"], (tag, name, n, run["steps"])
        run["launches"] = launches
        run["launches_per_step"] = eng.launches_per_step()
        assert eng.replays == run["steps"], (eng.replays, run["steps"])
        runs[tag] = run
    margins, engines["off"].margins = engines["off"].margins, None
    assert runs["on"]["launches_per_step"] == \
        runs["off"]["launches_per_step"], runs
    greedy = [rid for rid, _, temp, _ in reqs if temp == 0.0]
    sampled = [rid for rid, _, temp, _ in reqs if temp > 0.0]
    streams = streams_vs_eager({r: outs["off"][r] for r in greedy},
                               {r: outs["on"][r] for r in greedy}, margins)
    for rid in sampled:
        assert outs["on"][rid] == outs["off"][rid], rid
    stats = engines["on"].spec_stats()
    for eng in engines.values():
        assert eng.kv_blocks_used == 0, eng.kv_blocks_used
        assert eng.prefix_stats()["hits"] > 0, eng.prefix_stats()
        assert eng.prefix_stats()["cow_copies"] > 0, eng.prefix_stats()
    turns = []
    for i, tag in enumerate(("on", "off", "off", "on")):
        _, row = spec_run(engines[tag], spec_traffic(41 + i // 2, f"w{i}"))
        turns.append({"engine": tag, **row})
    mean = lambda tag, key: statistics.mean(r[key] for r in turns
                                            if r["engine"] == tag)
    res = {"setup_s": setup_s, "draft_depth": SPEC_DEPTH,
           "captures": {t: e.captures for t, e in engines.items()},
           "replays": {t: e.replays for t, e in engines.items()},
           "runs": runs, "spec_stats": stats,
           "greedy_streams": streams,
           "sampled_streams_equal": len(sampled),
           "turns": turns,
           "step_ms": {t: mean(t, "step_ms") for t in engines},
           "tokens_per_step": {t: mean(t, "tokens_per_step")
                               for t in engines},
           "decode_tok_s": {t: mean(t, "decode_tok_s") for t in engines},
           "replay_device_ms": {t: mean(t, "replay_device_ms")
                                for t in engines}}
    for eng in engines.values():
        assert eng.captures == 1, eng.captures
    res["wall_s"] = time.perf_counter() - t0
    log("spec_engine " + json.dumps(res))
    return engines


def preempt_phase(engines):
    """On the spec engine and the spec-off one: spec_traffic on fresh
    phrases plus a late 300-token prompt at step 16, first with two
    preemptions -- at step 16 the running request that borrows g0's
    prefix pages (g5), which frees a slot for the late prompt, and at
    step 24 the late prompt itself, still prefilling (19 chunks of 16) --
    then again without preemption (the reference; its prompts now hit the
    prefix cache).  Every greedy stream equals the reference's under the
    near-tie rule.  A temperature stream's seed folds in the request's
    submission ordinal on its engine (duplicate prompts draw distinct
    streams), so the reference run draws other ones by design: the two
    engines' preempted runs, at equal ordinals, must draw the same
    temperature streams instead.  Also printed and checked: the swaps'
    pages, ms and GB/s (CUDA events around each call), the borrowed
    pages' refcounts before and after the first preemption, one capture
    each, the pools' addresses unchanged, and the prefix cache still hits
    afterwards."""
    t0 = time.perf_counter()
    late = np.random.default_rng(43).integers(
        0, 32000, size=SPEC_TRAFFIC["late"])
    res, sampled = {}, {}
    for tag, eng in engines.items():
        rows = {"out": [], "in": []}
        swap = eng._swap
        swap_out, swap_in = swap.swap_out, swap.swap_in

        def timed(kind, fn):
            def call(*args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                host = fn(*args)
                end.record()
                payload = host if kind == "out" else args[1]
                rows[kind].append((start, end, len(args[0]),
                                   payload.nbytes()))
                return host
            return call

        swap.swap_out = timed("out", swap_out)
        swap.swap_in = timed("in", swap_in)
        ptrs = eng._ptrs(eng.kv.caches)
        pre = spec_traffic(44, f"{tag}p") + [(f"{tag}pl", late, 0.0, 16)]
        seen = {}

        def on_step(e, i):
            if i == 16:
                st = e._states[f"{tag}pg5"]
                assert st.num_shared > 0 and st.slot is not None
                # the pages it still borrows (the last hit page was
                # copied on write)
                shared = [int(b) for b in
                          st.table[:st.cached_tokens // e.page_size]]
                seen["refcounts_before"] = [e.kv.allocator.refcount(b)
                                            for b in shared]
                assert e.preempt(f"{tag}pg5")
                seen["refcounts_after"] = [e.kv.allocator.refcount(b)
                                           for b in shared]
            if i == 24:
                st = e._states[f"{tag}pl"]
                assert st.slot is not None and st.prefilling, st.kv_len
                seen["late_kv_len"] = st.kv_len
                assert e.preempt(f"{tag}pl")

        got, run = spec_run(eng, pre, on_step=on_step)
        torch.cuda.synchronize()
        assert eng._ptrs(eng.kv.caches) == ptrs == eng._pool_ptrs
        del swap.swap_out, swap.swap_in
        for rid in ("pg5", "pl"):
            assert eng._states[f"{tag}{rid}"].preempts == 1
        hits = eng.prefix_stats()["hits"]
        base = [(f"{tag}u{rid[len(tag) + 1:]}", *rest) for rid, *rest in pre]
        eng.margins = {}
        ref, _ = spec_run(eng, base)
        margins, eng.margins = eng.margins, None
        assert eng.prefix_stats()["hits"] > hits, eng.prefix_stats()
        rename = {u[0]: p_[0] for u, p_ in zip(base, pre) if u[2] == 0.0}
        streams = streams_vs_eager(
            {rename[r]: ref[r] for r in rename},
            {r: got[r] for r in rename.values()},
            {rename[r]: margins[r] for r in rename})
        sampled[tag] = [got[rid] for rid, _, temp, _ in pre if temp > 0.0]
        assert eng.kv_blocks_used == 0 and eng.captures == 1
        swaps = {kind: [{"pages": n, "bytes": b,
                         "ms": s_.elapsed_time(e_),
                         "gb_s": b / s_.elapsed_time(e_) / 1e6}
                        for s_, e_, n, b in r] for kind, r in rows.items()}
        assert len(swaps["out"]) == len(swaps["in"]) == 2, swaps
        res[tag] = {"captures": eng.captures, "replays": eng.replays,
                    "pages_out": swap.pages_out, "pages_in": swap.pages_in,
                    "swaps": swaps, **seen, "run": run,
                    "streams": streams,
                    "pool_addresses_unchanged": True}
    assert sampled["on"] == sampled["off"]
    res["sampled_streams_equal_on_off"] = len(sampled["on"])
    res["wall_s"] = time.perf_counter() - t0
    log("preempt " + json.dumps(res))
    return res


def spec_cross_check_phase():
    """llama-350m-hd128 cut to 2 layers, f32, the same weights on both
    sides: the speculative engine on the card (captured) against the same
    engine on the CPU (the plain versions), with one preemption and one
    injected serve.step fault (the request it hits is isolated: preempted
    and restored) on both sides; greedy streams equal with 0 exempt, and
    equal draft and acceptance counts."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = llama("llama-350m-hd128", num_hidden_layers=2, dtype="float32",
                seed=1)
    cpu = llama("llama-350m-hd128", num_hidden_layers=2, dtype="float32",
                device="cpu", seed=1)
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(45)
    prompts = [np.tile(rng.integers(0, 32000, size=int(n)), 3)
               for n in rng.integers(8, 30, size=5)]
    outs = {}
    for tag, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, None)):
        eng = Engine(model, max_batch=4, max_seq_len=256, page_size=16,
                     spec_decode=True, draft_depth=SPEC_DEPTH,
                     device=dev).warmup()
        inj = install_faults("serve.step@6")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                rids = [eng.add_request(p, max_new_tokens=24,
                                        request_id=f"x{i}")
                        for i, p in enumerate(prompts)]
                for _ in range(5):
                    eng.step()
                victim = min(eng.scheduler.active(),
                             key=lambda t: t[1].prefilling)[1]
                victim = victim.request.request_id
                assert eng.preempt(victim)
                eng.run()
        finally:
            clear_faults()
        assert inj.fired == [("serve.step", 6)], inj.fired
        assert eng.kv_blocks_used == 0
        outs[tag] = ({r: eng.output_ids(r) for r in rids},
                     eng.spec_stats(), victim,
                     sum(eng._states[r].preempts for r in rids),
                     eng.captures)
    (ref, rstats, rvic, rpre, _), (got, gstats, gvic, gpre, caps) = \
        outs["cpu"], outs["gpu"]
    assert got == ref, {r: (ref[r], got[r]) for r in ref if ref[r] != got[r]}
    assert (gvic, gpre) == (rvic, rpre) == (rvic, 2), (gvic, gpre, rpre)
    for key in ("proposed", "accepted", "verifies"):
        assert gstats[key] == rstats[key], (key, gstats, rstats)
    assert gstats["verifies"] > 0, gstats     # verify spans ran
    assert caps == 1, caps
    res = {"requests": len(ref), "equal": len(ref), "exempt": 0,
           "preempts": gpre, "spec_stats": gstats, "captures": caps,
           "wall_s": time.perf_counter() - t0}
    log("spec_cross_check " + json.dumps(res))
    del gpu, cpu
    torch.cuda.empty_cache()
    return res


def kv8_cross_check_phase():
    """llama-350m-hd128 cut to 2 layers, f32, the same weights on both
    sides, int8 KV pools, the card (captured) against the CPU (the plain
    versions) on three engines: ``kv_cache_dtype="int8"``; that with
    ``weight_quant="int8"`` (codes and scales bit-equal card vs CPU); that
    with ``spec_decode=True`` and one preemption (the swap carries values
    and scales).  Greedy streams equal under the near-tie rule (CPU
    margins, at most one request exempt), prefix accounting equal, on
    the card one capture each and no ragged-attention or megakernel
    launch."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(46)
    spec_prompts = [np.tile(rng.integers(0, 32000, size=int(n)), 3)
                    for n in rng.integers(8, 30, size=5)]
    forms = (("int8_kv", {}), ("int8_kv_weight_int8", {"weight_quant": "int8"}),
             ("int8_kv_spec_preempt", {"spec_decode": True,
                                       "draft_depth": SPEC_DEPTH}))
    res = {}
    for form, kw in forms:
        gpu = llama("llama-350m-hd128", num_hidden_layers=2, dtype="float32",
                    seed=1)
        cpu = llama("llama-350m-hd128", num_hidden_layers=2, dtype="float32",
                    device="cpu", seed=1)
        cpu.load_state_dict(gpu.state_dict())
        outs = {}
        for tag, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, None)):
            eng = Engine(model, max_batch=4, max_seq_len=256, page_size=16,
                         device=dev, kv_cache_dtype="int8", **kw).warmup()
            eng.margins = {}
            before = kernel_launches()
            if "spec_decode" in kw:
                rids = [eng.add_request(p, max_new_tokens=24,
                                        request_id=f"x{i}")
                        for i, p in enumerate(spec_prompts)]
                for _ in range(5):
                    eng.step()
                victim = min(eng.scheduler.active(),
                             key=lambda t: t[1].prefilling)[1]
                assert eng.preempt(victim.request.request_id)
                eng.run()
                out = {r: eng.output_ids(r) for r in rids}
                assert eng._swap.pages_in > 0 and sum(
                    eng._states[r].preempts for r in rids) == 1
            else:
                _, out = serve(eng, np.random.default_rng(2), 3, 17, 90, 6,
                               10)
            delta = launch_delta(before, kernel_launches())
            assert eng.kv_blocks_used == 0
            outs[tag] = (out, eng.margins, eng.prefix_stats(), eng.captures,
                         delta, eng.spec_stats())
        if "weight_quant" in kw:
            cbuf, gbuf = dict(cpu.named_buffers()), dict(gpu.named_buffers())
            assert sorted(cbuf) == sorted(gbuf) and gbuf
            for bname, t in gbuf.items():
                assert torch.equal(t.cpu(), cbuf[bname]), bname
        (ref, margins, rstats, _, _, rspec), \
            (got, _, gstats, caps, delta, gspec) = outs["cpu"], outs["gpu"]
        assert sorted(got) == sorted(ref)
        verdicts = {rid: near_tie_equal(ref[rid], got[rid], margins[rid])
                    for rid in ref}
        exempt = sorted(r for r, v in verdicts.items() if v == "exempt")
        assert len(exempt) <= 1, exempt
        assert rstats == gstats, (rstats, gstats)
        assert caps == 1, caps
        assert delta["ragged_paged_attention"] == 0 and \
            delta["mega_decode"] == 0, delta
        main = "int8_matmul" if "weight_quant" in kw else "fused_rms_rope_qkv"
        assert delta[main] > 0, delta
        if "spec_decode" in kw:
            assert gspec["verifies"] > 0, gspec
            if not exempt:
                for key in ("proposed", "accepted", "verifies"):
                    assert gspec[key] == rspec[key], (key, gspec, rspec)
        res[form] = {"requests": len(ref),
                     "equal": sum(v == "equal" for v in verdicts.values()),
                     "exempt": exempt,
                     "min_margin": min(min(m) for m in margins.values()),
                     "captures": caps,
                     "launches": {k: v for k, v in delta.items() if v}}
        del gpu, cpu, outs
        torch.cuda.empty_cache()
    res["bucket_int8"] = kv8_bucket_cross_check()
    res["wall_s"] = time.perf_counter() - t0
    log("kv8_cross_check " + json.dumps(res))
    return res


def kv8_bucket_cross_check(steps=4):
    """The bucket prefill/decode path over int8 ``PagedKVCache`` pools,
    llama-350m-hd128 cut to 2 layers, f32, card against CPU: 4 prompts in
    one prefill call (the flash forward kernel) and ``steps`` decode calls
    (the paged composition: no paged-attention launch), the card fed the
    CPU's greedy tokens; each call's greedy token on the card equal to
    the CPU's under the near-tie rule (CPU margins), logits finite, their
    largest difference reported (an int8 code one unit apart where the
    card's and the CPU's K round a tie differently moves a logit by more
    than the f32 tolerance)."""
    gpu = llama("llama-350m-hd128", num_hidden_layers=2, dtype="float32",
                seed=1)
    cpu = llama("llama-350m-hd128", num_hidden_layers=2, dtype="float32",
                device="cpu", seed=1)
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 32000, size=int(n)) for n in (17, 40, 64, 90)]
    ref = paged_generate(cpu, prompts, steps, "cpu", kv_dtype="int8")
    got = paged_generate(gpu, prompts, steps, "cuda", forced=ref["tokens"],
                         kv_dtype="int8")
    layers = gpu.cfg.num_hidden_layers
    pre, dec = got["launches"]
    assert pre["flash_attention_fwd"] == layers, pre
    assert dec["paged_attention"] == 0 and \
        dec["fused_rms_rope_qkv"] == layers * steps, dec
    exempt, err = [], 0.0
    for i, (g, r) in enumerate(zip(got["logits"], ref["logits"])):
        assert bool(torch.isfinite(g).all()), f"call {i}: non-finite"
        err = max(err, float((g - r).abs().max()))
        top = r.topk(2, dim=-1).values
        margin = (top[:, 0] - top[:, 1]).numpy()
        for row in np.nonzero(g.argmax(-1).numpy()
                              != r.argmax(-1).numpy())[0]:
            assert margin[row] < TIE, (i, int(row), float(margin[row]))
            exempt.append([i, int(row)])
    assert len(exempt) <= 1, exempt
    del gpu, cpu
    torch.cuda.empty_cache()
    return {"calls": steps + 1, "rows": len(prompts), "exempt": exempt,
            "max_abs_logit_diff": err,
            "launches_decode": {k: v for k, v in dec.items() if v}}


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def quant_engine_phase(kind):
    """The engine phase's model, engine and traffic with
    Engine(weight_quant=kind): every projection and the LM head launch
    the int8/int4 kernel (7 per layer + 1 per step), the fused QKV/MLP
    kernels none, ragged attention one per layer."""
    name = QUANT[kind][0]
    t0 = time.perf_counter()
    model = llama("llama2-7b", dtype="bfloat16", seed=0)
    torch.cuda.synchronize()
    bf16_alloc = torch.cuda.memory_allocated()
    bf16_weights = tensor_bytes(model.parameters())
    eng = Engine(model, max_batch=8, max_seq_len=512, page_size=16,
                 weight_quant=kind).warmup()
    setup_s = time.perf_counter() - t0
    assert (eng.captures, eng.replays) == (1, 0)
    qlin = [m for m in model.modules() if isinstance(m, Q.QuantizedLinear)]
    layers = model.cfg.num_hidden_layers
    per_step = 7 * layers + 1
    assert len(qlin) == per_step, len(qlin)
    kv_bytes = tensor_bytes(c for kv in eng.kv.caches for c in kv)
    mem = {"bf16_weight_bytes": bf16_weights,
           "weight_bytes": tensor_bytes(list(model.parameters())
                                        + list(model.buffers())),
           "linear_code_bytes": tensor_bytes(m.weight for m in qlin),
           "bf16_linear_bytes": 2 * sum(m.in_features * m.out_features
                                        for m in qlin),
           "memory_allocated_bf16_model": bf16_alloc,
           "memory_allocated_engine": torch.cuda.memory_allocated(),
           "kv_pool_bytes": kv_bytes}
    rng = np.random.default_rng(1)
    reset_launches()
    steps0, replays0 = eng.steps, eng.replays
    t1 = time.perf_counter()
    reqs, out = serve(eng, rng, 5, 17, 300, 16, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = kernel_launches()
    steps, replays = eng.steps - steps0, eng.replays - replays0
    stats = eng.prefix_stats()
    assert len(reqs) == 8 and sorted(out) == sorted(reqs), sorted(out)
    for rid, (_, n) in reqs.items():
        assert len(out[rid]) == n, (rid, len(out[rid]), n)
    assert eng.kv_blocks_used == 0, eng.kv_blocks_used
    assert stats["hits"] > 0 and stats["cow_copies"] > 0, stats
    want = {name: per_step * steps, "ragged_paged_attention": layers * steps,
            "fused_rms_rope_qkv": 0, "fused_swiglu_mlp": 0}
    got = {k: launches[k] for k in want}
    assert got == want, (got, want)
    other = [v[0] for k, v in QUANT.items() if k != kind][0]
    assert launches[other] == 0, launches
    res = {"weight_quant": kind, "setup_s": setup_s, "steps": steps,
           "wall_s": wall, "tokens": eng.tokens_emitted,
           "tok_s": eng.tokens_emitted / wall,
           "step_ms": wall / steps * 1e3, "prefix": stats,
           "launches": got, "launches_per_step": per_step,
           "memory": mem}
    assert eng.launches_per_step()[name] == per_step
    # the model is quantized already: the twin serves it as it is
    eager, (_, eager_out) = eager_twin(model, lambda e: serve(
        e, np.random.default_rng(1), 5, 17, 300, 16, 32))
    graph_phase(res, eng, eager, steps, replays, out, eager_out)
    log("quant_engine " + json.dumps(res))
    del eng, eager, model, qlin
    torch.cuda.empty_cache()
    return res


def near_tie_equal(ref, got, margins):
    """"equal", or "exempt" when the streams first differ at a step whose
    reference top-2 margin is below TIE; raises otherwise."""
    for i, (r, g) in enumerate(zip(ref, got)):
        if r != g:
            if margins[i] >= TIE:
                raise AssertionError(f"token {i}: {g} != {r}, reference "
                                     f"margin {margins[i]}")
            return "exempt"
    if len(ref) != len(got):
        raise AssertionError(f"lengths {len(got)} != {len(ref)}")
    return "equal"


def cross_check_phase():
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = llama("llama2-7b", num_hidden_layers=2, dtype="float32", seed=1)
    cpu = llama("llama2-7b", num_hidden_layers=2, dtype="float32",
                device="cpu", seed=1)
    cpu.load_state_dict(gpu.state_dict())
    outs = {}
    for tag, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, None)):
        eng = Engine(model, max_batch=4, max_seq_len=256, page_size=16,
                     device=dev).warmup()
        eng.margins = {}
        reqs, out = serve(eng, np.random.default_rng(2), 3, 17, 90, 6, 10)
        assert eng.kv_blocks_used == 0
        outs[tag] = (out, eng.margins, eng.prefix_stats())
    (ref, margins, rstats), (got, _, gstats) = outs["cpu"], outs["gpu"]
    verdicts = {rid: near_tie_equal(ref[rid], got[rid], margins[rid])
                for rid in ref}
    assert sorted(got) == sorted(ref)
    assert rstats == gstats, (rstats, gstats)
    res = {"requests": len(ref),
           "equal": sum(v == "equal" for v in verdicts.values()),
           "exempt": sorted(r for r, v in verdicts.items()
                            if v == "exempt"),
           "min_margin": min(min(m) for m in margins.values())}
    log("cross_check " + json.dumps(res))
    return res


def quant_cross_check_phase():
    """For int8 and int4: 2 layers at full llama2-7b width in f32, the
    same float weights on both sides, each engine quantizing its own
    model in place (weight_quant=).  The codes and scales quantized on
    the card must equal the CPU's bit for bit; greedy streams, the
    kernels on the card against the plain versions on the CPU, equal
    under the near-tie rule; prefix stats equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for kind in QUANT:
        gpu = llama("llama2-7b", num_hidden_layers=2, dtype="float32",
                    seed=1)
        cpu = llama("llama2-7b", num_hidden_layers=2, dtype="float32",
                    device="cpu", seed=1)
        cpu.load_state_dict(gpu.state_dict())
        outs = {}
        for tag, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, None)):
            eng = Engine(model, max_batch=4, max_seq_len=256, page_size=16,
                         device=dev, weight_quant=kind).warmup()
            eng.margins = {}
            reqs, out = serve(eng, np.random.default_rng(2), 3, 17, 90, 6,
                              10)
            assert eng.kv_blocks_used == 0
            outs[tag] = (out, eng.margins, eng.prefix_stats())
        cbuf = dict(cpu.named_buffers())
        gbuf = dict(gpu.named_buffers())
        assert sorted(cbuf) == sorted(gbuf) and len(gbuf) == 2 * 15
        for bname, t in gbuf.items():
            assert torch.equal(t.cpu(), cbuf[bname]), f"{kind} {bname}"
        (ref, margins, rstats), (got, _, gstats) = outs["cpu"], outs["gpu"]
        verdicts = {rid: near_tie_equal(ref[rid], got[rid], margins[rid])
                    for rid in ref}
        assert sorted(got) == sorted(ref) and len(ref) == 6
        assert rstats == gstats, (rstats, gstats)
        res[kind] = {"requests": len(ref),
                     "equal": sum(v == "equal" for v in verdicts.values()),
                     "exempt": sorted(r for r, v in verdicts.items()
                                      if v == "exempt"),
                     "min_margin": min(min(m) for m in margins.values()),
                     "buffers_bit_equal": len(gbuf)}
        del gpu, cpu, outs
        torch.cuda.empty_cache()
    log("quant_cross_check " + json.dumps(res))
    return res


def mega_engine_phase():
    """The engine phase's model, engine and traffic with
    fused_ops="mega": per layer one decode-megakernel launch and one fused
    MLP launch, no QKV or ragged attention launch."""
    t0 = time.perf_counter()
    model = llama("llama2-7b", dtype="bfloat16", seed=0, fused_ops="mega")
    torch.cuda.synchronize()
    eng = Engine(model, max_batch=8, max_seq_len=512, page_size=16).warmup()
    setup_s = time.perf_counter() - t0
    assert (eng.captures, eng.replays) == (1, 0)
    rng = np.random.default_rng(1)
    reset_launches()
    steps0, replays0 = eng.steps, eng.replays
    t1 = time.perf_counter()
    reqs, out = serve(eng, rng, 5, 17, 300, 16, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    steps, replays = eng.steps - steps0, eng.replays - replays0
    layers = model.cfg.num_hidden_layers
    stats = eng.prefix_stats()
    assert len(reqs) == 8 and sorted(out) == sorted(reqs), sorted(out)
    for rid, (_, n) in reqs.items():
        assert len(out[rid]) == n, (rid, len(out[rid]), n)
    assert eng.kv_blocks_used == 0, eng.kv_blocks_used
    assert stats["hits"] > 0 and stats["cow_copies"] > 0, stats
    per_step = {"mega_decode": layers, "fused_swiglu_mlp": layers,
                "fused_rms_rope_qkv": 0, "ragged_paged_attention": 0}
    got = {k: eng.launches_per_step()[k] for k in per_step}
    assert got == per_step, (got, per_step)
    launches = kernel_launches()
    totals = {k: launches[k] for k in per_step}
    assert totals == {k: v * steps for k, v in per_step.items()}, totals
    res = {"fused_ops": "mega", "setup_s": setup_s, "steps": steps,
           "wall_s": wall, "tokens": eng.tokens_emitted,
           "tok_s": eng.tokens_emitted / wall,
           "step_ms": wall / steps * 1e3, "prefix": stats,
           "launches_per_step": got, "launches": totals}
    eager, (_, eager_out) = eager_twin(model, lambda e: serve(
        e, np.random.default_rng(1), 5, 17, 300, 16, 32))
    graph_phase(res, eng, eager, steps, replays, out, eager_out)
    log("mega_engine " + json.dumps(res))
    del eng, eager, model
    torch.cuda.empty_cache()
    return res


def stack_ptrs(pool):
    return [t.data_ptr() for pack in pool.device_stacks()
            for ab in pack.values() for t in ab.values()]


def serve_lora(eng, rng, vocab, max_new=(16, 32), prompt_hi=120):
    """Multi-LoRA traffic: two base requests; adapter "ad0" three times,
    the second sharing the first's 64-token prefix after it finished
    (prefix hits within an adapter), the third the bare prefix (fully
    cached: copy-on-write); one prompt X under "ad1" and, after it
    finished, under "ad2" (no hit across adapters); one more request on
    each of "ad1" and "ad2".  Returns {id: (prompt, max_new, adapter)},
    the outputs, and the page hits of the two second-arrivals."""
    reqs, out = {}, {}

    def add(rid, prompt, adapter):
        n = int(rng.integers(max_new[0], max_new[1] + 1))
        reqs[rid] = (prompt, n, adapter)
        eng.add_request(prompt, max_new_tokens=n, request_id=rid,
                        adapter=adapter)

    rnd = lambda n: rng.integers(0, vocab, size=n)
    some = lambda: rnd(int(rng.integers(17, prompt_hi + 1)))
    prefix, x_prompt = rnd(64), rnd(40)
    add("b0", some(), None)
    add("b1", some(), None)
    add("a0p", np.concatenate([prefix, rnd(20)]), "ad0")
    add("a1x", x_prompt.copy(), "ad1")
    add("a1y", some(), "ad1")
    add("a2y", some(), "ad2")
    while not (eng._states["a0p"].finished and eng._states["a1x"].finished):
        eng.step()
    hits = {}
    for rid, prompt, adapter in (("a0q", np.concatenate([prefix, rnd(30)]),
                                  "ad0"), ("a2x", x_prompt.copy(), "ad2"),
                                 ("a0r", prefix.copy(), "ad0")):
        h0 = eng.prefix_stats()["hits"]
        add(rid, prompt, adapter)
        eng._admit_all()
        hits[rid] = eng.prefix_stats()["hits"] - h0
    out.update(eng.run())
    return reqs, out, hits


def base_streams(model, reqs, max_batch=8):
    """The base requests of ``reqs`` (and prompt X) through a LoRA-less
    engine on ``model`` (on the card): {id: output} and the margins."""
    eng = Engine(model, max_batch=max_batch, max_seq_len=512,
                 page_size=16).warmup()
    eng.margins = {}
    for rid, (prompt, n, adapter) in reqs.items():
        if adapter is None or rid == "a1x":
            eng.add_request(prompt, max_new_tokens=n, request_id=rid)
    out = eng.run()
    return out, eng.margins


def lora_engine_phase():
    """llama2-7b in bf16 behind the same engine with lora=LoRAPool(model,
    max_adapters=4, rank=16) and three random adapters: mixed batches,
    224 grouped-BGMV launches per step, prefix hits within an adapter and
    none across adapters, base streams equal to a LoRA-less engine's,
    then an evict/load churn that leaves the stack tensors in place."""
    t0 = time.perf_counter()
    model = llama("llama2-7b", dtype="bfloat16", seed=0, fused_ops="off")
    torch.cuda.synchronize()
    pool = LoRAPool(model, max_adapters=4, rank=LORA_RANK)
    arng = np.random.default_rng(5)
    for name in ("ad0", "ad1", "ad2"):
        pool.load(name, random_adapter(model, rank=LORA_RANK, rng=arng,
                                       scale=LORA_SCALE))
    eng = Engine(model, max_batch=8, max_seq_len=512, page_size=16,
                 lora=pool).warmup()
    setup_s = time.perf_counter() - t0
    assert (eng.captures, eng.replays) == (1, 0)
    ptrs = stack_ptrs(pool)
    layers = model.cfg.num_hidden_layers
    rng = np.random.default_rng(1)
    reset_launches()
    steps0, replays0 = eng.steps, eng.replays
    t1 = time.perf_counter()
    reqs, out, hits = serve_lora(eng, rng, model.cfg.vocab_size)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    steps, replays = eng.steps - steps0, eng.replays - replays0
    assert sorted(out) == sorted(reqs) and len(reqs) == 9, sorted(out)
    for rid, (_, n, _) in reqs.items():
        assert len(out[rid]) == n, (rid, len(out[rid]), n)
    assert eng.kv_blocks_used == 0, eng.kv_blocks_used
    assert hits["a0q"] > 0 and hits["a2x"] == 0, hits
    assert eng.prefix_stats()["cow_copies"] > 0, eng.prefix_stats()
    per_step = {"grouped_bgmv": 7 * layers, "ragged_paged_attention": layers,
                "fused_rms_rope_qkv": 0, "fused_swiglu_mlp": 0,
                "mega_decode": 0}
    got = {k: eng.launches_per_step()[k] for k in per_step}
    assert got == per_step, (got, per_step)
    launches = kernel_launches()
    totals = {k: launches[k] for k in per_step}
    assert totals == {k: v * steps for k, v in per_step.items()}, totals
    # the same traffic through an eager twin, before the churn below
    # evicts one of its adapters
    eager, (_, eager_out, _) = eager_twin(
        model, lambda e: serve_lora(e, np.random.default_rng(1),
                                    model.cfg.vocab_size), lora=pool)
    # base streams against a LoRA-less engine on the same model and path
    ref, margins = base_streams(model, reqs)
    verdicts = {rid: near_tie_equal(ref[rid], out[rid], margins[rid])
                for rid in ("b0", "b1")}
    changed = ref["a1x"] != out["a1x"] or ref["a1x"] != out["a2x"]
    assert changed, "the adapters left prompt X's greedy stream unchanged"
    # churn: evict an idle adapter, load a fourth into its slot, serve on
    freed = pool.slot_of("ad2")
    pool.evict("ad2")
    slot = pool.load("ad3", random_adapter(model, rank=LORA_RANK, rng=arng,
                                           scale=LORA_SCALE))
    assert slot == freed and stack_ptrs(pool) == ptrs
    for rid, adapter in (("c3", "ad3"), ("c1", "ad1")):
        eng.add_request(rng.integers(0, model.cfg.vocab_size, size=40),
                        max_new_tokens=8, request_id=rid, adapter=adapter)
    churn = eng.run()
    assert sorted(churn) == ["c1", "c3"] and eng.kv_blocks_used == 0
    assert stack_ptrs(pool) == ptrs and pool.stats()["live_refs"] == 0
    res = {"setup_s": setup_s, "steps": steps, "wall_s": wall,
           "tokens": sum(len(o) for o in out.values()),
           "tok_s": sum(len(o) for o in out.values()) / wall,
           "step_ms": wall / steps * 1e3, "prefix": eng.prefix_stats(),
           "page_hits": hits, "launches_per_step": got, "launches": totals,
           "base_vs_lora_less": verdicts, "adapter_changed_stream": changed,
           "lora_stack_bytes": pool.nbytes(), "lora_scale": LORA_SCALE,
           "pool": pool.stats(), "stack_ptrs_unchanged": True}
    # the windows' batches: six adapted requests over three adapters,
    # two base
    graph_phase(res, eng, eager, steps, replays, out, eager_out,
                adapters=(None, "ad0", "ad1", "ad3"))
    log("lora_engine " + json.dumps(res))
    del eng, eager, model, pool
    torch.cuda.empty_cache()
    return res


def mega_cross_check_phase():
    """fused_ops="mega", 2 layers at full llama2-7b width in f32, the same
    weights on both sides: the megakernel on the card against the
    composition on the CPU, greedy streams equal under the near-tie rule,
    prefix stats equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = llama("llama2-7b", num_hidden_layers=2, dtype="float32", seed=1,
                fused_ops="mega")
    cpu = llama("llama2-7b", num_hidden_layers=2, dtype="float32",
                device="cpu", seed=1, fused_ops="mega")
    cpu.load_state_dict(gpu.state_dict())
    outs = {}
    for tag, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, None)):
        eng = Engine(model, max_batch=4, max_seq_len=256, page_size=16,
                     device=dev).warmup()
        eng.margins = {}
        reqs, out = serve(eng, np.random.default_rng(2), 3, 17, 90, 6, 10)
        assert eng.kv_blocks_used == 0
        assert eng.launches_per_step()["mega_decode"] == 2
        outs[tag] = (out, eng.margins, eng.prefix_stats())
    (ref, margins, rstats), (got, _, gstats) = outs["cpu"], outs["gpu"]
    verdicts = {rid: near_tie_equal(ref[rid], got[rid], margins[rid])
                for rid in ref}
    assert sorted(got) == sorted(ref) and len(ref) == 6
    assert rstats == gstats, (rstats, gstats)
    res = {"requests": len(ref),
           "equal": sum(v == "equal" for v in verdicts.values()),
           "exempt": sorted(r for r, v in verdicts.items()
                            if v == "exempt"),
           "min_margin": min(min(m) for m in margins.values())}
    log("mega_cross_check " + json.dumps(res))
    del gpu, cpu
    torch.cuda.empty_cache()
    return res


def lora_cross_check_phase():
    """Multi-LoRA, 2 layers at full llama2-7b width in f32, the same
    weights and adapters on both sides: the grouped-BGMV kernel on the
    card against the plain version on the CPU, greedy streams equal under
    the near-tie rule and prefix stats equal; on the card the base
    requests' streams also equal a LoRA-less engine's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = llama("llama2-7b", num_hidden_layers=2, dtype="float32", seed=1,
                fused_ops="off")
    cpu = llama("llama2-7b", num_hidden_layers=2, dtype="float32",
                device="cpu", seed=1, fused_ops="off")
    cpu.load_state_dict(gpu.state_dict())
    adapters = [random_adapter(cpu, rank=LORA_RANK,
                               rng=np.random.default_rng(6 + i),
                               scale=LORA_SCALE) for i in range(3)]
    outs = {}
    for tag, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, None)):
        pool = LoRAPool(model, max_adapters=4, rank=LORA_RANK)
        for i, w in enumerate(adapters):
            pool.load(f"ad{i}", w)
        eng = Engine(model, max_batch=4, max_seq_len=256, page_size=16,
                     device=dev, lora=pool).warmup()
        eng.margins = {}
        reqs, out, hits = serve_lora(eng, np.random.default_rng(3), 32000,
                                     max_new=(6, 10), prompt_hi=90)
        assert eng.kv_blocks_used == 0
        assert hits["a0q"] > 0 and hits["a2x"] == 0, hits
        outs[tag] = (out, eng.margins, eng.prefix_stats(), reqs)
    (ref, margins, rstats, reqs), (got, _, gstats, _) = outs["cpu"], \
        outs["gpu"]
    verdicts = {rid: near_tie_equal(ref[rid], got[rid], margins[rid])
                for rid in ref}
    assert sorted(got) == sorted(ref) and len(ref) == 9
    assert rstats == gstats, (rstats, gstats)
    base, bmargins = base_streams(gpu, reqs, max_batch=4)
    base_verdicts = {rid: near_tie_equal(base[rid], got[rid], bmargins[rid])
                     for rid in ("b0", "b1")}
    res = {"requests": len(ref),
           "equal": sum(v == "equal" for v in verdicts.values()),
           "exempt": sorted(r for r, v in verdicts.items()
                            if v == "exempt"),
           "min_margin": min(min(m) for m in margins.values()),
           "base_vs_lora_less": base_verdicts}
    log("lora_cross_check " + json.dumps(res))
    del gpu, cpu
    torch.cuda.empty_cache()
    return res


# -- GPT phases --------------------------------------------------------------

def gelu_case(t, h, f, dtype, gen):
    """The fused GELU MLP at (T, H, F), two calls bit-equal.  Library:
    torch.addmm -> F.gelu -> torch.addmm (cuBLAS with the bias in the
    epilogue)."""
    kern, plain, library = mlp_inputs("gelu", t, h, f, dtype, gen)
    nbytes = torch.finfo(dtype).bits // 8 * (2 * t * h + 2 * h * f + f + h)
    got = kern()
    err = compare("gelu_mlp", got, plain(), dtype)
    assert torch.equal(got, kern()), f"gelu_mlp t={t}: two calls differ"
    return err, kern, plain, library, nbytes, 4.0 * t * h * f


def paged_case(b, h, hkv, d, page, lens, dtype, gen, rng):
    """Paged decode attention: one q row per slot over pages of a random
    permutation of the pool, tables padded with the out-of-range sentinel
    past each slot's live pages (at least one sentinel column).  A
    zero-length slot must give exact zeros.  Library: SDPA over the
    gathered, head-repeated KV with a length mask (gather included)."""
    lens = np.asarray(lens, np.int32)
    mb = -(-int(lens.max()) // page) + 1
    nb = b * mb
    q = rand((b, h, d), dtype, gen)
    kp, vp = rand((nb, page, hkv, d), dtype, gen), \
        rand((nb, page, hkv, d), dtype, gen)
    tables = np.full((b, mb), nb, np.int32)
    perm = rng.permutation(nb)
    used = 0
    for s in range(b):
        n = -(-int(lens[s]) // page)
        tables[s, :n] = perm[used:used + n]
        used += n
    tt = torch.from_numpy(tables).cuda()
    ln = torch.from_numpy(lens).cuda()
    kern = lambda: PA.paged_attention(q, kp, vp, tt, ln)
    plain = lambda: PA.plain(q, kp, vp, tt, ln)
    g = h // hkv

    def library():
        k, v = RA.paged_gather_dense(kp, vp, tt)
        k = k.transpose(1, 2).repeat_interleave(g, 1)
        v = v.transpose(1, 2).repeat_interleave(g, 1)
        mask = torch.arange(k.shape[2], device="cuda") < ln[:, None]
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=mask[:, None, None])

    got = kern()
    err = compare("paged_attn", got, plain(), dtype)
    assert bool((got[ln == 0] == 0).all()), "zero-length slot not zeros"
    assert torch.equal(got, kern()), f"paged_attn {dtype}: two calls differ"
    it = q.element_size()
    nbytes = it * (2 * b * h * d + 2 * int(lens.sum()) * hkv * d) \
        + 4 * (b * mb + b)
    return err, kern, plain, library, nbytes, 4.0 * int(lens.sum()) * h * d


def dense_view_case(b, h, hkv, d, cap, lens, dtype, gen):
    """Paged decode attention over dense (B, cap, H_kv, D) caches read as
    one page of cap positions per slot (``dense_attention``, the view
    ``generate()``'s decode step attends), held against
    ``attend_dense_gqa`` on the same caches, two calls bit-equal.
    Library: SDPA over the dense, head-repeated cache with a length
    mask."""
    lens = np.asarray(lens, np.int32)
    q = rand((b, h, d), dtype, gen)
    kc, vc = rand((b, cap, hkv, d), dtype, gen), \
        rand((b, cap, hkv, d), dtype, gen)
    ln = torch.from_numpy(lens).cuda()
    scale = 1.0 / math.sqrt(d)
    kern = lambda: PA.dense_attention(q, kc, vc, ln)
    plain = lambda: PA.attend_dense_gqa(q, kc, vc, ln, scale)
    g = h // hkv

    def library():
        k = kc.transpose(1, 2).repeat_interleave(g, 1)
        v = vc.transpose(1, 2).repeat_interleave(g, 1)
        mask = torch.arange(cap, device="cuda") < ln[:, None]
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=mask[:, None, None])

    got = kern()
    err = compare("dense_decode_view", got, plain(), dtype)
    assert torch.equal(got, kern()), f"dense view {dtype}: two calls differ"
    it = q.element_size()
    nbytes = it * (2 * b * h * d + 2 * int(lens.sum()) * hkv * d) + 4 * b
    return err, kern, plain, library, nbytes, 4.0 * int(lens.sum()) * h * d


def dense_view_rows(gen, rng):
    """The paged-attention kernel on the dense-cache view at the generate
    phase's llama2-7b decode step (B 8, capacity 192 = 128 + 64) and at
    the llama2-70b GQA shape, bf16 and f32, contexts drawn in [1, 192]
    with one full slot; then a strided cache must raise on the card, and
    caches of another dtype than q (bf16 q on f32 caches and the
    reverse) agree with ``attend_dense_gqa`` within the bf16 tolerance."""
    rows = []
    cap = GENERATE["capacity"]
    lens = [int(n) for n in rng.integers(1, cap + 1, size=8)]
    lens[0] = cap
    for geom, (h, hkv) in (("llama2-7b", (32, 32)),
                           ("llama2-70b-gqa", (64, 8))):
        for dt in (torch.bfloat16, torch.float32):
            case = dense_view_case(8, h, hkv, 128, cap, lens, dt, gen)
            p = paged_plan(8, h, hkv, 128, cap, 1, dt,
                           sm_count(torch.device("cuda")))
            rows.append(timed_row(
                "dense_decode_view", geom, dt, case,
                {"capacity": cap, "lens": lens,
                 "host_us": host_us(case[1]), "path": p.path,
                 "splits": p.splits, "stages_per_split": p.per,
                 "grid_blocks": p.grid_blocks}))
            del case
            torch.cuda.empty_cache()
    z = lambda *shape, dt=torch.bfloat16: torch.zeros(shape, dtype=dt,
                                                      device="cuda")
    ln = torch.ones((2,), dtype=torch.int32, device="cuda")
    if not raises(lambda: PA.dense_attention(
            z(2, 4, 128), z(2, 32, 4, 128)[:, ::2],
            z(2, 32, 4, 128)[:, ::2], ln)):
        raise AssertionError("dense_decode_view took a strided cache")
    # a kv_cache_dtype other than the model's: q is cast to the caches'
    # dtype for the kernel and the output comes back in q's
    for q_dt, c_dt in ((torch.bfloat16, torch.float32),
                       (torch.float32, torch.bfloat16)):
        q = rand((8, 32, 128), q_dt, gen)
        kc, vc = (rand((8, cap, 32, 128), c_dt, gen) for _ in range(2))
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = PA.dense_attention(q, kc, vc, ln)
        assert got.dtype == q_dt, got.dtype
        compare("dense_decode_view mixed dtypes", got,
                PA.attend_dense_gqa(q, kc, vc, ln, 1.0 / math.sqrt(128)),
                torch.bfloat16)
    return rows


def paged_plan_fields(b, h, hkv, d, page, lens, dtype):
    p = paged_plan(b, h, hkv, d, page, -(-max(lens) // page) + 1, dtype,
                   sm_count(torch.device("cuda")))
    return {"path": p.path, "splits": p.splits, "stages_per_split": p.per,
            "grid_blocks": p.grid_blocks}


def gpt_kernel_rows(gen, rng):
    """The fused GELU MLP at the gpt3-6.7b engine step (T = 128, H 4096,
    F 16384), at gpt3-13b's H 5120 / F 20480 and at T = 1 and T = 257;
    paged decode attention at the gpt3-6.7b decode shape (B = 8, 32 heads
    of 128, page 16, ragged lengths up to 512), at the llama2-70b GQA
    shape (64 q heads over 8 kv heads) and at edge cases (lengths 1, an
    exact page multiple, the table's last position, a zero-length slot;
    head dims 128 and 64), each row with its plan and host time per call.
    bf16 and f32; then f16 at the gpt3-6.7b and edge shapes (a generator
    of their own, so the earlier rows keep their inputs), and an f16 head
    dim of 80, which must raise."""
    rows = []
    for geom, (t, h, f) in (("gpt3-6.7b", (128, 4096, 16384)),
                            ("gpt3-13b", (128, 5120, 20480)),
                            ("gpt3-6.7b T=1", (1, 4096, 16384)),
                            ("gpt3-6.7b T=257", (257, 4096, 16384))):
        for dt in (torch.bfloat16, torch.float32):
            rows.append(timed_row("fused_gelu_mlp", geom, dt,
                                  gelu_case(t, h, f, dt, gen),
                                  {"shape": [t, h, f],
                                   **plan_fields("gelu", t, h, f, dt)}))
            torch.cuda.empty_cache()
    # a card tensor the kernel cannot take raises, never falls back
    for h, f, dt in ((64, 256, torch.bfloat16), (128, 512, torch.float16)):
        z = lambda *shape: torch.zeros(shape, dtype=dt, device="cuda")
        try:
            FG.fused_gelu_mlp(z(4, h), z(h, f), z(f), z(f, h), z(h))
        except (TypeError, ValueError):
            continue
        raise AssertionError(f"fused_gelu_mlp took H={h} {dt}")
    ragged = [int(n) for n in rng.integers(1, 513, size=8)]
    paged = (("gpt3-6.7b", (8, 32, 32, 128, ragged)),
             ("llama2-70b-gqa", (8, 64, 8, 128, ragged)),
             ("edges d=128", (8, 32, 32, 128, [1, 16, 64, 0, 37, 512, 3,
                                               200])),
             ("edges d=64", (6, 16, 16, 64, [1, 32, 0, 17, 512, 48])))
    hgen = torch.Generator(device="cuda").manual_seed(7)
    hrng = np.random.default_rng(7)
    for dts, g_, r_, geoms in (
            ((torch.bfloat16, torch.float32), gen, rng, paged),
            ((torch.float16,), hgen, hrng,
             [c for c in paged if c[0] != "llama2-70b-gqa"])):
        for geom, (b, h, hkv, d, lens) in geoms:
            for dt in dts:
                case = paged_case(b, h, hkv, d, 16, lens, dt, g_, r_)
                rows.append(timed_row(
                    "paged_attention", geom, dt, case,
                    {"lens": lens, "host_us": host_us(case[1]),
                     **paged_plan_fields(b, h, hkv, d, 16, lens, dt)}))
                del case
                torch.cuda.empty_cache()
    z = lambda *shape: torch.zeros(shape, dtype=torch.float16, device="cuda")
    one = torch.ones((1,), dtype=torch.int32, device="cuda")
    if not raises(lambda: PA.paged_attention(
            z(1, 1, 80), z(1, 16, 1, 80), z(1, 16, 1, 80),
            torch.zeros((1, 1), dtype=torch.int32, device="cuda"), one)):
        raise AssertionError("paged_attention took an f16 head dim of 80")
    return rows


def paged_generate(model, prompts, steps, device, forced=None, page=16,
                   profile_calls=0, kv_dtype=None):
    """The bucket-prefill/decode path through ``model`` with pools from a
    ``PagedKVCache`` and tables from its allocator, padded with the
    out-of-range sentinel: one prefill call over all prompts (bucket of
    the longest, rounded up to 16), then ``steps`` one-token decode calls,
    greedy (or the tokens of ``forced``, (B, steps + 1)).  Returns the
    f32 logits of each call on the CPU ((B, V) at each slot's last
    position), the tokens, the wall time of the prefill and of the
    decode calls (synchronised on the card), and the kernel launches of
    each part.  With ``profile_calls``, that many further greedy decode
    calls run after the counted ones under torch.profiler ("profile":
    device busy and idle, the largest kernels, the MLP kernels' ms per
    call).  ``kv_dtype``: the pools' dtype (default the model's;
    ``"int8"``: the quantized pools)."""
    cfg = model.cfg
    kvh = getattr(cfg, "num_key_value_heads", None) or \
        cfg.num_attention_heads
    b = len(prompts)
    plens = np.array([len(p) for p in prompts], np.int32)
    s = -(-int(plens.max()) // 16) * 16
    mb = -(-(int(plens.max()) + steps + profile_calls) // page)
    kv = PagedKVCache(cfg.num_hidden_layers, b * mb, page, kvh,
                      cfg.head_dim, device=device,
                      dtype=kv_dtype if kv_dtype is not None
                      else next(model.parameters()).dtype)
    tables = np.full((b, mb), kv.oob_block, np.int32)
    for i, n in enumerate(plens):
        need = -(-(int(n) + steps + profile_calls) // page)
        tables[i, :need] = kv.allocator.allocate(need)
    ids = np.zeros((b, s), np.int64)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    dev = torch.device(device)
    tt = torch.from_numpy(tables).to(dev)
    lens = torch.from_numpy(plens).to(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    logits, toks, launches = [], [], []
    caches = kv.caches
    with torch.no_grad():
        reset_launches(dev.type)
        t0 = time.perf_counter()
        hidden, caches = model.model(torch.from_numpy(ids).to(dev),
                                     caches=caches, seq_lens=lens,
                                     block_tables=tt)
        last = hidden[torch.arange(b, device=dev), lens.long() - 1]
        lg = model.logits(last).float()
        sync()
        prefill_s = time.perf_counter() - t0
        launches.append(counts(dev.type))
        reset_launches(dev.type)
        t1 = time.perf_counter()
        for i in range(steps + 1):
            logits.append(lg)
            tok = lg.argmax(-1) if forced is None else \
                torch.from_numpy(forced[:, i]).to(dev)
            toks.append(tok)
            if i == steps:
                break
            hidden, caches = model.model(tok[:, None], caches=caches,
                                         seq_lens=lens, block_tables=tt)
            lg = model.logits(hidden[:, 0]).float()
            lens = lens + 1
        sync()
        decode_s = time.perf_counter() - t1
        launches.append(counts(dev.type))
        prof = None
        if profile_calls:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t2 = time.perf_counter()
                for _ in range(profile_calls):
                    hidden, caches = model.model(lg.argmax(-1)[:, None],
                                                 caches=caches,
                                                 seq_lens=lens,
                                                 block_tables=tt)
                    lg = model.logits(hidden[:, 0]).float()
                    lens = lens + 1
                sync()
                prof_ms = (time.perf_counter() - t2) * 1e3
    out = {"logits": [x.cpu() for x in logits],
           "tokens": torch.stack(toks, 1).cpu().numpy(),
           "prefill_s": prefill_s, "decode_s": decode_s,
           "launches": launches, "bucket": s, "plens": plens.tolist()}
    if prof is not None:
        out["profile"] = profile_summary(prof, prof_ms, profile_calls)
    return out


def gpt_engine_phase():
    """gpt3-6.7b in bf16, all 32 layers, behind the engine phase's engine
    and traffic: per step 32 fused GELU-MLP and 32 ragged-attention
    launches, none of the Llama kernels.  Returns the result, the model
    (kept for gpt_paged) and the requests and streams."""
    t0 = time.perf_counter()
    model = gpt("gpt3-6.7b", dtype="bfloat16", seed=0)
    torch.cuda.synchronize()
    eng = Engine(model, max_batch=8, max_seq_len=512, page_size=16).warmup()
    setup_s = time.perf_counter() - t0
    assert (eng.captures, eng.replays) == (1, 0)
    rng = np.random.default_rng(1)
    reset_launches()
    steps0, replays0 = eng.steps, eng.replays
    t1 = time.perf_counter()
    reqs, out = serve(eng, rng, 5, 17, 300, 16, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    steps, replays = eng.steps - steps0, eng.replays - replays0
    layers = model.cfg.num_hidden_layers
    stats = eng.prefix_stats()
    assert len(reqs) == 8 and sorted(out) == sorted(reqs), sorted(out)
    for rid, (_, n) in reqs.items():
        assert len(out[rid]) == n, (rid, len(out[rid]), n)
    assert eng.kv_blocks_used == 0, eng.kv_blocks_used
    assert stats["hits"] > 0 and stats["cow_copies"] > 0, stats
    per_step = {"fused_gelu_mlp": layers, "ragged_paged_attention": layers,
                "fused_swiglu_mlp": 0, "fused_rms_rope_qkv": 0,
                "mega_decode": 0, "paged_attention": 0}
    got = {k: eng.launches_per_step()[k] for k in per_step}
    assert got == per_step, (got, per_step)
    launches = kernel_launches()
    totals = {k: launches[k] for k in per_step}
    assert totals == {k: v * steps for k, v in per_step.items()}, totals
    res = {"model": "gpt3-6.7b", "setup_s": setup_s, "steps": steps,
           "wall_s": wall, "tokens": eng.tokens_emitted,
           "tok_s": eng.tokens_emitted / wall,
           "step_ms": wall / steps * 1e3, "prefix": stats,
           "launches_per_step": got, "launches": totals, "layers": layers,
           "weight_bytes": tensor_bytes(model.parameters()),
           "prompt_tokens": int(sum(len(p) for p, _ in reqs.values()))}
    eager, (_, eager_out) = eager_twin(model, lambda e: serve(
        e, np.random.default_rng(1), 5, 17, 300, 16, 32))
    graph_phase(res, eng, eager, steps, replays, out, eager_out)
    log("gpt_engine " + json.dumps(res))
    margins = {rid: eager.margins[rid] for rid in reqs}
    del eng, eager
    torch.cuda.empty_cache()
    return res, model, reqs, out, margins


def parting(paged_logits, engine_margins, n, dtype=torch.bfloat16):
    """Where a paged stream first parts from the engine's, at token ``n``:
    the paged path's top-2 margin of its f32 logits there, the engine's
    (eager twin's) margin at the same token, the tolerance of ``dtype``
    at the top logit's magnitude (atol + rtol * |logit|), and the
    verdict: "near_tie" when the paged margin is under it, "fault" when
    not."""
    top = paged_logits.float().topk(2).values
    margin = float(top[0] - top[1])
    atol, rtol = TOL[dtype]
    tol = atol + rtol * abs(float(top[0]))
    return {"step": n, "paged_margin": margin,
            "engine_margin": (float(engine_margins[n])
                              if n < len(engine_margins) else None),
            "tol": tol, "verdict": "near_tie" if margin < tol else "fault"}


def gpt_paged_phase(model, reqs, streams, margins, steps=32,
                    profile_calls=8):
    """The gpt_engine model on the bucket-prefill/decode path: the 8
    prompts of gpt_engine in one prefill call (the flash forward kernel,
    32 launches), then ``steps`` greedy decode calls (32 paged-attention
    launches each), then ``profile_calls`` more under torch.profiler.
    How many leading tokens of each request equal its gpt_engine stream
    is reported, not gated (bf16), and at each first difference the
    paged path's and the engine's top-2 margins against the bf16
    tolerance (``parting``; ``margins``: the gpt_engine eager twin's)."""
    rids = sorted(reqs)
    layers = model.cfg.num_hidden_layers
    run = paged_generate(model, [reqs[r][0] for r in rids], steps, "cuda",
                         profile_calls=profile_calls)
    pre, dec = run["launches"]
    want_pre = {"flash_attention_fwd": layers, "fused_gelu_mlp": layers,
                "paged_attention": 0, "ragged_paged_attention": 0}
    assert {k: pre[k] for k in want_pre} == want_pre, pre
    want_dec = {"paged_attention": layers * steps,
                "fused_gelu_mlp": layers * steps, "flash_attention_fwd": 0,
                "ragged_paged_attention": 0}
    assert {k: dec[k] for k in want_dec} == want_dec, dec
    for lg in run["logits"]:
        assert bool(torch.isfinite(lg).all()), "non-finite logits"
    agree, partings = {}, {}
    for i, rid in enumerate(rids):
        ref, got = streams[rid], run["tokens"][i]
        n = leading_equal(ref, got)
        agree[rid] = [n, len(ref)]
        if n < min(len(ref), len(got)):
            partings[rid] = parting(run["logits"][n][i], margins[rid], n)
    b = len(rids)
    res = {"model": "gpt3-6.7b", "batch": b, "bucket": run["bucket"],
           "prompt_lens": run["plens"], "decode_steps": steps,
           "prefill_ms": run["prefill_s"] * 1e3,
           "decode_step_ms": run["decode_s"] / steps * 1e3,
           "decode_tok_s": b * steps / run["decode_s"],
           "launches_prefill": {k: pre[k] for k in want_pre},
           "launches_decode": {k: dec[k] for k in want_dec},
           "leading_equal_vs_engine": agree,
           "partings": partings,
           "decode_profile": run["profile"]}
    log("gpt_paged " + json.dumps(res))
    return res


def randomize_affine(model, seed):
    """Biases and LayerNorm weights drawn on the model's device (they are
    zeros and ones at init), so a cross-check exercises them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                        * 0.05)
            elif ".ln_" in name and name.endswith(".weight"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=gen,
                                              device="cuda"))


def paged_cross_check(make, steps=4):
    """One model built on the card and copied to the CPU: 4 prompts
    through the bucket prefill and ``steps`` decode calls on both, the
    card fed the CPU's greedy tokens; every call's logits on the card
    within the f32 tolerance of the CPU's."""
    gpu = make(None)
    cpu = make("cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 32000, size=int(n)) for n in (17, 40, 64, 90)]
    ref = paged_generate(cpu, prompts, steps, "cpu")
    got = paged_generate(gpu, prompts, steps, "cuda", forced=ref["tokens"])
    err = max(compare(f"paged logits {i}", g, r, torch.float32)
              for i, (g, r) in enumerate(zip(got["logits"], ref["logits"])))
    pre, dec = got["launches"]
    layers = gpu.cfg.num_hidden_layers
    assert pre["flash_attention_fwd"] == layers, pre
    assert dec["paged_attention"] == layers * steps, dec
    del gpu, cpu
    torch.cuda.empty_cache()
    return {"calls": steps + 1, "max_abs_err": err,
            "launches_decode": {k: v for k, v in dec.items() if v}}


def gpt_cross_check_phase():
    """gpt2-345m cut to 2 layers, f32, biases and LayerNorms randomised,
    card against CPU: the Engine's greedy streams equal under the
    near-tie rule (at most one request exempt), prefix stats equal; the
    paged path's logits within f32 tolerance (prefill + 4 decode calls).
    The same paged-path check for llama-350m-hd128 cut to 2 layers."""
    torch.backends.cuda.matmul.allow_tf32 = False

    def make_gpt(dev):
        m = gpt("gpt2-345m", num_hidden_layers=2, dtype="float32",
                device=dev, seed=1)
        if dev is None:
            randomize_affine(m, 5)
        return m

    gpu = make_gpt(None)
    cpu = make_gpt("cpu")
    cpu.load_state_dict(gpu.state_dict())
    outs = {}
    for tag, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, None)):
        eng = Engine(model, max_batch=4, max_seq_len=256, page_size=16,
                     device=dev).warmup()
        eng.margins = {}
        reqs, out = serve(eng, np.random.default_rng(2), 3, 17, 90, 6, 10)
        assert eng.kv_blocks_used == 0
        outs[tag] = (out, eng.margins, eng.prefix_stats())
    (ref, margins, rstats), (got, _, gstats) = outs["cpu"], outs["gpu"]
    verdicts = {rid: near_tie_equal(ref[rid], got[rid], margins[rid])
                for rid in ref}
    exempt = sorted(r for r, v in verdicts.items() if v == "exempt")
    assert sorted(got) == sorted(ref) and len(exempt) <= 1, exempt
    assert rstats == gstats, (rstats, gstats)
    del gpu, cpu, outs
    torch.cuda.empty_cache()
    res = {"engine": {"requests": len(ref),
                      "equal": sum(v == "equal" for v in verdicts.values()),
                      "exempt": exempt,
                      "min_margin": min(min(m) for m in margins.values())},
           "gpt_paged": paged_cross_check(make_gpt),
           "llama_paged": paged_cross_check(
               lambda dev: llama("llama-350m-hd128", num_hidden_layers=2,
                                 dtype="float32", device=dev, seed=1))}
    log("gpt_cross_check " + json.dumps(res))
    return res


# -- generate phases --------------------------------------------------------

def timed_generate(model, ids, events=None, **kw):
    """Wall ms of one ``generate()`` call ending in a synchronize, and its
    output; with ``events`` (a list) the decode graph collects a CUDA
    event pair around each replay into it."""
    holder = model.decode_graph
    if holder is not None:
        holder.graph.replay_events = events
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(ids, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if holder is not None:
        holder.graph.replay_events = None
    return ms, out


def generate_phase():
    """llama2-7b bf16 fused (32 layers, seeded random weights):
    ``generate()`` over 8 prompts of 128 tokens, 64 new tokens, greedy.
    The first call prefills in one eager forward (flash forward, QKV and
    SwiGLU: one launch per layer each), runs the first decode step
    eagerly on a side stream, captures it and replays it for the other
    63 tokens: captures 1, replays 63, each replay crediting 32 QKV, 32
    SwiGLU and 32 paged-attention launches.  Then prefill ms (a
    max_new_tokens=1 call of the same capacity), decode ms per step,
    captured and eager (``_eager_step``: the same caches and buffers
    without the graph) in turns (captured, eager, eager, captured), the
    replays' device ms by CUDA events, greedy streams equal between the
    two, and a second call of the same shape with fewer tokens and
    top-k/top-p sampling, reproducible from ``seed`` and leaving
    captures at 1."""
    b, p, new, cap = (GENERATE[k] for k in ("batch", "prompt", "new",
                                            "capacity"))
    t0 = time.perf_counter()
    model = llama("llama2-7b", dtype="bfloat16", fused_ops="on", seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ids = torch.from_numpy(np.random.default_rng(11).integers(
        0, 32000, size=(b, p))).cuda()
    layers = model.cfg.num_hidden_layers
    reset_launches()
    first_ms, out = timed_generate(model, ids, max_new_tokens=new)
    launches = kernel_launches()
    holder = model.decode_graph
    assert (holder.captures, holder.replays) == (1, new - 1), \
        (holder.captures, holder.replays)
    assert holder.key == (b, cap, torch.bfloat16), holder.key
    names = ("fused_rms_rope_qkv", "fused_swiglu_mlp", "paged_attention",
             "flash_attention_fwd", "ragged_paged_attention", "mega_decode")
    per_step = {k: holder.graph.launches[k] for k in names}
    assert per_step == {**dict.fromkeys(names[:3], layers),
                        **dict.fromkeys(names[3:], 0)}, per_step
    # prefill, the eager step before the capture, the replays
    want = {"fused_rms_rope_qkv": layers * (new + 1),
            "fused_swiglu_mlp": layers * (new + 1),
            "paged_attention": layers * new,
            "flash_attention_fwd": layers, "ragged_paged_attention": 0,
            "mega_decode": 0}
    totals = {k: launches[k] for k in names}
    assert totals == want, (totals, want)
    assert out.shape == (b, p + new) and torch.equal(out[:, :p], ids)
    assert int(out.min()) >= 0 and int(out.max()) < 32000
    prefill_ms = statistics.median(
        timed_generate(model, ids, max_new_tokens=1, max_len=cap)[0]
        for _ in range(3))
    turns, streams = [], {}
    for tag in ("captured", "eager", "eager", "captured"):
        events = [] if tag == "captured" else None
        ms, got = timed_generate(model, ids, events, max_new_tokens=new,
                                 _eager_step=tag == "eager")
        row = {"mode": tag, "call_ms": ms,
               "step_ms": (ms - prefill_ms) / (new - 1)}
        if events:
            row["replay_device_ms"] = replay_ms(events) / len(events)
        turns.append(row)
        streams.setdefault(tag, got)
        assert torch.equal(got, streams[tag]), f"{tag} streams moved"
    assert torch.equal(streams["captured"], streams["eager"]), \
        "captured and eager greedy streams differ"
    assert torch.equal(streams["captured"], out)
    assert (holder.captures, holder.replays) == (1, 3 * (new - 1))
    mean = lambda tag, key: statistics.mean(r[key] for r in turns
                                            if r["mode"] == tag)
    kw = dict(max_new_tokens=new // 2, max_len=cap,
              decode_strategy="sampling", temperature=0.8, top_k=50,
              top_p=0.9)
    seed(5)
    s1 = model.generate(ids, **kw)
    seed(5)
    s2 = model.generate(ids, **kw)
    assert torch.equal(s1, s2), "sampled streams not reproducible"
    assert model.decode_graph is holder and holder.captures == 1
    step_ms = mean("captured", "step_ms")
    res = {"model": "llama2-7b", "dtype": "bfloat16", "batch": b,
           "prompt": p, "new_tokens": new, "capacity": cap,
           "setup_s": setup_s, "first_call_ms": first_ms,
           "prefill_ms": prefill_ms,
           "captured_step_ms": step_ms,
           "eager_step_ms": mean("eager", "step_ms"),
           "replay_device_ms": mean("captured", "replay_device_ms"),
           "host_ms_outside_replay":
               step_ms - mean("captured", "replay_device_ms"),
           "decode_tok_s": b / step_ms * 1e3,
           "call_tok_s": b * new / mean("captured", "call_ms") * 1e3,
           "captures": holder.captures, "replays": holder.replays,
           "launches_per_step": per_step, "launches": totals,
           "layers": layers, "turns": turns,
           "streams_captured_vs_eager": "equal",
           "sampled": {"new_tokens": new // 2, "top_k": 50, "top_p": 0.9,
                       "temperature": 0.8, "reproducible": True,
                       "differs_from_greedy": not torch.equal(
                           s1, out[:, :p + new // 2])}}
    log("generate " + json.dumps(res))
    res["streams"] = out
    del holder
    return res, model, ids


def kv8_generate_phase(model, ids, bf16):
    """The generate phase's model and prompts with
    ``generate(kv_cache_dtype="int8")``: the int8 dense 4-tuple caches in
    a new decode graph (key (batch, capacity, int8)), captured once and
    replayed (captures 1, replays 63); per step 32 QKV and 32 SwiGLU
    launches and no paged-attention launch (the dense int8 composition
    attends the caches, K dequantized in bf16 and V in f32); prefill ms,
    decode ms per step captured and eager in turns, the replays' device
    ms, decode tokens/s beside the bf16 call's (``bf16``: the generate
    phase's result); captured and eager greedy streams equal; how many
    leading tokens of each row equal the bf16 stream (reported)."""
    t0 = time.perf_counter()
    b, p, new, cap = (GENERATE[k] for k in ("batch", "prompt", "new",
                                            "capacity"))
    layers = model.cfg.num_hidden_layers
    kw = dict(max_new_tokens=new, kv_cache_dtype="int8")
    reset_launches()
    first_ms, out = timed_generate(model, ids, **kw)
    launches = kernel_launches()
    holder = model.decode_graph
    assert holder.key == (b, cap, torch.int8), holder.key
    assert all(len(c) == 4 and c[0].dtype == torch.int8
               for c in holder.caches)
    assert (holder.captures, holder.replays) == (1, new - 1), \
        (holder.captures, holder.replays)
    names = ("fused_rms_rope_qkv", "fused_swiglu_mlp", "paged_attention",
             "flash_attention_fwd", "ragged_paged_attention", "mega_decode")
    per_step = {k: holder.graph.launches[k] for k in names}
    assert per_step == {**dict.fromkeys(names[:2], layers),
                        **dict.fromkeys(names[2:], 0)}, per_step
    want = {"fused_rms_rope_qkv": layers * (new + 1),
            "fused_swiglu_mlp": layers * (new + 1), "paged_attention": 0,
            "flash_attention_fwd": layers, "ragged_paged_attention": 0,
            "mega_decode": 0}
    totals = {k: launches[k] for k in names}
    assert totals == want, (totals, want)
    assert out.shape == (b, p + new) and torch.equal(out[:, :p], ids)
    assert int(out.min()) >= 0 and int(out.max()) < 32000
    prefill_ms = statistics.median(
        timed_generate(model, ids, max_new_tokens=1, max_len=cap,
                       kv_cache_dtype="int8")[0] for _ in range(3))
    turns, streams = [], {}
    for tag in ("captured", "eager", "eager", "captured"):
        events = [] if tag == "captured" else None
        ms, got = timed_generate(model, ids, events,
                                 _eager_step=tag == "eager", **kw)
        row = {"mode": tag, "call_ms": ms,
               "step_ms": (ms - prefill_ms) / (new - 1)}
        if events:
            row["replay_device_ms"] = replay_ms(events) / len(events)
        turns.append(row)
        streams.setdefault(tag, got)
        assert torch.equal(got, streams[tag]), f"{tag} streams moved"
    assert torch.equal(streams["captured"], streams["eager"]), \
        "captured and eager int8 greedy streams differ"
    assert torch.equal(streams["captured"], out)
    assert model.decode_graph is holder and holder.captures == 1
    mean = lambda tag, key: statistics.mean(r[key] for r in turns
                                            if r["mode"] == tag)
    step_ms = mean("captured", "step_ms")
    ref = bf16["streams"].cpu().numpy()[:, p:]
    got = out.cpu().numpy()[:, p:]
    res = {"model": "llama2-7b", "dtype": "bfloat16",
           "kv_cache_dtype": "int8", "batch": b, "prompt": p,
           "new_tokens": new, "capacity": cap, "first_call_ms": first_ms,
           "prefill_ms": prefill_ms, "captured_step_ms": step_ms,
           "eager_step_ms": mean("eager", "step_ms"),
           "replay_device_ms": mean("captured", "replay_device_ms"),
           "host_ms_outside_replay":
               step_ms - mean("captured", "replay_device_ms"),
           "decode_tok_s": b / step_ms * 1e3,
           "captures": holder.captures, "replays": holder.replays,
           "launches_per_step": per_step, "launches": totals,
           "turns": turns, "streams_captured_vs_eager": "equal",
           "cache_bytes": tensor_bytes(t for c in holder.caches for t in c),
           "bf16_cache_bytes": 2 * layers * b * cap * 2
               * model.cfg.num_key_value_heads * model.cfg.head_dim,
           "vs_bf16": {key: {"int8": v, "bf16": bf16[key]} for key, v in (
               ("captured_step_ms", step_ms),
               ("replay_device_ms", mean("captured", "replay_device_ms")),
               ("prefill_ms", prefill_ms),
               ("decode_tok_s", b / step_ms * 1e3))},
           "leading_equal_vs_bf16": [[leading_equal(r, g), len(r)]
                                     for r, g in zip(ref, got)],
           "phase_s": time.perf_counter() - t0}
    log("kv8_generate " + json.dumps(res))
    del holder
    torch.cuda.empty_cache()
    return res


def generate_cross(make, steps=16):
    """One model built on the card and copied to the CPU: greedy
    ``generate()`` of 4 prompts of 40 tokens on both, equal under the
    near-tie rule (CPU margins from its dense forward over the output,
    at most one row exempt); then a sampled call on the card twice after
    ``seed(7)``, equal; then the final norm's weight swapped for its
    negation on both: a new decode graph is captured and the greedy
    streams still agree, and differ from the first."""
    gpu = make(None)
    cpu = make("cpu")
    cpu.load_state_dict(gpu.state_dict())
    ids = np.random.default_rng(6).integers(0, 32000, size=(4, 40))

    def greedy_pair():
        got = gpu.generate(torch.from_numpy(ids).cuda(),
                           max_new_tokens=steps).cpu().numpy()
        ref = cpu.generate(torch.from_numpy(ids),
                           max_new_tokens=steps).numpy()
        with torch.no_grad():
            lg = cpu(torch.from_numpy(ref[:, :-1]))[:, ids.shape[1] - 1:]
        top = lg.float().topk(2, dim=-1).values
        margins = (top[..., 0] - top[..., 1]).numpy()
        verdicts = [near_tie_equal(list(r[40:]), list(g[40:]), m)
                    for r, g, m in zip(ref, got, margins)]
        exempt = [i for i, v in enumerate(verdicts) if v == "exempt"]
        assert len(exempt) <= 1, exempt
        return got, margins, verdicts, exempt

    reset_launches()
    got, margins, verdicts, exempt = greedy_pair()
    launches = {k: v for k, v in kernel_launches().items() if v}
    holder = gpu.decode_graph
    assert (holder.captures, holder.replays) == (1, steps - 1)
    layers = gpu.cfg.num_hidden_layers
    assert launches["paged_attention"] == layers * steps, launches
    kw = dict(max_new_tokens=steps, decode_strategy="sampling",
              temperature=1.0, top_p=0.9)
    seed(7)
    a = gpu.generate(torch.from_numpy(ids).cuda(), **kw)
    seed(7)
    assert torch.equal(gpu.generate(torch.from_numpy(ids).cuda(), **kw), a)
    # a weight swapped behind the same shape: the captured graph has the
    # old address built in, so the next call must capture a new one
    name = [n for n, w in gpu.named_parameters()
            if w.ndim == 1 and n.endswith("weight")][-1]
    for m in (gpu, cpu):
        w = m.get_parameter(name)
        w.data = w.data * -1
    changed, _, after, _ = greedy_pair()
    assert gpu.decode_graph is not holder and \
        gpu.decode_graph.captures == 1
    assert not np.array_equal(changed, got), "stale decode graph"
    del gpu, cpu, holder
    torch.cuda.empty_cache()
    return {"rows": len(got), "equal": verdicts.count("equal"),
            "exempt": exempt, "min_margin": float(margins.min()),
            "launches": launches, "sampled_reproducible": True,
            "recaptured_after_weight_swap": True,
            "equal_after_swap": after.count("equal")}


def generate_cross_check_phase():
    """generate() card against CPU in f32, 2 layers: llama-350m-hd128 and
    gpt2-345m (biases and LayerNorms randomised)."""
    torch.backends.cuda.matmul.allow_tf32 = False

    def make_gpt(dev):
        m = gpt("gpt2-345m", num_hidden_layers=2, dtype="float32",
                device=dev, seed=1)
        if dev is None:
            randomize_affine(m, 5)
        return m

    res = {"llama-350m-hd128": generate_cross(
               lambda dev: llama("llama-350m-hd128", num_hidden_layers=2,
                                 dtype="float32", device=dev, seed=1)),
           "gpt2-345m": generate_cross(make_gpt)}
    log("generate_cross_check " + json.dumps(res))
    return res


# -- train phases ----------------------------------------------------------

def train_setup(cfg_name, layers, dtype, seed, device=None, lr=3e-4):
    model = llama(cfg_name, num_hidden_layers=layers, seed=seed,
                  device=device)
    opt = optimizer.AdamW(learning_rate=lr, weight_decay=0.1,
                          grad_clip=ClipGradByGlobalNorm(1.0),
                          parameters=model.parameters())
    if dtype == "bfloat16":
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = TrainStep(model, causal_lm_loss, opt)
    return model, step, step.init_state(seed=0)


def token_batch(rng, b, s, vocab=32000):
    ids = rng.integers(0, vocab, size=(b, s)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    return {"input_ids": ids, "labels": labels}


def train_flops(cfg, b, s):
    """6 N T for the matmul parameters (the embedding lookup excluded)
    plus causal attention, forward and backward (3 x 4 d per visible
    (query, key) pair per head)."""
    n = cfg.num_params() - cfg.vocab_size * cfg.hidden_size
    attn = 12.0 * b * cfg.num_attention_heads * cfg.head_dim \
        * causal_pairs(s, s) * cfg.num_hidden_layers
    return 6.0 * n * b * s + attn


def profile_train(step, state, batch, n_steps=2):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_ms_by_kernel(prof)
    flash = {k: v / n_steps for k, v in by_name.items() if "flash_" in k}
    return {**profile_summary(prof, wall_ms, n_steps, top=12),
            "flash_ms_per_step": sum(flash.values()),
            "flash_kernels_ms_per_step": {k[:80]: v
                                          for k, v in flash.items()}}


def train_phase(preset="llama2-7b", layers=4, b=2, s=2048, steps=5):
    # PyTorch's default precision (TF32 off, as main() sets it): the
    # port's fused-op backward chooses TF32 for its bf16 inputs itself
    # (incubate/nn/functional.py), as a TrainStep user gets it
    t0 = time.perf_counter()
    model, step, state = train_setup(preset, layers, "bfloat16", 0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             token_batch(np.random.default_rng(3), b, s,
                         PRESETS[preset].vocab_size).items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(met["loss"]))
    launches = {k: v for k, v in kernel_launches().items() if k in TRAINING}
    cfg = model.cfg
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    want = {"fused_rms_rope_qkv": layers * steps,
            "fused_swiglu_mlp": layers * steps,
            "flash_attention_fwd": layers * steps,
            "flash_attention_bwd": layers * steps, "fused_adamw": steps}
    assert launches == want, (launches, want)
    for name, p in state["params"].items():
        assert p.dtype == torch.bfloat16, name
        assert state["opt"]["master"][name].dtype == torch.float32, name
    steady = statistics.mean(step_ms[1:])
    flops = train_flops(cfg, b, s)
    res = {"layers": layers, "batch": [b, s], "tokens_per_step": b * s,
           "params": sum(p.numel() for p in state["params"].values()),
           "setup_s": setup_s, "losses": losses, "step_ms": step_ms,
           "steady_step_ms": steady, "tok_s": b * s / steady * 1e3,
           "model_tflop_per_step": flops / 1e12,
           "model_tflop_s": flops / steady * 1e-9,
           "bf16_peak_share": flops / (steady * 1e-3) / PEAK_OPS_S[
               torch.bfloat16],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches}
    res["profile"] = profile_train(step, state, batch)
    log("train " + json.dumps(res))
    del model, step, state, batch
    torch.cuda.empty_cache()
    return res


def moment_close(name, got, want, rel_l2=1e-4, max_frac=1e-3):
    """Per tensor: ||got - want|| <= rel_l2 ||want|| and
    max|got - want| <= max_frac max|want|.  Returns the two ratios."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    d = (g - w).abs()
    l2 = float(d.norm() / w.norm())
    mx = float(d.max() / w.abs().max())
    if not (l2 <= rel_l2 and mx <= max_frac):
        raise AssertionError(f"{name}: rel L2 err {l2} (limit {rel_l2}), "
                             f"max err / max|want| {mx} (limit {max_frac})")
    return l2, mx


def update_close(name, got, want, init, m, v, lr, steps):
    """The parameter update (final - init), card against CPU:
    - every element within 2 lr per step (Adam's normalised update flips
      sign where a gradient sits at the noise level);
    - the tensor within 2e-3 relative L2 error (gradients summed in
      another order move Adam's later updates by their relative error,
      which is large for near-zero gradients; 2e-4 measured on an H100);
    - elements whose gradient was zero at every step (the CPU's m and v
      zero: embedding rows of tokens not in the batch) move by the
      decoupled decay alone, lr wd |p| = 1e-4 |p| per step, and must agree
      within 4 f32 units of p, so a wrong or missing decay fails.
    Returns (relative L2 error, number of decay-only elements)."""
    init = init.float()
    g = got.detach().float().cpu() - init
    w = want.detach().float().cpu() - init
    d = (g - w).abs()
    if not float(d.max()) <= 2 * lr * steps:
        raise AssertionError(f"{name}: update differs by {float(d.max())}")
    l2 = float(d.norm() / w.norm()) if float(w.norm()) else float(d.norm())
    if not l2 <= 2e-3:
        raise AssertionError(f"{name}: update rel L2 err {l2} (limit 2e-3)")
    pure = (m.detach().cpu() == 0) & (v.detach().cpu() == 0)
    eps = torch.finfo(torch.float32).eps
    if pure.any():
        within(f"{name} decay-only", g[pure], w[pure],
               4 * eps * init[pure].abs())
    return l2, int(pure.sum())


def train_cross_check_phase(preset="llama-350m-hd128", b=2, s=256,
                            steps=2):
    """Card (kernels) against CPU (plain versions), f32, same weights and
    batch.  Loss rtol 1e-4; each moment tensor within 1e-4 relative L2
    error and a largest error of 1e-3 of its largest value (gradients are
    summed in another order on the card, so an element whose sum cancels
    can differ by more in relative terms; the L2 ratio bounds the
    tensor); each parameter's update by update_close."""
    torch.backends.cuda.matmul.allow_tf32 = False
    lr = 1e-3
    gpu = train_setup(preset, 2, "float32", 5, lr=lr)
    cpu = train_setup(preset, 2, "float32", 5, device="cpu", lr=lr)
    cpu[0].load_state_dict(gpu[0].state_dict())
    init = {k: t.detach().clone() for k, t in cpu[0].named_parameters()}
    batch = token_batch(np.random.default_rng(4), b, s,
                        PRESETS[preset].vocab_size)
    losses = {}
    states = {}
    for tag, (_, step, state) in (("gpu", gpu), ("cpu", cpu)):
        losses[tag] = []
        for _ in range(steps):
            state, met = step(state, batch)
            losses[tag].append(float(met["loss"]))
        states[tag] = state
    for a, b_ in zip(losses["gpu"], losses["cpu"]):
        assert abs(a - b_) <= 1e-4 * abs(b_), losses
    errs = {}
    for slot in ("moment1", "moment2"):
        ratios = [moment_close(f"{slot}.{k}", t,
                               states["cpu"]["opt"][slot][k])
                  for k, t in states["gpu"]["opt"][slot].items()]
        errs[slot] = {"max_rel_l2": max(r[0] for r in ratios),
                      "max_err_over_max": max(r[1] for r in ratios)}
    assert set(states["gpu"]["params"]) == set(init)
    copt = states["cpu"]["opt"]
    upd = {k: update_close(f"param {k}", t, states["cpu"]["params"][k],
                           init[k], copt["moment1"][k], copt["moment2"][k],
                           lr, steps)
           for k, t in states["gpu"]["params"].items()}
    decay_only = sum(n for _, n in upd.values())
    assert decay_only > 0, "no decay-only elements to hold the decay"
    res = {"preset": preset, "layers": 2, "batch": [b, s],
           "losses": losses, "moments": errs,
           "params": {"max_update_rel_l2": max(l2 for l2, _ in upd.values()),
                      "decay_only_elements": decay_only}}
    log("train_cross_check " + json.dumps(res))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    took = _build.build()
    log("build " + json.dumps({"wall_s": time.perf_counter() - t0,
                               "per_source_s": took}))
    phase_s = {"build": time.perf_counter() - t0}

    def run(name, fn, *args):
        """``fn(*args)``, its wall seconds kept under ``name``."""
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    kernel_rows = run("kernels", kernel_phase)
    engine, model = run("engine", engine_phase)
    engines = run("spec_engine", spec_engine_phase, model)
    run("preempt", preempt_phase, engines)
    del engines
    torch.cuda.empty_cache()
    run("kv8_engine", kv8_engine_phase, model, engine)
    del model
    torch.cuda.empty_cache()
    gen, gen_model, gen_ids = run("generate", generate_phase)
    run("kv8_generate", kv8_generate_phase, gen_model, gen_ids, gen)
    del gen_model
    torch.cuda.empty_cache()
    quant = {kind: run(f"quant_engine_{kind}", quant_engine_phase, kind)
             for kind in QUANT}
    mega = run("mega_engine", mega_engine_phase)
    lora = run("lora_engine", lora_engine_phase)
    gpt_engine, gpt_model, gpt_reqs, gpt_streams, gpt_margins = \
        run("gpt_engine", gpt_engine_phase)
    gpt_paged = run("gpt_paged", gpt_paged_phase, gpt_model, gpt_reqs,
                    gpt_streams, gpt_margins)
    del gpt_model
    torch.cuda.empty_cache()
    for name, fn in (("cross_check", cross_check_phase),
                     ("quant_cross_check", quant_cross_check_phase),
                     ("mega_cross_check", mega_cross_check_phase),
                     ("lora_cross_check", lora_cross_check_phase),
                     ("gpt_cross_check", gpt_cross_check_phase),
                     ("generate_cross_check", generate_cross_check_phase),
                     ("spec_cross_check", spec_cross_check_phase),
                     ("kv8_cross_check", kv8_cross_check_phase)):
        run(name, fn)
    train = run("train", train_phase)
    run("train_cross_check", train_cross_check_phase)
    main_rows = {r["name"]: r for r in kernel_rows
                 if r["geometry"] == "llama2-7b" and r["dtype"] == "bfloat16"
                 and "shape" not in r}
    main_rows.update({r["name"]: r for r in kernel_rows
                      if r["geometry"] == "llama2-7b-step"})
    main_rows.update({r["name"]: r for r in kernel_rows
                      if r["geometry"] == "gpt3-6.7b"
                      and r["dtype"] == "bfloat16"})
    launches = {**train["launches"], **engine["launches"],
                "mega_decode": mega["launches"]["mega_decode"],
                "grouped_bgmv": lora["launches"]["grouped_bgmv"],
                "fused_gelu_mlp": gpt_engine["launches"]["fused_gelu_mlp"],
                "paged_attention":
                    gpt_paged["launches_decode"]["paged_attention"]}
    for kind, (name, _, _) in QUANT.items():
        launches[name] = quant[kind]["launches"][name]
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": main_rows[name]["max_abs_err"],
         "ms": main_rows[name]["ms"], "plain_ms": main_rows[name]["plain_ms"],
         "bound_ms": main_rows[name]["bound_ms"],
         "bound_by": main_rows[name]["bound_by"],
         "library_ms": main_rows[name]["library_ms"]}
        for name, src, rep in KERNELS]}
    log("smoke " + json.dumps({"wall_s": time.perf_counter() - t0,
                               "phase_s": phase_s}))
    log(f"card: {smi}")
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
