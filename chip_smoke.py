#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the run on its own (nothing is caught):

1. build: compiles the seven CUDA kernel sources from paddle_tpu_torch/csrc
   for sm_90a, one nvcc per source, all at once (timed as set-up);
2. kernels: holds each kernel against its plain PyTorch version on the
   card, in bf16 and f32, at the serving path's llama2-7b shapes (T = B*C
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
   MLP kernel's scratch bytes, error and time at T = 128 and T = 4096; and
   the flash kernels off those shapes (causal Sq < Sk, ragged lengths,
   head dims 18, 64, 80, 256); the int8 and int4 weight-only matmul
   kernels at the four shapes of the quantized llama2-7b engine step (128
   rows through 4096x4096, 4096x11008 and 11008x4096 weights, 8 rows
   through the 4096x32000 LM head) with a cuBLAS yardstick over the
   widened weight, each kind's sum over one step's 225 calls, and their
   edge cases (M 1/8/257, K 100/102, N 200, f16, an unaligned x, every
   int8 code and every packed int4 byte);
3. engine: llama2-7b in bf16, all 32 layers, random weights drawn on the
   card from a seeded generator, behind Engine(max_batch=8,
   max_seq_len=512, page_size=16): 8 staggered greedy requests, two of
   them sharing a 64-token prefix after a first one finished (prefix
   hits and copy-on-write); checks that all finished, the pool drained
   and each kernel's launch count equals layers x non-empty steps;
   then the same model, engine and traffic with Engine(weight_quant=
   "int8") and again "int4": the quantized kernel launched 225 times per
   step (7 projections x 32 layers + the LM head), ragged attention 32,
   the fused QKV/MLP kernels 0; weight bytes on the card against bf16;
4. cross-check: a 2-layer model at full llama2-7b width in f32, the same
   weights on both sides, kernels on the card against the plain versions
   on the CPU: greedy streams must be equal under the near-tie rule; the
   same for int8 and int4, whose codes and scales quantized on the card
   must equal the CPU's bit for bit;
5. train: llama2-7b width cut to 4 layers, amp O2 (bf16 parameters, f32
   master weights), AdamW + ClipGradByGlobalNorm through TrainStep, batch
   2 x 2048, 5 steps on one fixed batch, PyTorch's default precision:
   losses finite and falling, each kernel's launch count (flash forward
   = backward = qkv = MLP = layers x steps, fused AdamW = steps), step
   ms, tokens/s, model TFLOP/s and its
   share of the bf16 peak, peak memory, and a 2-step torch.profiler
   window (device busy/idle, kernel time by name);
6. train cross-check: llama-350m-hd128 cut to 2 layers, f32, batch
   2 x 256, 2 steps, kernels on the card against the plain versions on
   the CPU from the same weights and batch: losses, moments and each
   parameter's update must agree (decay-only elements to 4 f32 units).

Prints each measurement as a JSON line (kernel, mlp_scratch, flash_edges,
quant_edges, engine, quant_engine, cross_check, quant_cross_check, train,
train_cross_check), the card's name and power limit,
a {"kernels": [...]} line, and last the {"ok": true, "device": {...}}
line.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import PRESETS, causal_lm_loss, llama
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn import quant as Q
from paddle_tpu_torch.ops.cuda import _build
from paddle_tpu_torch.ops.cuda import flash_attention as FA
from paddle_tpu_torch.ops.cuda import fused_adamw as AD
from paddle_tpu_torch.ops.cuda import fused_mlp as FM
from paddle_tpu_torch.ops.cuda import fused_norm_qkv as FQ
from paddle_tpu_torch.ops.cuda import int4_matmul as I4
from paddle_tpu_torch.ops.cuda import int8_matmul as I8
from paddle_tpu_torch.ops.cuda import ragged_attention as RA
from paddle_tpu_torch.serving import Engine

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
# (name, launch counter, source, TPU kernel it replaces)
KERNELS = [
    ("fused_rms_rope_qkv", FQ.KERNEL,
     "paddle_tpu_torch/csrc/fused_norm_qkv.cu",
     "paddle_tpu/ops/pallas/fused_norm_qkv.py:158"),
    ("fused_swiglu_mlp", FM.KERNEL, "paddle_tpu_torch/csrc/fused_mlp.cu",
     "paddle_tpu/ops/pallas/fused_mlp.py:148"),
    ("ragged_paged_attention", RA.KERNEL,
     "paddle_tpu_torch/csrc/ragged_attention.cu",
     "paddle_tpu/ops/pallas/ragged_attention.py:137"),
    ("flash_attention_fwd", FA.FWD,
     "paddle_tpu_torch/csrc/flash_attention.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:161"),
    ("flash_attention_bwd", FA.BWD,
     "paddle_tpu_torch/csrc/flash_attention.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:412"),
    ("fused_adamw", AD.KERNEL, "paddle_tpu_torch/csrc/fused_adamw.cu",
     "paddle_tpu/ops/pallas/fused_adamw.py:89"),
    ("int8_matmul", I8.KERNEL, "paddle_tpu_torch/csrc/int8_matmul.cu",
     "paddle_tpu/ops/pallas/int8_matmul.py:92"),
    ("int4_matmul", I4.KERNEL, "paddle_tpu_torch/csrc/int4_matmul.cu",
     "paddle_tpu/ops/pallas/int4_matmul.py:143"),
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
    x = rand((t, h), dtype, gen)
    wg, wu = rand((h, i), dtype, gen, 0.02), rand((h, i), dtype, gen, 0.02)
    wd = rand((i, h), dtype, gen, 0.02)
    kern = lambda: FM.fused_swiglu_mlp(x, wg, wu, wd)
    plain = lambda: FM.plain(x, wg, wu, wd)
    library = lambda: (F.silu(x @ wg) * (x @ wu)) @ wd
    nbytes = x.element_size() * (2 * t * h + 3 * h * i)
    err = compare("mlp", kern(), plain(), dtype)
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
    err = compare("attn", kern(), plain(), dtype, rows)
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

    err = max(compare(f"flash d{n}", a, w, dtype)
              for n, a, w in zip("qkv", kern(), plain()))
    it = q.element_size()
    # read q, k, v, out, dO, lse; write dq, dk, dv
    nbytes = it * (5 * q.numel() + 4 * k.numel()) + 4 * b * h * s
    # recompute s, then dp, dv, dk, dq: five products per visible pair
    ops = 10.0 * b * h * d * causal_pairs(s, s)
    return err, kern, plain, library, nbytes, ops


def flash_edge_checks(gen):
    """The flash kernels against their plain versions off the main path's
    shapes: causal with Sq < Sk (a bottom-right offset), lengths that are
    not tile multiples, GQA, and head dims other than 128: 64, 80 and 256
    (16-byte loads, columns past the head dim zero) and 18 (element
    loads)."""
    errs = {}
    for b, sq, sk, h, hkv, d, causal in ((1, 100, 260, 4, 2, 128, True),
                                        (2, 70, 70, 2, 2, 64, False),
                                        (1, 90, 90, 4, 1, 80, True),
                                        (1, 80, 150, 2, 2, 256, True),
                                        (2, 40, 40, 2, 1, 18, False)):
        for dt in (torch.bfloat16, torch.float32):
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


def mlp_scratch_rows(gen):
    """Scratch bytes, error against plain and time of the bf16 MLP
    kernel at the serving and the training token counts (llama2-7b
    widths)."""
    rows = []
    for t in (128, 4096):
        x = rand((t, 4096), torch.bfloat16, gen)
        wg, wu = (rand((4096, 11008), torch.bfloat16, gen, 0.02)
                  for _ in range(2))
        wd = rand((11008, 4096), torch.bfloat16, gen, 0.02)
        n = FM.KERNEL.helper("pt_fused_swiglu_mlp_scratch",
                             [ctypes.c_int] * 3, ctypes.c_longlong)(
            t, 4096, 11008)
        row = {"t": t, "scratch_bytes": 4 * n,
               "scratch_bytes_one_split_per_chunk": 4 * (11008 // 128)
               * (-(-t // 64) * 64) * 4096,
               "max_abs_err": compare(f"mlp t={t}",
                                      FM.fused_swiglu_mlp(x, wg, wu, wd),
                                      FM.plain(x, wg, wu, wd),
                                      torch.bfloat16),
               "ms": cuda_ms(lambda: FM.fused_swiglu_mlp(x, wg, wu, wd)),
               "plain_ms": cuda_ms(lambda: FM.plain(x, wg, wu, wd))}
        rows.append(row)
        log("mlp_scratch " + json.dumps(row))
        del x, wg, wu, wd
        torch.cuda.empty_cache()
    return rows


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


def quant_kernel_rows(gen):
    """int8 and int4, bf16 and f32, at the weight-only engine step's four
    shapes; then each kind's sum over one step's 225 calls."""
    rows = []
    for kind in QUANT:
        for m, k, n, calls in QUANT_STEP:
            for dt in (torch.bfloat16, torch.float32):
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
                       if kind == "int8" else None}
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
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            step[key] = sum(r[key] * r["calls_per_step"] for r in part)
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
    an identity x through all 256 int8 codes, and through all 256 packed
    bytes, must give the codes and the sign-extended nibbles exactly."""
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
    for dt in (torch.bfloat16, torch.float32):
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
                8, 16, 32, 32, 128, 16, 512, dt, gen, rng)),
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
                8, 16, 64, 8, 128, 16, 512, dt, gen, rng)),
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
            for dt in (torch.bfloat16, torch.float32):
                err, kern, plain, library, nbytes, ops = make(dt)
                torch.cuda.synchronize()
                bms, by = bound_ms(nbytes, ops, dt)
                row = {"name": name, "geometry": geom,
                       "dtype": str(dt).replace("torch.", ""),
                       "max_abs_err": err, "tol": TOL[dt],
                       "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
                       "library_ms": cuda_ms(library), "bound_ms": bms,
                       "bound_by": by}
                rows.append(row)
                log("kernel " + json.dumps(row))
                del kern, plain, library
                torch.cuda.empty_cache()
    mlp_scratch_rows(tgen)
    flash_edge_checks(tgen)
    # the weight-only kernels draw from their own generator, so the
    # earlier cases keep their inputs
    qgen = torch.Generator(device="cuda").manual_seed(2)
    rows += quant_kernel_rows(qgen)
    quant_edge_checks(qgen)
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


def reset_launches():
    for _, kern, _, _ in KERNELS:
        kern.launches = 0


def kernel_launches():
    return {name: kern.launches for name, kern, _, _ in KERNELS}


def profile_steps(eng, rng, n_steps: int = 8):
    """Device busy time and kernel time by name over ``n_steps`` steps of
    a fresh full batch (8 prompts of 17-300 tokens), traced with
    torch.profiler after the counted run; None where the trace shows no
    device activity."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(8):
        eng.add_request(rng.integers(0, 32000, size=int(
            rng.integers(17, 301))), max_new_tokens=32,
            request_id=f"prof{i}")
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": n_steps, "wall_ms": wall_ms,
            "device_busy_ms": busy if busy else None,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "top_kernels_ms": [[k[:80], v] for k, v in top]}


def engine_phase():
    t0 = time.perf_counter()
    model = llama("llama2-7b", dtype="bfloat16", seed=0)
    torch.cuda.synchronize()
    eng = Engine(model, max_batch=8, max_seq_len=512, page_size=16).warmup()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    reset_launches()
    steps0 = eng.steps
    t1 = time.perf_counter()
    reqs, out = serve(eng, rng, 5, 17, 300, 16, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {k: v for k, v in kernel_launches().items() if k in SERVING}
    steps = eng.steps - steps0
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
           "launches": launches, "layers": layers,
           "prompt_tokens": int(sum(len(p) for p, _ in reqs.values()))}
    res["profile"] = profile_steps(eng, rng)
    log("engine " + json.dumps(res))
    del eng, model
    torch.cuda.empty_cache()
    return res


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
    steps0 = eng.steps
    t1 = time.perf_counter()
    reqs, out = serve(eng, rng, 5, 17, 300, 16, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = kernel_launches()
    steps = eng.steps - steps0
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
    res["profile"] = profile_steps(eng, rng)
    log("quant_engine " + json.dumps(res))
    del eng, model, qlin
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
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"steps": n_steps, "wall_ms": wall_ms,
            "device_busy_ms": busy if busy else None,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "top_kernels_ms": [[k[:80], v] for k, v in top]}


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
    kernel_rows = kernel_phase()
    engine = engine_phase()
    quant = {kind: quant_engine_phase(kind) for kind in QUANT}
    cross_check_phase()
    quant_cross_check_phase()
    train = train_phase()
    train_cross_check_phase()
    main_rows = {r["name"]: r for r in kernel_rows
                 if r["geometry"] == "llama2-7b" and r["dtype"] == "bfloat16"
                 and "shape" not in r}
    main_rows.update({r["name"]: r for r in kernel_rows
                      if r["geometry"] == "llama2-7b-step"})
    launches = {**train["launches"], **engine["launches"]}
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
        for name, _, src, rep in KERNELS]}
    log(f"card: {smi}")
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
