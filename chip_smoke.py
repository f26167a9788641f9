#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the run on its own (nothing is caught):

1. build: compiles the three CUDA kernels from paddle_tpu_torch/csrc for
   sm_90a, one nvcc per source, all at once (timed as set-up);
2. kernels: holds each kernel against its plain PyTorch version on the
   card, in bf16 and f32, at the serving path's llama2-7b shapes (T = B*C
   = 128 tokens; ragged attention B=8, C=16, page 16, contexts up to 512)
   and at the llama2-70b geometry (64 q heads over 8 kv heads); prints
   each max error beside its tolerance, the kernel's median time, its
   bound from this card's memory rate and peak, the plain version's time
   and the time of a PyTorch yardstick call (cuBLAS matmul chains,
   scaled_dot_product_attention over the gathered KV) that the port
   never calls;
3. engine: llama2-7b in bf16, all 32 layers, random weights drawn on the
   card from a seeded generator, behind Engine(max_batch=8,
   max_seq_len=512, page_size=16): 8 staggered greedy requests, two of
   them sharing a 64-token prefix after a first one finished (prefix
   hits and copy-on-write); checks that all finished, the pool drained
   and each kernel's launch count equals layers x non-empty steps;
4. cross-check: a 2-layer model at full llama2-7b width in f32, the same
   weights on both sides, kernels on the card against the plain versions
   on the CPU: greedy streams must be equal under the near-tie rule.

Prints each measurement as a JSON line, the card's name and power limit,
a {"kernels": [...]} line, and last the {"ok": true, "device": {...}}
line.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.models import llama
from paddle_tpu_torch.ops.cuda import _build
from paddle_tpu_torch.ops.cuda import fused_mlp as FM
from paddle_tpu_torch.ops.cuda import fused_norm_qkv as FQ
from paddle_tpu_torch.ops.cuda import ragged_attention as RA
from paddle_tpu_torch.serving import Engine

# H100 SXM, NVIDIA's data sheet (dense): memory rate and peak by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain on the card: |kernel - plain| <= atol + rtol * |plain|.
# f32: the same arithmetic in another summation order.  bf16: the same
# rounding points, where an f32 sum on a rounding boundary can move an
# intermediate or the output by one bf16 unit (2**-8 relative).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# near-tie rule: a greedy token may differ only where the reference's
# top-2 logit margin is below this (f32 logits here differ by ~1e-5)
TIE = 1e-3
KERNELS = [
    ("fused_rms_rope_qkv", FQ, "paddle_tpu_torch/csrc/fused_norm_qkv.cu",
     "paddle_tpu/ops/pallas/fused_norm_qkv.py:158"),
    ("fused_swiglu_mlp", FM, "paddle_tpu_torch/csrc/fused_mlp.cu",
     "paddle_tpu/ops/pallas/fused_mlp.py:148"),
    ("ragged_paged_attention", RA,
     "paddle_tpu_torch/csrc/ragged_attention.cu",
     "paddle_tpu/ops/pallas/ragged_attention.py:137"),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn()``, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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


def kernel_phase():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    shapes = {
        "llama2-7b": [
            ("fused_rms_rope_qkv", lambda dt: qkv_case(128, 4096, 4096,
                                                       4096, 128, dt, gen)),
            ("fused_swiglu_mlp", lambda dt: mlp_case(128, 4096, 11008, dt,
                                                     gen)),
            ("ragged_paged_attention", lambda dt: attn_case(
                8, 16, 32, 32, 128, 16, 512, dt, gen, rng))],
        "llama2-70b-gqa": [
            ("fused_rms_rope_qkv", lambda dt: qkv_case(128, 8192, 8192,
                                                       1024, 128, dt, gen)),
            ("fused_swiglu_mlp", lambda dt: mlp_case(128, 8192, 28672, dt,
                                                     gen)),
            ("ragged_paged_attention", lambda dt: attn_case(
                8, 16, 64, 8, 128, 16, 512, dt, gen, rng))],
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


def kernel_launches():
    return {name: mod.KERNEL.launches for name, mod, _, _ in KERNELS}


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
    for _, mod, _, _ in KERNELS:
        mod.KERNEL.launches = 0
    steps0 = eng.steps
    t1 = time.perf_counter()
    reqs, out = serve(eng, rng, 5, 17, 300, 16, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = kernel_launches()
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
    cross_check_phase()
    main_rows = {r["name"]: r for r in kernel_rows
                 if r["geometry"] == "llama2-7b" and r["dtype"] == "bfloat16"}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": engine["launches"][name],
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
