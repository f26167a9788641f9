"""Time this checkout's ragged paged-attention and grouped-BGMV kernels
against another tree's, on one card.

    python3 -m paddle_tpu_torch.ops.cuda.compare_ragged_bgmv --other DIR

``DIR`` is the ``csrc`` directory of another checkout (for example a
``git archive`` of an earlier commit unpacked into a directory that
``.gitignore`` lists).  Both trees' ``ragged_attention.cu`` and
``lora_matmul.cu`` are built, each with its own tree's ``*.cuh``, with
this checkout's ``nvcc`` flags into ``build/``, and timed in turns --
this tree, the other, the other, this tree -- in bf16 on the same inputs:
ragged attention at the llama2-7b engine step and the llama2-70b GQA
geometry (B 8, C 16, page 16, contexts up to 512: decode rows deep in
their context, chunks, partial chunks, an idle slot, tables padded with
the out-of-range sentinel); grouped BGMV at the multi-LoRA llama2-7b
step's three geometries (8 slots of 16 rows, rank 16, two base slots)
and their sum over one step's 224 calls.  A tree's C entry point is
called through its own interface, as its own wrapper calls it: the plan
one (:mod:`.ragged_plan` gives the spans and the scratch,
:mod:`.bgmv_plan` the d_in slice) or the one before it (no scratch; the
older ragged library has a ``pt_ragged_paged_attention_smem`` helper, the
older BGMV entry no slice).  Each time is the median of 5 CUDA-event
windows around 5 calls, and the device time of a call with the host out
of the way (``_compare.device_ms``); a line keeps the better of a tree's two turns,
beside one PyTorch call of the same function that the port never calls
(SDPA over the gathered, repeated K/V; ``bmm`` over the gathered
stacks), and the largest difference between the two trees' outputs (on
live rows for attention), which must lie within the bf16 tolerance
(|a - b| <= 2e-2 + 2e-2 |b|).  Prints one JSON line per row and the
card's name and power limit.  Needs a CUDA card and ``nvcc``.
``--sweep`` adds this tree's ragged attention over the choices its plan
makes (1, 2, 3, 4 and 8 position spans; device ms each, the plan's
choice marked).

    python3 -m paddle_tpu_torch.ops.cuda.compare_ragged_bgmv --other DIR --engine

adds the serving step, which needs the other tree's whole package (DIR
inside an unpacked ``paddle_tpu_torch``): llama2-7b in bf16 (32 layers,
seeded random weights) behind ``Engine(max_batch=8, max_seq_len=512,
page_size=16)`` with a ``LoRAPool`` of three rank-16 adapters serves 8
greedy requests (prompts of 17-120 tokens, 32 new tokens each, two base
requests and two on each adapter) once per turn -- this tree, the other,
the other, this tree, this tree, the other -- with the engine's
ragged-attention and BGMV calls going to that tree's own wrappers (the
other package imported under another name, its kernels built from its
own sources), so a turn pays its tree's host cost too (each turn's prompts
are fresh tokens of the same lengths, so no turn hits another's prefix
pages).  Each turn prints its steps, step ms (host wall time over the
steps, ending in a synchronize), tokens/s and the host's time inside the
two kernels' calls per step; two more turns, one per tree, run under
``torch.profiler`` and add the device's busy ms per step (the union of
the kernels' intervals).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from ._build import dtype_code, stream_of
from ._compare import build_tree, card, cuda_ms, device_ms
from .bgmv_plan import bgmv_plan
from .compare_int4_mega import _held, _sum_step
from .compare_qkv_quant import _check, _turns
from .mlp_plan import sm_count
from .ragged_attention import paged_gather_dense
from .ragged_plan import ragged_plan

SOURCES = ("ragged_attention", "lora_matmul")
# (B, C, H, H_kv, D, page, contexts up to)
RAGGED_ROWS = [("llama2-7b", 8, 16, 32, 32, 128, 16, 512),
               ("llama2-70b-gqa", 8, 16, 64, 8, 128, 16, 512)]
# (d_in, d_out, calls per step) of the multi-LoRA llama2-7b step, rank 16
BGMV_ROWS = [(4096, 4096, 128), (4096, 11008, 64), (11008, 4096, 32)]
BGMV_IDX = [0, 1, 2, 3, 0, 4, 1, 2]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _ragged_caller(lib, spans=None):
    """fn(q, kp, vp, tables, starts, lens) -> out through the tree's own C
    interface; ``spans`` (splits, per) overrides the plan's."""
    fn = lib.pt_ragged_paged_attention
    fn.restype = _I
    old = hasattr(lib, "pt_ragged_paged_attention_smem")
    fn.argtypes = ([_P] * 7 + [_I] * 8 + [_F, _I, _P] if old
                   else [_P] * 9 + [_I] * 10 + [_F, _I, _P])

    def call(q, kp, vp, tt, st, ln):
        b, c, h, d = q.shape
        nb, page, hkv, _ = kp.shape
        mb = tt.shape[1]
        out = torch.empty_like(q)
        ptrs = [t.data_ptr() for t in (q, kp, vp, tt, st, ln, out)]
        tail = (1.0 / math.sqrt(d), dtype_code(q.dtype), stream_of(q))
        if old:
            rc = fn(*ptrs, b, c, h, nb, page, hkv, d, mb, *tail)
        else:
            p = ragged_plan(b, c, h, hkv, d, page, mb, q.dtype,
                            sm_count(q.device))
            if spans is not None:
                p = dataclasses.replace(p, splits=spans[0], per=spans[1])
            scratch = torch.empty((max(1, p.partial_bytes),),
                                  dtype=torch.uint8, device=q.device)
            base = scratch.data_ptr()
            rc = fn(*ptrs, base, base + p.ml_offset, b, c, h, nb, page, hkv,
                    d, mb, p.splits, p.per, *tail)
        _check(lib, "pt_ragged_paged_attention", rc)
        return out
    return call


def _bgmv_caller(lib, planned: bool):
    """fn(x, a, b, idx) -> out through the tree's own C interface."""
    fn = lib.pt_grouped_bgmv
    fn.restype = _I
    fn.argtypes = ([_P] * 5 + [_I] * 8 + [_P] if planned
                   else [_P] * 5 + [_I] * 7 + [_P])

    def call(x, a, b, idx):
        bsz, c, d_in = x.shape
        n, _, r = a.shape
        d_out = b.shape[2]
        out = torch.empty((bsz, c, d_out), dtype=x.dtype, device=x.device)
        ptrs = [t.data_ptr() for t in (x, a, b, idx, out)]
        tail = (dtype_code(x.dtype), stream_of(x))
        if planned:
            p = bgmv_plan(bsz, c, d_in, r, d_out, x.dtype)
            rc = fn(*ptrs, bsz, c, d_in, r, d_out, n, p.slice, *tail)
        else:
            rc = fn(*ptrs, bsz, c, d_in, r, d_out, n, *tail)
        _check(lib, "pt_grouped_bgmv", rc)
        return out
    return call


def ragged_inputs(b, c, h, hkv, d, page, max_ctx, gen, rng,
                  dt=torch.bfloat16):
    """A serving step's attention inputs: decode rows deep in their
    context, fresh and partial chunks, an idle last slot; block tables of
    a permutation of the pool padded with the out-of-range sentinel.
    Returns the kernel's arguments and the live-row mask."""
    mb = max_ctx // page
    nb = b * mb
    starts = rng.integers(0, max_ctx - c, size=b).astype(np.int32)
    lens = rng.integers(1, c + 1, size=b).astype(np.int32)
    starts[::3] = rng.integers(300, max_ctx - 1, size=len(starts[::3]))
    lens[::3] = 1
    lens[1::3] = c
    lens[-1] = 0
    tables = np.full((b, mb), nb, np.int32)
    perm = rng.permutation(nb)
    used = 0
    for s in range(b):
        n = -(-(int(starts[s]) + int(lens[s])) // page)
        tables[s, :n] = perm[used:used + n]
        used += n

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    q = rand((b, c, h, d))
    kp, vp = rand((nb, page, hkv, d)), rand((nb, page, hkv, d))
    tt, st, ln = (torch.from_numpy(a).cuda() for a in (tables, starts, lens))
    live = torch.arange(c, device="cuda")[None, :] < ln[:, None]
    return (q, kp, vp, tt, st, ln), live


def _sdpa(q, kp, vp, tt, st, ln):
    """SDPA over the gathered K/V, repeated over each kv head's group."""
    c, g = q.shape[1], q.shape[2] // kp.shape[2]
    k, v = paged_gather_dense(kp, vp, tt)
    k = k.transpose(1, 2).repeat_interleave(g, 1)
    v = v.transpose(1, 2).repeat_interleave(g, 1)
    pos = st.long()[:, None] + torch.arange(c, device=q.device)
    mask = torch.arange(k.shape[2], device=q.device) <= pos[..., None]
    return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                          attn_mask=mask[:, None])


def bgmv_inputs(d_in, d_out, gen, bsz=8, c=16, r=16, n=5,
                dt=torch.bfloat16):
    def rand(shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(dt)
    x = rand((bsz, c, d_in))
    a, b = rand((n, d_in, r), 0.05), rand((n, r, d_out), 0.05)
    a[0] = 0
    b[0] = 0
    return x, a, b, torch.tensor(BGMV_IDX, dtype=torch.int32, device="cuda")


def _kernels_of(root: Path, name: str):
    """``ops.cuda`` of the ``paddle_tpu_torch`` package at ``root``,
    imported as ``name`` (its modules import each other relatively, and
    its kernels build from its own ``csrc`` into its own ``build/``)."""
    spec = importlib.util.spec_from_file_location(
        name, root / "__init__.py", submodule_search_locations=[str(root)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.cuda")


def engine_turns(other_root: Path,
                 turns=("this", "other", "other", "this", "this", "other")):
    """The multi-LoRA engine's step ms with each tree's two kernels and
    wrappers, in turns (module docstring)."""
    from ...models import llama
    from ...serving import Engine, LoRAPool, random_adapter
    from . import lora_matmul, ragged_attention
    from ._compare import device_events, union_ms
    other = _kernels_of(other_root, "other_paddle_tpu_torch")
    model = llama("llama2-7b", dtype="bfloat16", seed=0, fused_ops="off")
    pool = LoRAPool(model, max_adapters=4, rank=16)
    arng = np.random.default_rng(5)
    for name in ("ad0", "ad1", "ad2"):
        pool.load(name, random_adapter(model, rank=16, rng=arng, scale=0.05))
    eng = Engine(model, max_batch=8, max_seq_len=512, page_size=16,
                 lora=pool).warmup()
    vocab = model.cfg.vocab_size
    lengths = np.random.default_rng(7).integers(17, 121, size=8)
    adapters = (None, "ad0", "ad1", "ad2") * 2
    in_calls = [0.0]

    def timed(fn):
        def call(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            in_calls[0] += time.perf_counter() - t
            return out
        return call
    saved = (ragged_attention.ragged_paged_attention,
             lora_matmul.grouped_bgmv)
    wrappers = {"this": tuple(timed(f) for f in saved),
                "other": (timed(other.ragged_attention.ragged_paged_attention),
                          timed(other.lora_matmul.grouped_bgmv))}

    def serve(i, name):
        (ragged_attention.ragged_paged_attention,
         lora_matmul.grouped_bgmv) = wrappers[name]
        rng = np.random.default_rng(100 + i)
        for k in range(8):
            eng.add_request(rng.integers(0, vocab, size=int(lengths[k])),
                            max_new_tokens=32, request_id=f"t{i}r{k}",
                            adapter=adapters[k])
        torch.cuda.synchronize()
        in_calls[0] = 0.0
        steps0, t0 = eng.steps, time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = eng.steps - steps0
        row = {"engine": "multi-lora llama2-7b", "turn": i, "tree": name,
               "steps": steps, "step_ms": wall / steps * 1e3,
               "tok_s": 8 * 32 / wall,
               "host_ms_in_kernel_calls_per_step": in_calls[0] / steps * 1e3}
        return row
    try:
        for j, name in enumerate(wrappers):        # build, load, warm up
            (ragged_attention.ragged_paged_attention,
             lora_matmul.grouped_bgmv) = wrappers[name]
            eng.add_request(np.arange(1, 40), max_new_tokens=4,
                            request_id=f"warm{j}", adapter="ad0")
            eng.run()
        for i, name in enumerate(turns):
            print(json.dumps(serve(i, name)), flush=True)
        for j, name in enumerate(("this", "other")):
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                row = serve(len(turns) + j, name)
            row["device_busy_ms_per_step"] = union_ms(
                device_events(prof)) / row["steps"]
            print(json.dumps(row), flush=True)
    finally:
        (ragged_attention.ragged_paged_attention,
         lora_matmul.grouped_bgmv) = saved
    del eng, model, pool
    torch.cuda.empty_cache()


def sweep(libs, gen, rng):
    """This tree's ragged attention with 1, 2, 3, 4 and 8 spans at both
    rows: the device ms of each, the plan's own choice marked, every
    output held against the plan's."""
    for geom, *shape in RAGGED_ROWS:
        ins, live = ragged_inputs(*shape, gen, rng)
        b, c, h, hkv, d, page, max_ctx = shape
        plan = ragged_plan(b, c, h, hkv, d, page, max_ctx // page,
                           torch.bfloat16, sm_count(ins[0].device))
        want = _ragged_caller(libs["ragged_attention"])(*ins)
        for splits in (1, 2, 3, 4, 8):
            per = -(-plan.stages // splits)
            if -(-plan.stages // per) != splits:
                continue
            fn = _ragged_caller(libs["ragged_attention"], (splits, per))
            _held("ragged sweep", fn(*ins), want, live)
            print(json.dumps({
                "sweep": "ragged_paged_attention", "geometry": geom,
                "splits": splits, "stages_per_split": per,
                "plan": splits == plan.splits,
                "device_ms": device_ms(lambda: fn(*ins))}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="csrc directory of the other tree")
    ap.add_argument("--engine", action="store_true",
                    help="also time the multi-LoRA serving step in turns")
    ap.add_argument("--sweep", action="store_true",
                    help="also time this tree's ragged attention over its "
                    "plan's split choices")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_ragged_bgmv: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(f"card: {smi}", flush=True)
    other = args.other.resolve()
    if args.engine and not (other.parent / "__init__.py").is_file():
        print("compare_ragged_bgmv: --engine needs the other tree's whole "
              f"package around {other}", file=sys.stderr)
        return 2
    libs = {"this": build_tree("rb-this", _build.CSRC, SOURCES),
            "other": build_tree("rb-other", other, SOURCES)}
    planned = {"this": True,
               "other": "int slice," in (other / "lora_matmul.cu").read_text()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    ragged = {name: _ragged_caller(lib["ragged_attention"])
              for name, lib in libs.items()}
    for geom, *shape in RAGGED_ROWS:
        ins, live = ragged_inputs(*shape, gen, rng)
        res, dev, outs = _turns(ragged, ins)
        print(json.dumps({
            "kernel": "ragged_paged_attention", "geometry": geom,
            "shape": shape, "dtype": "bfloat16",
            "this_ms": res["this"], "other_ms": res["other"],
            "this_device_ms": dev["this"], "other_device_ms": dev["other"],
            "library_ms": cuda_ms(lambda: _sdpa(*ins)),
            "library_device_ms": device_ms(lambda: _sdpa(*ins)),
            "max_abs_diff": _held("ragged", outs["this"], outs["other"],
                                  live)}), flush=True)
        del ins, outs
        torch.cuda.empty_cache()
    bgmv = {name: _bgmv_caller(lib["lora_matmul"], planned[name])
            for name, lib in libs.items()}
    rows = []
    for d_in, d_out, calls in BGMV_ROWS:
        x, a, b, ix = ins = bgmv_inputs(d_in, d_out, gen)
        res, dev, outs = _turns(bgmv, ins)
        library = lambda: torch.bmm(torch.bmm(x, a.index_select(0, ix.long())),
                                    b.index_select(0, ix.long()))
        row = {"kernel": "grouped_bgmv", "geometry": "llama2-7b",
               "shape": [d_in, d_out, 16], "dtype": "bfloat16",
               "calls_per_step": calls,
               "this_ms": res["this"], "other_ms": res["other"],
               "this_device_ms": dev["this"], "other_device_ms": dev["other"],
               "library_ms": cuda_ms(library),
               "library_device_ms": device_ms(library),
               "max_abs_diff": _held("bgmv", outs["this"], outs["other"])}
        rows.append(row)
        print(json.dumps(row), flush=True)
    step = {"kernel": "grouped_bgmv", "geometry": "llama2-7b-step",
            "dtype": "bfloat16",
            "calls_per_step": sum(r["calls_per_step"] for r in rows),
            "max_abs_diff": max(r["max_abs_diff"] for r in rows)}
    for key in ("this_ms", "other_ms", "this_device_ms", "other_device_ms",
                "library_ms", "library_device_ms"):
        step[key] = _sum_step(rows, key)
    print(json.dumps(step), flush=True)
    if args.sweep:
        sweep(libs["this"], gen, rng)
    if args.engine:
        engine_turns(other.parent)
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
