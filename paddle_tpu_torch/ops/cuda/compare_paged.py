"""Time this checkout's paged decode-attention kernel against another
tree's, on one card.

    python3 -m paddle_tpu_torch.ops.cuda.compare_paged --other DIR [--sweep]

``DIR`` is the ``csrc`` directory of another checkout's
``paddle_tpu_torch`` package (for example a ``git archive`` of an earlier
commit unpacked into a directory that ``.gitignore`` lists).  Each tree's
kernel is called through its own wrapper (the other package imported
under another name, its kernel built from its own sources into its own
``build/``), so a call pays its tree's host cost too.  In turns -- this
tree, the other, the other, this tree -- in bf16 on the same inputs, at
the geometries of ``chip_smoke.py``'s ``paged_attention`` rows: the
gpt3-6.7b decode (B 8, 32 heads of 128, page 16, lengths drawn in
[1, 512]), the llama2-70b GQA geometry (64 q heads over 8 kv heads, the
same lengths) and the two edge sets (lengths 1, a page multiple, 512, a
zero-length slot; head dims 128 and 64), tables of a permutation of the
pool padded with the out-of-range sentinel.  Each row prints, for both
trees: the CUDA-event ms (median of 5 windows of 5 calls; the better of
the tree's two turns), the device ms (calls queued behind a sleep kernel,
``_compare.device_ms``), the host's wall time per call (500 calls without
a synchronize, three turns a tree in the order this, other, other, this,
this, other: the least and every turn) and the largest difference from
the plain version, which
must lie within the bf16 tolerance (|a - b| <= 2e-2 + 2e-2 |b|); this
tree's plan (path, spans, stages per span, grid blocks); one PyTorch call
of the same function that the port never calls (SDPA over the gathered,
head-repeated K/V); and the bound (live K/V, q and output bytes over
3.35 TB/s).  Prints the card's name and power limit.  Needs a CUDA card
and ``nvcc``.

``--sweep`` adds this tree's kernel at the gpt3-6.7b and 70b GQA rows
over the span counts that 1, 2, 4 and 8 asked spans give (and the
plan's own): the device ms of each, the plan's choice marked, every
output held against the plan's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from . import paged_attention as PA
from ._compare import card, cuda_ms, device_ms
from .compare_int4_mega import _held
from .compare_qkv_quant import _turns
from .compare_ragged_bgmv import _kernels_of
from .mlp_plan import sm_count
from .paged_plan import check_plan, paged_plan
from .ragged_attention import paged_gather_dense

HBM_BYTES_S = 3.35e12
PAGE = 16


def rows():
    """(geometry, B, H, H_kv, D, lengths) of chip_smoke.py's rows."""
    ragged = [int(n) for n in np.random.default_rng(4).integers(1, 513,
                                                                size=8)]
    return [("gpt3-6.7b", 8, 32, 32, 128, ragged),
            ("llama2-70b-gqa", 8, 64, 8, 128, ragged),
            ("edges d=128", 8, 32, 32, 128, [1, 16, 64, 0, 37, 512, 3, 200]),
            ("edges d=64", 6, 16, 16, 64, [1, 32, 0, 17, 512, 48])]


def paged_inputs(b, h, hkv, d, lens, gen, rng, dt=torch.bfloat16):
    """q, pools, sentinel-padded tables of a pool permutation, lens."""
    lens = np.asarray(lens, np.int32)
    mb = -(-int(lens.max()) // PAGE) + 1
    nb = b * mb
    tables = np.full((b, mb), nb, np.int32)
    perm = rng.permutation(nb)
    used = 0
    for s in range(b):
        n = -(-int(lens[s]) // PAGE)
        tables[s, :n] = perm[used:used + n]
        used += n

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    q = rand((b, h, d))
    kp, vp = rand((nb, PAGE, hkv, d)), rand((nb, PAGE, hkv, d))
    return (q, kp, vp, torch.from_numpy(tables).cuda(),
            torch.from_numpy(lens).cuda())


def bound_ms(q, kp, lens) -> float:
    """Live K/V rows, q and the output, over the memory rate (ms)."""
    b, h, d = q.shape
    it = q.element_size()
    nbytes = it * (2 * b * h * d + 2 * int(lens.sum()) * kp.shape[2] * d) \
        + 4 * (b + b * (-(-int(lens.max()) // PAGE) + 1))
    return nbytes / HBM_BYTES_S * 1e3


def _sdpa(q, kp, vp, tt, ln):
    g = q.shape[1] // kp.shape[2]
    k, v = paged_gather_dense(kp, vp, tt)
    k = k.transpose(1, 2).repeat_interleave(g, 1)
    v = v.transpose(1, 2).repeat_interleave(g, 1)
    mask = torch.arange(k.shape[2], device="cuda") < ln[:, None]
    return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                          attn_mask=mask[:, None, None])


def host_us(fn, calls: int = 500) -> float:
    """The host's wall time per call of ``calls`` calls without a
    synchronize between them (µs)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _plan_of(q, kp, tt):
    b, h, d = q.shape
    return paged_plan(b, h, kp.shape[2], d, PAGE, tt.shape[1], q.dtype,
                      sm_count(q.device))


def sweep(gen, rng):
    """This tree's kernel over several span counts at the gpt3-6.7b and
    70b GQA rows (module docstring)."""
    for geom, b, h, hkv, d, lens in rows()[:2]:
        ins = paged_inputs(b, h, hkv, d, lens, gen, rng)
        q, kp, vp, tt, ln = ins
        plan = _plan_of(q, kp, tt)
        want = PA.paged_attention(*ins)
        scale = 1.0 / math.sqrt(d)
        pers = {-(-plan.stages // n) for n in (1, 2, 4, 8)} | {plan.per}
        for per in sorted(pers, reverse=True):
            p = dataclasses.replace(plan, per=per,
                                    splits=-(-plan.stages // per))
            check_plan("sweep", p)
            fn = lambda: PA.launch(q, kp, vp, tt, ln, scale, p)
            _held("paged sweep", fn(), want)
            print(json.dumps({
                "sweep": "paged_attention", "geometry": geom,
                "splits": p.splits, "stages_per_split": per,
                "grid_blocks": p.grid_blocks, "plan": p == plan,
                "device_ms": device_ms(fn)}), flush=True)
        del ins, want
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="csrc directory of the other tree's package")
    ap.add_argument("--sweep", action="store_true",
                    help="also time this tree's kernel over its paths and "
                    "span counts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_paged: no CUDA device", file=sys.stderr)
        return 2
    other_root = args.other.resolve().parent
    if not (other_root / "__init__.py").is_file():
        print(f"compare_paged: no package around {args.other}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(f"card: {smi}", flush=True)
    other = _kernels_of(other_root, "other_paddle_tpu_torch")
    calls = {"this": PA.paged_attention,
             "other": other.paged_attention.paged_attention}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    for geom, b, h, hkv, d, lens in rows():
        ins = paged_inputs(b, h, hkv, d, lens, gen, rng)
        q, kp, vp, tt, ln = ins
        res, dev, outs = _turns(calls, ins)
        host = {"this": [], "other": []}
        for name in ("this", "other", "other", "this", "this", "other"):
            host[name].append(host_us(lambda: calls[name](*ins)))
        want = PA.plain(*ins)
        plan = _plan_of(q, kp, tt)
        print(json.dumps({
            "kernel": "paged_attention", "geometry": geom,
            "shape": [b, h, hkv, d, PAGE], "lens": lens, "dtype": "bfloat16",
            "this_ms": res["this"], "other_ms": res["other"],
            "this_device_ms": dev["this"], "other_device_ms": dev["other"],
            "this_host_us": min(host["this"]),
            "other_host_us": min(host["other"]),
            "host_us_turns": host,
            "this_max_abs_err": _held("this", outs["this"], want),
            "other_max_abs_err": _held("other", outs["other"], want),
            "bit_equal_calls": bool(torch.equal(outs["this"],
                                                calls["this"](*ins))),
            "path": plan.path, "splits": plan.splits,
            "stages_per_split": plan.per, "grid_blocks": plan.grid_blocks,
            "library_ms": cuda_ms(lambda: _sdpa(*ins)),
            "library_device_ms": device_ms(lambda: _sdpa(*ins)),
            "bound_ms": bound_ms(q, kp, np.asarray(lens))}), flush=True)
        del ins, outs
        torch.cuda.empty_cache()
    if args.sweep:
        sweep(gen, rng)
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
