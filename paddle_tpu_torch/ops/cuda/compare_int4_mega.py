"""Time this checkout's int4 dequant GEMM and decode megakernel against
another tree's, on one card.

    python3 -m paddle_tpu_torch.ops.cuda.compare_int4_mega --other DIR

``DIR`` is the ``csrc`` directory of another checkout (for example a
``git archive`` of an earlier commit unpacked into a directory that
``.gitignore`` lists).  Both trees' ``int4_matmul.cu`` and
``mega_decode.cu`` are built, each with its own tree's ``*.cuh``, with
this checkout's ``nvcc`` flags into ``build/``, and timed in turns --
this tree, the other, the other, this tree -- in bf16 at the main path's
rows: int4 at the quantized llama2-7b step's four shapes and their sum
over one step's 225 calls; the megakernel at the llama2-7b and 70b GQA
serving steps (B 8, C 16, page 16, contexts up to 512).  A tree's C entry
point is called through its own interface, as its own wrapper calls it:
the plan one (:mod:`.int4_plan` and :mod:`.mega_plan` give the tiles,
splits and scratch) or the one before it (int4's
``pt_int4_matmul_scratch`` helper sizes its partials; the megakernel took
no plan).  Each time is the median of 5 CUDA-event windows around 5
calls, and the device time of a call with the host out of the way
(``_compare.device_ms``); a line keeps the better of a tree's two turns,
beside (int4) one cuBLAS product over the widened weight (never called
by the port), and the largest difference between the two trees' outputs
(the megakernel's output on live rows), which must lie within the bf16
tolerance (|a - b| <= 2e-2 + 2e-2 |b|).  Prints one JSON line per row and the card's name and power
limit.  Needs a CUDA card and ``nvcc``.

    python3 -m paddle_tpu_torch.ops.cuda.compare_int4_mega --other DIR --phases

adds the megakernel's phases: a copy of each tree's ``mega_decode.cu``
with ``%globaltimer`` stamps taken by block 0 after each grid barrier
(and one more barrier at the end) is built beside the timed one, and
each phase's time (median of 5 calls, each alone) and share of the sum
are printed for both geometries.  The stamps and the extra barrier cost
a little, so the sum exceeds the kernel's time; the shares are what the
line is for.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import _build
from ._build import dtype_code, stream_of
from ._compare import build_tree, card, cuda_ms
from .compare_qkv_quant import _check, _turns
from .int4_matmul import unpack_int4
from .int4_plan import int4_plan
from .int8_matmul import DTYPES as QUANT_DTYPES
from .mega_plan import mega_plan
from .mlp_plan import sm_count

SOURCES = ("int4_matmul", "mega_decode")
# (M, K, N, calls per step) of the quantized llama2-7b engine step
INT4_ROWS = [(128, 4096, 4096, 128), (128, 4096, 11008, 64),
             (128, 11008, 4096, 32), (8, 4096, 32000, 1)]
MEGA_ROWS = [("llama2-7b", 4096, 4096, 4096),
             ("llama2-70b-gqa", 8192, 8192, 1024)]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _int4_caller(lib):
    """fn(x, w, scale) -> out through the tree's own C interface."""
    fn = lib.pt_int4_matmul
    fn.restype = _I
    old = hasattr(lib, "pt_int4_matmul_scratch")
    if old:
        fn.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        helper = lib.pt_int4_matmul_scratch
        helper.argtypes, helper.restype = [_I] * 4, ctypes.c_longlong
    else:
        fn.argtypes = [_P] * 5 + [_I] * 8 + [_P]

    def call(x, w, s):
        m, k = x.shape
        n = w.shape[1]
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
        code = dtype_code(x.dtype, QUANT_DTYPES)
        ptrs = (x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr())
        if old:
            part = torch.empty((max(1, helper(m, k, n, code)),),
                               dtype=torch.float32, device=x.device)
            rc = fn(*ptrs, part.data_ptr(), m, k, n, code, stream_of(x))
        else:
            p = int4_plan(m, k, n, x.dtype, sm_count(x.device))
            part = torch.empty((max(1, p.partial_bytes // 4),),
                               dtype=torch.float32, device=x.device)
            rc = fn(*ptrs, part.data_ptr(), m, k, n, k, code, p.bm, p.bn,
                    p.splits, stream_of(x))
        _check(lib, "pt_int4_matmul", rc)
        return out
    return call


def _int4_inputs(m, k, n, gen, dt=torch.bfloat16):
    x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
    w = torch.randint(-128, 128, (k // 2, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((n,), generator=gen, device="cuda") * 1e-2 + 1e-3
    wide = unpack_int4(w).to(dt)
    return (x, w, s), lambda: torch.matmul(x, wide) * s


def _mega_caller(lib, planned: bool):
    """fn(*args) -> (out, span_k, span_v) through the tree's own C
    interface; args as ``mega_decode.mega_decode`` takes them."""
    fn = lib.pt_mega_decode
    fn.restype = _I
    fn.argtypes = ([_P] * 20 + [_I] * 12 + [_F] * 2 + [_I, _P] if planned
                   else [_P] * 18 + [_I] * 10 + [_F] * 2 + [_I, _P])

    def call(x, g, wq, wk, wv, wo, cos, sin, kp, vp, tt, st, ln, hd, eps):
        b, c, h = x.shape
        nq, nk = wq.shape[1], wk.shape[1]
        nb, page, hkv, d = kp.shape
        dt, dev = x.dtype, x.device
        out = torch.empty((b, c, h), dtype=dt, device=dev)
        sk = torch.empty((b, c, nk), dtype=dt, device=dev)
        sv = torch.empty((b, c, nk), dtype=dt, device=dev)
        q_scr = torch.empty((b * c, nq), dtype=dt, device=dev)
        att = torch.empty((b * c, nq), dtype=dt, device=dev)
        ptrs = [a.data_ptr() for a in (x, g, wq, wk, wv, wo, cos, sin, kp,
                                       vp, tt, st, ln, out, sk, sv, q_scr,
                                       att)]
        tail = (float(eps), 1.0 / math.sqrt(d), dtype_code(dt),
                stream_of(x))
        if planned:
            p = mega_plan(b * c, h, nq, nk, hd, dt, sm_count(dev))
            scratch = torch.empty((max(1, p.scratch_bytes),),
                                  dtype=torch.uint8, device=dev)
            base = scratch.data_ptr()
            rc = fn(*ptrs, base, base + p.partial_offset, b, c, h, nq, nk,
                    nb, page, hkv, d, tt.shape[1], p.qkv_splits, p.o_splits,
                    *tail)
        else:
            rc = fn(*ptrs, b, c, h, nq, nk, nb, page, hkv, d, tt.shape[1],
                    *tail)
        _check(lib, "pt_mega_decode", rc)
        return out, sk, sv
    return call


def mega_inputs(b, c, h, nq, nk, hd, page, max_ctx, gen, rng,
                dt=torch.bfloat16):
    """A serving step's megakernel inputs: per slot a decode row deep in
    its context, a fresh chunk, partial chunks, an idle last slot; block
    tables of a permutation of the pool padded with the out-of-range
    sentinel.  Returns the kernel's arguments and the live-row mask."""
    mb = max_ctx // page
    nb = b * mb
    starts = rng.integers(0, max_ctx - c, size=b).astype(np.int32)
    lens = rng.integers(1, c + 1, size=b).astype(np.int32)
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

    def rand(shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dt)
    hkv = nk // hd
    x = rand((b, c, h))
    g = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dt)
    wq, wk, wv = rand((h, nq), 0.02), rand((h, nk), 0.02), rand((h, nk), 0.02)
    wo = rand((nq, h), 0.02)
    kp, vp = rand((nb, page, hkv, hd)), rand((nb, page, hkv, hd))
    tt, st, ln = (torch.from_numpy(a).cuda() for a in (tables, starts, lens))
    pos = (st.long()[:, None] + torch.arange(c, device="cuda")).float()
    inv = 1.0 / (10000.0 ** (torch.arange(0, hd, 2, device="cuda").float()
                             / hd))
    ang = pos[..., None] * inv
    ang = torch.cat([ang, ang], -1)
    args = (x, g, wq, wk, wv, wo, ang.cos().to(dt), ang.sin().to(dt), kp, vp,
            tt, st, ln, hd, 1e-5)
    live = torch.arange(c, device="cuda")[None, :] < ln[:, None]
    return args, live


def _held(name, a, b, rows=None):
    """The largest |a - b| (over ``rows`` if given), raising past the bf16
    tolerance |a - b| <= 2e-2 + 2e-2 |b|."""
    if isinstance(a, tuple):
        return max(_held(name, x, y) for x, y in zip(a, b))
    a, b = a.float(), b.float()
    if rows is not None:
        a, b = a[rows], b[rows]
    err = (a - b).abs()
    if not bool(torch.isfinite(err).all()) or bool(
            (err > 2e-2 + 2e-2 * b.abs()).any()):
        raise AssertionError(f"{name}: this tree and the other differ by "
                             f"{float(err.max())} (bf16 tolerance 2e-2)")
    return float(err.max())


_STAMPS = """
__device__ unsigned long long pt_stamps[16];
#define PT_STAMP(i)                                                    \\
  if (blockIdx.x == 0 && threadIdx.x == 0) {                           \\
    unsigned long long t_;                                             \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));             \\
    pt_stamps[i] = t_;                                                 \\
  }
extern "C" int pt_read_stamps(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, pt_stamps, sizeof(pt_stamps));
}
"""
_GRID = "cg::grid_group grid = cg::this_grid();"


def _stamped(src: str) -> str:
    """``src`` with a stamp at the start of each cooperative kernel, one
    after each of its grid barriers and a last barrier and stamp at its
    end."""
    out, pos = [], 0
    while (i := src.find(_GRID, pos)) >= 0:
        depth, o = 0, i
        while True:                       # the kernel's opening brace
            o -= 1
            if src[o] == "}":
                depth += 1
            elif src[o] == "{":
                if depth == 0:
                    break
                depth -= 1
        depth, e = 0, o
        while True:                       # and its closing one
            e += 1
            if src[e] == "{":
                depth += 1
            elif src[e] == "}":
                if depth == 0:
                    break
                depth -= 1
        body = src[i + len(_GRID):e]
        n = body.count("grid.sync();")
        for k in range(1, n + 1):
            body = body.replace("grid.sync();", f"GRID_SYNC PT_STAMP({k})",
                                1)
        body = body.replace("GRID_SYNC", "grid.sync();")
        out.append(src[pos:i] + _GRID + " PT_STAMP(0)" + body
                   + f"  grid.sync(); PT_STAMP({n + 1})\n")
        pos = e
    out.append(src[pos:])
    text = "".join(out)
    return text.replace("#include <cooperative_groups.h>",
                        "#include <cooperative_groups.h>\n" + _STAMPS, 1)


def _phase_shares(tag, csrc: Path, planned: bool, names, gen, rng):
    """Each phase's microseconds and share at the two geometries for one
    tree, from a stamped copy of its megakernel."""
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp) / "csrc"
        shutil.copytree(csrc, d)
        (d / "mega_decode.cu").write_text(
            _stamped((d / "mega_decode.cu").read_text()))
        lib = build_tree(f"i4m-stamps-{tag}", d, ["mega_decode"])[
            "mega_decode"]
    lib.pt_read_stamps.argtypes = [_P]
    call = _mega_caller(lib, planned)
    for geom, h, nq, nk in MEGA_ROWS:
        margs, _ = mega_inputs(8, 16, h, nq, nk, 128, 16, 512, gen, rng)
        buf = (ctypes.c_ulonglong * 16)()
        runs = []
        for _ in range(5):
            call(*margs)
            torch.cuda.synchronize()
            _check(lib, "pt_read_stamps", lib.pt_read_stamps(buf))
            st = list(buf)[:len(names) + 1]
            runs.append([(b - a) / 1e3 for a, b in zip(st, st[1:])])
        us = [float(np.median([r[i] for r in runs])) for i in range(len(names))]
        print(json.dumps({"kernel": "mega_decode", "tree": tag,
                          "geometry": geom, "phases": list(names),
                          "phase_us": us,
                          "share": [u / sum(us) for u in us]}), flush=True)
        del margs
        torch.cuda.empty_cache()


def _sum_step(rows, key):
    if any(r[key] is None for r in rows):
        return None
    return sum(r[key] * r["calls_per_step"] for r in rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="csrc directory of the other tree")
    ap.add_argument("--phases", action="store_true",
                    help="also time the megakernel's phases in both trees")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_int4_mega: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(f"card: {smi}", flush=True)
    other = args.other.resolve()
    libs = {"this": build_tree("i4m-this", _build.CSRC, SOURCES),
            "other": build_tree("i4m-other", other, SOURCES)}
    planned = {"this": True,
               "other": "qkv_splits" in (other / "mega_decode.cu").read_text()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    int4 = {name: _int4_caller(lib["int4_matmul"])
            for name, lib in libs.items()}
    rows = []
    for m, k, n, calls in INT4_ROWS:
        ins, library = _int4_inputs(m, k, n, gen)
        res, dev, outs = _turns(int4, ins)
        row = {"kernel": "int4_matmul", "geometry": "llama2-7b",
               "shape": [m, k, n], "dtype": "bfloat16",
               "calls_per_step": calls,
               "this_ms": res["this"], "other_ms": res["other"],
               "this_device_ms": dev["this"], "other_device_ms": dev["other"],
               "library_ms": cuda_ms(library),
               "max_abs_diff": _held("int4", outs["this"], outs["other"])}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del ins, library, outs
        torch.cuda.empty_cache()
    step = {"kernel": "int4_matmul", "geometry": "llama2-7b-step",
            "dtype": "bfloat16",
            "calls_per_step": sum(r["calls_per_step"] for r in rows),
            "max_abs_diff": max(r["max_abs_diff"] for r in rows)}
    for key in ("this_ms", "other_ms", "this_device_ms", "other_device_ms",
                "library_ms"):
        step[key] = _sum_step(rows, key)
    print(json.dumps(step), flush=True)
    mega = {name: _mega_caller(lib["mega_decode"], planned[name])
            for name, lib in libs.items()}
    rng = np.random.default_rng(0)
    for geom, h, nq, nk in MEGA_ROWS:
        margs, live = mega_inputs(8, 16, h, nq, nk, 128, 16, 512, gen, rng)
        res, dev, outs = _turns(mega, margs)
        diff = max(_held("mega out", outs["this"][0], outs["other"][0], live),
                   _held("mega span", outs["this"][1:], outs["other"][1:]))
        print(json.dumps({
            "kernel": "mega_decode", "geometry": geom,
            "shape": [8, 16, h, nq, nk, 128], "dtype": "bfloat16",
            "this_ms": res["this"], "other_ms": res["other"],
            "this_device_ms": dev["this"], "other_device_ms": dev["other"],
            "max_abs_diff": diff}), flush=True)
        del margs, outs
        torch.cuda.empty_cache()
    if args.phases:
        this = mega_plan(128, 4096, 4096, 4096, 128, torch.bfloat16).phases
        _phase_shares("this", _build.CSRC, True, this, gen, rng)
        _phase_shares("other", other, planned["other"],
                      this if planned["other"] else
                      ("qkv", "attention", "o_proj"), gen, rng)
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
