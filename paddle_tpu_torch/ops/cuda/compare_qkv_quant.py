"""Time this checkout's fused RMSNorm+RoPE+QKV and int8 kernels against
another tree's, on one card.

    python3 -m paddle_tpu_torch.ops.cuda.compare_qkv_quant --other DIR

``DIR`` is the ``csrc`` directory of another checkout (for example a
``git archive`` of an earlier commit unpacked into a directory that
``.gitignore`` lists).  Both trees' ``fused_norm_qkv.cu`` and
``int8_matmul.cu`` are built, each with its own tree's ``*.cuh``, with
this checkout's ``nvcc`` flags into ``build/``, and timed in turns --
this tree, the other, the other, this tree -- in bf16 at the main path's
rows: QKV at llama2-7b (T = 128 and the training T = 4096) and llama2-70b
GQA (T = 128); int8 at the quantized llama2-7b step's four shapes and
their sum over one step's 225 calls.  A tree's C entry point is called
through its own interface, as its own wrapper calls it: the plan one
(:mod:`.qkv_plan` and :mod:`.int8_plan` size the scratch and give the
split count) or the one before it (no scratch for QKV; a
``pt_int8_matmul_scratch`` helper sizes int8's partials).  Each time is
the median of 5 CUDA-event windows around 5 calls, and the device time of
a call with the host out of the way (``_compare.device_ms``); a line
keeps the better of a tree's two turns, beside one PyTorch call chain of
the same function (never called by the port).  Prints one JSON line per row and the card's name
and power limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from . import _build
from ._build import dtype_code, stream_of
from ._compare import build_tree, card, cuda_ms, device_ms
from .int8_matmul import DTYPES as INT8_DTYPES
from .int8_plan import int8_plan
from .mlp_plan import sm_count
from .qkv_plan import qkv_plan

SOURCES = ("fused_norm_qkv", "int8_matmul")
QKV_ROWS = [("llama2-7b", 128, 4096, 4096, 4096),
            ("llama2-7b-train", 4096, 4096, 4096, 4096),
            ("llama2-70b-gqa", 128, 8192, 8192, 1024)]
# (M, K, N, calls per step) of the quantized llama2-7b engine step
INT8_ROWS = [(128, 4096, 4096, 128), (128, 4096, 11008, 64),
             (128, 11008, 4096, 32), (8, 4096, 32000, 1)]
_P, _I = ctypes.c_void_p, ctypes.c_int


def _check(lib, sym, rc):
    if rc:
        raise RuntimeError(f"{sym}: CUDA error {rc} "
                           f"({lib.pt_error_string(rc).decode()})")


def _qkv_caller(lib, planned: bool):
    """fn(x, g, wq, wk, wv, cos, sin, hd) -> (q, k, v) through the tree's
    own C interface."""
    fn = lib.pt_fused_rms_rope_qkv
    fn.restype = _I
    fn.argtypes = ([_P] * 12 + [_I] * 5 + [ctypes.c_float, _I, _I, _P]
                   if planned else
                   [_P] * 10 + [_I] * 5 + [ctypes.c_float, _I, _P])

    def call(x, g, wq, wk, wv, cos, sin, hd):
        t, h = x.shape
        nq, nk = wq.shape[1], wk.shape[1]
        q = torch.empty((t, nq), dtype=x.dtype, device=x.device)
        k = torch.empty((t, nk), dtype=x.dtype, device=x.device)
        v = torch.empty((t, nk), dtype=x.dtype, device=x.device)
        ins = [a.data_ptr() for a in (x, g, wq, wk, wv, cos, sin)]
        outs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
        if planned:
            p = qkv_plan(t, h, nq, nk, hd, x.dtype, sm_count(x.device))
            scratch = torch.empty((p.scratch_bytes,), dtype=torch.uint8,
                                  device=x.device)
            base = scratch.data_ptr()
            rc = fn(*ins, base,
                    base + p.partial_offset if p.splits > 1 else None,
                    *outs, t, h, nq, nk, hd, 1e-5, dtype_code(x.dtype),
                    p.splits, stream_of(x))
        else:
            rc = fn(*ins, *outs, t, h, nq, nk, hd, 1e-5,
                    dtype_code(x.dtype), stream_of(x))
        _check(lib, "pt_fused_rms_rope_qkv", rc)
        return q, k, v
    return call


def _int8_caller(lib):
    """fn(x, w, scale) -> out through the tree's own C interface."""
    fn = lib.pt_int8_matmul
    fn.restype = _I
    old = hasattr(lib, "pt_int8_matmul_scratch")
    if old:
        fn.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        helper = lib.pt_int8_matmul_scratch
        helper.argtypes, helper.restype = [_I] * 4, ctypes.c_longlong
    else:
        fn.argtypes = [_P] * 5 + [_I] * 5 + [_P]

    def call(x, w, s):
        (m, k), n = x.shape, w.shape[1]
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
        code = dtype_code(x.dtype, INT8_DTYPES)
        ptrs = (x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr())
        if old:
            part = torch.empty((max(1, helper(m, k, n, code)),),
                               dtype=torch.float32, device=x.device)
            rc = fn(*ptrs, part.data_ptr(), m, k, n, code, stream_of(x))
        else:
            p = int8_plan(m, k, n, x.dtype, sm_count(x.device))
            part = torch.empty((max(1, p.partial_bytes // 4),),
                               dtype=torch.float32, device=x.device)
            rc = fn(*ptrs, part.data_ptr(), m, k, n, code, p.splits,
                    stream_of(x))
        _check(lib, "pt_int8_matmul", rc)
        return out
    return call


def _qkv_inputs(t, h, nq, nk, gen, hd=128, dt=torch.bfloat16):
    def rand(shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(dt)
    x = rand((t, h))
    g = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dt)
    wq, wk, wv = rand((h, nq), 0.02), rand((h, nk), 0.02), rand((h, nk), 0.02)
    ang = torch.rand((t, hd // 2), generator=gen, device="cuda") * 500
    ang = torch.cat([ang, ang], -1)
    cos, sin = ang.cos().to(dt), ang.sin().to(dt)
    wcat = torch.cat([wq, wk, wv], 1)

    def library():
        y = F.rms_norm(x, (h,), g, 1e-5) @ wcat
        q, k = y[:, :nq].view(t, -1, hd), y[:, nq:nq + nk].view(t, -1, hd)
        c, s = cos[:, None], sin[:, None]
        rot = lambda u: torch.cat([-u[..., hd // 2:], u[..., :hd // 2]], -1)
        return q * c + rot(q) * s, k * c + rot(k) * s, y[:, nq + nk:]
    return (x, g, wq, wk, wv, cos, sin, hd), library


def _int8_inputs(m, k, n, gen, dt=torch.bfloat16):
    x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((n,), generator=gen, device="cuda") * 1e-3 + 1e-4
    wide = w.to(dt)
    return (x, w, s), lambda: torch.matmul(x, wide) * s


def _turns(calls, ins):
    """Best CUDA-event and device ms of each tree over the turns this,
    other, other, this (device None where none was measured); and each
    tree's output."""
    res, dev, outs = {}, {}, {}
    for name in ("this", "other", "other", "this"):
        fn = lambda: calls[name](*ins)
        outs[name] = fn()
        ms, dms = cuda_ms(fn), device_ms(fn)
        res[name] = min(ms, res.get(name, ms))
        dev[name] = min((d for d in (dms, dev.get(name)) if d is not None),
                        default=None)
    return res, dev, outs


def _diff(a, b):
    if isinstance(a, tuple):
        return max(_diff(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="csrc directory of the other tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_qkv_quant: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(f"card: {smi}", flush=True)
    other = args.other.resolve()
    trees = {"this": (build_tree("qkvq-this", _build.CSRC, SOURCES), True),
             "other": (build_tree("qkvq-other", other, SOURCES),
                       "int splits" in (other / "fused_norm_qkv.cu")
                       .read_text())}
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = {name: _qkv_caller(libs["fused_norm_qkv"], planned)
           for name, (libs, planned) in trees.items()}
    for geom, t, h, nq, nk in QKV_ROWS:
        ins, library = _qkv_inputs(t, h, nq, nk, gen)
        res, dev, outs = _turns(qkv, ins)
        print(json.dumps({
            "kernel": "fused_rms_rope_qkv", "geometry": geom,
            "shape": [t, h, nq, nk, 128], "dtype": "bfloat16",
            "this_ms": res["this"], "other_ms": res["other"],
            "this_device_ms": dev["this"], "other_device_ms": dev["other"],
            "library_ms": cuda_ms(library),
            "max_abs_diff": _diff(outs["this"], outs["other"])}),
            flush=True)
        del ins, library, outs
        torch.cuda.empty_cache()
    int8 = {name: _int8_caller(libs["int8_matmul"])
            for name, (libs, _) in trees.items()}
    step = {"kernel": "int8_matmul", "geometry": "llama2-7b-step",
            "dtype": "bfloat16", "calls_per_step": 0}
    for m, k, n, calls in INT8_ROWS:
        ins, library = _int8_inputs(m, k, n, gen)
        res, dev, outs = _turns(int8, ins)
        row = {"kernel": "int8_matmul", "geometry": "llama2-7b",
               "shape": [m, k, n], "dtype": "bfloat16",
               "calls_per_step": calls,
               "this_ms": res["this"], "other_ms": res["other"],
               "this_device_ms": dev["this"], "other_device_ms": dev["other"],
               "library_ms": cuda_ms(library),
               "max_abs_diff": _diff(outs["this"], outs["other"])}
        print(json.dumps(row), flush=True)
        step["calls_per_step"] += calls
        for key in ("this_ms", "other_ms", "this_device_ms",
                    "other_device_ms", "library_ms"):
            part = step.get(key, 0.0)
            step[key] = None if part is None or row[key] is None \
                else part + row[key] * calls
        del ins, library, outs
        torch.cuda.empty_cache()
    print(json.dumps(step), flush=True)
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
