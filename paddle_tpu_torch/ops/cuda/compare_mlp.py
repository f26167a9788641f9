"""Time this checkout's fused MLP kernels against another tree's, on one
card.

    python3 -m paddle_tpu_torch.ops.cuda.compare_mlp --other DIR

``DIR`` is the ``csrc`` directory of another checkout (for example a
``git archive`` of an earlier commit unpacked into a directory that
``.gitignore`` lists).  Both trees' ``fused_mlp.cu`` and
``fused_gelu_mlp.cu`` are built, each with its own tree's ``*.cuh``,
with this checkout's ``nvcc`` flags into ``build/``, and timed in turns
-- this tree, the other, the other, this tree -- at the main path's
rows: SwiGLU at llama2-7b (T = 128 and the training T = 4096) and
llama2-70b (T = 128), GELU at gpt3-6.7b (T = 1, 8, 128, 257), in bf16,
and the two T = 128 serving rows in f32.  A tree's C entry point is
called through its own interface, as its own wrapper calls it: the
split-partial one (a ``pt_fused_*_mlp_scratch`` helper sizes one f32
scratch; GELU's biases widened to f32 on each call) or the plan one
(:mod:`.mlp_plan` sizes h and the partials; the biases in x's dtype).
Each time is the median of 5 CUDA-event windows around 5 calls; a line
keeps the better of a tree's two turns, beside one PyTorch call chain
of the same function (cuBLAS, never called by the port).  Prints one
JSON line per row and the card's name and power limit.  Needs a CUDA
card and ``nvcc``.
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
from ._compare import build_tree, card, cuda_ms
from .mlp_plan import mlp_plan, sm_count

SOURCES = ("fused_mlp", "fused_gelu_mlp")
ROWS = [("swiglu", "llama2-7b", 128, 4096, 11008, torch.bfloat16),
        ("swiglu", "llama2-7b-train", 4096, 4096, 11008, torch.bfloat16),
        ("swiglu", "llama2-70b", 128, 8192, 28672, torch.bfloat16),
        ("gelu", "gpt3-6.7b", 128, 4096, 16384, torch.bfloat16),
        ("gelu", "gpt3-6.7b T=1", 1, 4096, 16384, torch.bfloat16),
        ("gelu", "gpt3-6.7b T=8", 8, 4096, 16384, torch.bfloat16),
        ("gelu", "gpt3-6.7b T=257", 257, 4096, 16384, torch.bfloat16),
        ("swiglu", "llama2-7b", 128, 4096, 11008, torch.float32),
        ("gelu", "gpt3-6.7b", 128, 4096, 16384, torch.float32)]
_P, _I = ctypes.c_void_p, ctypes.c_int
SYMBOL = {"swiglu": ("fused_mlp", "pt_fused_swiglu_mlp", 4),
          "gelu": ("fused_gelu_mlp", "pt_fused_gelu_mlp", 5)}


def _caller(libs, kind):
    """fn(*inputs) -> out through the tree's own C interface."""
    src, sym, n_in = SYMBOL[kind]
    lib = libs[src]
    fn = getattr(lib, sym)
    fn.restype = ctypes.c_int
    old = hasattr(lib, sym + "_scratch")
    gelu = kind == "gelu"
    if old:
        fn.argtypes = [_P] * (n_in + 2) + [_I] * 4 + [_P]
        helper = getattr(lib, sym + "_scratch")
        helper.argtypes, helper.restype = [_I] * 3, ctypes.c_longlong
    else:
        fn.argtypes = [_P] * (n_in + 3) + [_I] * (7 if gelu else 6) + [_P]

    def call(*ins):
        x, w_up = ins[0], ins[1]
        t, h = x.shape
        inter = w_up.shape[1]
        out = torch.empty((t, h), dtype=x.dtype, device=x.device)
        code = dtype_code(x.dtype)
        if old:
            if gelu:   # that wrapper widened the biases on every call
                ins = (ins[0], ins[1], ins[2].float(), ins[3],
                       ins[4].float())
            part = torch.empty((helper(t, h, inter),), dtype=torch.float32,
                               device=x.device)
            rc = fn(*[a.data_ptr() for a in ins], part.data_ptr(),
                    out.data_ptr(), t, h, inter, code, stream_of(x))
        else:
            p = mlp_plan(t, h, inter, x.dtype, kind, sm_count(x.device))
            scratch = torch.empty((p.scratch_bytes,), dtype=torch.uint8,
                                  device=x.device)
            base = scratch.data_ptr()
            rc = fn(*[a.data_ptr() for a in ins], base,
                    base + p.partial_offset if p.splits > 1 else None,
                    out.data_ptr(), t, h, inter, code,
                    *((code,) if gelu else ()), p.up_bn, p.splits,
                    stream_of(x))
        if rc:
            raise RuntimeError(f"{sym}: CUDA error {rc} "
                               f"({lib.pt_error_string(rc).decode()})")
        return out
    return call


def _inputs(kind, t, h, inter, dtype, gen):
    def rand(shape, std):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(dtype)
    x = rand((t, h), 1.0)
    if kind == "swiglu":
        ins = (x, rand((h, inter), 0.02), rand((h, inter), 0.02),
               rand((inter, h), 0.02))
        lib = lambda: (F.silu(x @ ins[1]) * (x @ ins[2])) @ ins[3]
    else:
        b1, b2 = rand((inter,), 0.1), rand((h,), 0.1)
        ins = (x, rand((h, inter), 0.02), b1, rand((inter, h), 0.02), b2)
        lib = lambda: torch.addmm(b2, F.gelu(torch.addmm(b1, x, ins[1])),
                                  ins[3])
    return ins, lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="csrc directory of the other tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_mlp: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(f"card: {smi}", flush=True)
    trees = {"this": build_tree("mlp-this", _build.CSRC, SOURCES),
             "other": build_tree("mlp-other", args.other.resolve(),
                                 SOURCES)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kind, geom, t, h, inter, dt in ROWS:
        ins, lib = _inputs(kind, t, h, inter, dt, gen)
        calls = {name: _caller(libs, kind) for name, libs in trees.items()}
        res, outs = {}, {}
        for name in ("this", "other", "other", "this"):
            outs[name] = calls[name](*ins)
            ms = cuda_ms(lambda: calls[name](*ins))
            res[name] = min(ms, res.get(name, ms))
        line = {"kind": kind, "geometry": geom, "shape": [t, h, inter],
                "dtype": str(dt).replace("torch.", ""),
                "this_ms": res["this"], "other_ms": res["other"],
                "library_ms": cuda_ms(lib),
                "max_abs_diff": float((outs["this"].float()
                                       - outs["other"].float()).abs().max())}
        print(json.dumps(line), flush=True)
        del ins, lib, outs
        torch.cuda.empty_cache()
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
