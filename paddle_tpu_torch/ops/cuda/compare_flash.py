"""Time this checkout's flash kernels against another tree's, on one card.

    python3 -m paddle_tpu_torch.ops.cuda.compare_flash --other DIR

``DIR`` is the ``csrc`` directory of another checkout (for example a
``git archive`` of an earlier commit unpacked into a directory that
``.gitignore`` lists).  Both trees' ``flash_attention.cu`` are built with
the same ``nvcc`` flags into ``build/``, bound through the same wrappers
(:mod:`.flash_attention`), and timed in turns -- this tree, the other,
the other, this tree -- at the training path's shapes (B 2, S 2048, 32
heads of 128) and llama2-70b's GQA (B 1, S 2048, 64 q heads over 8 kv
heads), causal, in bf16, f16 and f32.  Each call's time is the median of
5 CUDA-event windows around 5 calls; a line keeps the better of a tree's
two turns.  A dtype the other tree's kernels refuse is reported as such.
Prints one JSON line per (shape, dtype) and the card's name and power
limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from . import _build
from . import flash_attention as FA
from ._compare import build_tree, card, cuda_ms as _cuda_ms

SHAPES = {"llama2-7b-train": (2, 2048, 32, 32, 128),
          "llama2-70b-gqa": (1, 2048, 64, 8, 128)}
DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def _library(name: str, csrc: Path):
    cdll = build_tree(name, csrc, ["flash_attention"])["flash_attention"]
    for sym, kern in (("pt_flash_fwd", FA.FWD), ("pt_flash_bwd", FA.BWD)):
        fn = getattr(cdll, sym)
        fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
    return cdll


def _use(cdll) -> None:
    FA.FWD._lib = FA.BWD._lib = cdll


def _turn(q, k, v, do, scale):
    """(forward ms, backward ms, outputs) of the bound library, or None
    where it refuses the dtype."""
    try:
        out, lse = FA.flash_fwd(q, k, v, scale, True)
        grads = FA.flash_bwd(q, k, v, out, lse, do, scale, True)
    except RuntimeError as err:
        if "invalid argument" in str(err):
            return None
        raise
    fwd = _cuda_ms(lambda: FA.flash_fwd(q, k, v, scale, True))
    bwd = _cuda_ms(lambda: FA.flash_bwd(q, k, v, out, lse, do, scale, True))
    return fwd, bwd, (out, lse, *grads)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="csrc directory of the other tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_flash: no CUDA device", file=sys.stderr)
        return 2
    smi = card()
    print(f"card: {smi}", flush=True)
    libs = {"this": _library("this", _build.CSRC),
            "other": _library("other", args.other.resolve())}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for geom, (b, s, h, hkv, d) in SHAPES.items():
        for dt in DTYPES:
            def rand(shape):
                return torch.randn(shape, generator=gen, device="cuda").to(dt)
            q, do = rand((b, s, h, d)), rand((b, s, h, d))
            k, v = rand((b, s, hkv, d)), rand((b, s, hkv, d))
            res = {}
            for name in ("this", "other", "other", "this"):
                _use(libs[name])
                got = _turn(q, k, v, do, d ** -0.5)
                if got is None:
                    res[name] = None
                    continue
                fwd, bwd, outs = got
                prev = res.get(name)
                res[name] = {"fwd_ms": min(fwd, prev["fwd_ms"]) if prev
                             else fwd,
                             "bwd_ms": min(bwd, prev["bwd_ms"]) if prev
                             else bwd, "outs": outs}
            line = {"geometry": geom, "dtype": str(dt).replace("torch.", "")}
            for name, r in res.items():
                line[name] = ({"fwd_ms": r["fwd_ms"], "bwd_ms": r["bwd_ms"]}
                              if r else "refuses the dtype")
            if res["this"] and res["other"]:
                line["max_abs_diff"] = max(
                    float((x.float() - y.float()).abs().max())
                    for x, y in zip(res["this"]["outs"],
                                    res["other"]["outs"]))
            print(json.dumps(line), flush=True)
            del q, k, v, do, res
            torch.cuda.empty_cache()
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
