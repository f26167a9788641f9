"""Pieces shared by the parent-vs-change timing tools (``compare_flash``,
``compare_mlp``): build another tree's kernel sources beside this one's,
time a call with CUDA events, and name the card."""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

from . import _build


def build_tree(tag: str, csrc: Path, sources: Sequence[str]
               ) -> Dict[str, ctypes.CDLL]:
    """Compile ``<csrc>/<source>.cu`` for each source, with that tree's
    ``*.cuh``, into ``build/paddle_tpu_torch/compare/<tag>/`` (one nvcc
    per source, all at once, this checkout's flags) and load each."""
    out = _build.BUILD_DIR / "compare" / tag
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for f in csrc.glob("*.cuh"):
        shutil.copy(f, out / f.name)
    procs = []
    for src in sources:
        shutil.copy(csrc / f"{src}.cu", out / f"{src}.cu")
        lib = out / f"lib{src}.so"
        procs.append((src, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(out / f"{src}.cu")])))
    libs = {}
    for src, lib, p in procs:
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed on {csrc / src}.cu")
        cdll = ctypes.CDLL(str(lib))
        cdll.pt_error_string.argtypes = [ctypes.c_int]
        cdll.pt_error_string.restype = ctypes.c_char_p
        libs[src] = cdll
    return libs


def cuda_ms(fn, iters: int = 5, reps: int = 5) -> float:
    """The median over ``iters`` CUDA-event windows of ``reps`` calls, per
    call, after two warm-up calls."""
    for _ in range(2):
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


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
