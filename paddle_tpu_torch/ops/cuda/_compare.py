"""Pieces shared by the parent-vs-change timing tools (``compare_flash``,
``compare_mlp``, ``compare_qkv_quant``, ``compare_int4_mega``) and
``chip_smoke.py``: build another tree's kernel sources beside this one's,
time a call with CUDA events (as the host sees it, or with the host out
of the way), the busy union of a profiler trace, and name the card."""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import time
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


def union_ms(events) -> float:
    """The time in ms during which at least one of ``events`` (profiler
    device events) ran: overlapping kernels -- a dependent launch starts
    before the kernel it waits for has ended -- count once."""
    total, start, end = 0.0, None, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total / 1e3


def device_events(prof):
    return [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def _cycles_per_ms() -> float:
    """The card's clock, from a timed ``torch.cuda._sleep``."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    b.synchronize()
    return 20_000_000 / a.elapsed_time(b)


def device_ms(fn, calls: int = 20, windows: int = 3, tries: int = 4):
    """Device time of one ``fn()`` in ms, with the host out of the way: a
    sleep kernel holds the stream while the host queues ``calls`` calls
    behind it, so CUDA events around them time the card running them back
    to back; the median over ``windows`` such windows.  Where a call is
    shorter than the host's time to issue it, cuda_ms measures the host
    and this the card.  (A profiler trace's busy union served here once;
    late in a long process on an H100 its traces lost kernels.)  The sleep
    is lengthened until the host queues every call within it; None if it
    never does in ``tries`` rounds."""
    fn()
    torch.cuda.synchronize()
    per_ms = _cycles_per_ms()
    sleep_ms, times = 5.0, []
    for _ in range(tries):
        while len(times) < windows:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(sleep_ms * per_ms))
            a.record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            host_ms = (time.perf_counter() - t0) * 1e3
            b.record()
            b.synchronize()
            if host_ms > 0.8 * sleep_ms:
                sleep_ms = 2.0 * host_ms
                break
            times.append(a.elapsed_time(b) / calls)
        if len(times) == windows:
            return statistics.median(times)
    return None


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
