"""Build and bind the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/paddle_tpu_torch/lib<name>-<hash>.so

into a shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes).  The file
name carries a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited kernel is
rebuilt and a stale library is never loaded.  :func:`build` starts one
``nvcc`` per source, all at once, and waits for all of them.  Nothing is
built at import time: the first launch of a kernel builds it.

Every C entry point returns ``cudaGetLastError()``; :meth:`Kernel.launch`
raises when that is not 0 and counts a launch only after it succeeded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

__all__ = ["CSRC", "BUILD_DIR", "Kernel", "build", "dtype_code", "stream_of"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("fused_norm_qkv", "fused_mlp", "ragged_attention",
           "flash_attention", "fused_adamw", "int8_matmul", "int4_matmul",
           "mega_decode", "lora_matmul", "fused_gelu_mlp",
           "paged_attention")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(dtype: torch.dtype,
               allowed=(torch.float32, torch.bfloat16)) -> int:
    """The C entry points' dtype code (0 f32, 1 bf16, 2 f16) of a dtype
    in ``allowed``, the types the calling kernel takes."""
    if dtype not in allowed:
        names = ", ".join(str(d).replace("torch.", "") for d in allowed)
        raise TypeError(f"kernel takes {names}; got {dtype}")
    return _DTYPE_CODES[dtype]


# PyTorch's own accessor of the current raw stream (its CUDA builds have
# it): a launch asks for the stream on every call, and this skips building
# a Stream object
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s card."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from paddle_tpu_torch/csrc at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns the seconds
    each build took (0.0 for one already built); raises with the
    compiler's output when one fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, took = [], {n: 0.0 for n in names}
    for n in names:
        if not library_path(n).is_file():
            todo.append(n)
    if not todo:
        return took
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"tmp{os.getpid()}-{out.name}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        took[n] = time.perf_counter() - t0
        if p.returncode != 0:
            errors.append(f"{n}.cu (exit {p.returncode}):\n"
                          f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return took


class Kernel:
    """One C entry point of one kernel library, with its launch count.

    ``launches`` grows by one each time :meth:`launch` ran the kernel
    without a launch error -- and nowhere else, so a run can show that
    its path went through the kernel.  ``plain_calls`` counts the calls
    whose CPU tensors ran the plain version instead (``_common.on_cuda``
    adds them), so a CPU run can count the same path."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.plain_calls = 0
        self._lib = None
        self._helpers = {}

    def _library(self):
        if self._lib is None:
            build([self.source])
            lib = ctypes.CDLL(str(library_path(self.source)))
            getattr(lib, self.symbol).argtypes = self.argtypes
            getattr(lib, self.symbol).restype = ctypes.c_int
            lib.pt_error_string.argtypes = [ctypes.c_int]
            lib.pt_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def helper(self, symbol: str, argtypes: List, restype):
        """Another C function of the same library (sizes of scratch),
        bound once."""
        if symbol not in self._helpers:
            fn = getattr(self._library(), symbol)
            fn.argtypes, fn.restype = argtypes, restype
            self._helpers[symbol] = fn
        return self._helpers[symbol]

    def launch(self, *args) -> None:
        lib = self._library()
        rc = getattr(lib, self.symbol)(*args)
        if rc != 0:
            msg = lib.pt_error_string(rc).decode(errors="replace")
            raise RuntimeError(f"{self.symbol} failed: CUDA error {rc} "
                               f"({msg})")
        self.launches += 1
