"""Argument checks shared by the kernel wrappers, their output-and-scratch
allocation, and the plain versions' f32-accumulating product."""

from __future__ import annotations

import math

import torch


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in f32, whatever the inputs'
    dtype (the JAX contracts' ``preferred_element_type=float32``).  On a
    card this is a full-f32 product only with
    ``torch.backends.cuda.matmul.allow_tf32 = False``."""
    return a.float() @ b.float()


def on_cuda(op: str, *tensors: torch.Tensor, kernel=None) -> bool:
    """True when ``op`` must launch its kernel, False when its inputs lie
    on the CPU (the plain version runs; ``kernel.plain_calls`` counts it).
    Any other device, or a mix of devices, raises: a CUDA tensor gets the
    kernel or an error."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            devs = sorted({str(u.device) for u in tensors})
            raise ValueError(f"{op}: inputs on several devices {devs}")
    if dev.type == "cpu":
        if kernel is not None:
            kernel.plain_calls += 1
        return False
    if dev.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {dev} (cuda or cpu)")
    return True


def check(op: str, cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"{op}: {what}")


def fp_pools(op: str, *pools: torch.Tensor) -> None:
    """Raise on int8 KV pools or caches, on any device: the attention
    kernels read fp pools only, and int8 ones attend through
    ``incubate.nn.functional``'s dequantizing composition, chosen there by
    the cache's arity (as in the reference, whose kernels are fp-only)."""
    for t in pools:
        if t.dtype == torch.int8:
            raise ValueError(
                f"{op}: int8 KV pools are attended by the dequantizing "
                "composition in incubate.nn.functional, not this kernel")


def check_dense(op: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    """Every tensor contiguous, of ``dtype`` and 16-byte aligned (the
    kernels load 16-byte vectors).  The messages are formatted only on
    failure: a serving step calls the wrappers hundreds of times."""
    for name, t in tensors.items():
        if t.dtype == dtype and t.is_contiguous() and t.data_ptr() % 16 == 0:
            continue
        check(op, t.dtype == dtype, f"{name} is {t.dtype}, expected {dtype}")
        check(op, t.is_contiguous(), f"{name} is not contiguous")
        check(op, False, f"{name} is not 16-byte aligned")


def out_and_scratch(shape, dtype: torch.dtype, device, scratch_bytes: int):
    """An uninitialised output of ``shape`` and, behind it in the same
    allocation (256-byte aligned), ``scratch_bytes`` of kernel scratch:
    one allocation per call instead of two, which the host pays for on
    every launch.  Returns the output (a view of the allocation) and the
    scratch's address (None without scratch)."""
    if not scratch_bytes:
        return torch.empty(shape, dtype=dtype, device=device), None
    n = math.prod(shape)
    item = dtype.itemsize
    off = -(-n * item // 256) * 256
    buf = torch.empty((off + scratch_bytes + item - 1) // item, dtype=dtype,
                      device=device)
    return buf[:n].view(shape), buf.data_ptr() + off
