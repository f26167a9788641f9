"""Argument checks shared by the kernel wrappers, and the plain versions'
f32-accumulating product."""

from __future__ import annotations

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


def check_dense(op: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    """Every tensor contiguous, of ``dtype`` and 16-byte aligned (the
    kernels load 16-byte vectors)."""
    for name, t in tensors.items():
        check(op, t.dtype == dtype, f"{name} is {t.dtype}, expected {dtype}")
        check(op, t.is_contiguous(), f"{name} is not contiguous")
        check(op, t.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
