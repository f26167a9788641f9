"""The port's hand-written CUDA kernels for Hopper (sm_90a), one module per
kernel: the wrapper that launches it on CUDA tensors, its plain PyTorch
version (run on CPU tensors) and its launch counter (``KERNEL.launches``).
The sources are ``paddle_tpu_torch/csrc/*.cu``; ``_build`` compiles them
at first use."""

from . import (flash_attention, fused_adamw, fused_mlp, fused_norm_qkv,
               int4_matmul, int8_matmul, ragged_attention)

__all__ = ["flash_attention", "fused_adamw", "fused_mlp", "fused_norm_qkv",
           "int4_matmul", "int8_matmul", "ragged_attention"]
