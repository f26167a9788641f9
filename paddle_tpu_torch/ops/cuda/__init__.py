"""The port's hand-written CUDA kernels for Hopper (sm_90a), one module per
kernel: the wrapper that launches it on CUDA tensors, its plain PyTorch
version (run on CPU tensors) and its launch counter (``KERNEL.launches``;
``plain_calls`` counts the CPU's plain runs).  The sources are
``paddle_tpu_torch/csrc/*.cu``; ``_build`` compiles them at first use.
:data:`KERNELS` names every counter, and :func:`counts` reads them."""

from typing import Dict

from . import (flash_attention, fused_adamw, fused_gelu_mlp, fused_mlp,
               fused_norm_qkv, int4_matmul, int8_matmul, lora_matmul,
               mega_decode, paged_attention, ragged_attention)

__all__ = ["KERNELS", "counts", "flash_attention", "fused_adamw",
           "fused_gelu_mlp", "fused_mlp", "fused_norm_qkv", "int4_matmul",
           "int8_matmul", "lora_matmul", "mega_decode", "paged_attention",
           "ragged_attention"]

# every kernel's counter, by the name of the function it computes
KERNELS = {
    "fused_rms_rope_qkv": fused_norm_qkv.KERNEL,
    "fused_swiglu_mlp": fused_mlp.KERNEL,
    "ragged_paged_attention": ragged_attention.KERNEL,
    "mega_decode": mega_decode.KERNEL,
    "grouped_bgmv": lora_matmul.KERNEL,
    "int8_matmul": int8_matmul.KERNEL,
    "int4_matmul": int4_matmul.KERNEL,
    "flash_attention_fwd": flash_attention.FWD,
    "flash_attention_bwd": flash_attention.BWD,
    "fused_adamw": fused_adamw.KERNEL,
    "fused_gelu_mlp": fused_gelu_mlp.KERNEL,
    "paged_attention": paged_attention.KERNEL,
}


def counts(device_type: str) -> Dict[str, int]:
    """Each kernel's launches (``"cuda"``) or plain-version calls
    (``"cpu"``) so far."""
    attr = "launches" if device_type == "cuda" else "plain_calls"
    return {name: getattr(k, attr) for name, k in KERNELS.items()}
