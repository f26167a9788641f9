"""The launch plan of the grouped BGMV kernel (``csrc/lora_matmul.cu``):
its path, the d_in slice of each block of a slot's cluster, and the grid.

bf16 runs one launch: a thread-block cluster of :data:`CLUSTER` (16)
blocks per slot, beyond the portable 8, which Hopper allows.  Block q of
a cluster shrinks d_in piece q (``slice`` wide: d_in over 16, rounded up
to a multiple of 64), the cluster adds its pieces' partials through
distributed shared memory, and every block expands the output tiles q,
q + 16, ... (128 columns) from the rounded sum, so the shrink runs once
per slot with no scratch and no second launch.  f32 runs one SIMT launch
over (stripe, slot) in clusters of 8.

:func:`bgmv_plan` is a pure function of the shapes and the dtype, so the
CPU tests check it; the wrapper passes ``slice`` to the C entry point,
which refuses (``cudaErrorInvalidValue``) a slice it cannot run.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

__all__ = ["BgmvPlan", "CLUSTER", "EXPAND_COLS", "MAX_RANK", "bgmv_plan"]

CLUSTER = 16            # blocks per slot (bf16)
MAX_RANK = 64
EXPAND_COLS = 128       # output columns per expand tile (bf16)
ROWS = 16               # x rows per product pass
_SLICE_STEP = 64
_SIMT_CLUSTER = 8
_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class BgmvPlan:
    dtype: torch.dtype
    bsz: int
    c: int
    d_in: int
    r: int
    d_out: int
    slice: int           # d_in per block (bf16; 0 for f32)

    @property
    def cluster(self) -> int:
        """Blocks per slot (bf16; 0 for f32)."""
        return CLUSTER if self.slice else 0

    @property
    def path(self) -> str:
        return "tensor_cores" if self.cluster else "simt"

    @property
    def rank_pad(self) -> int:
        """The rank padded with zero columns: to 16 (bf16, mma's step) or
        to the SIMT kernel's 16, 32 or 64."""
        if self.cluster:
            return -(-self.r // 16) * 16
        return 16 if self.r <= 16 else 32 if self.r <= 32 else 64

    @property
    def row_passes(self) -> int:
        return -(-self.c // ROWS)

    @property
    def tiles(self) -> int:
        """Output tiles of 128 columns per slot (bf16)."""
        return -(-self.d_out // EXPAND_COLS)

    @property
    def grid_blocks(self) -> int:
        if self.cluster:
            return self.cluster * self.bsz
        stripe = 512 if self.r <= 16 else 256
        stripes = -(-self.d_out // stripe)
        return -(-stripes // _SIMT_CLUSTER) * _SIMT_CLUSTER * self.bsz


@functools.lru_cache(maxsize=256)
def bgmv_plan(bsz: int, c: int, d_in: int, r: int, d_out: int,
              dtype: torch.dtype) -> BgmvPlan:
    """The plan for x (bsz, c, d_in) through rank-``r`` adapters to
    d_out.  Raises TypeError for a dtype other than f32 or bf16 and
    ValueError for a rank outside [1, 64] or sizes below 1."""
    if dtype not in _DTYPES:
        raise TypeError(f"grouped_bgmv: x is {dtype}; the kernel takes "
                        "float32 or bfloat16")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"grouped_bgmv: rank {r} not in [1, {MAX_RANK}]")
    if min(bsz, c, d_in, d_out) < 1:
        raise ValueError(f"grouped_bgmv: sizes bsz {bsz}, c {c}, d_in "
                         f"{d_in}, d_out {d_out}")
    if dtype == torch.float32:
        return BgmvPlan(dtype, bsz, c, d_in, r, d_out, 0)
    slice_ = -(-d_in // (CLUSTER * _SLICE_STEP)) * _SLICE_STEP
    return BgmvPlan(dtype, bsz, c, d_in, r, d_out, slice_)
