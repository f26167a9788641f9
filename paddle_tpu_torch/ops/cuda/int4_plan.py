"""The launch plan of the weight-only int4 matmul (``csrc/int4_matmul.cu``):
tiles, the contraction split and its f32 partials.

bf16 and f16 run ``csrc/dequant_swap.cuh`` with the operands swapped: a
block is two warpgroups, one per 64 output columns, and owns ``bn`` = 128
columns of W by ``bm`` rows of x, where ``bm`` is the wgmma n the kernel
instantiates -- 8 for M <= 8 (the LM head's one row per slot), 64 for M
<= 64, else 128 (a serving step; larger M takes several row tiles).  The
contraction (``bk`` = 64 steps of K) is split only where the tiles are
fewer than the SMs, as the MLP plan's :func:`.mlp_plan.split_count` does,
but then into as many splits as the :data:`BLOCKS_PER_SM` co-resident
blocks of every SM hold (``floor(2 sms / tiles)``, so the blocks run in
one wave), the f32 partials within :data:`MAX_PARTIAL_BYTES`, no split
left empty: 8 at M = 128 and N = 4096, 3 at N = 11008, none at the LM
head's 250 tiles.  (On an H100, 64-wide tiles, split_count's
``ceil(sms / tiles)`` and more splits than one wave holds were slower at
the step's shapes.)  f32 runs the SIMT body of
``csrc/dequant_matmul.cuh`` (64 x 64 tiles) with the int8 plan's f32
rule.

:func:`int4_plan` is a pure function of the shapes, the dtype and the SM
count, cached, so the CPU tests check it and the wrapper asks for it once
per shape; the C entry point refuses (``cudaErrorInvalidValue``) a plan it
cannot run, and :func:`check_plan` makes the same test in Python.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .int8_plan import _f32_splits
from .mlp_plan import H100_SMS

__all__ = ["Int4Plan", "int4_plan", "check_plan", "BM16", "BN16",
           "BLOCKS_PER_SM", "MAX_PARTIAL_BYTES"]

_BK = 64
# the tiles the 16-bit body takes: wgmma n (rows of x), column width
BM16 = (8, 64, 128)
BN16 = 128
_F32_TILE = (64, 64)
# co-resident blocks per SM the 16-bit kernel is built for
# (__launch_bounds__(256, 2))
BLOCKS_PER_SM = 2
# the f32 partials of one call at most (the step's largest: 3 splits of
# 128 x 11008, 16.9 MB)
MAX_PARTIAL_BYTES = 32 << 20
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class Int4Plan:
    dtype: torch.dtype
    m: int
    k: int
    n: int
    bm: int              # rows of x per block (the wgmma n for 16-bit x)
    bn: int              # columns of W per block
    splits: int          # contraction splits

    bk = _BK

    @property
    def tiles(self) -> int:
        """Output tiles (blocks per split)."""
        return -(-self.m // self.bm) * -(-self.n // self.bn)

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def k_steps(self) -> int:
        return -(-self.k // self.bk)

    @property
    def steps_per_split(self) -> int:
        return -(-self.k_steps // self.splits)

    @property
    def partial_bytes(self) -> int:
        return 0 if self.splits == 1 else 4 * self.splits * self.m * self.n


def _bm(m: int) -> int:
    return next(b for b in BM16 if m <= b or b == BM16[-1])


def _splits16(tiles: int, k_steps: int, split_bytes: int, sms: int) -> int:
    """1 where the tiles fill the SMs; else as many splits as one wave of
    co-resident blocks holds, capped by the steps and the partials,
    trimmed so that no split is left empty."""
    if tiles >= sms or k_steps <= 1:
        return 1
    splits = max(1, min(BLOCKS_PER_SM * sms // tiles, k_steps,
                        MAX_PARTIAL_BYTES // split_bytes))
    per = -(-k_steps // splits)
    return -(-k_steps // per)


@functools.lru_cache(maxsize=512)
def int4_plan(m: int, k: int, n: int, dtype: torch.dtype,
              sms: int = H100_SMS) -> Int4Plan:
    """The plan for x (m, k) through a packed (k/2, n) int4 weight.
    Raises TypeError for a dtype other than f32, bf16 or f16 and
    ValueError for m < 1, n < 1, k < 0 or k odd."""
    if dtype not in _DTYPES:
        raise TypeError(f"int4_plan: the int4 kernel takes float32, "
                        f"bfloat16 or float16; got {dtype}")
    if m < 1 or n < 1 or k < 0 or k % 2:
        raise ValueError(f"int4_plan: shape ({m}, {k}, {n}) needs m, n >= 1 "
                         "and an even k >= 0")
    if dtype == torch.float32:
        plan = Int4Plan(dtype, m, k, n, *_F32_TILE, 1)
        splits = _f32_splits(plan.tiles, plan.k_steps, sms)
    else:
        plan = Int4Plan(dtype, m, k, n, _bm(m), BN16, 1)
        splits = _splits16(plan.tiles, plan.k_steps, 4 * m * n, sms)
    return dataclasses.replace(plan, splits=splits)


def check_plan(op: str, plan: Int4Plan) -> None:
    """Raise ValueError for a plan the C entry point would refuse."""
    if plan.dtype == torch.float32:
        tile_ok = (plan.bm, plan.bn) == _F32_TILE
    else:
        tile_ok = plan.bm in BM16 and plan.bn == BN16
    ok = (plan.dtype in _DTYPES and tile_ok and plan.m >= 1 and plan.n >= 1
          and plan.k >= 0 and plan.k % 2 == 0 and plan.splits >= 1
          and (plan.splits == 1 if plan.k_steps == 0 else
               (plan.splits - 1) * plan.steps_per_split < plan.k_steps))
    if not ok:
        raise ValueError(f"{op}: the kernel cannot run the plan {plan}")
