"""The launch plan of the weight-only int8 matmul (``csrc/int8_matmul.cu``):
tiles, the contraction split and its f32 partials.

bf16 and f16 run ``csrc/dequant_gemm.cuh``: blocks of ``bm`` = 128 rows of
x by ``bn`` = 128 columns of W, ``bk`` = 64 contraction steps.  The
contraction is split only where the tiles are too few to give every SM a
block, by the MLP plan's rule (:func:`.mlp_plan.split_count`):
``ceil(sms / tiles)`` splits, the f32 partials (splits x M x N x 4 bytes)
within 16 MiB, no split left empty -- 5 splits at M = 128 and N = 4096, 2
at N = 11008, none at the LM head's 250 tiles.  f32 runs the SIMT body of
``csrc/dequant_matmul.cuh`` (64 x 64 tiles, 64-deep chunks) with that
body's own rule, reproduced here: split until the grid holds 8 blocks per
SM, at most 16 splits.

:func:`int8_plan` is a pure function of the shapes, the dtype and the SM
count, so the CPU tests check it; the wrapper allocates the partials from
it and passes ``splits`` to the C entry point, which refuses
(``cudaErrorInvalidValue``) a plan it cannot run.  :func:`check_plan`
makes the same test in Python, before any launch.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .mlp_plan import H100_SMS, split_count

__all__ = ["Int8Plan", "int8_plan", "check_plan"]

_BK = 64
# (bm, bn) by dtype
_TILE = {torch.bfloat16: (128, 128), torch.float16: (128, 128),
         torch.float32: (64, 64)}
# the f32 SIMT body's split rule
_F32_BLOCKS_PER_SM = 8
_F32_MAX_SPLITS = 16


@dataclasses.dataclass(frozen=True)
class Int8Plan:
    dtype: torch.dtype
    m: int
    k: int
    n: int
    bm: int              # rows of x per block
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


def _f32_splits(tiles: int, k_steps: int, sms: int) -> int:
    want = min(-(-_F32_BLOCKS_PER_SM * sms // tiles), _F32_MAX_SPLITS,
               k_steps)
    if want <= 1:
        return 1
    per = -(-k_steps // want)
    return -(-k_steps // per)


@functools.lru_cache(maxsize=512)
def int8_plan(m: int, k: int, n: int, dtype: torch.dtype,
              sms: int = H100_SMS) -> Int8Plan:
    """The plan for x (m, k) through a (k, n) int8 weight.  Raises
    TypeError for a dtype other than f32, bf16 or f16 and ValueError for
    m < 1, n < 1 or k < 0."""
    if dtype not in _TILE:
        raise TypeError(f"int8_plan: the int8 kernel takes float32, "
                        f"bfloat16 or float16; got {dtype}")
    if m < 1 or n < 1 or k < 0:
        raise ValueError(f"int8_plan: shape ({m}, {k}, {n}) needs m, n >= 1 "
                         "and k >= 0")
    bm, bn = _TILE[dtype]
    plan = Int8Plan(dtype, m, k, n, bm, bn, 1)
    if dtype == torch.float32:
        splits = _f32_splits(plan.tiles, plan.k_steps, sms)
    else:
        splits = split_count(plan.tiles, plan.k_steps, 4 * m * n, sms)
    return dataclasses.replace(plan, splits=splits)


def check_plan(op: str, plan: Int8Plan) -> None:
    """Raise ValueError for a plan the C entry point would refuse."""
    ok = (plan.dtype in _TILE and (plan.bm, plan.bn) == _TILE[plan.dtype]
          and plan.m >= 1 and plan.n >= 1 and plan.k >= 0
          and plan.splits >= 1
          and (plan.splits == 1 if plan.k_steps == 0 else
               (plan.splits - 1) * plan.steps_per_split < plan.k_steps))
    if not ok:
        raise ValueError(f"{op}: the kernel cannot run the plan {plan}")
