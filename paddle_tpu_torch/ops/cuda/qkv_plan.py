"""The launch plan of the fused RMSNorm -> QKV -> RoPE kernel
(``csrc/fused_norm_qkv.cu``): tiles, the contraction split and the
scratch they need.

bf16 runs as a norm kernel that writes ``nx`` (T, H) in bf16 and a GEMM
over ``bm`` = 128 token rows by ``bn`` = 128 output columns of one of q, k
or v (``bk`` = 64 contraction steps).  The GEMM splits its contraction
only where its tiles are too few to give every SM a block, by the rule
the MLP plan uses (:func:`.mlp_plan.split_count`): ``ceil(sms / tiles)``
splits, the f32 partials (splits x T x (Nq + 2 Nk) x 4 bytes) within
16 MiB, no split left empty.  f32 runs the SIMT tile of 64 token rows by
one head, with no split and no scratch.

:func:`qkv_plan` is a pure function of the shapes, the dtype and the SM
count, so the CPU tests check it; the wrapper allocates the scratch from
it (nx, then the partials at a 256-aligned offset) and passes ``splits``
to the C entry point, which refuses (``cudaErrorInvalidValue``) a plan it
cannot run.  :func:`check_plan` makes the same test in Python, before any
launch.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .mlp_plan import H100_SMS, split_count

__all__ = ["QkvPlan", "qkv_plan", "check_plan"]

_BK = 64
_ITEM = {torch.float32: 4, torch.bfloat16: 2}
# (bm, bn) by dtype; f32's bn is the head dim
_TILE = {torch.bfloat16: (128, 128), torch.float32: (64, None)}


@dataclasses.dataclass(frozen=True)
class QkvPlan:
    dtype: torch.dtype
    t: int
    h: int
    nq: int
    nk: int
    head_dim: int
    bm: int              # token rows per block
    bn: int              # output columns per block
    splits: int          # contraction splits of the GEMM

    bk = _BK

    @property
    def n_total(self) -> int:
        return self.nq + 2 * self.nk

    @property
    def row_tiles(self) -> int:
        return -(-self.t // self.bm)

    @property
    def col_tiles(self) -> int:
        return -(-self.nq // self.bn) + 2 * -(-self.nk // self.bn)

    @property
    def tiles(self) -> int:
        """Output tiles of the GEMM (blocks per split)."""
        return self.row_tiles * self.col_tiles

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def k_steps(self) -> int:
        return -(-self.h // self.bk)

    @property
    def steps_per_split(self) -> int:
        return -(-self.k_steps // self.splits)

    @property
    def nx_bytes(self) -> int:
        return self.t * self.h * 2 if self.dtype == torch.bfloat16 else 0

    @property
    def partial_bytes(self) -> int:
        return 0 if self.splits == 1 else 4 * self.splits * self.t * self.n_total

    @property
    def partial_offset(self) -> int:
        """Byte offset of the partials in one scratch buffer (256-aligned)."""
        return -(-self.nx_bytes // 256) * 256

    @property
    def scratch_bytes(self) -> int:
        return self.partial_offset + self.partial_bytes


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"qkv_plan: {what}")


@functools.lru_cache(maxsize=256)
def qkv_plan(t: int, h: int, nq: int, nk: int, head_dim: int,
             dtype: torch.dtype, sms: int = H100_SMS) -> QkvPlan:
    """The plan for x (t, h) through (h, nq) and two (h, nk) weights.
    Raises TypeError for a dtype other than f32 or bf16 and ValueError for
    t < 1, h not a multiple of 32, a head dim other than 64 or 128, or
    widths that are not positive multiples of it."""
    if dtype not in _ITEM:
        raise TypeError(f"qkv_plan: the QKV kernel takes float32 and "
                        f"bfloat16; got {dtype}")
    _check(t >= 1, f"token count {t} < 1")
    _check(h > 0 and h % 32 == 0, f"hidden {h} not a multiple of 32")
    _check(head_dim in (64, 128), f"head_dim {head_dim} not in (64, 128)")
    _check(nq > 0 and nk > 0 and nq % head_dim == 0 and nk % head_dim == 0,
           f"widths {nq}, {nk} not multiples of head_dim {head_dim}")
    bm, bn = _TILE[dtype]
    if dtype == torch.float32:
        return QkvPlan(dtype, t, h, nq, nk, head_dim, bm, head_dim, 1)
    plan = QkvPlan(dtype, t, h, nq, nk, head_dim, bm, bn, 1)
    splits = split_count(plan.tiles, plan.k_steps, 4 * t * plan.n_total, sms)
    return dataclasses.replace(plan, splits=splits)


def check_plan(op: str, plan: QkvPlan) -> None:
    """Raise ValueError for a plan the C entry point would refuse."""
    bm, bn = _TILE.get(plan.dtype, (None, None))
    ok = (plan.dtype in _ITEM and plan.t >= 1 and plan.h > 0
          and plan.h % 32 == 0 and plan.head_dim in (64, 128)
          and plan.nq > 0 and plan.nk > 0
          and plan.nq % plan.head_dim == 0 and plan.nk % plan.head_dim == 0
          and plan.bm == bm and plan.bn == (bn or plan.head_dim)
          and plan.splits >= 1
          and (plan.dtype == torch.bfloat16 or plan.splits == 1)
          and (plan.splits - 1) * plan.steps_per_split < plan.k_steps)
    if not ok:
        raise ValueError(f"{op}: the kernel cannot run the plan {plan}")
