"""The launch plan of the decode megakernel (``csrc/mega_decode.cu``): its
phases, the contraction splits of its two GEMM phases and the scratch they
need.

bf16 runs five phases of work items in one cooperative launch (two
blocks per SM): the norm (``nx``, a (T, H) bf16 scratch), Q/K/V tiles of
``bm`` = 128 token rows by ``bn`` = 128 columns of [q | k | v], their
split sum, the attention, O-projection tiles of 128 x 128 of H into f32
partials, and their sum with the residual.  The Q/K/V contraction over H
is split by the fused QKV kernel's rule (``qkv_plan``'s
:func:`.mlp_plan.split_count` over the SMs: 2 at llama2-7b and 70b GQA,
T = 128); its sum phase runs where there is more than one split or the
head dim is 256 (a head's two halves then lie in two tiles).  The O
projection over Nq is always split into partials, as many as fill the
grid (``split_count`` over the co-resident blocks, 2 per SM, the partials
within 16 MiB): 8 at llama2-7b, 4 at 70b.  The two phases' partials share
one buffer, since the Q/K/V sum has read its partials before the O
projection writes.  f32 runs three SIMT phases with no split and no
scratch.

:func:`mega_plan` is a pure function of the shapes, the dtype and the SM
count, so the CPU tests check it; the wrapper allocates the scratch from
it (nx, then the partials at a 256-aligned offset) and passes the splits
to the C entry point, which refuses (``cudaErrorInvalidValue``) a plan it
cannot run.  :func:`check_plan` makes the same test in Python.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from .mlp_plan import H100_SMS, split_count

__all__ = ["MegaPlan", "mega_plan", "check_plan", "BLOCKS_PER_SM"]

_BK = 64
_TILE = 128
# co-resident blocks per SM the bf16 kernel is built for
# (__launch_bounds__(256, 2))
BLOCKS_PER_SM = 2
_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class MegaPlan:
    dtype: torch.dtype
    t: int               # token rows, B * C
    h: int
    nq: int
    nk: int
    head_dim: int
    qkv_splits: int      # contraction splits of the Q/K/V phase (over H)
    o_splits: int        # contraction splits of the O projection (over Nq)

    bm = bn = _TILE
    bk = _BK

    @property
    def bf16(self) -> bool:
        return self.dtype == torch.bfloat16

    @property
    def row_tiles(self) -> int:
        return -(-self.t // self.bm)

    @property
    def qkv_tiles(self) -> int:
        return self.row_tiles * (-(-self.nq // self.bn)
                                 + 2 * -(-self.nk // self.bn))

    @property
    def o_tiles(self) -> int:
        return self.row_tiles * -(-self.h // self.bn)

    @property
    def qkv_steps(self) -> int:
        return self.h // self.bk

    @property
    def o_steps(self) -> int:
        return self.nq // self.bk

    @property
    def qkv_sum(self) -> bool:
        """Whether the Q/K/V phase writes partials and a sum phase
        follows."""
        return self.bf16 and (self.qkv_splits > 1 or self.head_dim > self.bn)

    @property
    def phases(self) -> Tuple[str, ...]:
        if not self.bf16:
            return ("qkv", "attention", "o_proj")
        return (("norm", "qkv") + (("qkv_sum",) if self.qkv_sum else ())
                + ("attention", "o_proj", "o_sum"))

    @property
    def nx_bytes(self) -> int:
        return self.t * self.h * 2 if self.bf16 else 0

    @property
    def partial_bytes(self) -> int:
        if not self.bf16:
            return 0
        qkv = (4 * self.qkv_splits * self.t * (self.nq + 2 * self.nk)
               if self.qkv_sum else 0)
        return max(qkv, 4 * self.o_splits * self.t * self.h)

    @property
    def partial_offset(self) -> int:
        """Byte offset of the partials in one scratch buffer (256-aligned)."""
        return -(-self.nx_bytes // 256) * 256

    @property
    def scratch_bytes(self) -> int:
        return self.partial_offset + self.partial_bytes


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"mega_plan: {what}")


@functools.lru_cache(maxsize=256)
def mega_plan(t: int, h: int, nq: int, nk: int, head_dim: int,
              dtype: torch.dtype, sms: int = H100_SMS) -> MegaPlan:
    """The plan for a (t, h) span batch through (h, nq) and two (h, nk)
    projections and an (nq, h) O projection.  Raises TypeError for a dtype
    other than f32 or bf16 and ValueError for t < 1, h not a multiple of
    64, a head dim other than 64, 128 or 256, or widths that are not
    positive multiples of it."""
    if dtype not in _DTYPES:
        raise TypeError(f"mega_plan: the megakernel takes float32 and "
                        f"bfloat16; got {dtype}")
    _check(t >= 1, f"token count {t} < 1")
    _check(h > 0 and h % 64 == 0, f"hidden {h} not a multiple of 64")
    _check(head_dim in (64, 128, 256),
           f"head_dim {head_dim} not in (64, 128, 256)")
    _check(nq > 0 and nk > 0 and nq % head_dim == 0 and nk % head_dim == 0,
           f"widths {nq}, {nk} not multiples of head_dim {head_dim}")
    plan = MegaPlan(dtype, t, h, nq, nk, head_dim, 1, 1)
    if dtype == torch.float32:
        return plan
    return dataclasses.replace(
        plan,
        qkv_splits=split_count(plan.qkv_tiles, plan.qkv_steps,
                               4 * t * (nq + 2 * nk), sms),
        o_splits=split_count(plan.o_tiles, plan.o_steps, 4 * t * h,
                             BLOCKS_PER_SM * sms))


def _splits_ok(steps: int, splits: int) -> bool:
    if splits < 1 or steps < 1:
        return False
    return (splits - 1) * -(-steps // splits) < steps


def check_plan(op: str, plan: MegaPlan) -> None:
    """Raise ValueError for a plan the C entry point would refuse."""
    if plan.bf16:
        ok = (_splits_ok(plan.qkv_steps, plan.qkv_splits)
              and _splits_ok(plan.o_steps, plan.o_splits))
    else:
        ok = plan.dtype in _DTYPES and plan.qkv_splits == plan.o_splits == 1
    if not ok:
        raise ValueError(f"{op}: the kernel cannot run the plan {plan}")
