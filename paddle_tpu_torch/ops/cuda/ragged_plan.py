"""The launch plan of the ragged paged-attention kernel
(``csrc/ragged_attention.cu``): its path, position splits and the scratch
they need.

bf16 with a head dim that is a multiple of 8 up to 256 runs the
tensor-core path.  The q rows of one kv head (``rows`` = C x G, row =
j * G + g) form tiles of 16 rows, one block of 4 warps each.  A slot's
positions (up to MB x page) come in stages of 64; they are cut into
``splits`` spans of ``per`` stages, one block each:
``splits = ceil(BLOCKS_PER_SM x SMs / (B x H_kv x tiles))``, capped by
the stages and by :data:`MAX_PARTIAL_BYTES` of partials, then trimmed so
that no span is empty.  The grid would hold four blocks per SM if every
slot's table were full; at a serving step short and idle slots exit
their later spans at once.  ``compare_ragged_bgmv --sweep`` times 1, 2,
3, 4 and 8 spans on the card: on an H100 this rule's choice was the
fastest at both the llama2-7b and the 70b GQA step (PERF.md §6).  The
plan reads only shapes, never the values of ``starts`` or ``lens``: a
call never waits on the host.  Where
``splits`` > 1, every span of a row tile writes f32 partials (acc, and m
and l per row) that a combine kernel merges in span order.  Other shapes
run the SIMT path: one block per (slot, kv head, 64 rows), no split, no
scratch.

:func:`ragged_plan` is a pure function of the shapes, the dtype and the
SM count, so the CPU tests check it; the wrapper allocates the partials
from it and passes ``splits`` and ``per`` to the C entry point, which
refuses (``cudaErrorInvalidValue``) a plan it cannot run.
:func:`check_plan` makes the same test in Python; :func:`ragged_plan`
runs it once per shape (plans are cached), so a call pays only the
lookup.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .mlp_plan import H100_SMS

__all__ = ["BLOCKS_PER_SM", "MAX_PARTIAL_BYTES", "SMEM_LIMIT", "RaggedPlan",
           "check_plan", "ragged_plan", "tensor_core_path"]

BLOCKS_PER_SM = 4
MAX_PARTIAL_BYTES = 32 << 20
# Hopper's shared memory a block may use (H100: 232,448 bytes)
SMEM_LIMIT = 232448
STAGE = 64          # positions per ring stage
TILE = 16           # q rows per row tile
_SIMT_ROWS = 64     # q rows per SIMT block
_DTYPES = (torch.float32, torch.bfloat16)


def tensor_core_path(dtype: torch.dtype, d: int) -> bool:
    """Whether (dtype, head dim) runs on the tensor cores."""
    return dtype == torch.bfloat16 and d % 8 == 0 and 8 <= d <= 256


@dataclasses.dataclass(frozen=True)
class RaggedPlan:
    dtype: torch.dtype
    b: int
    c: int
    g: int               # q heads per kv head
    h_kv: int
    d: int
    page: int
    mb: int
    splits: int          # position spans per row tile
    per: int             # stages per span

    @property
    def tensor_cores(self) -> bool:
        return tensor_core_path(self.dtype, self.d)

    @property
    def path(self) -> str:
        return "tensor_cores" if self.tensor_cores else "simt"

    @property
    def rows(self) -> int:
        return self.c * self.g

    @property
    def tiles(self) -> int:
        """Row blocks of a kv head: 16-row tiles, or the SIMT path's 64."""
        return -(-self.rows // (TILE if self.tensor_cores else _SIMT_ROWS))

    @property
    def stages(self) -> int:
        return -(-self.mb * self.page // STAGE)

    @property
    def grid_blocks(self) -> int:
        return self.b * self.h_kv * self.tiles * self.splits

    @property
    def combine(self) -> bool:
        """Whether a combine kernel follows (some slot may span splits)."""
        return self.splits > 1

    @property
    def partial_rows(self) -> int:
        return self.b * self.h_kv * self.splits * self.tiles * TILE

    @property
    def ml_offset(self) -> int:
        """Byte offset of the (m, l) partials in one scratch buffer."""
        return -(-self.partial_rows * self.d * 4 // 256) * 256

    @property
    def partial_bytes(self) -> int:
        if not self.combine:
            return 0
        return self.ml_offset + self.partial_rows * 2 * 4

    @property
    def smem_bytes(self) -> int:
        d = self.d
        if not self.tensor_cores:
            return 4 * (_SIMT_ROWS * (d + 1) + _SIMT_ROWS * d
                        + self.page * (d + 1) + self.page * d
                        + _SIMT_ROWS * self.page + 3 * _SIMT_ROWS)
        ld = (64 if d <= 64 else 128 if d <= 128 else 256) + 8
        return 2 * ld * (TILE + 4 * STAGE)


@functools.lru_cache(maxsize=256)
def ragged_plan(b: int, c: int, h: int, h_kv: int, d: int, page: int,
                mb: int, dtype: torch.dtype,
                sms: int = H100_SMS) -> RaggedPlan:
    """The plan for q (b, c, h, d) over pools of ``page``-position pages,
    (b, mb) block tables.  Raises TypeError for a dtype other than f32 or
    bf16 and ValueError for sizes below 1, h not a multiple of h_kv, or a
    plan the kernel cannot run (:func:`check_plan`)."""
    if dtype not in _DTYPES:
        raise TypeError(f"ragged_plan: the kernel takes float32 and "
                        f"bfloat16; got {dtype}")
    if min(b, c, h, h_kv, d, page, mb) < 1 or h % h_kv:
        raise ValueError(f"ragged_plan: b {b}, c {c}, {h} q heads over "
                         f"{h_kv} kv heads, d {d}, page {page}, mb {mb}")
    plan = RaggedPlan(dtype, b, c, h // h_kv, h_kv, d, page, mb, 1, 1)
    if plan.tensor_cores:
        base = plan.grid_blocks
        per_split = base * TILE * (d + 2) * 4   # acc, m and l of a span
        splits = max(1, min(-(-BLOCKS_PER_SM * sms // base), plan.stages,
                            MAX_PARTIAL_BYTES // per_split))
        per = -(-plan.stages // splits)
        plan = dataclasses.replace(plan, splits=-(-plan.stages // per),
                                   per=per)
    check_plan("ragged_paged_attention", plan)
    return plan


def check_plan(op: str, plan: RaggedPlan) -> None:
    """Raise ValueError for a plan the C entry point would refuse, or
    whose blocks need more shared memory than a block may have."""
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"{op}: page {plan.page} x head_dim {plan.d} "
                         f"needs {plan.smem_bytes} bytes of shared memory")
    ok = plan.splits >= 1 and plan.per >= 1
    if plan.tensor_cores:
        ok = (ok and plan.h_kv <= 65535 and plan.b <= 65535
              and (plan.splits - 1) * plan.per < plan.stages
              <= plan.splits * plan.per)
    else:
        ok = ok and plan.splits == plan.per == 1
    if not ok:
        raise ValueError(f"{op}: the kernel cannot run the plan {plan}")
