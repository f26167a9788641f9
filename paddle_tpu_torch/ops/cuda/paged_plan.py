"""The launch plan of the paged decode-attention kernel
(``csrc/paged_attention.cu``): its path, position spans, grid and the
scratch they need.

bf16 and f16 run the tensor-core path: the G = H / H_kv q heads of one kv
head form tiles of 16 rows (zero rows past G), one block of 4 warps each.
f32 runs the SIMT path with tiles of 8 rows.  (A SIMT path for 16-bit
types ran slower than the tensor cores even at G = 1, PERF.md §6, and
was dropped.)  A slot's positions (up to
MB x page) come in stages of 64 (16-bit types) or 32 (f32); they are cut
into ``splits`` spans of ``per`` stages, one block each:
``splits = floor(resident x SMs / (B x H_kv x tiles))``, at least 1,
capped by the stages and by :data:`MAX_PARTIAL_BYTES` of partials, then
trimmed so that no span is empty; ``resident`` is the blocks an SM holds
at once (its shared memory over a block's, at most
:data:`BLOCKS_PER_SM`: 3 at head dim 128).  So the grid fills the card in
one wave when every slot's table is full; blocks whose span starts past
their slot's last live position exit at once.  ``compare_paged --sweep``
times other span counts on the card: on an H100 a second wave of blocks
cost more than the shorter spans gained (PERF.md §6).  The plan reads
only shapes, never ``lens`` or the tables, so a call never waits on the
host.  Where ``splits`` > 1, every span of a slot with more than one
writes f32 partials (acc, and m and l per row) into the scratch, and the
last of them to finish merges them in span order inside the same launch,
counting on an int32 counter per (slot, kv head, tile) that it leaves at
zero.

:func:`paged_plan` is a pure function of the shapes, the dtype and the
SM count, cached, so the CPU tests check it and a call pays only the
lookup; the wrapper passes ``splits`` and ``per`` to the C entry point,
which refuses (``cudaErrorInvalidValue``) a plan it cannot run.
:func:`check_plan` makes the same test in Python.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .mlp_plan import H100_SMS

__all__ = ["BLOCKS_PER_SM", "HEAD_DIMS", "MAX_PARTIAL_BYTES", "SMEM_LIMIT",
           "SM_SMEM", "PagedPlan", "check_plan", "paged_plan",
           "tensor_core_path"]

# blocks an SM holds at once, at most: 4 blocks of 128 threads with up to
# 128 registers each fill its 65,536 registers
BLOCKS_PER_SM = 4
MAX_PARTIAL_BYTES = 32 << 20
# Hopper's shared memory a block may use (H100: 232,448 bytes), and an
# SM's, of which each resident block reserves 1 KB more
SMEM_LIMIT = 232448
SM_SMEM = 233472
HEAD_DIMS = (32, 64, 96, 128)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_TC_ROWS, _SIMT_ROWS = 16, 8
_RING = 2           # stages in a block's ring of K/V copies


def tensor_core_path(dtype: torch.dtype) -> bool:
    """Whether ``dtype`` runs on the tensor cores (16-bit types do)."""
    return dtype in (torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    dtype: torch.dtype
    b: int
    g: int               # q heads per kv head
    h_kv: int
    d: int
    page: int
    mb: int
    splits: int          # position spans per (slot, kv head, tile)
    per: int             # stages per span

    @property
    def path(self) -> str:
        return "tensor_cores" if tensor_core_path(self.dtype) else "simt"

    @property
    def rows_per_tile(self) -> int:
        return _TC_ROWS if self.path == "tensor_cores" else _SIMT_ROWS

    @property
    def tiles(self) -> int:
        return -(-self.g // self.rows_per_tile)

    @property
    def trows(self) -> int:
        """Rows a tile keeps in the partials."""
        return min(self.g, self.rows_per_tile)

    @property
    def stage(self) -> int:
        """Positions per ring stage."""
        return 32 if self.dtype == torch.float32 else 64

    @property
    def stages(self) -> int:
        return -(-self.mb * self.page // self.stage)

    @property
    def grid_blocks(self) -> int:
        return self.b * self.h_kv * self.tiles * self.splits

    @property
    def table_slots(self) -> int:
        """Table entries a span can touch: one per page, plus a partial
        page at each end."""
        return -(-self.per * self.stage // self.page) + 1

    @property
    def smem_bytes(self) -> int:
        d, item = self.d, self.dtype.itemsize
        table = 16 * -(-self.table_slots // 4)
        if self.path == "tensor_cores":
            return 2 * (d + 8) * (_TC_ROWS + 2 * _RING * self.stage) + table
        r, s = _SIMT_ROWS, self.stage
        return 4 * (r * d + r * s + 3 * r) \
            + 2 * _RING * s * (d + 16 // item) * item + table

    @property
    def resident_per_sm(self) -> int:
        """Blocks of this plan an SM holds at once."""
        return max(1, min(BLOCKS_PER_SM,
                          SM_SMEM // (self.smem_bytes + 1024)))

    @property
    def partial_rows(self) -> int:
        return self.b * self.h_kv * self.tiles * self.splits * self.trows

    @property
    def ml_offset(self) -> int:
        """Byte offset of the (m, l) partials in the scratch."""
        return -(-self.partial_rows * self.d * 4 // 256) * 256

    @property
    def counter_offset(self) -> int:
        """Byte offset of the int32 counters in the scratch."""
        return self.ml_offset + -(-self.partial_rows * 2 * 4 // 256) * 256

    @property
    def scratch_bytes(self) -> int:
        """Partials and counters; none without spans to merge."""
        if self.splits == 1:
            return 0
        return self.counter_offset + 4 * self.b * self.h_kv * self.tiles


@functools.lru_cache(maxsize=256)
def paged_plan(b: int, h: int, h_kv: int, d: int, page: int, mb: int,
               dtype: torch.dtype, sms: int = H100_SMS) -> PagedPlan:
    """The plan for q (b, h, d) over pools of ``page``-position pages and
    (b, mb) block tables.  Raises TypeError for a dtype other than f32,
    bf16 or f16 and ValueError for sizes below 1, h not a multiple of
    h_kv, a head dim outside :data:`HEAD_DIMS`, or a plan the kernel
    cannot run (:func:`check_plan`)."""
    if dtype not in _DTYPES:
        raise TypeError(f"paged_plan: the kernel takes float32, bfloat16 "
                        f"and float16; got {dtype}")
    if min(b, h, h_kv, page, mb) < 1 or h % h_kv:
        raise ValueError(f"paged_plan: b {b}, {h} q heads over {h_kv} kv "
                         f"heads, page {page}, mb {mb}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_plan: head_dim {d} not in {HEAD_DIMS}")
    plan = PagedPlan(dtype, b, h // h_kv, h_kv, d, page, mb, 1, 1)
    base = plan.grid_blocks
    per_split = b * h_kv * plan.tiles * plan.trows * (d + 2) * 4
    splits = max(1, min(plan.resident_per_sm * sms // base, plan.stages,
                        MAX_PARTIAL_BYTES // per_split))
    per = -(-plan.stages // splits)
    plan = dataclasses.replace(plan, splits=-(-plan.stages // per), per=per)
    check_plan("paged_attention", plan)
    return plan


def check_plan(op: str, plan: PagedPlan) -> None:
    """Raise ValueError for a plan the C entry point would refuse, or
    whose blocks need more shared memory than a block may have."""
    ok = (plan.splits >= 1 and plan.per >= 1
          and (plan.splits - 1) * plan.per < plan.stages
          <= plan.splits * plan.per
          and plan.b <= 65535 and plan.h_kv <= 65535
          and plan.tiles * plan.splits < 2 ** 31
          and plan.d in HEAD_DIMS)
    if not ok:
        raise ValueError(f"{op}: the kernel cannot run the plan {plan}")
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"{op}: page {plan.page} x {plan.per} stages "
                         f"needs {plan.smem_bytes} bytes of shared memory")
