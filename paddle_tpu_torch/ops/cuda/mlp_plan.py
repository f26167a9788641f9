"""The launch plan of the fused MLP kernels (``csrc/fused_mlp.cu``,
``csrc/fused_gelu_mlp.cu``): tiles, the down projection's split-K count
and the scratch they need.

Both MLPs run as an up GEMM that writes ``h`` (T, I) in x's dtype and a
down GEMM ``h @ W_down`` in ``down_bn``-wide output tiles of ``bm`` rows.
The down projection splits its contraction (in ``bk`` = 64 steps) only
where its output tiles are too few to give every SM a block: then
``splits = ceil(sms / tiles)``, capped so that the f32 partials
(splits x T x H x 4 bytes) stay within :data:`MAX_PARTIAL_BYTES`, and
trimmed so that no split is left empty.  ``bm`` is 128 for bf16 (two
wgmma warpgroups of 64 rows) and 64 for f32 (the SIMT tile).

:func:`mlp_plan` is a pure function of the shapes, the dtype and the SM
count, so the CPU tests check it; the wrappers allocate the scratch from
it and pass ``up_bn`` and ``splits`` to the C entry point, which refuses
(``cudaErrorInvalidValue``) a plan it cannot run.  :func:`check_plan`
makes the same test in Python, before any launch.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

__all__ = ["MAX_PARTIAL_BYTES", "H100_SMS", "MlpPlan", "mlp_plan",
           "check_plan", "sm_count"]

H100_SMS = 132
MAX_PARTIAL_BYTES = 16 << 20
_BK = 64
_ITEM = {torch.float32: 4, torch.bfloat16: 2}
# up tile widths each source takes, by (kind, dtype)
_UP_BN = {("swiglu", torch.bfloat16): (64,),
          ("gelu", torch.bfloat16): (128, 64),
          ("swiglu", torch.float32): (128,),
          ("gelu", torch.float32): (128,)}


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    kind: str            # "swiglu" or "gelu"
    dtype: torch.dtype
    t: int
    h: int
    inter: int
    bm: int              # token rows per block, both GEMMs
    up_bn: int           # intermediate columns per up block
    down_bn: int         # output columns per down block
    splits: int          # contraction splits of the down projection

    bk = _BK

    @property
    def row_tiles(self) -> int:
        return -(-self.t // self.bm)

    @property
    def up_blocks(self) -> int:
        return self.row_tiles * (self.inter // self.up_bn)

    @property
    def down_tiles(self) -> int:
        """Output tiles of the down projection (blocks per split)."""
        return self.row_tiles * (self.h // self.down_bn)

    @property
    def down_blocks(self) -> int:
        return self.down_tiles * self.splits

    @property
    def k_steps(self) -> int:
        return self.inter // self.bk

    @property
    def steps_per_split(self) -> int:
        return -(-self.k_steps // self.splits)

    @property
    def h_bytes(self) -> int:
        return self.t * self.inter * _ITEM[self.dtype]

    @property
    def partial_bytes(self) -> int:
        return 0 if self.splits == 1 else 4 * self.splits * self.t * self.h

    @property
    def partial_offset(self) -> int:
        """Byte offset of the partials in one scratch buffer (256-aligned)."""
        return -(-self.h_bytes // 256) * 256

    @property
    def scratch_bytes(self) -> int:
        return self.partial_offset + self.partial_bytes


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"mlp_plan: {what}")


@functools.lru_cache(maxsize=256)
def mlp_plan(t: int, h: int, inter: int, dtype: torch.dtype,
             kind: str = "swiglu", sms: int = H100_SMS) -> MlpPlan:
    """The plan for x (t, h) through (h, inter) up weights and an
    (inter, h) down weight.  Raises TypeError for a dtype other than f32
    or bf16 and ValueError for H or I not a multiple of 128 or t < 1."""
    if dtype not in _ITEM:
        raise TypeError(f"mlp_plan: the MLP kernels take float32 and "
                        f"bfloat16; got {dtype}")
    _check(kind in ("swiglu", "gelu"), f"unknown kind {kind!r}")
    _check(t >= 1, f"token count {t} < 1")
    _check(h % 128 == 0 and inter % 128 == 0 and h > 0 and inter > 0,
           f"hidden {h} and intermediate {inter} must be multiples of 128")
    bf = dtype == torch.bfloat16
    bm = 128 if bf else 64
    rows = -(-t // bm)
    up_bn = _UP_BN[(kind, dtype)][0]
    if len(_UP_BN[(kind, dtype)]) > 1 and rows * (inter // up_bn) < sms:
        up_bn = _UP_BN[(kind, dtype)][1]   # the wider band leaves SMs idle
    down_bn = 128
    tiles = rows * (h // down_bn)
    splits = 1
    if tiles < sms:
        k_steps = inter // _BK
        cap = MAX_PARTIAL_BYTES // (4 * t * h)
        splits = max(1, min(-(-sms // tiles), k_steps, cap))
        per = -(-k_steps // splits)
        splits = -(-k_steps // per)         # none left empty
    return MlpPlan(kind, dtype, t, h, inter, bm, up_bn, down_bn, splits)


def check_plan(op: str, plan: MlpPlan) -> None:
    """Raise ValueError for a plan the C entry point would refuse."""
    ok = (plan.dtype in _ITEM and plan.t >= 1
          and plan.h % 128 == 0 and plan.inter % 128 == 0
          and plan.h > 0 and plan.inter > 0
          and plan.up_bn in _UP_BN.get((plan.kind, plan.dtype), ())
          and plan.bm == (128 if plan.dtype == torch.bfloat16 else 64)
          and plan.down_bn == 128 and plan.splits >= 1
          and (plan.splits - 1) * plan.steps_per_split < plan.k_steps)
    if not ok:
        raise ValueError(f"{op}: the kernel cannot run the plan {plan}")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (cached)."""
    return _sms(device.index if device.index is not None
                else torch.cuda.current_device())
