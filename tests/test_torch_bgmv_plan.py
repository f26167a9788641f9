"""The grouped-BGMV kernel's plan (paddle_tpu_torch.ops.cuda.bgmv_plan), the
wrapper's use of it, and the bf16 kernel's order of operations, on the
CPU.

The plan is a pure function of the shapes and the dtype: bf16 runs one
launch, a thread-block cluster of 16 blocks per slot, block q shrinking
d_in piece q (``slice`` wide) and expanding output tiles q, q + 16, ...;
f32 runs one SIMT launch with no split.  The CUDA kernels run only on the card
(``chip_smoke.py`` holds them against the plain version there); here the
wrapper is driven as if its tensors lay on a card, with the launch
replaced by a recorder.

The split emulation repeats the kernel's arithmetic in torch: per piece,
256-column stages whose 16-deep steps the 4 warps take in turn, each warp
summing its steps' f32 products in order across the stages, the warps'
sums added in warp order; the pieces' partials added in rank order,
rounded to the storage type (the contract's intermediate), and expanded
in f32 and rounded.  It is held against the JAX ``_lora_bgmv_ref`` and
``grouped_bgmv(interpret=True)`` at f32 1e-4 and bf16 2e-2 (an f32 sum
taken in another order can move a rounding by one bf16 unit); index-0
rows must be exact zeros.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.incubate.nn.functional import _lora_bgmv_ref as jax_ref
from paddle_tpu.ops.pallas.lora_matmul import grouped_bgmv as jax_bgmv
from paddle_tpu_torch.ops.cuda import lora_matmul as TLM
from paddle_tpu_torch.ops.cuda.bgmv_plan import bgmv_plan

BF16, F32 = torch.bfloat16, torch.float32
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

# (B, C, d_in, r, d_out) -> (cluster, slice, grid blocks, tiles) in bf16
MAIN = {
    (8, 16, 4096, 16, 4096): (16, 256, 128, 32),      # q, k, v, o
    (8, 16, 4096, 16, 11008): (16, 256, 128, 86),     # gate, up
    (8, 16, 11008, 16, 4096): (16, 704, 128, 32),     # down
    (8, 1, 4096, 16, 11008): (16, 256, 128, 86),      # C = 1
    (1, 16, 4096, 16, 4096): (16, 256, 16, 32),       # one slot
    (3, 5, 100, 16, 1000): (16, 64, 48, 8),           # ragged widths
    (4, 40, 2048, 48, 1000): (16, 128, 64, 8),        # 3 row passes
    (4, 16, 4096, 64, 4096): (16, 256, 64, 32),       # rank 64
    (32, 16, 4096, 16, 4096): (16, 256, 512, 32),     # 32 slots
}


@pytest.mark.parametrize("shape", sorted(MAIN))
def test_plan_at_the_main_geometries(shape):
    p = bgmv_plan(*shape, BF16)
    assert p.path == "tensor_cores"
    assert (p.cluster, p.slice, p.grid_blocks, p.tiles) == MAIN[shape]
    assert p.slice % 64 == 0
    assert p.cluster * p.slice >= shape[2] > p.cluster * (p.slice - 64)
    assert p.rank_pad % 16 == 0 and p.rank_pad - 16 < shape[3]
    assert p.row_passes == -(-shape[1] // 16)


def test_the_cluster_fills_the_card():
    """16 blocks a slot at every batch: the multi-LoRA step's 8 slots run
    128 blocks, about one per SM."""
    for bsz in (1, 8, 16, 17, 64):
        p = bgmv_plan(bsz, 16, 4096, 16, 4096, BF16)
        assert (p.cluster, p.slice) == (16, 256)
        assert p.grid_blocks == bsz * 16
    assert bgmv_plan(8, 16, 4096, 16, 4096, BF16).grid_blocks >= 128


@pytest.mark.parametrize("r,pad,blocks", [(8, 16, 64), (16, 16, 64),
                                          (24, 32, 128), (64, 64, 128)])
def test_f32_is_one_simt_launch(r, pad, blocks):
    p = bgmv_plan(8, 16, 4096, r, 4096, F32)
    assert (p.path, p.cluster, p.slice) == ("simt", 0, 0)
    assert (p.rank_pad, p.grid_blocks) == (pad, blocks)


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(TypeError, match="float16"):
        bgmv_plan(8, 16, 4096, 16, 4096, torch.float16)
    for r in (0, 65):
        with pytest.raises(ValueError, match="rank"):
            bgmv_plan(8, 16, 4096, r, 4096, BF16)
    with pytest.raises(ValueError, match="sizes"):
        bgmv_plan(8, 16, 0, 16, 4096, BF16)


# -- the kernel's order of operations ----------------------------------------

def emulate(x, a, b, idx, cluster, slice_):
    """The tensor-core kernel's arithmetic in torch, in its order."""
    dt = x.dtype
    bsz, c, d_in = x.shape
    ad = idx.long().clamp(0, a.shape[0] - 1)
    ai, bi = a[ad].float(), b[ad].float()          # (B, d_in, r), (B, r, N)
    xf = x.float()
    h = torch.zeros((bsz, c, a.shape[2]))
    for q in range(cluster):                        # pieces, in rank order
        k0, k1 = q * slice_, min(d_in, (q + 1) * slice_)
        warps = [torch.zeros_like(h) for _ in range(4)]
        for kc in range(k0, k1, 256):               # ring stages, in order
            steps = list(range(kc, min(k1, kc + 256), 16))
            for w in range(4):                      # warp w: steps w, w + 4
                for s in steps[w::4]:
                    warps[w] = warps[w] + xf[:, :, s:s + 16] \
                        @ ai[:, s:s + 16]
        h = h + (((warps[0] + warps[1]) + warps[2]) + warps[3])
    h = h.to(dt).float()                            # the intermediate
    out = (h @ bi).to(dt)
    out[ad == 0] = 0                                # the base no-op
    return out


@pytest.mark.parametrize("r,dtype,cluster", [(8, "bfloat16", 16),
                                             (16, "float32", 2),
                                             (24, "bfloat16", 2),
                                             (64, "float32", 16)])
def test_split_order_matches_jax(r, dtype, cluster):
    """Cluster 16 (the plan's) gives one-stage pieces and empty ones; 2
    gives pieces of three ring stages, the last one short."""
    rng = np.random.default_rng(r)
    bsz, c, d_in, d_out, n = 4, 16, 1100, 200, 4
    jdt, tdt = (jnp.bfloat16, BF16) if dtype == "bfloat16" \
        else (jnp.float32, F32)
    x = rng.normal(size=(bsz, c, d_in)).astype(np.float32)
    a = (rng.normal(size=(n, d_in, r)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(n, r, d_out)) * 0.05).astype(np.float32)
    a[0] = 0
    b[0] = 0
    idx = np.array([2, 0, 3, 1], np.int32)
    slice_ = -(-d_in // (cluster * 64)) * 64
    if cluster == 16:
        assert slice_ == bgmv_plan(bsz, c, d_in, r, d_out, BF16).slice
    got = emulate(*(torch.from_numpy(v).to(tdt) for v in (x, a, b)),
                  torch.from_numpy(idx), cluster, slice_).float().numpy()
    assert (got[1] == 0.0).all()                    # index 0: exact zeros
    jx, ja, jb = (jnp.asarray(v, jdt) for v in (x, a, b))
    for f in (jax_ref, lambda *z: jax_bgmv(*z, interpret=True)):
        want = np.asarray(jnp.asarray(f(jx, ja, jb, jnp.asarray(idx)),
                                      jnp.float32))
        np.testing.assert_allclose(got, want, **TOL[dtype])


def test_wrapper_passes_the_plan(monkeypatch):
    """On a card the wrapper passes the plan's slice and allocates only
    the output; f32 passes a slice of 0."""
    calls = []
    monkeypatch.setattr(TLM, "on_cuda", lambda op, *ts, kernel=None: True)
    monkeypatch.setattr(TLM, "stream_of", lambda x: 0)
    monkeypatch.setattr(TLM.KERNEL, "launch", lambda *a: calls.append(a))
    idx = torch.tensor([1, 0, 2, 1], dtype=torch.int32)
    for dt, slice_ in ((BF16, 128), (F32, 0)):
        x = torch.zeros((4, 40, 2048), dtype=dt)
        a = torch.zeros((3, 2048, 48), dtype=dt)
        b = torch.zeros((3, 48, 1000), dtype=dt)
        out = TLM.grouped_bgmv(x, a, b, idx)
        args = calls[-1]
        # (x, a, b, idx, out, bsz, c, d_in, r, d_out, n, slice, dtype,
        # stream)
        assert args[4] == out.data_ptr() and out.shape == (4, 40, 1000)
        assert args[5:12] == (4, 40, 2048, 48, 1000, 3, slice_)
    with pytest.raises(ValueError, match="rank 65"):
        TLM.grouped_bgmv(x, torch.zeros((3, 2048, 65)),
                         torch.zeros((3, 65, 1000)), idx)
