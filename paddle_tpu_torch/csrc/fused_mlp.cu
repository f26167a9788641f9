// Fused SwiGLU MLP, (silu(x @ Wg) * (x @ Wu)) @ Wd, for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_mlp.py
// (`fused_swiglu_mlp`, pallas_call at :148).  The numerical contract is
// paddle_tpu/incubate/nn/functional.py `_fused_swiglu_mlp_ref`: gate and
// up accumulate in f32, h = silu(g) * u is rounded to the storage type,
// the down projection accumulates in f32 and is rounded once at the end.
//
// Bound on an H100 (the function's, not the design's): at serving token
// counts (T = 128) the three H x I weight matrices are the bytes, ~64
// operations per weight byte in bf16, far below the card's ~295, so the
// weight read bounds it (0.081 ms at llama2-7b); at the training T = 4096
// the 6 T H I operations bound it (1.12 ms).
//
// Design.  The TPU kernel keeps the (T, I) intermediate in VMEM and
// carries an f32 (T, H) accumulator across a sequential I axis.  Here the
// intermediate goes through device memory in the storage type -- the
// contract rounds it there anyway, and at T = 128 it is 2.8 MB against
// 270 MB of weights -- and the MLP is two Hopper GEMMs
// (csrc/mlp_gemm.cuh):
//   up:   block (128 token rows, 64 columns of I) accumulates x @ Wg and
//         x @ Wu side by side (two m64n64 wgmma accumulators per
//         warpgroup sharing one layout, one x tile feeding both), forms
//         silu(g) * u in registers in f32, rounds once and stores h with
//         16-byte stores; I = 11008 gives 172 blocks at T = 128, two to
//         an SM;
//   down: out = h @ Wd in 128 x 128 tiles, the contraction split only
//         where the tiles are too few to fill the SMs (the plan's
//         choice, ops/cuda/mlp_plan.py: 5 splits at T = 128 and H = 4096,
//         none at T = 4096), the splits' f32 partials (10.5 MB at T =
//         128) summed in a fixed order.
// Both stream their tiles through a 3-stage cp.async ring (64-deep
// contraction steps, 32 KB a stage) into swizzled tiles that wgmma reads
// directly.  The down kernel and the split sum are programmatic dependent
// launches: the down blocks start while the up kernel's last blocks run
// and request their first Wd tiles before they wait for h.  No atomics:
// two calls give the same bits.
//
// f32 runs the same two-kernel plan on the SIMT units (64 x 128 tiles,
// full f32 products, no TF32).
//
// One C call issues two or three kernels on the caller's stream; it
// neither allocates nor synchronises: h and the partials are the
// caller's scratch, sized by the plan.
#include "mlp_gemm.cuh"

namespace {

using namespace mlp;

__device__ __forceinline__ float swiglu(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

constexpr int kUpBN = 64;   // I columns per bf16 up block (each of g, u)

// h (t, inter) = round(silu(x @ wg) * (x @ wu)); grid (row tiles, I / 64).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
up16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
            const bf16* __restrict__ wu, bf16* __restrict__ hout, int t,
            int h, int inter) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  sm90::launch_dependents();   // the down kernel may start its weights
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kUpBN;
  float acc[2][kUpBN / 2];
#pragma unroll
  for (int i = 0; i < kUpBN / 2; ++i) acc[0][i] = acc[1][i] = 0.f;
  const bf16* const w[2] = {wg, wu};
  gemm_tiles<2, kUpBN>(sm, x, h, t, m0, w, inter, n0, 0, h / kBK, acc);
#pragma unroll
  for (int i = 0; i < kUpBN / 2; ++i) acc[0][i] = swiglu(acc[0][i], acc[1][i]);
  store_rows<kUpBN>(hout, inter, t, m0, n0, sm, acc[0]);
}

// The f32 up projection: grid (row tiles of 64, I / 128).
__global__ void __launch_bounds__(kThreads)
up32_kernel(const float* __restrict__ x, const float* __restrict__ wg,
            const float* __restrict__ wu, float* __restrict__ hout, int t,
            int h, int inter) {
  __shared__ float sm[simt::smem_floats<2>()];
  const int m0 = blockIdx.x * simt::kBM, n0 = blockIdx.y * simt::kBN;
  float acc[2][simt::kRM][8] = {};
  const float* const w[2] = {wg, wu};
  simt::gemm<2>(sm, x, h, t, m0, w, inter, n0, 0, h, acc);
  const int tx = threadIdx.x % simt::kTX, ty = threadIdx.x / simt::kTX;
#pragma unroll
  for (int r = 0; r < simt::kRM; ++r) {
    const int row = m0 + ty * simt::kRM + r;
    if (row >= t) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      hout[(size_t)row * inter + n0 + simt::col_of(tx, c)] =
          swiglu(acc[0][r][c], acc[1][r][c]);
  }
}

}  // namespace

// x (t, h); wg/wu (h, inter); wd (inter, h) -> out (t, h), all 16-byte
// aligned and of `dtype` (PT_F32 or PT_BF16).  hbuf: scratch of t x inter
// values of `dtype`; partial: f32 scratch of splits x t x h values (unused
// with one split).  up_bn is the plan's up tile width (64 for bf16, 128
// for f32) and splits its down split count; a plan this source cannot run
// returns cudaErrorInvalidValue before any launch.
extern "C" int pt_fused_swiglu_mlp(const void* x, const void* wg,
                                   const void* wu, const void* wd,
                                   void* hbuf, void* partial, void* out,
                                   int t, int h, int inter, int dtype,
                                   int up_bn, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kps = steps_per_split(t, h, inter, splits);
  const bool bf = dtype == PT_BF16;
  if (kps == 0 || hbuf == nullptr || (dtype != PT_F32 && !bf) ||
      up_bn != (bf ? kUpBN : simt::kBN))
    return (int)cudaErrorInvalidValue;
  if (bf) {
    constexpr size_t smem = smem_bytes<2, kUpBN>();
    cudaError_t e = allow_smem(up16_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((t + kBM - 1) / kBM, inter / kUpBN);
    up16_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
        static_cast<const bf16*>(wu), static_cast<bf16*>(hbuf), t, h, inter);
  } else {
    dim3 grid((t + simt::kBM - 1) / simt::kBM, inter / simt::kBN);
    up32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wg),
        static_cast<const float*>(wu), static_cast<float*>(hbuf), t, h,
        inter);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return bf ? down<bf16>(hbuf, wd, nullptr, 0, partial, out, t, h, inter,
                         splits, kps, s)
            : down<float>(hbuf, wd, nullptr, 0, partial, out, t, h, inter,
                          splits, kps, s);
}
