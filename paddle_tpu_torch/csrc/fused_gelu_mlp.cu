// Fused GELU MLP, gelu(x @ W1 + b1) @ W2 + b2 (GPT's 4h FFN), for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_mlp.py
// (`fused_gelu_mlp`, pallas_call at :181; body `_gelu_kernel`).  The
// numerical contract is paddle_tpu/incubate/nn/functional.py
// `_fused_gelu_mlp_ref`: x @ W1 accumulates in f32 and b1 is added in f32,
// the exact erf GELU runs in f32 and h is rounded to the storage type,
// h @ W2 accumulates in f32, b2 is added in f32 and the result is rounded
// once.  The biases arrive in the storage type or in f32 and are widened
// (exactly) where they are added.
//
// Bound on an H100 (the function's): at serving token counts (T <= 128)
// the two H x F weight matrices are the bytes, ~64 operations per weight
// byte in bf16 at T = 128 and fewer below, so the weight read bounds it
// (0.081 ms at gpt3-6.7b, F = 16384); at large T the 4 T H F operations.
//
// Design (csrc/fused_mlp.cu's, with one up-projection and two biases; the
// GEMM main loops, the down projection, its split-K rule and the split
// sum are csrc/mlp_gemm.cuh).  The TPU kernel keeps the (T, F)
// intermediate in VMEM; here it goes through device memory in the storage
// type, where the contract rounds it anyway (4 MB at T = 128):
//   up:   block (128 token rows, 128 or 64 columns of F: the plan takes
//         the wider band unless it leaves SMs idle, so 64 at T <= 128 and
//         F = 16384, 256 blocks two to an SM) accumulates x @ W1 in m64
//         wgmma accumulators, adds b1 and runs the erf GELU in registers
//         in f32, rounds once and stores h with 16-byte stores;
//   down: out = h @ W2 + b2 in 128 x 128 tiles, the contraction split
//         only where the tiles are too few (5 splits at T <= 128, H =
//         4096); with one split the epilogue adds b2 and rounds, with more
//         the fixed-order split sum does.
// 3-stage cp.async rings of 64-deep steps feed swizzled tiles to wgmma;
// rows past T are zero-filled by the copies.  The down kernel and the
// split sum are dependent launches that start while the kernel before
// them finishes (csrc/mlp_gemm.cuh).  No atomics.
//
// f32 runs the same plan on the SIMT units (64 x 128 tiles, full f32).
//
// One C call issues two or three kernels on the caller's stream; it
// neither allocates nor synchronises.
#include "mlp_gemm.cuh"

namespace {

using namespace mlp;

// the exact (erf) GELU in f32
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// h (t, f) = round(gelu(x @ w1 + b1)); grid (row tiles, f / BN).
template <int BN>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
up16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
            const void* __restrict__ b1, int b1_bf16,
            bf16* __restrict__ hout, int t, int h, int f) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  sm90::launch_dependents();   // the down kernel may start its weights
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  float acc[1][BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[0][i] = 0.f;
  const bf16* const w[1] = {w1};
  gemm_tiles<1, BN>(sm, x, h, t, m0, w, f, n0, 0, h / kBK, acc);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float bias = bias_at(b1, b1_bf16, n0 + acc_col(j, e));
      acc[0][4 * j + e] = gelu_erf(acc[0][4 * j + e] + bias);
      acc[0][4 * j + 2 + e] = gelu_erf(acc[0][4 * j + 2 + e] + bias);
    }
  store_rows<BN>(hout, f, t, m0, n0, sm, acc[0]);
}

template <int BN>
int up16(const void* x, const void* w1, const void* b1, int b1_bf16,
         void* hbuf, int t, int h, int f, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<1, BN>();
  cudaError_t e = allow_smem(up16_kernel<BN>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((t + kBM - 1) / kBM, f / BN);
  up16_kernel<BN><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1, b1_bf16,
      static_cast<bf16*>(hbuf), t, h, f);
  return (int)cudaGetLastError();
}

// The f32 up projection: grid (row tiles of 64, f / 128).
__global__ void __launch_bounds__(kThreads)
up32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
            const void* __restrict__ b1, int b1_bf16,
            float* __restrict__ hout, int t, int h, int f) {
  __shared__ float sm[simt::smem_floats<1>()];
  const int m0 = blockIdx.x * simt::kBM, n0 = blockIdx.y * simt::kBN;
  float acc[1][simt::kRM][8] = {};
  const float* const w[1] = {w1};
  simt::gemm<1>(sm, x, h, t, m0, w, f, n0, 0, h, acc);
  const int tx = threadIdx.x % simt::kTX, ty = threadIdx.x / simt::kTX;
#pragma unroll
  for (int r = 0; r < simt::kRM; ++r) {
    const int row = m0 + ty * simt::kRM + r;
    if (row >= t) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n0 + simt::col_of(tx, c);
      hout[(size_t)row * f + col] =
          gelu_erf(acc[0][r][c] + bias_at(b1, b1_bf16, col));
    }
  }
}

}  // namespace

// x (t, h); w1 (h, f); b1 (f,); w2 (f, h); b2 (h,) -> out (t, h), x, w1,
// w2 and out 16-byte aligned and of `dtype` (PT_F32 or PT_BF16), the
// biases of `bias_dtype` (PT_F32, or `dtype`).
// hbuf: scratch of t x f values of `dtype`; partial: f32 scratch of
// splits x t x h values (unused with one split).  up_bn is the plan's up
// tile width (64 or 128 for bf16, 128 for f32) and splits its down split
// count; a plan this source cannot run returns cudaErrorInvalidValue
// before any launch.
extern "C" int pt_fused_gelu_mlp(const void* x, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, void* hbuf, void* partial,
                                 void* out, int t, int h, int f, int dtype,
                                 int bias_dtype, int up_bn, int splits,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kps = steps_per_split(t, h, f, splits);
  const bool bf = dtype == PT_BF16;
  const int bias16 = bias_dtype == PT_BF16;
  if (kps == 0 || hbuf == nullptr || (dtype != PT_F32 && !bf) ||
      (bias_dtype != PT_F32 && bias_dtype != dtype) ||
      (bf ? up_bn != 64 && up_bn != 128 : up_bn != simt::kBN))
    return (int)cudaErrorInvalidValue;
  int rc;
  if (bf) {
    rc = up_bn == 128 ? up16<128>(x, w1, b1, bias16, hbuf, t, h, f, s)
                      : up16<64>(x, w1, b1, bias16, hbuf, t, h, f, s);
  } else {
    dim3 grid((t + simt::kBM - 1) / simt::kBM, f / simt::kBN);
    up32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), b1,
        bias16, static_cast<float*>(hbuf), t, h, f);
    rc = (int)cudaGetLastError();
  }
  if (rc) return rc;
  return bf ? down<bf16>(hbuf, w2, b2, bias16, partial, out, t, h, f,
                         splits, kps, s)
            : down<float>(hbuf, w2, b2, bias16, partial, out, t, h, f,
                          splits, kps, s);
}
