// Fused GELU MLP, gelu(x @ W1 + b1) @ W2 + b2 (GPT's 4h FFN), for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_mlp.py
// (`fused_gelu_mlp`, pallas_call at :181; body `_gelu_kernel`).  The
// numerical contract is paddle_tpu/incubate/nn/functional.py
// `_fused_gelu_mlp_ref`: x @ W1 accumulates in f32 and b1 is added in f32,
// the exact erf GELU runs in f32 and h is rounded to the storage type,
// h @ W2 accumulates in f32, b2 is added in f32 and the result is rounded
// once.  The biases arrive as f32 (the wrapper widens them, exactly).
//
// Bound on an H100: at serving token counts (T = 128) the two H x F weight
// matrices are the bytes, ~64 operations per weight byte in bf16, so the
// weight read bounds it.  bf16 runs its products on the tensor cores
// (WMMA, mma.sync 16x16x16, f32 accumulation); f32 runs them on the SIMT
// units so it stays full f32, and is bound by their rate.
//
// Scratch.  Each F split writes an f32 (Tpad, H) partial.  At serving
// token counts every split is one 128-wide F chunk, so at gpt3-6.7b's
// F = 16384, T = 128 the partials are 128 x 128 x 4096 x 4 B = 268 MB,
// as large as the bf16 weights, and their write and read-back are more
// traffic than the weights.  The splits are capped as in
// csrc/mlp_tiles.cuh.  Shrinking the scratch (fewer, longer splits at
// serving T) is later work.
//
// Design (csrc/fused_mlp.cu's, with one up-projection and two biases;
// the tile geometry, the split plan, the down projection and pass 2 are
// csrc/mlp_tiles.cuh).  The TPU kernel carries an f32 (T, H) accumulator
// across a sequential F axis; on the H100 blocks run in parallel with
// nothing carried between them, so the F axis is split across blocks:
//   pass 1: block (token tile of 64, F split) computes, chunk by chunk of
//           128, h = gelu(x @ W1[:, chunk] + b1[chunk]) into shared memory
//           -- the (T, F) intermediate never goes to device memory -- and
//           multiplies it by that chunk's 128 rows of W2, adding into its
//           f32 partial (splits, Tpad, H);
//   pass 2: a small kernel sums the partials in a fixed split order, adds
//           b2 once and rounds.  No atomics: the same sum order every run.
#include "mlp_tiles.cuh"

#include <type_traits>

namespace {

using namespace mlp;

// the exact (erf) GELU in f32
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// ---- f32: SIMT units ------------------------------------------------------

constexpr size_t kSimtSmem =
    sizeof(float) * (kBKs * kBT + kBKs * kBI + kBI * kBT);

__global__ void __launch_bounds__(kThreads)
gelu_partial_simt(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  float* __restrict__ partial, int t, int tpad, int h,
                  int f, int cps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);   // [kBKs][kBT]
  float* ws = xs + kBKs * kBT;                  // [kBKs][kBI]
  float* hs = ws + kBKs * kBI;                  // [kBI][kBT]

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int t0 = blockIdx.x * kBT;
  const int split = blockIdx.y;
  float* prow = partial + (size_t)split * tpad * h;
  for (int ch = 0; ch < cps; ++ch) {
  const int i0 = (split * cps + ch) * kBI;
  if (i0 >= f) break;

  // 1. x @ W1 for this token tile and F chunk
  float a1[kRM][8];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) a1[r][c] = 0.f;
  for (int k0 = 0; k0 < h; k0 += kBKs) {
    for (int e = tid; e < kBT * kBKs; e += kThreads) {
      const int r = e / kBKs, kk = e % kBKs;
      const int row = t0 + r;
      xs[kk * kBT + r] = row < t ? x[(size_t)row * h + k0 + kk] : 0.f;
    }
    for (int e = tid; e < kBKs * kBI; e += kThreads) {
      const int kk = e / kBI, c = e % kBI;
      ws[e] = w1[(size_t)(k0 + kk) * f + i0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBKs; ++kk) {
      float a[kRM], bw[8];
#pragma unroll
      for (int r = 0; r < kRM; ++r) a[r] = xs[kk * kBT + ty * kRM + r];
#pragma unroll
      for (int c = 0; c < 8; ++c) bw[c] = ws[kk * kBI + col_of(tx, c)];
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) a1[r][c] += a[r] * bw[c];
    }
    __syncthreads();
  }

  // 2. h = gelu(x @ W1 + b1) stays in shared memory
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float bias = b1[i0 + col_of(tx, c)];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
      hs[col_of(tx, c) * kBT + ty * kRM + r] = gelu_erf(a1[r][c] + bias);
  }
  __syncthreads();

  // 3. h chunk times W2[i0:i0+kBI, :] -> f32 partial (reuses the W1
  //    stage)
  down_partial_simt(hs, ws, w2, prow, t, t0, h, i0, ch == 0);
  }   // chunks of this split
}

// ---- bf16: tensor cores -------------------------------------------------

constexpr size_t kTcSmem = sizeof(bf16) * (kBT * kLdA + kBK * kLdB +
                                           kBT * kLdH) +
                           sizeof(float) * kBT * kLdC;

__global__ void __launch_bounds__(kThreads)
gelu_partial_tc(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                float* __restrict__ partial, int t, int tpad, int h, int f,
                int cps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);   // [kBT][kLdA]
  bf16* bw = as + kBT * kLdA;                 // [kBK][kLdB]
  bf16* hs = bw + kBK * kLdB;                 // [kBT][kLdH]
  float* cs = reinterpret_cast<float*>(hs + kBT * kLdH);   // [kBT][kLdC]

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;     // 32-row x 32-column tile
  const int t0 = blockIdx.x * kBT;
  const int split = blockIdx.y;
  float* prow = partial + (size_t)split * tpad * h;
  for (int ch = 0; ch < cps; ++ch) {
  const int i0 = (split * cps + ch) * kBI;
  if (i0 >= f) break;

  // 1. x @ W1 for this token tile and F chunk
  FragC a1[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(a1[i][j], 0.f);
  for (int k0 = 0; k0 < h; k0 += kBK) {
    {   // x tile: kBT x kBK = 256 vectors of 8, one per thread
      const int r = tid / (kBK / 8), v = tid % (kBK / 8);
      const int row = t0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row < t)
        val = *reinterpret_cast<const uint4*>(x + (size_t)row * h + k0 +
                                              v * 8);
      *reinterpret_cast<uint4*>(as + r * kLdA + v * 8) = val;
    }
    load_w_tile(bw, w1, f, k0, i0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA a[2];
      FragB b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * 32 + i * 16) * kLdA + kk,
                               kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bw + kk * kLdB + wn * 32 + j * 16,
                               kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(a1[i][j], a[i], b[j], a1[i][j]);
    }
    __syncthreads();
  }

  // 2. h = round(gelu(x @ W1 + b1)): staged as f32 (a fragment's element
  //    layout does not name its column, so the bias is added here), then
  //    rounded to bf16 into the shared h chunk
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kLdC + wn * 32 +
                                  j * 16,
                              a1[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kBT * kBI; e += kThreads) {
    const int r = e / kBI, c = e % kBI;
    hs[r * kLdH + c] =
        pt::from_f<bf16>(gelu_erf(cs[r * kLdC + c] + b1[i0 + c]));
  }
  __syncthreads();

  // 3. h chunk times W2[i0:i0+kBI, :] added into the f32 partial
  //    (reuses the W1 stage)
  down_partial_tc(hs, bw, w2, prow, t0, h, i0, ch == 0);
  }   // chunks of this split
}

template <typename T>
int launch(const void* x, const void* w1, const float* b1, const void* w2,
           const float* b2, void* partial, void* out, int t, int h, int f,
           cudaStream_t stream) {
  const int cps = chunks_per_split(t, f);
  const int splits = splits_of(t, f), tpad = tpad_of(t);
  dim3 grid(tpad / kBT, splits);
  float* part = static_cast<float*>(partial);
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value) {
    e = cudaFuncSetAttribute(gelu_partial_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kTcSmem);
    if (e != cudaSuccess) return (int)e;
    gelu_partial_tc<<<grid, kThreads, kTcSmem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
        static_cast<const bf16*>(w2), part, t, tpad, h, f, cps);
  } else {
    e = cudaFuncSetAttribute(gelu_partial_simt,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSimtSmem);
    if (e != cudaSuccess) return (int)e;
    gelu_partial_simt<<<grid, kThreads, kSimtSmem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), b1,
        static_cast<const float*>(w2), part, t, tpad, h, f, cps);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_splits<T>(part, b2, out, splits, t, h, stream);
  return 0;
}

}  // namespace

// x (t, h); w1 (h, f); b1 (f,) f32; w2 (f, h); b2 (h,) f32 -> out (t, h),
// 16-byte aligned.  `partial` is f32 scratch of
// pt_fused_gelu_mlp_scratch() elements.  Needs h % 128 == 0 and
// f % 128 == 0.
extern "C" int pt_fused_gelu_mlp(const void* x, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, void* partial, void* out,
                                 int t, int h, int f, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  int rc;
  if (dtype == PT_F32) {
    rc = launch<float>(x, w1, fb1, w2, fb2, partial, out, t, h, f, s);
  } else if (dtype == PT_BF16) {
    rc = launch<bf16>(x, w1, fb1, w2, fb2, partial, out, t, h, f, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// f32 scratch elements `pt_fused_gelu_mlp` needs for these sizes.
extern "C" long long pt_fused_gelu_mlp_scratch(int t, int h, int f) {
  return (long long)splits_of(t, f) * tpad_of(t) * h;
}
