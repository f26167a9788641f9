// Fused SwiGLU MLP, (silu(x @ Wg) * (x @ Wu)) @ Wd, for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_mlp.py
// (`fused_swiglu_mlp`, pallas_call at :148).  The numerical contract is
// paddle_tpu/incubate/nn/functional.py `_fused_swiglu_mlp_ref`: gate and
// up accumulate in f32, h = silu(g) * u is rounded to the storage type,
// the down projection accumulates in f32 and is rounded once at the end.
//
// Bound on an H100: at serving token counts (T = 128) the three H x I
// weight matrices are the bytes, ~64 operations per weight byte in bf16,
// so the weight read bounds it.  bf16 runs its products on the tensor
// cores (WMMA, mma.sync 16x16x16, f32 accumulation); f32 runs them on the
// SIMT units so it stays full f32, and is bound by their rate.  The f32
// partials below add 2 * (I/128) * T * H * 4 bytes of traffic, more than
// the bf16 weights at 7B width (PERF.md has the measured times).
//
// Scratch.  One f32 partial per I-split is (Tpad, H); with one split per
// 128-wide I chunk that grows with T (5.8 GB at T = 4096, H = 4096,
// I = 11008).  So the splits are capped at kMaxPartialRows / Tpad, and a
// block then walks several I chunks in order, adding each chunk's product
// into its own partial: the scratch stays at most kMaxPartialRows x H x 4
// bytes (512 MiB at H = 4096).  At serving token counts (Tpad = 128 gives
// 256 splits) every split is still one chunk.
//
// Design.  The TPU kernel carries an f32 (T, H) accumulator across a
// sequential I axis; on the H100 blocks run in parallel with nothing
// carried between them.  So the I axis is split across blocks:
//   pass 1: block (token tile of 64, I split) computes, chunk by chunk
//           of 128, its h chunk into shared memory -- the (T, I)
//           intermediate never goes to device memory -- and multiplies it
//           by that chunk's 128 rows of Wd, adding into its f32 partial
//           (splits, Tpad, H);
//   pass 2: a small kernel sums the partials in a fixed split order and
//           rounds.  No atomics, so the sum order is the same every run.
// The tile geometry, the split plan, the down projection of step 3 and
// pass 2 are csrc/mlp_tiles.cuh, shared with the GELU MLP kernel.
#include "mlp_tiles.cuh"

#include <type_traits>

namespace {

using namespace mlp;

constexpr size_t kSimtSmem =
    sizeof(float) * (kBKs * kBT + 2 * kBKs * kBI + kBI * kBT);

__global__ void __launch_bounds__(kThreads)
swiglu_partial_simt(const float* __restrict__ x, const float* __restrict__ wg,
                    const float* __restrict__ wu,
                    const float* __restrict__ wd,
                    float* __restrict__ partial, int t, int tpad, int h,
                    int inter, int cps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);   // [kBKs][kBT]
  float* gs = xs + kBKs * kBT;                  // [kBKs][kBI]
  float* us = gs + kBKs * kBI;                  // [kBKs][kBI]
  float* hs = us + kBKs * kBI;                  // [kBI][kBT]

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int t0 = blockIdx.x * kBT;
  const int split = blockIdx.y;
  float* prow = partial + (size_t)split * tpad * h;
  for (int ch = 0; ch < cps; ++ch) {
  const int i0 = (split * cps + ch) * kBI;
  if (i0 >= inter) break;

  // 1. gate and up for this token tile and I chunk
  float ag[kRM][8], au[kRM][8];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) ag[r][c] = au[r][c] = 0.f;
  for (int k0 = 0; k0 < h; k0 += kBKs) {
    for (int e = tid; e < kBT * kBKs; e += kThreads) {
      const int r = e / kBKs, kk = e % kBKs;
      const int row = t0 + r;
      xs[kk * kBT + r] = row < t ? x[(size_t)row * h + k0 + kk] : 0.f;
    }
    for (int e = tid; e < kBKs * kBI; e += kThreads) {
      const int kk = e / kBI, c = e % kBI;
      const size_t off = (size_t)(k0 + kk) * inter + i0 + c;
      gs[e] = wg[off];
      us[e] = wu[off];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBKs; ++kk) {
      float a[kRM], bg[8], bu[8];
#pragma unroll
      for (int r = 0; r < kRM; ++r) a[r] = xs[kk * kBT + ty * kRM + r];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        bg[c] = gs[kk * kBI + col_of(tx, c)];
        bu[c] = us[kk * kBI + col_of(tx, c)];
      }
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          ag[r][c] += a[r] * bg[c];
          au[r][c] += a[r] * bu[c];
        }
    }
    __syncthreads();
  }

  // 2. h = silu(g) * u stays in shared memory
#pragma unroll
  for (int r = 0; r < kRM; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float gv = ag[r][c];
      hs[col_of(tx, c) * kBT + ty * kRM + r] = gv / (1.f + expf(-gv)) *
                                                 au[r][c];
    }
  __syncthreads();

  // 3. h chunk times Wd[i0:i0+kBI, :] -> f32 partial (reuses the gate
  //    stage)
  down_partial_simt(hs, gs, wd, prow, t, t0, h, i0, ch == 0);
  }   // chunks of this split
}

// ---- bf16: tensor cores, 8 warps as 2 x 4, each a 32 x 32 tile --------

constexpr size_t kTcSmem = sizeof(bf16) * (kBT * kLdA + 2 * kBK * kLdB +
                                           kBT * kLdH) +
                           sizeof(float) * kBT * kLdC;

__global__ void __launch_bounds__(kThreads)
swiglu_partial_tc(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                  const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                  float* __restrict__ partial, int t, int tpad, int h,
                  int inter, int cps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);   // [kBT][kLdA]
  bf16* bg = as + kBT * kLdA;                 // [kBK][kLdB]
  bf16* bu = bg + kBK * kLdB;                 // [kBK][kLdB]
  bf16* hs = bu + kBK * kLdB;                 // [kBT][kLdH]
  float* cs = reinterpret_cast<float*>(hs + kBT * kLdH);   // [kBT][kLdC]

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;     // 32-row x 32-column tile
  const int t0 = blockIdx.x * kBT;
  const int split = blockIdx.y;
  float* prow = partial + (size_t)split * tpad * h;
  for (int ch = 0; ch < cps; ++ch) {
  const int i0 = (split * cps + ch) * kBI;
  if (i0 >= inter) break;

  // 1. gate and up for this token tile and I chunk
  FragC ag[2][2], au[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(ag[i][j], 0.f);
      wmma::fill_fragment(au[i][j], 0.f);
    }
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
    load_w_tile(bg, wg, inter, k0, i0);
    load_w_tile(bu, wu, inter, k0, i0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA a[2];
      FragB fg[2], fu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * 32 + i * 16) * kLdA + kk,
                               kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fg[j], bg + kk * kLdB + wn * 32 + j * 16,
                               kLdB);
        wmma::load_matrix_sync(fu[j], bu + kk * kLdB + wn * 32 + j * 16,
                               kLdB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(ag[i][j], a[i], fg[j], ag[i][j]);
          wmma::mma_sync(au[i][j], a[i], fu[j], au[i][j]);
        }
    }
    __syncthreads();
  }

  // 2. h = round(silu(g) * u): the two accumulators share one element
  //    layout, so the product is elementwise on the fragments; staged as
  //    f32, then rounded to bf16 into the shared h chunk
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < ag[i][j].num_elements; ++e) {
        const float gv = ag[i][j].x[e];
        ag[i][j].x[e] = gv / (1.f + expf(-gv)) * au[i][j].x[e];
      }
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kLdC + wn * 32 +
                                  j * 16,
                              ag[i][j], kLdC, wmma::mem_row_major);
    }
  __syncthreads();
  for (int e = tid; e < kBT * kBI; e += kThreads) {
    const int r = e / kBI, c = e % kBI;
    hs[r * kLdH + c] = pt::from_f<bf16>(cs[r * kLdC + c]);
  }
  __syncthreads();

  // 3. h chunk times Wd[i0:i0+kBI, :] added into the f32 partial
  //    (reuses the gate stage)
  down_partial_tc(hs, bg, wd, prow, t0, h, i0, ch == 0);
  }   // chunks of this split
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* partial, void* out, int t, int h, int inter,
           cudaStream_t stream) {
  const int cps = chunks_per_split(t, inter);
  const int splits = splits_of(t, inter), tpad = tpad_of(t);
  dim3 grid(tpad / kBT, splits);
  float* part = static_cast<float*>(partial);
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value) {
    e = cudaFuncSetAttribute(swiglu_partial_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kTcSmem);
    if (e != cudaSuccess) return (int)e;
    swiglu_partial_tc<<<grid, kThreads, kTcSmem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
        static_cast<const bf16*>(wu), static_cast<const bf16*>(wd), part, t,
        tpad, h, inter, cps);
  } else {
    e = cudaFuncSetAttribute(swiglu_partial_simt,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSimtSmem);
    if (e != cudaSuccess) return (int)e;
    swiglu_partial_simt<<<grid, kThreads, kSimtSmem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(wg),
        static_cast<const float*>(wu), static_cast<const float*>(wd), part, t,
        tpad, h, inter, cps);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_splits<T>(part, nullptr, out, splits, t, h, stream);
  return 0;
}

}  // namespace

// x (t, h); wg/wu (h, inter); wd (inter, h) -> out (t, h), 16-byte
// aligned.  `partial` is f32 scratch of pt_fused_swiglu_mlp_scratch()
// elements.  Needs h % 128 == 0 and inter % 128 == 0.
extern "C" int pt_fused_swiglu_mlp(const void* x, const void* wg,
                                   const void* wu, const void* wd,
                                   void* partial, void* out, int t, int h,
                                   int inter, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == PT_F32) {
    rc = launch<float>(x, wg, wu, wd, partial, out, t, h, inter, s);
  } else if (dtype == PT_BF16) {
    rc = launch<bf16>(x, wg, wu, wd, partial, out, t, h, inter, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// f32 scratch elements `pt_fused_swiglu_mlp` needs for these sizes.
extern "C" long long pt_fused_swiglu_mlp_scratch(int t, int h, int inter) {
  return (long long)splits_of(t, inter) * tpad_of(t) * h;
}
