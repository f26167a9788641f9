// Fused RMSNorm -> Q/K/V projections -> rotate-half RoPE, for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_norm_qkv.py
// (`fused_rms_rope_qkv`, pallas_call at :158).  The numerical contract is
// paddle_tpu/incubate/nn/functional.py `_fused_rms_rope_qkv_ref`:
//   nx = round(x * rsqrt(mean(x^2) + eps) * g)          (f32 math)
//   y  = nx @ W                                          (f32 accumulation)
//   q/k: rope(round(y)) in f32, rounded;  v: round(y)
// where round() is a cast to the storage type.
//
// Bound on an H100: at serving token counts (T = B*C = 128) the kernel
// reads the H x (Nq + 2 Nk) weights once and does 2*T*H*(Nq+2Nk)
// operations, ~64 per weight byte in bf16: below the card's ~295
// operations per byte, so the weight read bounds it.  bf16 runs its
// products on the tensor cores (WMMA, mma.sync 16x16x16 with f32
// accumulation); f32 runs them on the SIMT units so it stays full f32,
// and is bound by their rate.  Neither main loop overlaps its loads with
// its products yet (PERF.md has the measured times against the bound).
//
// Design: one block computes a BT=64 token tile of exactly one head
// (HD columns) of one of q, k, v, so the RoPE pair (j, j +- HD/2) of
// every output column lies in the same block: the f32 result tile is
// staged in shared memory and the epilogue reads both halves from there
// (the TPU kernel's {0,+-1} selector matmuls are a matrix-unit device,
// not part of the contract).  The per-row RMS scale is computed once per
// block into shared memory; the x tile is normed, rounded and staged in
// shared memory as it is read, so x is read from device memory once per
// head and never written back normed.
#include "common.cuh"

#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBT = 64;   // token rows per block
constexpr int kThreads = 256;

template <int HD>
constexpr int kLdc = HD + 4;   // padded f32 result tile row

// f32 main loop on the SIMT units: each thread owns RM rows x 8 columns
// (four in each half of the head) of the result tile.
template <int HD>
__device__ void mainloop_simt(const float* __restrict__ x,
                              const float* __restrict__ g,
                              const float* __restrict__ w, int ldw,
                              int col0, int t, int h, int t0,
                              const float* rstd, unsigned char* stage,
                              float* cs) {
  constexpr int BK = 16;
  constexpr int TX = HD / 8, TY = kThreads / TX, RM = kBT / TY;
  constexpr int HALF = HD / 2;
  float* xs = reinterpret_cast<float*>(stage);   // [BK][kBT], k-major
  float* ws = xs + BK * kBT;                     // [BK][HD]
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  float acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < h; k0 += BK) {
    for (int e = tid; e < kBT * BK; e += kThreads) {
      const int r = e / BK, kk = e % BK;
      const int row = t0 + r;
      xs[kk * kBT + r] =
          row < t ? x[(size_t)row * h + k0 + kk] * rstd[r] * g[k0 + kk]
                  : 0.f;
    }
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int kk = e / HD, c = e % HD;
      ws[kk * HD + c] = w[(size_t)(k0 + kk) * ldw + col0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[RM], b[8];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = xs[kk * kBT + ty * RM + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        b[c] = ws[kk * HD + tx * 4 + c];
        b[4 + c] = ws[kk * HD + HALF + tx * 4 + c];
      }
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] += a[r] * b[c];
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      cs[(ty * RM + r) * kLdc<HD> + tx * 4 + c] = acc[r][c];
      cs[(ty * RM + r) * kLdc<HD> + HALF + tx * 4 + c] = acc[r][4 + c];
    }
}

// bf16 main loop on the tensor cores: 8 warps tile the 64 x HD result;
// the normed, rounded x tile and the weight tile are staged in shared
// memory as bf16, 16-byte vectors at a time.
template <int HD>
__device__ void mainloop_tc(const bf16* __restrict__ x,
                            const bf16* __restrict__ g,
                            const bf16* __restrict__ w, int ldw, int col0,
                            int t, int h, int t0, const float* rstd,
                            unsigned char* stage, float* cs) {
  constexpr int BK = 32, LDA = BK + 8, LDB = HD + 8;
  constexpr int WARPS_N = HD / 32, WARPS_M = 8 / WARPS_N;
  constexpr int FM = kBT / WARPS_M / 16;        // 16-row fragments / warp
  bf16* as = reinterpret_cast<bf16*>(stage);    // [kBT][LDA]
  bf16* bs = as + kBT * LDA;                    // [BK][LDB]
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][2];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < h; k0 += BK) {
    {   // A: kBT x BK = 256 vectors of 8, one per thread
      const int r = tid / (BK / 8), v = tid % (BK / 8);
      const int row = t0 + r;
      alignas(16) bf16 vals[8];
      if (row < t) {
        alignas(16) bf16 xv[8], gv[8];
        *reinterpret_cast<uint4*>(xv) = *reinterpret_cast<const uint4*>(
            x + (size_t)row * h + k0 + v * 8);
        *reinterpret_cast<uint4*>(gv) =
            *reinterpret_cast<const uint4*>(g + k0 + v * 8);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          vals[i] = pt::from_f<bf16>(pt::to_f(xv[i]) * rstd[r] *
                                     pt::to_f(gv[i]));
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) vals[i] = pt::from_f<bf16>(0.f);
      }
      *reinterpret_cast<uint4*>(as + r * LDA + v * 8) =
          *reinterpret_cast<const uint4*>(vals);
    }
    for (int e = tid; e < BK * HD / 8; e += kThreads) {   // B
      const int kk = e / (HD / 8), v = e % (HD / 8);
      *reinterpret_cast<uint4*>(bs + kk * LDB + v * 8) =
          *reinterpret_cast<const uint4*>(w + (size_t)(k0 + kk) * ldw +
                                          col0 + v * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * FM * 16 + i * 16) * LDA + kk,
                               LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          cs + (wm * FM * 16 + i * 16) * kLdc<HD> + wn * 32 + j * 16,
          acc[i][j], kLdc<HD>, wmma::mem_row_major);
}

template <typename T, int HD>
constexpr size_t smem_bytes() {
  constexpr size_t stage = std::is_same<T, bf16>::value
      ? (size_t)(kBT * 40 + 32 * (HD + 8)) * sizeof(bf16)
      : (size_t)(16 * kBT + 16 * HD) * sizeof(float);
  constexpr size_t tile = (size_t)kBT * kLdc<HD> * sizeof(float);
  return kBT * sizeof(float) + (stage > tile ? stage : tile);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fused_rms_rope_qkv_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          const T* __restrict__ wq, const T* __restrict__ wk,
                          const T* __restrict__ wv, const T* __restrict__ cos,
                          const T* __restrict__ sin, T* __restrict__ q,
                          T* __restrict__ k, T* __restrict__ v, int t, int h,
                          int nq, int nk, float eps) {
  constexpr int HALF = HD / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* rstd = reinterpret_cast<float*>(smem);            // [kBT]
  unsigned char* stage = smem + kBT * sizeof(float);        // main loop
  float* cs = reinterpret_cast<float*>(stage);  // result tile, after it

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kBT;
  const int heads_q = nq / HD, heads_k = nk / HD;
  const int head = blockIdx.y;
  const T* w;
  T* out;
  int ldw, col0, kind;                   // kind: 0 q, 1 k, 2 v
  if (head < heads_q) {
    w = wq; out = q; ldw = nq; col0 = head * HD; kind = 0;
  } else if (head < heads_q + heads_k) {
    w = wk; out = k; ldw = nk; col0 = (head - heads_q) * HD; kind = 1;
  } else {
    w = wv; out = v; ldw = nk; col0 = (head - heads_q - heads_k) * HD;
    kind = 2;
  }

  // 1. per-row 1/rms, one warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kBT; r += kThreads / 32) {
    const int row = t0 + r;
    float s = 0.f;
    if (row < t) {
      for (int c = lane; c < h; c += 32) {
        const float xv = pt::to_f(x[(size_t)row * h + c]);
        s += xv * xv;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) rstd[r] = rsqrtf(s / (float)h + eps);
  }
  __syncthreads();

  // 2. normed-x tile times the head's weight columns, f32 accumulation,
  //    into the shared f32 result tile
  if constexpr (std::is_same<T, bf16>::value) {
    mainloop_tc<HD>(x, g, w, ldw, col0, t, h, t0, rstd, stage, cs);
  } else {
    mainloop_simt<HD>(x, g, w, ldw, col0, t, h, t0, rstd, stage, cs);
  }
  __syncthreads();

  // 3. epilogue: round, then rotate-half RoPE on q and k in f32
  for (int e = tid; e < kBT * HALF; e += kThreads) {
    const int r = e / HALF, j = e % HALF;
    const int row = t0 + r;
    if (row >= t) continue;
    const float lo = pt::round_to<T>(cs[r * kLdc<HD> + j]);
    const float hi = pt::round_to<T>(cs[r * kLdc<HD> + HALF + j]);
    T* orow = out + (size_t)row * ldw + col0;
    if (kind == 2) {
      orow[j] = pt::from_f<T>(lo);
      orow[HALF + j] = pt::from_f<T>(hi);
      continue;
    }
    const T* crow = cos + (size_t)row * HD;
    const T* srow = sin + (size_t)row * HD;
    // explicit roundings keep the contract's y*c + rot*s unfused
    const float o_lo = __fadd_rn(__fmul_rn(lo, pt::to_f(crow[j])),
                                 __fmul_rn(-hi, pt::to_f(srow[j])));
    const float o_hi = __fadd_rn(__fmul_rn(hi, pt::to_f(crow[HALF + j])),
                                 __fmul_rn(lo, pt::to_f(srow[HALF + j])));
    orow[j] = pt::from_f<T>(o_lo);
    orow[HALF + j] = pt::from_f<T>(o_hi);
  }
}

template <typename T, int HD>
int launch(const void* x, const void* g, const void* wq, const void* wk,
           const void* wv, const void* cos, const void* sin, void* q,
           void* k, void* v, int t, int h, int nq, int nk, float eps,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD>();
  cudaError_t e = cudaFuncSetAttribute(
      fused_rms_rope_qkv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((t + kBT - 1) / kBT, nq / HD + 2 * (nk / HD));
  fused_rms_rope_qkv_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(wq), static_cast<const T*>(wk),
      static_cast<const T*>(wv), static_cast<const T*>(cos),
      static_cast<const T*>(sin), static_cast<T*>(q), static_cast<T*>(k),
      static_cast<T*>(v), t, h, nq, nk, eps);
  return 0;
}

template <typename T>
int dispatch_hd(const void* x, const void* g, const void* wq, const void* wk,
                const void* wv, const void* cos, const void* sin, void* q,
                void* k, void* v, int t, int h, int nq, int nk, int head_dim,
                float eps, cudaStream_t stream) {
  if (head_dim == 128)
    return launch<T, 128>(x, g, wq, wk, wv, cos, sin, q, k, v, t, h, nq, nk,
                          eps, stream);
  if (head_dim == 64)
    return launch<T, 64>(x, g, wq, wk, wv, cos, sin, q, k, v, t, h, nq, nk,
                         eps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (t, h); g (h,); wq (h, nq); wk/wv (h, nk); cos/sin (t, head_dim)
// -> q (t, nq), k/v (t, nk).  All row-major, all of one dtype, 16-byte
// aligned.  Needs h % 32 == 0, head_dim in {64, 128}, nq and nk
// multiples of it.
extern "C" int pt_fused_rms_rope_qkv(const void* x, const void* g,
                                     const void* wq, const void* wk,
                                     const void* wv, const void* cos,
                                     const void* sin, void* q, void* k,
                                     void* v, int t, int h, int nq, int nk,
                                     int head_dim, float eps, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == PT_F32) {
    rc = dispatch_hd<float>(x, g, wq, wk, wv, cos, sin, q, k, v, t, h, nq,
                            nk, head_dim, eps, s);
  } else if (dtype == PT_BF16) {
    rc = dispatch_hd<bf16>(x, g, wq, wk, wv, cos, sin, q, k, v, t, h, nq,
                           nk, head_dim, eps, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
