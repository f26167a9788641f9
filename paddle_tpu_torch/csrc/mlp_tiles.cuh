// Device code shared by the fused MLP kernels (csrc/fused_mlp.cu, SwiGLU,
// and csrc/fused_gelu_mlp.cu, GELU): the tile geometry, the split plan
// of the intermediate axis, the down projection of one shared-memory h
// chunk into a split's f32 partial (SIMT for f32, WMMA for bf16) and the
// fixed-order sum of the partials.
//
// Both kernels split the intermediate axis I across blocks: block (token
// tile of kBT, I split) computes its h chunk of kBI columns into shared
// memory, then adds h @ W_down[chunk rows, :] into its own f32 partial
// (splits, Tpad, H); a second pass sums the partials in split order and
// rounds once.  Scratch: the splits are capped at kMaxPartialRows / Tpad
// (a block then walks several chunks in order), so the partials stay at
// most kMaxPartialRows x H x 4 bytes (512 MiB at H = 4096); at serving
// token counts every split is one chunk.
#pragma once

#include "common.cuh"

#include <mma.h>

#include <algorithm>

namespace mlp {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBT = 64;    // token rows per block
constexpr int kBI = 128;   // intermediate columns per chunk
constexpr int kBN = 128;   // output columns per down-projection tile
constexpr int kThreads = 256;
constexpr long long kMaxPartialRows = 32768;   // splits x Tpad, at most

inline int tpad_of(int t) { return (t + kBT - 1) / kBT * kBT; }

// I chunks per split: one while splits x Tpad <= kMaxPartialRows, more
// once T is large.
inline int chunks_per_split(int t, int inter) {
  const long long chunks = inter / kBI;
  const long long max_splits =
      std::max(1LL, kMaxPartialRows / (long long)tpad_of(t));
  return (int)((chunks + max_splits - 1) / max_splits);
}

inline int splits_of(int t, int inter) {
  const int cps = chunks_per_split(t, inter);
  return (inter / kBI + cps - 1) / cps;
}

// ---- f32: SIMT units, 16 x 16 threads, each 4 rows x 8 columns --------

constexpr int kTX = 16, kTY = 16, kRM = kBT / kTY;
constexpr int kBKs = 16;

__device__ __forceinline__ int col_of(int tx, int c) {
  // four columns in each half of a 128-wide tile: conflict-free loads
  return (c < 4) ? tx * 4 + c : 64 + tx * 4 + (c - 4);
}

// h chunk hs [kBI][kBT] times wd[i0:i0+kBI, :] into the split's partial
// rows prow (row stride h), one column tile at a time, through the
// [kBKs][kBN] stage ds; the first chunk of a split starts from zero.
__device__ __forceinline__ void down_partial_simt(
    const float* hs, float* ds, const float* __restrict__ wd, float* prow,
    int t, int t0, int h, int i0, bool first) {
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  for (int n0 = 0; n0 < h; n0 += kBN) {
    float acc[kRM][8];
#pragma unroll
    for (int r = 0; r < kRM; ++r) {
      const int row = t0 + ty * kRM + r;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc[r][c] = (first || row >= t)
                        ? 0.f
                        : prow[(size_t)row * h + n0 + col_of(tx, c)];
    }
    for (int k0 = 0; k0 < kBI; k0 += kBKs) {
      for (int e = tid; e < kBKs * kBN; e += kThreads) {
        const int kk = e / kBN, c = e % kBN;
        ds[e] = wd[(size_t)(i0 + k0 + kk) * h + n0 + c];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBKs; ++kk) {
        float a[kRM], b[8];
#pragma unroll
        for (int r = 0; r < kRM; ++r) a[r] = hs[(k0 + kk) * kBT + ty * kRM + r];
#pragma unroll
        for (int c = 0; c < 8; ++c) b[c] = ds[kk * kBN + col_of(tx, c)];
#pragma unroll
        for (int r = 0; r < kRM; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] += a[r] * b[c];
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kRM; ++r) {
      const int row = t0 + ty * kRM + r;
      if (row >= t) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        prow[(size_t)row * h + n0 + col_of(tx, c)] = acc[r][c];
    }
  }
}

// ---- bf16: tensor cores, 8 warps as 2 x 4, each a 32 x 32 tile --------

constexpr int kBK = 32;
constexpr int kLdA = kBK + 8;     // bf16 rows of the x tile
constexpr int kLdB = kBI + 8;     // bf16 rows of a weight tile (kBI == kBN)
constexpr int kLdH = kBI + 8;     // bf16 rows of the h chunk
constexpr int kLdC = kBI + 4;     // f32 rows of the h staging tile

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// kBK x 128 bf16 weight tile, rows [k0, k0+kBK), into shared memory
__device__ __forceinline__ void load_w_tile(bf16* dst,
                                            const bf16* __restrict__ src,
                                            int ld, int k0, int c0) {
  for (int e = threadIdx.x; e < kBK * kBI / 8; e += kThreads) {
    const int kk = e / (kBI / 8), v = e % (kBI / 8);
    *reinterpret_cast<uint4*>(dst + kk * kLdB + v * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)(k0 + kk) * ld + c0 +
                                        v * 8);
  }
}

// h chunk hs [kBT][kLdH] times wd[i0:i0+kBI, :] added into the split's
// partial prow, straight from the fragments, through the [kBK][kLdB]
// stage bw (the partial has tpad rows, so every tile row exists; the
// first chunk of a split starts from zero).
__device__ __forceinline__ void down_partial_tc(
    const bf16* hs, bf16* bw, const bf16* __restrict__ wd, float* prow,
    int t0, int h, int i0, bool first) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;     // 32-row x 32-column tile
  for (int n0 = 0; n0 < h; n0 += kBN) {
    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (first)
          wmma::fill_fragment(acc[i][j], 0.f);
        else
          wmma::load_matrix_sync(
              acc[i][j],
              prow + (size_t)(t0 + wm * 32 + i * 16) * h + n0 + wn * 32 +
                  j * 16,
              h, wmma::mem_row_major);
      }
    for (int k0 = 0; k0 < kBI; k0 += kBK) {
      load_w_tile(bw, wd, h, i0 + k0, n0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        FragA a[2];
        FragB b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              a[i], hs + (wm * 32 + i * 16) * kLdH + k0 + kk, kLdH);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], bw + kk * kLdB + wn * 32 + j * 16,
                                 kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            prow + (size_t)(t0 + wm * 32 + i * 16) * h + n0 + wn * 32 +
                j * 16,
            acc[i][j], h, wmma::mem_row_major);
  }
  __syncthreads();
}

// ---- pass 2: fixed-order sum of the splits, + bias (if any), rounded ----

template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ bias,
                                  T* __restrict__ out, int splits, int h,
                                  size_t n, size_t stride) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(size_t)p * stride + i];
  if (bias != nullptr) s += bias[i % h];
  out[i] = pt::from_f<T>(s);
}

template <typename T>
void sum_splits(const float* partial, const float* bias, void* out,
                int splits, int t, int h, cudaStream_t stream) {
  const size_t n = (size_t)t * h;
  sum_splits_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      partial, bias, static_cast<T*>(out), splits, h, n,
      (size_t)tpad_of(t) * h);
}

}  // namespace mlp
