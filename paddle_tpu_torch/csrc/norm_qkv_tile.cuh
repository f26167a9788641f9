// Device code of the f32 fused RMSNorm -> Q/K/V -> RoPE kernel, shared by
// fused_norm_qkv.cu (one tile per block) and the f32 decode megakernel in
// mega_decode.cu (tiles as work items of its phase 1; its O-projection
// phase runs the same main loop without the norm).  bf16 runs on wgmma in
// qkv_gemm.cuh.
//
// A tile is BT=64 token rows by HD output columns of one weight matrix.
// `mainloop_simt<HD, NORM>` accumulates (norm(x) or x) @ W[:, col0:col0+HD]
// in f32 into the shared result tile `cs` (row stride kLdc<HD>):
// - NORM: x is normed as it is staged, `x * rstd[row] * g`;
// - !NORM: x is staged as it is.  These rows were written earlier in the
//   same launch by other blocks (mega_decode's attention output), so
//   they are loaded with `__ldcg` (L2, never the non-coherent read-only
//   path) after the grid barrier that orders them.
// The loop runs on the SIMT units so it stays full f32.
#pragma once

#include "common.cuh"

#include <type_traits>

namespace pt_tile {

constexpr int kBT = 64;   // token rows per tile
constexpr int kThreads = 256;

template <int HD>
constexpr int kLdc = HD + 4;   // padded f32 result tile row

// f32 main loop on the SIMT units: each thread owns RM rows x 8 columns
// (four in each half of the tile) of the result tile.
template <int HD, bool NORM>
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
      float xv = 0.f;
      if (row < t) {
        if constexpr (NORM) {
          xv = x[(size_t)row * h + k0 + kk] * rstd[r] * g[k0 + kk];
        } else {
          xv = __ldcg(x + (size_t)row * h + k0 + kk);
        }
      }
      xs[kk * kBT + r] = xv;
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

// Shared memory of one tile: the per-row 1/rms, then the main loop's
// staging area, which the f32 result tile reuses after it.
template <typename T, int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  static_assert(std::is_same<T, float>::value, "the SIMT tile is f32");
  constexpr size_t stage = (size_t)(16 * kBT + 16 * HD) * sizeof(float);
  constexpr size_t tile = (size_t)kBT * kLdc<HD> * sizeof(float);
  return kBT * sizeof(float) + (stage > tile ? stage : tile);
}

// One RMSNorm -> projection -> RoPE tile: token rows [t0, t0 + kBT) of
// head `head` of the concatenation [q heads | k heads | v heads].  All
// kThreads threads of the block take part; `smem` holds smem_bytes().
template <typename T, int HD>
__device__ void qkv_tile(const T* __restrict__ x, const T* __restrict__ g,
                         const T* __restrict__ wq, const T* __restrict__ wk,
                         const T* __restrict__ wv, const T* __restrict__ cos,
                         const T* __restrict__ sin, T* q, T* k, T* v, int t,
                         int h, int nq, int nk, float eps, int t0, int head,
                         unsigned char* smem) {
  constexpr int HALF = HD / 2;
  float* rstd = reinterpret_cast<float*>(smem);            // [kBT]
  unsigned char* stage = smem + kBT * sizeof(float);        // main loop
  float* cs = reinterpret_cast<float*>(stage);  // result tile, after it

  const int tid = threadIdx.x;
  const int heads_q = nq / HD, heads_k = nk / HD;
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
  mainloop_simt<HD, true>(x, g, w, ldw, col0, t, h, t0, rstd, stage, cs);
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

}  // namespace pt_tile
