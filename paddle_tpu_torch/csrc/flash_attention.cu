// Flash attention forward and backward over (B, S, H, D), for sm_90a.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py
// `_flash_fwd` (pallas_call at :161) and `_flash_bwd` (:412, :458, :488).
// The contract is theirs:
//   forward  s = (q k^T) * scale * log2(e) in f32 (the base-2 domain),
//            causal mask bottom-right aligned (row i sees key j iff
//            j <= i + Sk - Sq), online softmax with exp2, p rounded to the
//            storage type before p v, out = acc / l rounded once, and the
//            per-row lse = m + log2(l) in f32, shape (B, H, Sq);
//   backward p = exp2(s - lse) recomputed, dp = dO v^T,
//            ds = p * (dp - delta) * scale with delta = rowsum(dO o) (the
//            wrapper computes it, minus dlse * log2(e) for the lse
//            variant), dv = p^T dO, dk = ds^T q, dq = ds k, ds and p
//            rounded to the storage type before their products.
// GQA: q head h reads kv head h / (H / Hkv); K and V are never repeated.
// Head dims: any dh <= 256 (the reference's gate), computed at D = 64, 128
// or 256 with the columns past dh zero in shared memory (zeros add nothing
// to a product) and never stored.
//
// Bound on an H100: operations.  At the training shape (B=2, S=2048,
// 32 heads of 128, causal) the forward does ~69 GFLOP against ~67 MB of
// q/k/v/out, ~1000 operations per byte, far above the card's ~295.
//
// Design.  On the TPU the innermost grid axis runs in order and carries
// the running statistics in VMEM; here blocks run in parallel, so that
// axis becomes a loop inside the block:
//   forward: one block per (q tile, head, batch) loops over the k tiles
//            up to the causal diagonal, the running max, sum and the f32
//            output accumulator in shared memory;
//   dK/dV:   one block per (k tile, kv head, batch) loops over the GQA
//            group's q heads and over the q tiles at or below the
//            diagonal, accumulating dk and dv in f32 in shared memory --
//            the group sum happens in the block, with no atomics, so the
//            result is the same on every run;
//   dQ:      one block per (q tile, head, batch) loops over the k tiles.
// This is the split backward; the TPU's merged kernel writes dq as per-k-
// block f32 partials, which suits a sequential grid, not this one.
// Every tile product is one `block_mma`: bf16 on the tensor cores (WMMA
// 16x16x16, f32 accumulation, operands read from shared memory, either
// operand transposed by its fragment layout); f32 on the SIMT units, so it
// stays full f32.  Scores, probabilities and accumulators are staged in
// shared memory between products.
#include "common.cuh"

#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// Tiles for a head dim padded up to D (64, 128 or 256): bf16 tiles are
// 64 x 64 (tensor-core shapes), 32 x 32 at D = 256 so the backward's
// operand tiles fit the 227 KB of shared memory; f32 tiles are 32 x 32.
// PAD (one 16-byte vector) staggers the rows of every shared tile.
template <typename T, int D>
struct Tile {
  static constexpr int BQ = std::is_same<T, bf16>::value && D <= 128 ? 64 : 32;
  static constexpr int BK = BQ, PAD = 16 / sizeof(T);
};
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Shared-memory layout: arrays carved one after another, each rounded up
// to 128 bytes (WMMA wants 32-byte aligned tiles).
struct Carver {
  unsigned char* p;
  template <typename U>
  __device__ U* take(size_t n) {
    U* r = reinterpret_cast<U*>(p);
    p += align128(n * sizeof(U));
    return r;
  }
};

// C (M x N, f32, row stride ldc) = [C +] op(A) (M x K) . op(B) (K x N).
// A is stored (M, K) row-major, or (K, M) when AT; B is stored (K, N)
// row-major, or (N, K) when BT.  Called by every thread of the block.
template <typename T, int M, int N, int K, bool AT, bool BT, bool ACC>
__device__ __forceinline__ void block_mma(float* C, int ldc, const T* A,
                                          int lda, const T* B, int ldb) {
  if constexpr (std::is_same<T, bf16>::value) {
    using LA = typename std::conditional<AT, wmma::col_major,
                                         wmma::row_major>::type;
    using LB = typename std::conditional<BT, wmma::col_major,
                                         wmma::row_major>::type;
    const int warp = threadIdx.x / 32;
    for (int t = warp; t < (M / 16) * (N / 16); t += kWarps) {
      const int i = t / (N / 16) * 16, j = t % (N / 16) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (ACC)
        wmma::load_matrix_sync(c, C + i * ldc + j, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
#pragma unroll 4
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        wmma::load_matrix_sync(a, AT ? A + k * lda + i : A + i * lda + k,
                               lda);
        wmma::load_matrix_sync(b, BT ? B + j * ldb + k : B + k * ldb + j,
                               ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + i * ldc + j, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int e = threadIdx.x; e < M * N; e += kThreads) {
      const int i = e / N, j = e % N;
      float s = ACC ? C[i * ldc + j] : 0.f;
      for (int k = 0; k < K; ++k) {
        const float a = AT ? A[k * lda + i] : A[i * lda + k];
        const float b = BT ? B[j * ldb + k] : B[k * ldb + j];
        s += a * b;
      }
      C[i * ldc + j] = s;
    }
  }
}

// Rows [r0, r0 + R) of head hh of a (B, S, Hn, dh) tensor into shared
// memory [R][D + PAD]; rows >= S and columns >= dh are zeros.  16-byte
// vectors where dh allows them, single elements otherwise.
template <typename T, int R, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          int b, int r0, int S, int Hn,
                                          int hh, int dh) {
  constexpr int V = 16 / sizeof(T), LD = D + Tile<T, D>::PAD;
  if (dh % V == 0) {
    for (int e = threadIdx.x; e < R * (D / V); e += kThreads) {
      const int r = e / (D / V), c = e % (D / V);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < S && c * V < dh)
        val = *reinterpret_cast<const uint4*>(
            src + (((size_t)b * S + r0 + r) * Hn + hh) * dh + c * V);
      *reinterpret_cast<uint4*>(dst + r * LD + c * V) = val;
    }
  } else {
    for (int e = threadIdx.x; e < R * D; e += kThreads) {
      const int r = e / D, c = e % D;
      dst[r * LD + c] =
          r0 + r < S && c < dh
              ? src[(((size_t)b * S + r0 + r) * Hn + hh) * dh + c]
              : pt::from_f<T>(0.f);
    }
  }
}

// Accumulator rows [r0, r0 + R) (f32, stride LO) rounded into head hh of a
// (B, S, Hn, dh) tensor, rows >= S and columns >= dh skipped; `inv` scales
// row r (or null).
template <typename T, int R, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const float* acc, int LO,
                                           const float* inv, int b, int r0,
                                           int S, int Hn, int hh, int dh) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, c = e % D;
    if (r0 + r >= S || c >= dh) continue;
    const float val = inv ? acc[r * LO + c] / inv[r] : acc[r * LO + c];
    dst[(((size_t)b * S + r0 + r) * Hn + hh) * dh + c] = pt::from_f<T>(val);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- forward ---------------------------------------------------------------

template <typename T, int D>
constexpr size_t fwd_smem() {
  constexpr int BQ = Tile<T, D>::BQ, BK = Tile<T, D>::BK, P = Tile<T, D>::PAD;
  return align128(sizeof(T) * BQ * (D + P)) +
         2 * align128(sizeof(T) * BK * (D + P)) +
         align128(sizeof(float) * BQ * (BK + 4)) +
         align128(sizeof(T) * BQ * (BK + P)) +
         align128(sizeof(float) * BQ * (D + 4)) +
         3 * align128(sizeof(float) * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                 int dh, float scale_log2, int causal) {
  constexpr int BQ = Tile<T, D>::BQ, BK = Tile<T, D>::BK, P = Tile<T, D>::PAD;
  constexpr int LD = D + P, LS = BK + 4, LP = BK + P, LO = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* qs = cv.take<T>(BQ * LD);
  T* ks = cv.take<T>(BK * LD);
  T* vs = cv.take<T>(BK * LD);
  float* ss = cv.take<float>(BQ * LS);
  T* ps = cv.take<T>(BQ * LP);
  float* os = cv.take<float>(BQ * LO);
  float* ms = cv.take<float>(BQ);
  float* ls = cv.take<float>(BQ);
  float* safe = cv.take<float>(BQ);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  load_rows<T, BQ, D>(qs, q, b, q0, Sq, H, h, dh);
  for (int e = tid; e < BQ * LO; e += kThreads) os[e] = 0.f;
  for (int r = tid; r < BQ; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }
  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, max(0, (q0 + BQ - 1 + offset) / BK + 1));
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    load_rows<T, BK, D>(ks, k, b, k0, Sk, Hkv, hk, dh);
    load_rows<T, BK, D>(vs, v, b, k0, Sk, Hkv, hk, dh);
    __syncthreads();
    block_mma<T, BQ, BK, D, false, true, false>(ss, LS, qs, LD, ks, LD);
    __syncthreads();
    // online softmax, one warp per row; the warp also rescales its row of
    // the output accumulator
    for (int r = warp; r < BQ; r += kWarps) {
      const int qi = q0 + r;
      float mx = kNegInf;
      for (int j = lane; j < BK; j += 32) {
        const int kj = k0 + j;
        float s = ss[r * LS + j] * scale_log2;
        if (kj >= Sk || (causal && kj > qi + offset)) s = kNegInf;
        ss[r * LS + j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = ms[r], m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = exp2f(ss[r * LS + j] - m_cur);
        ps[r * LP + j] = pt::from_f<T>(p);
        sum += p;
      }
      sum = warp_sum(sum);
      const float alpha = exp2f(m_prev - m_cur);
      for (int c = lane; c < D; c += 32) os[r * LO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        ls[r] = alpha * ls[r] + sum;
        ms[r] = m_cur;
      }
    }
    __syncthreads();
    block_mma<T, BQ, D, BK, false, false, true>(os, LO, ps, LP, vs, LD);
    __syncthreads();
  }

  for (int r = tid; r < BQ; r += kThreads) {
    const float l = ls[r];
    safe[r] = l == 0.f ? 1.f : l;
    if (q0 + r < Sq)
      lse[((size_t)b * H + h) * Sq + q0 + r] = ms[r] + log2f(safe[r]);
  }
  __syncthreads();
  store_rows<T, BQ, D>(out, os, LO, safe, b, q0, Sq, H, h, dh);
}

// ---- backward --------------------------------------------------------------

template <typename T, int D>
constexpr size_t bwd_smem() {
  constexpr int BQ = Tile<T, D>::BQ, BK = Tile<T, D>::BK, P = Tile<T, D>::PAD;
  static_assert(BQ == BK, "dk/dv and dq kernels share one layout");
  return 4 * align128(sizeof(T) * BQ * (D + P)) +      // q, dO, k, v
         2 * align128(sizeof(float) * BQ * (BK + 4)) +  // s, dp
         2 * align128(sizeof(T) * BQ * (BK + P)) +      // p, ds
         2 * align128(sizeof(float) * BK * (D + 4)) +   // two accumulators
         2 * align128(sizeof(float) * BQ);              // lse, delta
}

// s and dp for a (q tile, k tile) pair are in shared memory; writes the
// rounded p and ds, masked entries zero.
template <typename T, int D>
__device__ __forceinline__ void probs_and_ds(
    const float* ss, const float* dps, T* ps, T* dss, const float* lse_s,
    const float* delta_s, int i0, int k0, int Sq, int Sk, int offset,
    int causal, float scale, float scale_log2) {
  constexpr int BQ = Tile<T, D>::BQ, BK = Tile<T, D>::BK;
  constexpr int LS = BK + 4, LP = BK + Tile<T, D>::PAD;
  for (int e = threadIdx.x; e < BQ * BK; e += kThreads) {
    const int r = e / BK, j = e % BK;
    const int qi = i0 + r, kj = k0 + j;
    const bool live = qi < Sq && kj < Sk && !(causal && kj > qi + offset);
    const float p = live ? exp2f(ss[r * LS + j] * scale_log2 - lse_s[r]) : 0.f;
    const float ds = p * (dps[r * LS + j] - delta_s[r]) * scale;
    if (ps) ps[r * LP + j] = pt::from_f<T>(p);
    dss[r * LP + j] = pt::from_f<T>(ds);
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int b, int h, int H, int i0,
                                           int Sq) {
  for (int r = threadIdx.x; r < Tile<T, D>::BQ; r += kThreads) {
    const bool in = i0 + r < Sq;
    const size_t at = ((size_t)b * H + h) * Sq + i0 + r;
    lse_s[r] = in ? lse[at] : 0.f;
    delta_s[r] = in ? delta[at] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                      int dh, float scale, float scale_log2, int causal) {
  constexpr int BQ = Tile<T, D>::BQ, BK = Tile<T, D>::BK, P = Tile<T, D>::PAD;
  constexpr int LD = D + P, LS = BK + 4, LP = BK + P, LO = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* qs = cv.take<T>(BQ * LD);
  T* dos = cv.take<T>(BQ * LD);
  T* ks = cv.take<T>(BK * LD);
  T* vs = cv.take<T>(BK * LD);
  float* ss = cv.take<float>(BQ * LS);
  float* dps = cv.take<float>(BQ * LS);
  T* ps = cv.take<T>(BQ * LP);
  T* dss = cv.take<T>(BQ * LP);
  float* dka = cv.take<float>(BK * LO);
  float* dva = cv.take<float>(BK * LO);
  float* lse_s = cv.take<float>(BQ);
  float* delta_s = cv.take<float>(BQ);

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BK;
  const int G = H / Hkv, offset = Sk - Sq;
  load_rows<T, BK, D>(ks, k, b, k0, Sk, Hkv, hk, dh);
  load_rows<T, BK, D>(vs, v, b, k0, Sk, Hkv, hk, dh);
  for (int e = threadIdx.x; e < BK * LO; e += kThreads) dka[e] = dva[e] = 0.f;
  // first q tile holding a row that sees key k0 (row i sees k0 iff
  // i + offset >= k0)
  const int qt0 = causal ? max(0, k0 - offset) / BQ : 0;
  const int nq = (Sq + BQ - 1) / BQ;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qt = qt0; qt < nq; ++qt) {
      const int i0 = qt * BQ;
      __syncthreads();
      load_rows<T, BQ, D>(qs, q, b, i0, Sq, H, h, dh);
      load_rows<T, BQ, D>(dos, dout, b, i0, Sq, H, h, dh);
      load_stats<T, D>(lse_s, delta_s, lse, delta, b, h, H, i0, Sq);
      __syncthreads();
      block_mma<T, BQ, BK, D, false, true, false>(ss, LS, qs, LD, ks, LD);
      block_mma<T, BQ, BK, D, false, true, false>(dps, LS, dos, LD, vs, LD);
      __syncthreads();
      probs_and_ds<T, D>(ss, dps, ps, dss, lse_s, delta_s, i0, k0, Sq, Sk,
                         offset, causal, scale, scale_log2);
      __syncthreads();
      block_mma<T, BK, D, BQ, true, false, true>(dva, LO, ps, LP, dos, LD);
      block_mma<T, BK, D, BQ, true, false, true>(dka, LO, dss, LP, qs, LD);
    }
  }
  __syncthreads();
  store_rows<T, BK, D>(dk, dka, LO, nullptr, b, k0, Sk, Hkv, hk, dh);
  store_rows<T, BK, D>(dv, dva, LO, nullptr, b, k0, Sk, Hkv, hk, dh);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int Hkv, int dh, float scale,
                    float scale_log2, int causal) {
  constexpr int BQ = Tile<T, D>::BQ, BK = Tile<T, D>::BK, P = Tile<T, D>::PAD;
  constexpr int LD = D + P, LS = BK + 4, LP = BK + P, LO = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* qs = cv.take<T>(BQ * LD);
  T* dos = cv.take<T>(BQ * LD);
  T* ks = cv.take<T>(BK * LD);
  T* vs = cv.take<T>(BK * LD);
  float* ss = cv.take<float>(BQ * LS);
  float* dps = cv.take<float>(BQ * LS);
  cv.take<T>(BQ * LP);   // the p tile of the shared layout, unused here
  T* dss = cv.take<T>(BQ * LP);
  float* dqa = cv.take<float>(BQ * LO);
  cv.take<float>(BK * LO);
  float* lse_s = cv.take<float>(BQ);
  float* delta_s = cv.take<float>(BQ);

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BQ;
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  load_rows<T, BQ, D>(qs, q, b, i0, Sq, H, h, dh);
  load_rows<T, BQ, D>(dos, dout, b, i0, Sq, H, h, dh);
  load_stats<T, D>(lse_s, delta_s, lse, delta, b, h, H, i0, Sq);
  for (int e = threadIdx.x; e < BQ * LO; e += kThreads) dqa[e] = 0.f;
  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, max(0, (i0 + BQ - 1 + offset) / BK + 1));

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_rows<T, BK, D>(ks, k, b, k0, Sk, Hkv, hk, dh);
    load_rows<T, BK, D>(vs, v, b, k0, Sk, Hkv, hk, dh);
    __syncthreads();
    block_mma<T, BQ, BK, D, false, true, false>(ss, LS, qs, LD, ks, LD);
    block_mma<T, BQ, BK, D, false, true, false>(dps, LS, dos, LD, vs, LD);
    __syncthreads();
    probs_and_ds<T, D>(ss, dps, static_cast<T*>(nullptr), dss, lse_s,
                       delta_s, i0, k0, Sq, Sk, offset, causal, scale,
                       scale_log2);
    __syncthreads();
    block_mma<T, BQ, D, BK, false, false, true>(dqa, LO, dss, LP, ks, LD);
  }
  __syncthreads();
  store_rows<T, BQ, D>(dq, dqa, LO, nullptr, b, i0, Sq, H, h, dh);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int B, int Sq, int Sk, int H, int Hkv, int dh, float scale_log2,
        int causal, cudaStream_t s) {
  constexpr size_t smem = fwd_smem<T, D>();
  static_assert(smem <= kMaxSmem, "forward tiles exceed shared memory");
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + Tile<T, D>::BQ - 1) / Tile<T, D>::BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Sk, H, Hkv, dh, scale_log2, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        int B, int Sq, int Sk, int H, int Hkv, int dh, float scale,
        float scale_log2, int causal, cudaStream_t s) {
  constexpr size_t smem = bwd_smem<T, D>();
  static_assert(smem <= kMaxSmem, "backward tiles exceed shared memory");
  cudaError_t e = allow_smem(flash_bwd_dkdv_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* l_ = static_cast<const float*>(lse);
  const float* d_ = static_cast<const float*>(delta);
  dim3 gkv((Sk + Tile<T, D>::BK - 1) / Tile<T, D>::BK, Hkv, B);
  flash_bwd_dkdv_kernel<T, D><<<gkv, kThreads, smem, s>>>(
      q_, k_, v_, do_, l_, d_, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Sk, H, Hkv, dh, scale, scale_log2, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gq((Sq + Tile<T, D>::BQ - 1) / Tile<T, D>::BQ, H, B);
  flash_bwd_dq_kernel<T, D><<<gq, kThreads, smem, s>>>(
      q_, k_, v_, do_, l_, d_, static_cast<T*>(dq), Sq, Sk, H, Hkv, dh,
      scale, scale_log2, causal);
  return (int)cudaGetLastError();
}

// The padded head dim a kernel instance computes at, 0 past 256.
int padded(int dh) {
  return dh <= 0 ? 0 : dh <= 64 ? 64 : dh <= 128 ? 128 : dh <= 256 ? 256 : 0;
}

template <typename T>
int fwd_any(const void* q, const void* k, const void* v, void* out,
            void* lse, int B, int Sq, int Sk, int H, int Hkv, int dh,
            float scale_log2, int causal, cudaStream_t s) {
  switch (padded(dh)) {
    case 64:
      return fwd<T, 64>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, dh, scale_log2,
                        causal, s);
    case 128:
      return fwd<T, 128>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, dh,
                         scale_log2, causal, s);
    case 256:
      return fwd<T, 256>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, dh,
                         scale_log2, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_any(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dq, void* dk, void* dv,
            int B, int Sq, int Sk, int H, int Hkv, int dh, float scale,
            float scale_log2, int causal, cudaStream_t s) {
  switch (padded(dh)) {
    case 64:
      return bwd<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H,
                        Hkv, dh, scale, scale_log2, causal, s);
    case 128:
      return bwd<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H,
                         Hkv, dh, scale, scale_log2, causal, s);
    case 256:
      return bwd<T, 256>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H,
                         Hkv, dh, scale, scale_log2, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, H, D); k/v (B, Sk, Hkv, D) -> out (B, Sq, H, D) in q's type,
// lse (B, H, Sq) f32 (base 2).  0 < D <= 256; H % Hkv == 0; all
// contiguous and 16-byte aligned.  scale_log2 = scale * log2(e).
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int Sq, int Sk,
                            int H, int Hkv, int D, float scale_log2,
                            int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == PT_BF16)
    return fwd_any<bf16>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, D, scale_log2,
                         causal, s);
  if (dtype == PT_F32)
    return fwd_any<float>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, D,
                          scale_log2, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The dK/dV kernel, then the dQ kernel, on one stream.  dout, dq like q;
// dk/dv like k; lse and delta (B, H, Sq) f32.
extern "C" int pt_flash_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, void* dk, void* dv,
                            int B, int Sq, int Sk, int H, int Hkv, int D,
                            float scale, float scale_log2, int causal,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == PT_BF16)
    return bwd_any<bf16>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H,
                         Hkv, D, scale, scale_log2, causal, s);
  if (dtype == PT_F32)
    return bwd_any<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                          H, Hkv, D, scale, scale_log2, causal, s);
  return (int)cudaErrorInvalidValue;
}
