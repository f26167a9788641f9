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
// 32 heads of 128, causal) the forward does 68.7 GFLOP against ~67 MB of
// q/k/v/out, ~1000 operations per byte, far above the card's ~295; the
// backward counts 171.9 GFLOP (five products per visible pair).
//
// Blocks.  On the TPU the innermost grid axis runs in order and carries
// the running statistics in VMEM; here blocks run in parallel, so that
// axis becomes a loop inside the block:
//   forward: one block per (q tile, head, batch) loops over the k tiles
//            up to the causal diagonal; q tiles launch in reverse order,
//            so the longest causal rows start first and the short ones
//            fill the tail;
//   dK/dV:   one block per (k tile, kv head, batch) loops over the GQA
//            group's q heads and over the q tiles at or below the
//            diagonal -- the group sum happens in the block, with no
//            atomics, so the result is the same on every run;
//   dQ:      one block per (q tile, head, batch) loops over the k tiles.
// This is the split backward; the TPU's merged kernel writes dq as per-k-
// block f32 partials, which suits a sequential grid, not this one.  The
// split recomputes s and dp in both kernels (7 tile products where the
// bound counts 5), the price of determinism without atomics.
//
// bf16 and f16: Hopper's warpgroup products (sm90.cuh).  A block is two
// warpgroups of 128 threads and owns a 128-row tile (each warpgroup 64
// rows and all D columns of its accumulator); at D = 256 it owns 64 rows
// and each warpgroup half of the accumulator's columns, so that an
// accumulator stays at 64 registers a thread.  What the design does
// about each cost of the WMMA kernel it replaces (every product went
// through shared memory, loads did not overlap compute, 64 x 64 tiles,
// the longest causal tiles ran last, and the split recompute):
//   - products in registers: s = q k^T is a wgmma from two swizzled
//     shared tiles straight into registers; the softmax runs on that
//     accumulator (row max and sum over the quad that holds a row, exp2
//     with scale * log2(e) folded into one fma, the output rescaled in
//     registers); p is rounded to the storage type in registers and is
//     the register A operand of p v, with v read MN-major from its shared
//     tile.  Accumulators leave registers only in the epilogue (through
//     shared memory, 16-byte stores).  The backward does the same with
//     transposed products: the dK/dV kernel computes s^T = k q^T and
//     dp^T = v dO^T, so p^T and ds^T are register A operands of
//     dv += p^T dO and dk += ds^T q with dO and q MN-major; nothing is
//     staged in shared memory;
//   - overlap: the streamed tiles (k and v; or q, dO, lse and delta) move
//     through a 3-stage ring of 16-byte cp.async copies, one tile ahead,
//     with one block barrier per tile.  Inside a warpgroup each step
//     issues tile j's score products and tile j-1's output products
//     together, then runs tile j's softmax (or p and ds) while the tensor
//     cores work; the ring holds tile j-1's operands, tile j's and tile
//     j+1 in flight (a deeper ring alone gained nothing on an H100).  A
//     thread's copies share one column and swizzle, so a 16-byte copy
//     costs two adds: per-copy address arithmetic had been the largest
//     cost outside the products;
//   - tiles: 128-row blocks and 128-wide k tiles in the forward, so a k
//     tile feeds twice the rows per byte from L2 (D = 256: 64-wide k
//     tiles; the dK/dV kernel streams 64-row q tiles, 32 at D = 256, and
//     the dQ kernel 64-row k tiles, to fit registers and shared memory);
//   - the causal tail: q tiles launch in reverse order in the forward and
//     dQ (the dK/dV kernel's first k tiles are already the longest);
//   - masks only on the tiles that hold the diagonal or a ragged edge;
//   - the split backward's recompute stays (7 products for the bound's 5),
//     each product now a wgmma.
// A head dim that is not a multiple of 8 takes synchronous element loads
// into the same tiles (rows of such a tensor are not 16-byte aligned);
// the kernels are otherwise the same.
//
// f32: SIMT kernels of the same structure (32 x 32 tiles, scores and
// accumulators in shared memory), full f32 products; they serve the f32
// card-against-CPU checks.
#include "common.cuh"
#include "sm90.cuh"

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---- f32: SIMT kernels ------------------------------------------------------

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
// f32 tiles are 32 x 32; PAD (one 16-byte vector) staggers the rows.
constexpr int kBQ = 32, kBK = 32, kPad = 4;

// Shared-memory layout: arrays carved one after another, each rounded up
// to 128 bytes.
struct Carver {
  unsigned char* p;
  template <typename U>
  __device__ U* take(size_t n) {
    U* r = reinterpret_cast<U*>(p);
    p += align128(n * sizeof(U));
    return r;
  }
};

// C (M x N, row stride ldc) = [C +] op(A) (M x K) . op(B) (K x N).
// A is stored (M, K) row-major, or (K, M) when AT; B is stored (K, N)
// row-major, or (N, K) when BT.  Called by every thread of the block.
template <int M, int N, int K, bool AT, bool BT, bool ACC>
__device__ __forceinline__ void block_mma(float* C, int ldc, const float* A,
                                          int lda, const float* B, int ldb) {
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

// Rows [r0, r0 + R) of head hh of a (B, S, Hn, dh) tensor into shared
// memory [R][D + kPad]; rows >= S and columns >= dh are zeros.  16-byte
// vectors where dh allows them, single elements otherwise.
template <int R, int D>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int b, int r0, int S, int Hn,
                                          int hh, int dh) {
  constexpr int V = 4, LD = D + kPad;
  if (dh % V == 0) {
    for (int e = threadIdx.x; e < R * (D / V); e += kThreads) {
      const int r = e / (D / V), c = e % (D / V);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < S && c * V < dh)
        val = *reinterpret_cast<const float4*>(
            src + (((size_t)b * S + r0 + r) * Hn + hh) * dh + c * V);
      *reinterpret_cast<float4*>(dst + r * LD + c * V) = val;
    }
  } else {
    for (int e = threadIdx.x; e < R * D; e += kThreads) {
      const int r = e / D, c = e % D;
      dst[r * LD + c] = r0 + r < S && c < dh
                            ? src[(((size_t)b * S + r0 + r) * Hn + hh) * dh + c]
                            : 0.f;
    }
  }
}

// Accumulator rows [r0, r0 + R) (stride LO) into head hh of a
// (B, S, Hn, dh) tensor, rows >= S and columns >= dh skipped; `inv`
// divides row r (or null).
template <int R, int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float* acc, int LO,
                                           const float* inv, int b, int r0,
                                           int S, int Hn, int hh, int dh) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, c = e % D;
    if (r0 + r >= S || c >= dh) continue;
    const float val = inv ? acc[r * LO + c] / inv[r] : acc[r * LO + c];
    dst[(((size_t)b * S + r0 + r) * Hn + hh) * dh + c] = val;
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

template <int D>
constexpr size_t fwd_smem32() {
  return align128(4 * kBQ * (D + kPad)) + 2 * align128(4 * kBK * (D + kPad)) +
         2 * align128(4 * kBQ * (kBK + 4)) + align128(4 * kBQ * (D + 4)) +
         3 * align128(4 * kBQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                   int dh, float scale_log2, int causal) {
  constexpr int LD = D + kPad, LS = kBK + 4, LO = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* qs = cv.take<float>(kBQ * LD);
  float* ks = cv.take<float>(kBK * LD);
  float* vs = cv.take<float>(kBK * LD);
  float* ss = cv.take<float>(kBQ * LS);
  float* ps = cv.take<float>(kBQ * LS);
  float* os = cv.take<float>(kBQ * LO);
  float* ms = cv.take<float>(kBQ);
  float* ls = cv.take<float>(kBQ);
  float* safe = cv.take<float>(kBQ);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  load_rows<kBQ, D>(qs, q, b, q0, Sq, H, h, dh);
  for (int e = tid; e < kBQ * LO; e += kThreads) os[e] = 0.f;
  for (int r = tid; r < kBQ; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }
  int nk = (Sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, max(0, (q0 + kBQ - 1 + offset) / kBK + 1));
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    load_rows<kBK, D>(ks, k, b, k0, Sk, Hkv, hk, dh);
    load_rows<kBK, D>(vs, v, b, k0, Sk, Hkv, hk, dh);
    __syncthreads();
    block_mma<kBQ, kBK, D, false, true, false>(ss, LS, qs, LD, ks, LD);
    __syncthreads();
    // online softmax, one warp per row; the warp also rescales its row of
    // the output accumulator
    for (int r = warp; r < kBQ; r += kWarps) {
      const int qi = q0 + r;
      float mx = kNegInf;
      for (int j = lane; j < kBK; j += 32) {
        const int kj = k0 + j;
        float s = ss[r * LS + j] * scale_log2;
        if (kj >= Sk || (causal && kj > qi + offset)) s = kNegInf;
        ss[r * LS + j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = ms[r], m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kBK; j += 32) {
        const float p = exp2f(ss[r * LS + j] - m_cur);
        ps[r * LS + j] = p;
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
    block_mma<kBQ, D, kBK, false, false, true>(os, LO, ps, LS, vs, LD);
    __syncthreads();
  }

  for (int r = tid; r < kBQ; r += kThreads) {
    const float l = ls[r];
    safe[r] = l == 0.f ? 1.f : l;
    if (q0 + r < Sq)
      lse[((size_t)b * H + h) * Sq + q0 + r] = ms[r] + log2f(safe[r]);
  }
  __syncthreads();
  store_rows<kBQ, D>(out, os, LO, safe, b, q0, Sq, H, h, dh);
}

template <int D>
constexpr size_t bwd_smem32() {
  return 4 * align128(4 * kBQ * (D + kPad)) +   // q, dO, k, v
         4 * align128(4 * kBQ * (kBK + 4)) +    // s, dp, p, ds
         2 * align128(4 * kBK * (D + 4)) +      // two accumulators
         2 * align128(4 * kBQ);                 // lse, delta
}

// s and dp for a (q tile, k tile) pair are in shared memory; writes p and
// ds, masked entries zero.
__device__ __forceinline__ void probs_and_ds(
    const float* ss, const float* dps, float* ps, float* dss,
    const float* lse_s, const float* delta_s, int i0, int k0, int Sq, int Sk,
    int offset, int causal, float scale, float scale_log2) {
  constexpr int LS = kBK + 4;
  for (int e = threadIdx.x; e < kBQ * kBK; e += kThreads) {
    const int r = e / kBK, j = e % kBK;
    const int qi = i0 + r, kj = k0 + j;
    const bool live = qi < Sq && kj < Sk && !(causal && kj > qi + offset);
    const float p = live ? exp2f(ss[r * LS + j] * scale_log2 - lse_s[r]) : 0.f;
    if (ps) ps[r * LS + j] = p;
    dss[r * LS + j] = p * (dps[r * LS + j] - delta_s[r]) * scale;
  }
}

__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int b, int h, int H, int i0,
                                           int Sq) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = i0 + r < Sq;
    const size_t at = ((size_t)b * H + h) * Sq + i0 + r;
    lse_s[r] = in ? lse[at] : 0.f;
    delta_s[r] = in ? delta[at] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int Sq,
                        int Sk, int H, int Hkv, int dh, float scale,
                        float scale_log2, int causal) {
  constexpr int LD = D + kPad, LS = kBK + 4, LO = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* qs = cv.take<float>(kBQ * LD);
  float* dos = cv.take<float>(kBQ * LD);
  float* ks = cv.take<float>(kBK * LD);
  float* vs = cv.take<float>(kBK * LD);
  float* ss = cv.take<float>(kBQ * LS);
  float* dps = cv.take<float>(kBQ * LS);
  float* ps = cv.take<float>(kBQ * LS);
  float* dss = cv.take<float>(kBQ * LS);
  float* dka = cv.take<float>(kBK * LO);
  float* dva = cv.take<float>(kBK * LO);
  float* lse_s = cv.take<float>(kBQ);
  float* delta_s = cv.take<float>(kBQ);

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kBK;
  const int G = H / Hkv, offset = Sk - Sq;
  load_rows<kBK, D>(ks, k, b, k0, Sk, Hkv, hk, dh);
  load_rows<kBK, D>(vs, v, b, k0, Sk, Hkv, hk, dh);
  for (int e = threadIdx.x; e < kBK * LO; e += kThreads) dka[e] = dva[e] = 0.f;
  // first q tile holding a row that sees key k0 (row i sees k0 iff
  // i + offset >= k0)
  const int qt0 = causal ? max(0, k0 - offset) / kBQ : 0;
  const int nq = (Sq + kBQ - 1) / kBQ;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qt = qt0; qt < nq; ++qt) {
      const int i0 = qt * kBQ;
      __syncthreads();
      load_rows<kBQ, D>(qs, q, b, i0, Sq, H, h, dh);
      load_rows<kBQ, D>(dos, dout, b, i0, Sq, H, h, dh);
      load_stats(lse_s, delta_s, lse, delta, b, h, H, i0, Sq);
      __syncthreads();
      block_mma<kBQ, kBK, D, false, true, false>(ss, LS, qs, LD, ks, LD);
      block_mma<kBQ, kBK, D, false, true, false>(dps, LS, dos, LD, vs, LD);
      __syncthreads();
      probs_and_ds(ss, dps, ps, dss, lse_s, delta_s, i0, k0, Sq, Sk, offset,
                   causal, scale, scale_log2);
      __syncthreads();
      block_mma<kBK, D, kBQ, true, false, true>(dva, LO, ps, LS, dos, LD);
      block_mma<kBK, D, kBQ, true, false, true>(dka, LO, dss, LS, qs, LD);
    }
  }
  __syncthreads();
  store_rows<kBK, D>(dk, dka, LO, nullptr, b, k0, Sk, Hkv, hk, dh);
  store_rows<kBK, D>(dv, dva, LO, nullptr, b, k0, Sk, Hkv, hk, dh);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dq, int Sq, int Sk, int H, int Hkv,
                      int dh, float scale, float scale_log2, int causal) {
  constexpr int LD = D + kPad, LS = kBK + 4, LO = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* qs = cv.take<float>(kBQ * LD);
  float* dos = cv.take<float>(kBQ * LD);
  float* ks = cv.take<float>(kBK * LD);
  float* vs = cv.take<float>(kBK * LD);
  float* ss = cv.take<float>(kBQ * LS);
  float* dps = cv.take<float>(kBQ * LS);
  cv.take<float>(kBQ * LS);   // the p tile of the shared layout, unused here
  float* dss = cv.take<float>(kBQ * LS);
  float* dqa = cv.take<float>(kBQ * LO);
  cv.take<float>(kBK * LO);
  float* lse_s = cv.take<float>(kBQ);
  float* delta_s = cv.take<float>(kBQ);

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kBQ;
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  load_rows<kBQ, D>(qs, q, b, i0, Sq, H, h, dh);
  load_rows<kBQ, D>(dos, dout, b, i0, Sq, H, h, dh);
  load_stats(lse_s, delta_s, lse, delta, b, h, H, i0, Sq);
  for (int e = threadIdx.x; e < kBQ * LO; e += kThreads) dqa[e] = 0.f;
  int nk = (Sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, max(0, (i0 + kBQ - 1 + offset) / kBK + 1));

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_rows<kBK, D>(ks, k, b, k0, Sk, Hkv, hk, dh);
    load_rows<kBK, D>(vs, v, b, k0, Sk, Hkv, hk, dh);
    __syncthreads();
    block_mma<kBQ, kBK, D, false, true, false>(ss, LS, qs, LD, ks, LD);
    block_mma<kBQ, kBK, D, false, true, false>(dps, LS, dos, LD, vs, LD);
    __syncthreads();
    probs_and_ds(ss, dps, nullptr, dss, lse_s, delta_s, i0, k0, Sq, Sk,
                 offset, causal, scale, scale_log2);
    __syncthreads();
    block_mma<kBQ, D, kBK, false, false, true>(dqa, LO, dss, LS, ks, LD);
  }
  __syncthreads();
  store_rows<kBQ, D>(dq, dqa, LO, nullptr, b, i0, Sq, H, h, dh);
}

template <int D>
int fwd32(const float* q, const float* k, const float* v, float* out,
          float* lse, int B, int Sq, int Sk, int H, int Hkv, int dh,
          float scale_log2, int causal, cudaStream_t s) {
  constexpr size_t smem = fwd_smem32<D>();
  static_assert(smem <= kMaxSmem, "forward tiles exceed shared memory");
  cudaError_t e = allow_smem(flash_fwd32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd32_kernel<D><<<grid, kThreads, smem, s>>>(
      q, k, v, out, lse, Sq, Sk, H, Hkv, dh, scale_log2, causal);
  return (int)cudaGetLastError();
}

template <int D>
int bwd32(const float* q, const float* k, const float* v, const float* dout,
          const float* lse, const float* delta, float* dq, float* dk,
          float* dv, int B, int Sq, int Sk, int H, int Hkv, int dh,
          float scale, float scale_log2, int causal, cudaStream_t s) {
  constexpr size_t smem = bwd_smem32<D>();
  static_assert(smem <= kMaxSmem, "backward tiles exceed shared memory");
  cudaError_t e = allow_smem(flash_bwd_dkdv32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_bwd_dq32_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 gkv((Sk + kBK - 1) / kBK, Hkv, B);
  flash_bwd_dkdv32_kernel<D><<<gkv, kThreads, smem, s>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, Hkv, dh, scale,
      scale_log2, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gq((Sq + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq32_kernel<D><<<gq, kThreads, smem, s>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, H, Hkv, dh, scale, scale_log2,
      causal);
  return (int)cudaGetLastError();
}

// ---- bf16 and f16: warpgroup kernels ----------------------------------------

constexpr int kWgThreads = 256;  // two warpgroups
// Ring depth of the streamed tiles: the pipelined loops keep tile j-1's
// operands, tile j's and tile j+1 in flight.
constexpr int kRing = 3;

// Tiles for a head dim padded to D.  At D = 256 both warpgroups take the
// same 64 rows, each DW = 128 of the accumulator's columns (an
// accumulator of 64 x 256 would take 128 registers a thread); else each
// takes 64 rows of a 128-row tile with all D columns.
template <int D>
struct Geo {
  static constexpr int SPLIT = D == 256 ? 2 : 1;
  static constexpr int DW = D / SPLIT;       // accumulator columns
  static constexpr int ROWS = 128 / SPLIT;   // rows a block owns
  static constexpr int BKF = D == 256 ? 64 : 128;  // forward k tile
  static constexpr int BI = D == 256 ? 32 : 64;  // q tile of dK/dV
  static constexpr int BKQ = 64;                  // k tile of dQ
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (sm90::smem_addr(p) & 1023u)) & 1023u);
}

// Rows [r0, r0 + R) of head hh of a (B, S, Hn, dh) tensor into the
// swizzled R x D tile at `tile` (shared address `at`); rows >= S and
// columns >= dh are zeros.  16-byte cp.async copies when dh is a multiple
// of 8 (the caller commits and waits), else synchronous element loads.
// A thread's 16-byte chunks share one column and lie RSTEP rows apart,
// RSTEP a multiple of 8, so they share one swizzle: the per-chunk work is
// two adds and a bounds test.
template <typename T, int R, int D>
__device__ __forceinline__ void load_tile(unsigned char* tile, uint32_t at,
                                          const T* __restrict__ src, int b,
                                          int r0, int S, int Hn, int hh,
                                          int dh) {
  if (dh % 8 == 0) {
    constexpr int CPR = D / 8, RSTEP = kWgThreads / CPR;
    static_assert(RSTEP % 8 == 0 && R % RSTEP == 0, "chunk walk");
    const int c = threadIdx.x % CPR * 8, rb = threadIdx.x / CPR;
    const size_t ld = (size_t)Hn * dh;
    const T* p = src + ((size_t)b * S * Hn + hh) * dh + c + (r0 + rb) * ld;
    const uint32_t d = at + sm90::swz<R>(rb, c);
#pragma unroll
    for (int i = 0; i < R / RSTEP; ++i) {
      const bool in = c < dh && r0 + rb + i * RSTEP < S;
      sm90::cp_async16(d + i * RSTEP * 128, in ? p + i * RSTEP * ld : src,
                       in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < R * D; e += kWgThreads) {
      const int r = e / D, c = e % D;
      *reinterpret_cast<T*>(tile + sm90::swz<R>(r, c)) =
          r0 + r < S && c < dh
              ? src[(((size_t)b * S + r0 + r) * Hn + hh) * dh + c]
              : pt::from_f<T>(0.f);
    }
  }
}

// lse and delta of rows [i0, i0 + BQ) from offset `base` of the (B, H, Sq)
// arrays into BQ-float shared arrays, zero past Sq (4-byte cp.async).
template <int BQ>
__device__ __forceinline__ void load_stats16(uint32_t at_l, uint32_t at_d,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta,
                                             size_t base, int i0, int Sq) {
  const int t = threadIdx.x;
  if (t < 2 * BQ) {
    const int r = t % BQ;
    const bool in = i0 + r < Sq;
    const float* src = (t < BQ ? lse : delta) + (in ? base + i0 + r : 0);
    sm90::cp_async4((t < BQ ? at_l : at_d) + 4 * r, src, in ? 4 : 0);
  }
}

// A warpgroup's accumulator (64 rows from r0, DW columns from c0),
// rounded to T, into the swizzled R-row tile at `tile`.
template <typename T, int R, int DW>
__device__ __forceinline__ void stage_acc(unsigned char* tile,
                                          const float (&acc)[DW / 2], int r0,
                                          int c0) {
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 16 * warp + lane / 4 + 8 * i;
      const int c = c0 + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(tile + sm90::swz<R>(r, c)) =
          sm90::pack2<T>(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
}

// The swizzled R x D tile at `tile` into rows [r0, r0 + R) of head hh of
// a (B, S, Hn, dh) tensor, rows >= S and columns >= dh skipped.
template <typename T, int R, int D>
__device__ __forceinline__ void store_tile(T* __restrict__ dst,
                                           const unsigned char* tile, int b,
                                           int r0, int S, int Hn, int hh,
                                           int dh) {
  if (dh % 8 == 0) {
    for (int e = threadIdx.x; e < R * (D / 8); e += kWgThreads) {
      const int r = e / (D / 8), c = e % (D / 8) * 8;
      if (r0 + r < S && c < dh)
        *reinterpret_cast<uint4*>(
            dst + (((size_t)b * S + r0 + r) * Hn + hh) * dh + c) =
            *reinterpret_cast<const uint4*>(tile + sm90::swz<R>(r, c));
    }
  } else {
    for (int e = threadIdx.x; e < R * D; e += kWgThreads) {
      const int r = e / D, c = e % D;
      if (r0 + r < S && c < dh)
        dst[(((size_t)b * S + r0 + r) * Hn + hh) * dh + c] =
            *reinterpret_cast<const T*>(tile + sm90::swz<R>(r, c));
    }
  }
}

// The A fragments of a 64 x (2 N) accumulator over its columns, rounded
// to T (sm90.cuh gives the layout).
template <typename T, int N>
__device__ __forceinline__ void to_frags(const float (&s)[N],
                                         uint32_t (&f)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f[kk][r] = sm90::pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Waits until at most N of this thread's copy groups are in flight, makes
// the landed tiles visible to wgmma, and (a block barrier) releases the
// ring slots every warpgroup has finished reading.
template <int N>
__device__ __forceinline__ void tile_barrier() {
  sm90::cp_async_wait<N>();
  sm90::fence_proxy_async();
  __syncthreads();
}

template <typename T, int D>
constexpr size_t fwd_smem16() {
  return 1024 + (size_t)2 * Geo<D>::ROWS * D +
         (size_t)2 * kRing * 2 * Geo<D>::BKF * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                   int dh, float scale_log2, int causal) {
  using G = Geo<D>;
  constexpr int ROWS = G::ROWS, DW = G::DW, BK = G::BKF, ST = kRing;
  constexpr uint32_t QB = 2 * ROWS * D, KB = 2 * BK * D;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t sQ = sm90::smem_addr(sm), sK = sQ + QB,
                 sV = sK + ST * KB;

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4,
            lane = threadIdx.x % 32;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // longest tiles first
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  const int rw = G::SPLIT == 1 ? 64 * wg : 0;   // warpgroup's rows
  const int cw = G::SPLIT == 1 ? 0 : DW * wg;   // its accumulator columns
  const int row0 = q0 + rw + 16 * warp + lane / 4;  // rows row0, row0 + 8
  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, max(0, (q0 + ROWS - 1 + offset) / BK + 1));

  auto load_kv = [&](int kt) {
    const int slot = kt % ST;
    load_tile<T, BK, D>(sm + QB + slot * KB, sK + slot * KB, k, b, kt * BK,
                        Sk, Hkv, hk, dh);
    load_tile<T, BK, D>(sm + QB + (ST + slot) * KB, sV + slot * KB, v,
                        b, kt * BK, Sk, Hkv, hk, dh);
  };
  // s = q k^T of k tile kt, issued (not committed)
  auto scores = [&](int kt, float (&acc)[BK / 2]) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::mma_ss<T, BK>(acc, sm90::desc_k<ROWS>(sQ, rw, kk),
                          sm90::desc_k<BK>(sK + kt % ST * KB, 0, kk), kk);
  };
  // o += p v of k tile kt, issued (not committed)
  auto pv = [&](int kt, float (&acc)[DW / 2],
                const uint32_t (&frags)[BK / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::mma_rs<T, DW>(acc, frags[kk],
                          sm90::desc_mn<BK>(sV + kt % ST * KB, cw, kk), 1);
  };
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  // online softmax of k tile kt's scores in place: s becomes p, (m, l)
  // move on, alpha rescales the output accumulated so far; the 4 threads
  // of a quad hold one row
  auto softmax = [&](int kt, float (&p)[BK / 2]) {
    const int k0 = kt * BK;
    // the causal diagonal and the ragged edge (-inf: exp2 gives 0)
    if (k0 + BK > Sk ||
        (causal && k0 + BK - 1 > q0 + rw + 16 * warp + offset)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kj = k0 + 8 * j + 2 * (lane % 4) + e;
            if (kj >= Sk || (causal && kj > row0 + 8 * i + offset))
              p[4 * j + 2 * i + e] = -INFINITY;
          }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(p[4 * j + 2 * i], p[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * scale_log2);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = sm90::exp2_approx(m[i] - base);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = p[4 * j + 2 * i + e];
          x = sm90::exp2_approx(fmaf(x, scale_log2, -base));
          sum += x;
        }
      l[i] = l[i] * alpha[i] + sum;
    }
  };

  // k/v tiles 0 and 1 in flight, then tile 0's scores and probabilities
  load_tile<T, ROWS, D>(sm, sQ, q, b, q0, Sq, H, h, dh);
  load_kv(0);
  sm90::cp_async_commit();
  if (nk > 1) load_kv(1);
  sm90::cp_async_commit();
  float o[DW / 2], s[BK / 2];
  uint32_t pf[BK / 16][4];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) o[i] = 0.f;
  tile_barrier<1>();  // tile 0 (tile 1 may still be in flight)
  sm90::wgmma_fence();
  scores(0, s);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  softmax(0, s);
  to_frags<T, BK / 2>(s, pf);

  // Each step issues tile kt's scores and tile kt-1's p v, then runs tile
  // kt's softmax while the tensor cores work.
  for (int kt = 1; kt < nk; ++kt) {
    tile_barrier<0>();
    if (kt + 1 < nk) load_kv(kt + 1);
    sm90::cp_async_commit();
    sm90::wgmma_fence();
    scores(kt, s);
    sm90::wgmma_commit();
    pv(kt - 1, o, pf);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // the scores; p v may still run
    sm90::fence_regs(s);
    softmax(kt, s);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::keep_regs(pf);
#pragma unroll
    for (int j = 0; j < DW / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * j + 2 * i] *= alpha[i];
        o[4 * j + 2 * i + 1] *= alpha[i];
      }
    to_frags<T, BK / 2>(s, pf);
  }
  sm90::wgmma_fence();
  pv(nk - 1, o, pf);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  sm90::keep_regs(pf);

  // a row's sum over its quad; out = acc / l, lse = m + log2(l)
  float safe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    safe[i] = l[i] == 0.f ? 1.f : l[i];
    if (cw == 0 && lane % 4 == 0 && row0 + 8 * i < Sq)
      lse[((size_t)b * H + h) * Sq + row0 + 8 * i] = m[i] + log2f(safe[i]);
  }
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[4 * j + 2 * i] = o[4 * j + 2 * i] / safe[i];
      o[4 * j + 2 * i + 1] = o[4 * j + 2 * i + 1] / safe[i];
    }
  __syncthreads();  // every warpgroup is done with the q tile
  stage_acc<T, ROWS, DW>(sm, o, rw, cw);
  __syncthreads();
  store_tile<T, ROWS, D>(out, sm, b, q0, Sq, H, h, dh);
}

template <typename T, int D>
constexpr size_t dkdv_smem16() {
  // k, v; rings of q, dO, lse and delta
  return 1024 + (size_t)2 * 2 * Geo<D>::ROWS * D +
         (size_t)kRing * (2 * 2 * Geo<D>::BI * D + 2 * 4 * Geo<D>::BI);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dkdv16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                    int dh, float scale, float scale_log2, int causal) {
  using G = Geo<D>;
  constexpr int ROWS = G::ROWS, DW = G::DW, BQ = G::BI;
  constexpr uint32_t KB = 2 * ROWS * D, QB = 2 * BQ * D, SB = 4 * BQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  // k, v; q tile it (and its dO, lse, delta) in ring slot it % kRing
  const uint32_t oQ = 2 * KB, oO = oQ + kRing * QB, oL = oO + kRing * QB,
                 oD = oL + kRing * SB;
  const uint32_t sK = sm90::smem_addr(sm), sV = sK + KB, sQ = sK + oQ,
                 sO = sK + oO, sL = sK + oL, sD = sK + oD;

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4,
            lane = threadIdx.x % 32;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int group = H / Hkv, offset = Sk - Sq;
  const int rw = G::SPLIT == 1 ? 64 * wg : 0, cw = G::SPLIT == 1 ? 0 : DW * wg;
  const int key0 = k0 + rw + 16 * warp + lane / 4;  // keys key0, key0 + 8
  const int kw = k0 + rw + 16 * warp;               // the warp's first key
  // first q tile holding a row that sees key k0 (row i sees k0 iff
  // i + offset >= k0); each q head of the group walks [qt0, nq)
  const int qt0 = causal ? max(0, k0 - offset) / BQ : 0;
  const int per = (Sq + BQ - 1) / BQ - qt0, n_it = group * per;

  auto load_q = [&](int it) {
    const int slot = it % kRing, h = hk * group + it / per;
    const int i0 = (qt0 + it % per) * BQ;
    load_tile<T, BQ, D>(sm + oQ + slot * QB, sQ + slot * QB, q, b, i0, Sq, H,
                        h, dh);
    load_tile<T, BQ, D>(sm + oO + slot * QB, sO + slot * QB, dout, b, i0, Sq,
                        H, h, dh);
    load_stats16<BQ>(sL + slot * SB, sD + slot * SB, lse, delta,
                     ((size_t)b * H + h) * Sq, i0, Sq);
  };
  // s^T = k q^T and dp^T = v dO^T of q tile it (keys are rows, queries
  // columns), issued (not committed)
  auto products = [&](int it, float (&st)[BQ / 2], float (&dpt)[BQ / 2]) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::mma_ss<T, BQ>(st, sm90::desc_k<ROWS>(sK, rw, kk),
                          sm90::desc_k<BQ>(sQ + it % kRing * QB, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::mma_ss<T, BQ>(dpt, sm90::desc_k<ROWS>(sV, rw, kk),
                          sm90::desc_k<BQ>(sO + it % kRing * QB, 0, kk), kk);
  };
  float dka[DW / 2], dva[DW / 2];
  // dv += p^T dO and dk += ds^T q of q tile it (dO and q MN-major), issued
  auto grad_products = [&](int it, const uint32_t (&pf)[BQ / 16][4],
                           const uint32_t (&dsf)[BQ / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      sm90::mma_rs<T, DW>(dva, pf[kk],
                          sm90::desc_mn<BQ>(sO + it % kRing * QB, cw, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      sm90::mma_rs<T, DW>(dka, dsf[kk],
                          sm90::desc_mn<BQ>(sQ + it % kRing * QB, cw, kk), 1);
  };
  // p^T and ds^T of q tile it, in place of s^T and dp^T
  auto grads = [&](int it, float (&st)[BQ / 2], float (&dpt)[BQ / 2]) {
    const int i0 = (qt0 + it % per) * BQ;
    const float* ls = reinterpret_cast<const float*>(sm + oL + it % kRing * SB);
    const float* ds = reinterpret_cast<const float*>(sm + oD + it % kRing * SB);
    const bool edge = i0 + BQ > Sq || kw + 15 >= Sk ||
                      (causal && kw + 15 > i0 + offset);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * (lane % 4) + e, qi = i0 + col;
        const float lv = ls[col], dl = ds[col];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i + e, kj = key0 + 8 * i;
          float p = sm90::exp2_approx(fmaf(st[x], scale_log2, -lv));
          if (edge && (qi >= Sq || kj >= Sk || (causal && kj > qi + offset)))
            p = 0.f;
          st[x] = p;
          dpt[x] = p * (dpt[x] - dl) * scale;
        }
      }
  };

  load_tile<T, ROWS, D>(sm, sK, k, b, k0, Sk, Hkv, hk, dh);
  load_tile<T, ROWS, D>(sm + KB, sV, v, b, k0, Sk, Hkv, hk, dh);
  load_q(0);
  sm90::cp_async_commit();
  if (n_it > 1) load_q(1);
  sm90::cp_async_commit();
  float st[BQ / 2], dpt[BQ / 2];
  uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dka[i] = dva[i] = 0.f;
  tile_barrier<1>();  // k, v and q tile 0 (tile 1 may be in flight)
  sm90::wgmma_fence();
  products(0, st, dpt);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(st);
  sm90::fence_regs(dpt);
  grads(0, st, dpt);
  to_frags<T, BQ / 2>(st, pf);
  to_frags<T, BQ / 2>(dpt, dsf);

  // As in the forward: q tile it's products and q tile it-1's gradient
  // products are issued together, and tile it's p and ds are computed
  // while they run.
  for (int it = 1; it < n_it; ++it) {
    tile_barrier<0>();
    if (it + 1 < n_it) load_q(it + 1);
    sm90::cp_async_commit();
    sm90::wgmma_fence();
    products(it, st, dpt);
    sm90::wgmma_commit();
    grad_products(it - 1, pf, dsf);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // s^T and dp^T; the gradient products may run
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    grads(it, st, dpt);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dva);
    sm90::fence_regs(dka);
    sm90::keep_regs(pf);
    sm90::keep_regs(dsf);
    to_frags<T, BQ / 2>(st, pf);
    to_frags<T, BQ / 2>(dpt, dsf);
  }
  sm90::wgmma_fence();
  grad_products(n_it - 1, pf, dsf);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dva);
  sm90::fence_regs(dka);
  sm90::keep_regs(pf);
  sm90::keep_regs(dsf);

  __syncthreads();  // every warpgroup is done with the k and v tiles
  stage_acc<T, ROWS, DW>(sm, dka, rw, cw);
  stage_acc<T, ROWS, DW>(sm + KB, dva, rw, cw);
  __syncthreads();
  store_tile<T, ROWS, D>(dk, sm, b, k0, Sk, Hkv, hk, dh);
  store_tile<T, ROWS, D>(dv, sm + KB, b, k0, Sk, Hkv, hk, dh);
}

template <typename T, int D>
constexpr size_t dq_smem16() {
  // q, dO; the k ring and a 2-stage v ring (v tile kt is read only by
  // tile kt's products)
  return 1024 + (size_t)2 * 2 * Geo<D>::ROWS * D +
         (size_t)2 * (kRing + 2) * Geo<D>::BKQ * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dq16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                  int Sk, int H, int Hkv, int dh, float scale,
                  float scale_log2, int causal) {
  using G = Geo<D>;
  constexpr int ROWS = G::ROWS, DW = G::DW, BK = G::BKQ;
  constexpr uint32_t QB = 2 * ROWS * D, KB = 2 * BK * D;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  // q, dO; k tile kt in k slot kt % kRing, v tile kt in v slot kt % 2
  const uint32_t sQ = sm90::smem_addr(sm), sO = sQ + QB, sK = sO + QB,
                 sV = sK + kRing * KB;

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4,
            lane = threadIdx.x % 32;
  const int b = blockIdx.z, h = blockIdx.y;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // longest tiles first
  const int hk = h / (H / Hkv), offset = Sk - Sq;
  const int rw = G::SPLIT == 1 ? 64 * wg : 0, cw = G::SPLIT == 1 ? 0 : DW * wg;
  const int row0 = i0 + rw + 16 * warp + lane / 4;  // rows row0, row0 + 8
  const int qw = i0 + rw + 16 * warp;               // the warp's first row
  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, max(0, (i0 + ROWS - 1 + offset) / BK + 1));

  auto load_kv = [&](int kt) {
    load_tile<T, BK, D>(sm + 2 * QB + kt % kRing * KB, sK + kt % kRing * KB,
                        k, b, kt * BK, Sk, Hkv, hk, dh);
    load_tile<T, BK, D>(sm + 2 * QB + (kRing + kt % 2) * KB, sV + kt % 2 * KB,
                        v, b, kt * BK, Sk, Hkv, hk, dh);
  };
  // s = q k^T and dp = dO v^T of k tile kt, issued (not committed)
  auto products = [&](int kt, float (&s)[BK / 2], float (&dp)[BK / 2]) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::mma_ss<T, BK>(s, sm90::desc_k<ROWS>(sQ, rw, kk),
                          sm90::desc_k<BK>(sK + kt % kRing * KB, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::mma_ss<T, BK>(dp, sm90::desc_k<ROWS>(sO, rw, kk),
                          sm90::desc_k<BK>(sV + kt % 2 * KB, 0, kk), kk);
  };
  // dq += ds k of k tile kt (k MN-major), issued (not committed)
  auto dq_product = [&](int kt, float (&acc)[DW / 2],
                        const uint32_t (&frags)[BK / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::mma_rs<T, DW>(acc, frags[kk],
                          sm90::desc_mn<BK>(sK + kt % kRing * KB, cw, kk), 1);
  };
  float lr[2], dr[2];
  // ds = p (dp - delta) scale of k tile kt, in place of dp
  auto grads = [&](int kt, const float (&s)[BK / 2], float (&dp)[BK / 2]) {
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Sk || qw + 15 >= Sq ||
                      (causal && k0 + BK - 1 > qw + offset);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * i + e, qi = row0 + 8 * i;
          const int kj = k0 + 8 * j + 2 * (lane % 4) + e;
          float p = sm90::exp2_approx(fmaf(s[x], scale_log2, -lr[i]));
          if (edge && (qi >= Sq || kj >= Sk || (causal && kj > qi + offset)))
            p = 0.f;
          dp[x] = p * (dp[x] - dr[i]) * scale;
        }
  };

  load_tile<T, ROWS, D>(sm, sQ, q, b, i0, Sq, H, h, dh);
  load_tile<T, ROWS, D>(sm + QB, sO, dout, b, i0, Sq, H, h, dh);
  load_kv(0);
  sm90::cp_async_commit();
  if (nk > 1) load_kv(1);
  sm90::cp_async_commit();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row0 + 8 * i < Sq;
    const size_t at = ((size_t)b * H + h) * Sq + row0 + 8 * i;
    lr[i] = in ? lse[at] : 0.f;
    dr[i] = in ? delta[at] : 0.f;
  }
  float dqa[DW / 2], s[BK / 2], dp[BK / 2];
  uint32_t dsf[BK / 16][4];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dqa[i] = 0.f;
  tile_barrier<1>();  // q, dO and k/v tile 0 (tile 1 may be in flight)
  sm90::wgmma_fence();
  products(0, s, dp);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  sm90::fence_regs(dp);
  grads(0, s, dp);
  to_frags<T, BK / 2>(dp, dsf);

  // As in the forward: tile kt's products and tile kt-1's dq product are
  // issued together, and tile kt's ds is computed while they run.
  for (int kt = 1; kt < nk; ++kt) {
    tile_barrier<0>();
    if (kt + 1 < nk) load_kv(kt + 1);
    sm90::cp_async_commit();
    sm90::wgmma_fence();
    products(kt, s, dp);
    sm90::wgmma_commit();
    dq_product(kt - 1, dqa, dsf);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // s and dp; the dq product may still run
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    grads(kt, s, dp);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dqa);
    sm90::keep_regs(dsf);
    to_frags<T, BK / 2>(dp, dsf);
  }
  sm90::wgmma_fence();
  dq_product(nk - 1, dqa, dsf);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dqa);
  sm90::keep_regs(dsf);

  __syncthreads();  // every warpgroup is done with the q tile
  stage_acc<T, ROWS, DW>(sm, dqa, rw, cw);
  __syncthreads();
  store_tile<T, ROWS, D>(dq, sm, b, i0, Sq, H, h, dh);
}

template <typename T, int D>
int fwd16(const T* q, const T* k, const T* v, T* out, float* lse, int B,
          int Sq, int Sk, int H, int Hkv, int dh, float scale_log2,
          int causal, cudaStream_t s) {
  constexpr size_t smem = fwd_smem16<T, D>();
  static_assert(smem <= kMaxSmem, "forward tiles exceed shared memory");
  cudaError_t e = allow_smem(flash_fwd16_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + Geo<D>::ROWS - 1) / Geo<D>::ROWS, H, B);
  flash_fwd16_kernel<T, D><<<grid, kWgThreads, smem, s>>>(
      q, k, v, out, lse, Sq, Sk, H, Hkv, dh, scale_log2, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd16(const T* q, const T* k, const T* v, const T* dout,
          const float* lse, const float* delta, T* dq, T* dk, T* dv, int B,
          int Sq, int Sk, int H, int Hkv, int dh, float scale,
          float scale_log2, int causal, cudaStream_t s) {
  constexpr size_t smem_kv = dkdv_smem16<T, D>(), smem_q = dq_smem16<T, D>();
  static_assert(smem_kv <= kMaxSmem && smem_q <= kMaxSmem,
                "backward tiles exceed shared memory");
  cudaError_t e = allow_smem(flash_dkdv16_kernel<T, D>, smem_kv);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_dq16_kernel<T, D>, smem_q);
  if (e != cudaSuccess) return (int)e;
  constexpr int R = Geo<D>::ROWS;
  dim3 gkv((Sk + R - 1) / R, Hkv, B);
  flash_dkdv16_kernel<T, D><<<gkv, kWgThreads, smem_kv, s>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, Hkv, dh, scale,
      scale_log2, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gq((Sq + R - 1) / R, H, B);
  flash_dq16_kernel<T, D><<<gq, kWgThreads, smem_q, s>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, H, Hkv, dh, scale, scale_log2,
      causal);
  return (int)cudaGetLastError();
}

// ---- dispatch ---------------------------------------------------------------

// The padded head dim a kernel instance computes at, 0 past 256.
int padded(int dh) {
  return dh <= 0 ? 0 : dh <= 64 ? 64 : dh <= 128 ? 128 : dh <= 256 ? 256 : 0;
}

template <typename T, int D>
int fwd_at(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int Sq, int Sk, int H, int Hkv, int dh, float scale_log2,
           int causal, cudaStream_t s) {
  auto run = [&](auto kern) {
    return kern(static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(out),
                static_cast<float*>(lse), B, Sq, Sk, H, Hkv, dh, scale_log2,
                causal, s);
  };
  if constexpr (std::is_same<T, float>::value)
    return run(fwd32<D>);
  else
    return run(fwd16<T, D>);
}

template <typename T, int D>
int bwd_at(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int B, int Sq, int Sk, int H, int Hkv, int dh, float scale,
           float scale_log2, int causal, cudaStream_t s) {
  auto run = [&](auto kern) {
    return kern(static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq),
                static_cast<T*>(dk), static_cast<T*>(dv), B, Sq, Sk, H, Hkv,
                dh, scale, scale_log2, causal, s);
  };
  if constexpr (std::is_same<T, float>::value)
    return run(bwd32<D>);
  else
    return run(bwd16<T, D>);
}

template <typename T>
int fwd_any(const void* q, const void* k, const void* v, void* out,
            void* lse, int B, int Sq, int Sk, int H, int Hkv, int dh,
            float scale_log2, int causal, cudaStream_t s) {
  switch (padded(dh)) {
    case 64:
      return fwd_at<T, 64>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, dh,
                           scale_log2, causal, s);
    case 128:
      return fwd_at<T, 128>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, dh,
                            scale_log2, causal, s);
    case 256:
      return fwd_at<T, 256>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, dh,
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
      return bwd_at<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                           H, Hkv, dh, scale, scale_log2, causal, s);
    case 128:
      return bwd_at<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                            H, Hkv, dh, scale, scale_log2, causal, s);
    case 256:
      return bwd_at<T, 256>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                            H, Hkv, dh, scale, scale_log2, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, H, D); k/v (B, Sk, Hkv, D) -> out (B, Sq, H, D) in q's type,
// lse (B, H, Sq) f32 (base 2).  0 < D <= 256; H % Hkv == 0; all
// contiguous and 16-byte aligned; dtype 0 f32, 1 bf16, 2 f16.
// scale_log2 = scale * log2(e).
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int Sq, int Sk,
                            int H, int Hkv, int D, float scale_log2,
                            int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case PT_F32:
      return fwd_any<float>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, D,
                            scale_log2, causal, s);
    case PT_BF16:
      return fwd_any<bf16>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, D,
                           scale_log2, causal, s);
    case PT_F16:
      return fwd_any<__half>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, D,
                             scale_log2, causal, s);
  }
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
  switch (dtype) {
    case PT_F32:
      return bwd_any<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                            H, Hkv, D, scale, scale_log2, causal, s);
    case PT_BF16:
      return bwd_any<bf16>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                           H, Hkv, D, scale, scale_log2, causal, s);
    case PT_F16:
      return bwd_any<__half>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq,
                             Sk, H, Hkv, D, scale, scale_log2, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
