// Weight-only int8 GEMM for 16-bit activations, out = round(x @ widen(W) *
// scale[n]), on sm_90a wgmma: the bf16 and f16 body of int8_matmul.cu.
//
// Contract (paddle_tpu/ops/pallas/int8_matmul.py, nn/quant.py
// `weight_only_linear`): x (M, K) bf16 or f16, W (K, N) int8 codes, scale
// (N,) f32; the codes widen exactly to x's type (|code| <= 128); the
// products sum in f32; the scale multiplies the f32 sum; one rounding to
// x's type.  Device memory carries the codes only, never a widened copy.
//
// Bound on an H100.  At the serving M = 128 the kernel reads K*N code
// bytes against 2*M*K*N operations, 256 per byte, about the card's ~295
// bf16 operations per byte of memory rate: the weight stream and the
// tensor cores bound it about equally (0.0056 ms at 4096 x 4096); at the
// LM head's M = 8 the weight stream alone.
//
// Design.  A block is two warpgroups (256 threads) and owns 128 rows of x
// by 128 columns of W, 64 rows per warpgroup, each an m64n128 wgmma
// accumulator (mma_ss_mn, sm90.cuh).  The contraction runs in 64-deep
// steps:
//   x     arrives by cp.async into a 3-stage ring of K-major 128-byte-
//         swizzled tiles, two steps ahead; where x is not 16-byte aligned
//         or K % 8 != 0 each thread loads it through registers instead
//         (element loads, one step ahead);
//   W     the raw codes arrive by cp.async into a ring of kCStages 8 KB
//         tiles, kCStages steps ahead (the bytes in flight are what a
//         weight stream needs; where N % 16 != 0 or W is unaligned each
//         thread loads its chunks through registers with dequant_matmul.cuh
//         `load16`).  While the warpgroups' wgmma of step j runs
//         asynchronously, each thread widens the step j + 1 codes it
//         copied itself -- by byte permutes and one add, no conversion
//         instruction (widen4) -- and stores them into a ring of two
//         MN-major swizzled B tiles.  Those stores go through the generic
//         proxy and wgmma reads through the async proxy, so every thread
//         runs fence_proxy_async() before the barrier that hands the tile
//         over.
// Rows past M and contraction indices or columns past K or N are zero in
// shared memory and never stored.
//
// What bounds it now (PERF.md section 6): a 64-deep step costs about the
// same whatever M (the LM head's 64 steps at M = 8 take longer than the
// 13 of a split at M = 128 with 128 rows), so at M = 128 the kernel runs
// at 3.3-4x its bound; the copies, the wgmma and the widening each
// add to a step and none hides another (a build without any one of
// them saved that one's share).  Tried on the card and not kept: a code
// ring of 4 stages (no faster), of 6 (one block per SM: slower);
// widening one row per thread (bank-conflict-free stores: slower);
// skipping the products of a warpgroup whose rows all lie past M (faster
// at M <= 64, slower at M = 128).
//
// Split K.  Only where the 128 x 128 tiles are fewer than the SMs is the
// contraction split (ops/cuda/int8_plan.py, the rule of ops/cuda/
// mlp_plan.py: ceil(SMs / tiles) splits, f32 partials within 16 MiB; 5
// at N = 4096 and M = 128, 2 at N = 11008, none at the LM head's 250
// tiles).  One split: the epilogue scales the f32 accumulator, rounds and
// stores.  Splits: each writes its f32 sum to a partial (splits, M, N),
// and a dependent kernel adds them in split order, scales and rounds once
// -- no atomics, two calls give the same bits.
#pragma once

#include "common.cuh"
#include "dequant_matmul.cuh"
#include "mlp_gemm.cuh"
#include "sm90.cuh"

namespace dg {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kBM = 128;        // rows of x per block
constexpr int kBN = 128;        // columns of W per block
constexpr int kBK = 64;         // contraction step (the split-K unit too)
constexpr int kAStages = 3;     // cp.async ring of x tiles: 2 steps ahead
constexpr int kCStages = 3;     // cp.async ring of raw code tiles
constexpr int kBStages = 2;     // ring of widened weight tiles
constexpr uint32_t kABytes = kBM * kBK * 2, kCBytes = kBK * kBN,
                   kBBytes = kBK * kBN * 2;
constexpr size_t kSmem = 1024 + kAStages * kABytes + kCStages * kCBytes +
                         kBStages * kBBytes;
static_assert(kCStages >= 3, "the wait below assumes codes >= 3 ahead");

// Four int8 codes (one word, byte i the code of column i) widened exactly
// to T, as two words of two packed values: the code's byte, offset by 128,
// becomes the low mantissa bits of a float (bf16: 2^23 + u) or a half
// (f16: 1024 + u), and one subtraction of the same offset plus 128 leaves
// the code.  No conversion instruction: byte permutes and adds only.
template <typename T>
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi);
template <>
__device__ __forceinline__ void widen4<__half>(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;   // code + 128 in each byte
  const uint32_t h01 = __byte_perm(u, 0x64646464u, 0x5140);
  const uint32_t h23 = __byte_perm(u, 0x64646464u, 0x7362);
  const uint32_t off = 0x64806480u;     // 1152 = 1024 + 128, twice
  const __half2 a = __hsub2(*reinterpret_cast<const __half2*>(&h01),
                            *reinterpret_cast<const __half2*>(&off));
  const __half2 b = __hsub2(*reinterpret_cast<const __half2*>(&h23),
                            *reinterpret_cast<const __half2*>(&off));
  lo = *reinterpret_cast<const uint32_t*>(&a);
  hi = *reinterpret_cast<const uint32_t*>(&b);
}
template <>
__device__ __forceinline__ void widen4<__nv_bfloat16>(uint32_t w,
                                                      uint32_t& lo,
                                                      uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)   // 2^23 + u_i, less 2^23 + 128
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) -
           8388736.f;
  // an integer of at most 8 significant bits: its bf16 is the float's
  // upper half, exactly
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// grid (row tiles of kBM, column tiles of kBN, splits); split z owns the
// contraction steps [z kps, (z + 1) kps).  xasync: x is 16-byte aligned
// and k % 8 == 0, so its tiles go by cp.async; wasync: w is 16-byte
// aligned and n % 16 == 0, so its codes do too.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
dequant_gemm_kernel(const T* __restrict__ x,
                    const signed char* __restrict__ w,
                    const float* __restrict__ scale, T* __restrict__ out,
                    float* __restrict__ partial, int m, int k, int n,
                    int kps, int xasync, int wasync) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = mlp::align1024(smem_raw);
  sm90::launch_dependents();   // the split sum may start its launch
  unsigned char* ct = sm + kAStages * kABytes;       // raw code ring
  unsigned char* bt = ct + kCStages * kCBytes;       // widened B ring
  const uint32_t sa = sm90::smem_addr(sm), sc = sm90::smem_addr(ct),
                 sb = sm90::smem_addr(bt);
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int nk = (k + kBK - 1) / kBK;
  const int kb = blockIdx.z * kps, steps = min(nk, kb + kps) - kb;

  // x: 8 chunks of 16 bytes per row, a thread's 4 chunks 32 rows apart
  const int ca = tid % 8 * 8, ra = tid / 8;
  const uint32_t da = sm90::swz<kBM>(ra, ca);
  // codes: 8 chunks of 16 per row, a thread's 2 chunks 32 rows apart; a
  // thread widens the chunks it copied itself, so no barrier orders them
  const int cw = tid % 8 * 16, rw = tid / 8;
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(w);
  using EX = typename dq::Raw<2>::E;
  const EX* xr = reinterpret_cast<const EX*>(x);

  // x of step j into slot j % kAStages: by cp.async, or through registers
  auto load_x = [&](int j) {
    const int k0 = (kb + j) * kBK;
    if (xasync) {
      const uint32_t st = sa + (j % kAStages) * kABytes;
#pragma unroll
      for (int i = 0; i < kBM / 32; ++i) {
        const int r = m0 + ra + 32 * i;
        const bool in = r < m && k0 + ca < k;
        sm90::cp_async16(st + da + i * 32 * 128,
                         in ? x + (size_t)r * k + k0 + ca : x, in ? 16 : 0);
      }
    } else {
      unsigned char* st = sm + (j % kAStages) * kABytes;
#pragma unroll
      for (int i = 0; i < kBM / 32; ++i)
        *reinterpret_cast<uint4*>(st + da + i * 32 * 128) =
            dq::load16(xr, m, k, k, m0 + ra + 32 * i, k0 + ca, false);
    }
  };
  // raw codes of step j into slot j % kCStages, the same two ways
  auto load_codes = [&](int j) {
    const int k0 = (kb + j) * kBK;
    const uint32_t off = (j % kCStages) * kCBytes;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = k0 + rw + 32 * i;
      const uint32_t d = off + (rw + 32 * i) * kBN + cw;
      if (wasync) {
        const bool in = r < k && n0 + cw < n;
        sm90::cp_async16(sc + d, in ? wb + (size_t)r * n + n0 + cw : wb,
                         in ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(ct + d) =
            dq::load16(wb, k, n, n, r, n0 + cw, false);
      }
    }
  };
  // step j's codes widened to T into B slot j % kBStages
  auto widen = [&](int j) {
    const uint32_t off = (j % kCStages) * kCBytes;
    unsigned char* st = bt + (j % kBStages) * kBBytes;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 c = *reinterpret_cast<const uint4*>(
          ct + off + (rw + 32 * i) * kBN + cw);
      uint32_t p[8];
      widen4<T>(c.x, p[0], p[1]);
      widen4<T>(c.y, p[2], p[3]);
      widen4<T>(c.z, p[4], p[5]);
      widen4<T>(c.w, p[6], p[7]);
      *reinterpret_cast<uint4*>(st + sm90::swz<kBK>(rw + 32 * i, cw)) =
          make_uint4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<uint4*>(st + sm90::swz<kBK>(rw + 32 * i, cw + 8)) =
          make_uint4(p[4], p[5], p[6], p[7]);
    }
  };

  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  // one commit group per prologue stage: the codes of steps 0 ..
  // kCStages - 1, the x tiles of steps 0 and 1
#pragma unroll
  for (int j = 0; j < kCStages; ++j) {
    if (j < steps) load_codes(j);
    if (j < kAStages - 1 && j < steps && xasync) load_x(j);
    sm90::cp_async_commit();
  }
  if (!xasync && steps > 0) load_x(0);
  sm90::cp_async_wait<kCStages - 1>();
  if (steps > 0) widen(0);

  // Step j: its x tile has landed and its widened codes are stored.  Each
  // iteration commits one group (x of step j + 2, codes of step j +
  // kCStages), so waiting until one group is in flight leaves x of step j
  // and the codes of step j + 1 landed.  The products of step j run while
  // step j + 1's codes are widened.
  for (int j = 0; j < steps; ++j) {
    sm90::cp_async_wait<1>();
    sm90::fence_proxy_async();
    __syncthreads();
    if (xasync && j + kAStages - 1 < steps) load_x(j + kAStages - 1);
    if (j + kCStages < steps) load_codes(j + kCStages);
    sm90::cp_async_commit();
    const uint32_t st = sa + (j % kAStages) * kABytes;
    const uint32_t bs = sb + (j % kBStages) * kBBytes;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      sm90::mma_ss_mn<T, kBN>(acc, sm90::desc_k<kBM>(st, 64 * wg, kk),
                              sm90::desc_mn<kBK>(bs, 0, kk), 1);
    sm90::wgmma_commit();
    if (j + 1 < steps) {
      if (!xasync) load_x(j + 1);
      widen(j + 1);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
  }
  sm90::cp_async_wait<0>();

  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + mlp::acc_row(i);
      if (r >= m) continue;
      T* orow = out + (size_t)r * n;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = n0 + mlp::acc_col(j, 0);
        const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
        if (n % 2 == 0) {
          if (c < n)
            *reinterpret_cast<uint32_t*>(orow + c) =
                sm90::pack2<T>(v0 * scale[c], v1 * scale[c + 1]);
        } else {
          if (c < n) orow[c] = pt::from_f<T>(v0 * scale[c]);
          if (c + 1 < n) orow[c + 1] = pt::from_f<T>(v1 * scale[c + 1]);
        }
      }
    }
    return;
  }
  float* p = partial + (size_t)blockIdx.z * m * n;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + mlp::acc_row(i);
    if (r >= m) continue;
    float* prow = p + (size_t)r * n;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = n0 + mlp::acc_col(j, 0);
      const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      if (n % 2 == 0) {
        if (c < n)
          *reinterpret_cast<float2*>(prow + c) = make_float2(v0, v1);
      } else {
        if (c < n) prow[c] = v0;
        if (c + 1 < n) prow[c + 1] = v1;
      }
    }
  }
}

// The splits' partials added in split order, scaled and rounded once; a
// dependent launch after the GEMM.
template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scale,
                                  T* __restrict__ out, int splits, int n,
                                  size_t total) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  sm90::grid_dependency_wait();
  if (i >= total) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(size_t)p * total + i];
  out[i] = pt::from_f<T>(s * scale[i % n]);
}

// Contraction steps per split for the plan's `splits`, or 0 where the
// plan cannot run: m, n >= 1, k >= 0, no split left empty (k == 0: one).
inline int steps_per_split(int m, int k, int n, int splits) {
  if (m < 1 || n < 1 || k < 0 || splits < 1) return 0;
  const int nk = (k + kBK - 1) / kBK;
  if (nk == 0) return splits == 1 ? 1 : 0;
  const int kps = (nk + splits - 1) / splits;
  return (splits - 1) * kps < nk ? kps : 0;
}

// x (m, k) T; w (k, n) int8; scale (n,) f32 -> out (m, n) T; partial: f32
// scratch of splits x m x n values when splits > 1.  Contiguous
// row-major; no alignment needed.
template <typename T>
int run(const void* x, const void* w, const void* scale, void* out,
        void* partial, int m, int k, int n, int splits, cudaStream_t s) {
  const int kps = steps_per_split(m, k, n, splits);
  if (kps == 0 || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = mlp::allow_smem(dequant_gemm_kernel<T>, kSmem);
  if (e != cudaSuccess) return (int)e;
  const int xasync =
      k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? 1 : 0;
  const int wasync =
      n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 ? 1 : 0;
  dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN, splits);
  dequant_gemm_kernel<T><<<grid, kThreads, kSmem, s>>>(
      static_cast<const T*>(x), static_cast<const signed char*>(w),
      static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<float*>(partial), m, k, n, kps, xasync, wasync);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t total = (size_t)m * n;
  return (int)mlp::launch_dependent(
      sum_splits_kernel<T>, dim3((unsigned)((total + 255) / 256)), 256, 0, s,
      static_cast<const float*>(partial), static_cast<const float*>(scale),
      static_cast<T*>(out), splits, n, total);
}

}  // namespace dg
