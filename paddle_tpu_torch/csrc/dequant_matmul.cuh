// Weight-only dequant GEMM, out = x @ widen(W) * scale[n], for f32 x on
// sm_90a: the f32 body of int8_matmul.cu (W int8, (K, N)) and of
// int4_matmul.cu (W two int4 nibbles per byte, (K/2, N)).  bf16 and f16
// run on wgmma: int8 in dequant_gemm.cuh, int4 in dequant_swap.cuh, which
// both borrow `load16` from here.
//
// Contract (paddle_tpu/ops/pallas/int8_matmul.py and int4_matmul.py):
// the widened weight values are small integers, exact in f32; products
// accumulate in f32; the per-column scale multiplies the f32 sum.  int4
// layout (nn/quant.py `_pack_int4`): row 2i of W is the low nibble and
// row 2i+1 the high nibble of packed row i, each sign-extended.
//
// Bound on an H100: in f32 the SIMT units' 67 TFLOP/s bound it at M =
// 128 (2*M*K*N operations against K*N or K*N/2 weight bytes).
//
// Design.  A block owns a 64 x 64 output tile (64 rows of x, 64 columns
// of W) and walks its 64-deep K chunks: each thread loads its share of
// the next chunk's x tile and raw weight bytes into registers (16-byte
// vectors) while the block multiplies the current chunk from shared
// memory, then stores x transposed and the weight widened to f32.  Each
// thread accumulates 8 rows x 4 columns in full f32, to match the
// reference's HIGHEST-precision f32 products.  Blocks along M are
// neighbours in launch order, so the second reader of a weight tile
// finds it in L2.  Rows past M and columns past N or K are zero in shared
// memory and never stored; a vector load that is unaligned or crosses the
// edge becomes element loads, so no load reads past an array.
//
// Split K.  Where the tiles are too few (ops/cuda/int8_plan.py's f32
// rule: until the grid holds 8 blocks per SM, at most 16 splits), K is
// split into ranges of whole chunks (grid z): each block writes its f32
// sum to a partial (splits, M, N), and a second pass adds the partials in
// split order and applies the scale -- no atomics, the same sum order on
// every run.  With one split the block's epilogue scales and stores
// itself.
#pragma once

#include "common.cuh"

#include <cstdint>

namespace dq {

constexpr int kBM = 64;        // rows of x per block
constexpr int kBN = 64;        // columns of W per block
constexpr int kBK = 64;        // K per chunk
constexpr int kThreads = 128;  // 4 warps
constexpr int kSmem = 35840;   // the f32 tiles below fit in this many bytes
constexpr int kMinBlocks = 4;  // resident blocks per SM: <= 128 registers

// unsigned storage of one element of `bytes` bytes
template <int kBytes>
struct Raw;
template <>
struct Raw<1> { using E = unsigned char; };
template <>
struct Raw<2> { using E = unsigned short; };
template <>
struct Raw<4> { using E = unsigned int; };

// 16 bytes of row r, columns [c, c + 16 / sizeof(E)) of a rows x cols
// row-major array with leading dimension ld: zero where out of range;
// element loads where the vector is not aligned (`vec` false) or crosses
// the last column.
template <typename E>
__device__ __forceinline__ uint4 load16(const E* __restrict__ a, int rows,
                                        int cols, int ld, int r, int c,
                                        bool vec) {
  constexpr int V = 16 / sizeof(E);
  if (r >= rows || c >= cols) return make_uint4(0, 0, 0, 0);
  const E* p = a + (long long)r * ld + c;
  if (vec && c + V <= cols) return __ldg(reinterpret_cast<const uint4*>(p));
  union {
    uint4 u;
    E e[V];
  } v;
  v.u = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (c + i < cols) v.e[i] = p[i];
  return v.u;
}

// sign-extended nibbles of a packed byte, in defined integer arithmetic
__host__ __device__ __forceinline__ int nibble_lo(unsigned b) {
  const int v = b & 0xF;
  return v - ((v & 8) << 1);
}
__host__ __device__ __forceinline__ int nibble_hi(unsigned b) {
  const int v = (b >> 4) & 0xF;
  return v - ((v & 8) << 1);
}

// 16 small integers, widened to f32, into 16 consecutive floats of
// shared memory at `dst` (16-byte aligned): four 16-byte stores
__device__ __forceinline__ void store_widened(float* dst, const int (&v)[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    reinterpret_cast<float4*>(dst)[q] =
        make_float4((float)v[4 * q], (float)v[4 * q + 1],
                    (float)v[4 * q + 2], (float)v[4 * q + 3]);
}

// the K split of a product: `splits` ranges of `cps` chunks each (the
// last may be shorter), never empty
struct Split {
  int splits, cps;
};
template <bool kInt4>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dequant_matmul_kernel(const float* __restrict__ x,
                      const signed char* __restrict__ w,
                      const float* __restrict__ scale,
                      float* __restrict__ out, float* __restrict__ partial,
                      int m, int k, int n, int cps) {
  constexpr int kVx = 4;                              // x elements / vector
  constexpr int kXv = kBM * kBK / kVx / kThreads;     // x vectors / thread
  constexpr int kWr = kInt4 ? kBK / 2 : kBK;          // packed rows / chunk
  constexpr int kWv = kWr * kBN / 16 / kThreads;      // W vectors / thread
  // shared layouts: As[k][r] (transposed for the SIMT loop), Bs[k][c]
  // the widened weight
  constexpr int kLdA = kBM + 4;
  constexpr int kLdB = kBN + 8;
  static_assert(sizeof(float) * (kBK * kLdA + kBK * kLdB) <= kSmem,
                "shared tiles");

  __shared__ __align__(128) unsigned char smem[kSmem];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + kBK * kLdA;

  const unsigned* xr = reinterpret_cast<const unsigned*>(x);
  const unsigned char* wr = reinterpret_cast<const unsigned char*>(w);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int wrows = kInt4 ? k / 2 : k;
  const bool vec_x = k % kVx == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;

  uint4 xreg[kXv], wreg[kWv];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kXv; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kBK / kVx), c = (e % (kBK / kVx)) * kVx;
      xreg[i] = load16(xr, m, k, k, m0 + r, k0 + c, vec_x);
    }
    const int w0 = kInt4 ? k0 / 2 : k0;
#pragma unroll
    for (int i = 0; i < kWv; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kBN / 16), c = (e % (kBN / 16)) * 16;
      wreg[i] = load16(wr, wrows, n, n, w0 + r, n0 + c, vec_w);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < kXv; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kBK / kVx), c = (e % (kBK / kVx)) * kVx;
      const uint4 u = xreg[i];
      As[(c + 0) * kLdA + r] = __uint_as_float(u.x);
      As[(c + 1) * kLdA + r] = __uint_as_float(u.y);
      As[(c + 2) * kLdA + r] = __uint_as_float(u.z);
      As[(c + 3) * kLdA + r] = __uint_as_float(u.w);
    }
#pragma unroll
    for (int i = 0; i < kWv; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kBN / 16), c = (e % (kBN / 16)) * 16;
      const unsigned char* b = reinterpret_cast<const unsigned char*>(&wreg[i]);
      int lo[16], hi[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if constexpr (kInt4) {
          lo[j] = nibble_lo(b[j]);
          hi[j] = nibble_hi(b[j]);
        } else {
          lo[j] = static_cast<signed char>(b[j]);
        }
      }
      if constexpr (kInt4) {
        store_widened(Bs + (2 * r) * kLdB + c, lo);
        store_widened(Bs + (2 * r + 1) * kLdB + c, hi);
      } else {
        store_widened(Bs + r * kLdB + c, lo);
      }
    }
  };

  // this block's chunks: [c0, c1) of the K split (grid z)
  const int chunks = (k + kBK - 1) / kBK;
  const int c0 = blockIdx.z * cps;
  const int c1 = c0 + cps < chunks ? c0 + cps : chunks;
  const bool split = gridDim.z > 1;
  float* part = partial + (size_t)blockIdx.z * m * n;
  // 16 x 8 threads, each rows ty*8 .. +8 and columns tx*4 .. +4
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (c0 < c1) fetch(c0 * kBK);
  for (int ch = c0; ch < c1; ++ch) {
    stash();
    __syncthreads();
    if (ch + 1 < c1) fetch((ch + 1) * kBK);
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(As + kk * kLdA + ty * 8);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + kk * kLdA + ty * 8 + 4);
      const float4 bv =
          *reinterpret_cast<const float4*>(Bs + kk * kLdB + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= n) continue;
      if (split)
        part[(size_t)row * n + col] = acc[i][j];
      else
        out[(size_t)row * n + col] = acc[i][j] * scale[col];
    }
  }
}

// pass 2 of a split product: the partials added in split order and
// scaled
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scale,
                                  float* __restrict__ out, int splits, int m,
                                  int n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)m * n;
  if (i >= total) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(size_t)p * total + i];
  out[i] = s * scale[i % n];
}

// x (m, k) f32; w (k, n) int8, or (k/2, n) packed for kInt4; scale (n,)
// f32 -> out (m, n) f32, the product split as `sp` says (pass 2 only with
// sp.splits > 1; partial: f32 scratch of sp.splits x m x n values).  No
// alignment needed.
template <bool kInt4>
int run_split(const void* x, const void* w, const void* scale, void* out,
              void* partial, int m, int k, int n, Split sp,
              cudaStream_t stream) {
  if (sp.splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN, sp.splits);
  dequant_matmul_kernel<kInt4><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const signed char*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out),
      static_cast<float*>(partial), m, k, n, sp.cps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || sp.splits == 1) return (int)e;
  const size_t total = (size_t)m * n;
  sum_splits_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale),
      static_cast<float*>(out), sp.splits, m, n);
  return (int)cudaGetLastError();
}

// The split of k for `splits` ranges of 64-deep chunks, or {0, 0} where
// the plan cannot run: m, n >= 1, k >= 0, no split left empty (k == 0:
// one split).
inline Split split_for(int m, int k, int n, int splits) {
  const int chunks = (k + kBK - 1) / kBK;
  const int cps = splits >= 1 ? (chunks + splits - 1) / splits : 0;
  const bool ok = m >= 1 && n >= 1 && k >= 0 && splits >= 1 &&
                  (chunks == 0 ? splits == 1 : (splits - 1) * cps < chunks);
  return ok ? Split{splits, cps} : Split{0, 0};
}

}  // namespace dq
