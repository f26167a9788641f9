// Weight-only dequant GEMM, out = round(x @ widen(W) * scale[n]), for
// sm_90a: the kernel behind int4_matmul.cu (W two int4 nibbles per byte,
// (K/2, N)) in every type, and behind int8_matmul.cu (W int8, (K, N)) for
// f32 x only -- 16-bit int8 runs on wgmma in dequant_gemm.cuh, which
// borrows `load16` from here.
//
// Contract (paddle_tpu/ops/pallas/int8_matmul.py and int4_matmul.py):
// x (M, K) in f32, bf16 or f16; the widened weight values are small
// integers, exact in x's type; products accumulate in f32; the
// per-column scale multiplies the f32 sum; one rounding to x's type.
// int4 layout (nn/quant.py `_pack_int4`): row 2i of W is the low nibble
// and row 2i+1 the high nibble of packed row i, each sign-extended.
//
// Bound on an H100.  At serving token counts (M <= 256) the weight bytes
// are the cost: K*N (int8) or K*N/2 (int4) against 2*M*K*N operations,
// ~256 operations per int8 byte at M = 128 in bf16, about the card's
// ~295 bf16 operations per byte of HBM rate -- so at M = 128 the tensor
// cores and the weight stream bound it about equally, and at the LM
// head's M = 8 the weight stream alone.  HBM carries int8 or nibbles
// only: a block widens its weight tile in shared memory, never a widened
// copy in device memory.
//
// Design.  A block owns a 64 x 64 output tile (64 rows of x, 64 columns
// of W) and walks its K chunks: each thread loads its share of the next
// chunk's x tile and raw weight bytes into registers (16-byte vectors)
// while the block multiplies the current chunk from shared memory, then
// stores x as it is and the weight widened to x's type (16-byte stores).
// bf16/f16 multiply on the tensor cores (WMMA 16x16x16, f32
// accumulators; 4 warps as 2 x 2, each a 32 x 32 tile); f32 on the SIMT
// units in full f32 (each thread 8 rows x 4 columns), to match the
// reference's HIGHEST-precision f32 products.  Blocks along M are
// neighbours in launch order, so the second reader of a weight tile finds
// it in L2.  Rows past M and columns past N or K are zero in shared
// memory and never stored; a vector load that is unaligned or crosses the
// edge becomes element loads, so no load reads past an array.
//
// Split K.  At M = 128 a 4096-column weight has only 128 output tiles,
// one 4-warp block per SM (without a split this kernel ran 20x its
// bound: PERF.md).  So when the tiles are fewer than kBlocksPerSm
// blocks per SM, K is split into up to kMaxSplits ranges of whole chunks
// (grid z): each block writes its f32 sum to a partial (splits, M, N),
// and a second pass adds the partials in split order, applies the scale
// and rounds once -- no atomics, the same sum order on every run.  With
// one split the block's epilogue scales, rounds and stores itself.  The
// block is held to 128 registers so four fit on an SM.  Measured on the
// card and not kept (PERF.md): a 3-stage cp.async ring, BK = 64, and a
// 64 x 128 tile of 8 warps (which halves the L2 reads of x) were no
// faster; the WMMA loop itself is the limit, `wgmma` the next step.
#pragma once

#include "common.cuh"

#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace dq {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBM = 64;        // rows of x per block
constexpr int kBN = 64;        // columns of W per block
constexpr int kThreads = 128;  // 4 warps
constexpr int kSmem = 35840;   // both layouts below fit in this many bytes
constexpr int kMinBlocks = 4;  // resident blocks per SM: <= 128 registers
constexpr int kBlocksPerSm = 8;  // split K until the grid has this many
constexpr int kMaxSplits = 16;

// K per chunk: 128 for the 16-bit types, 64 for f32 (shared memory)
template <typename T>
struct Chunk {
  static constexpr int kBK = std::is_same<T, float>::value ? 64 : 128;
};

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

__device__ __forceinline__ unsigned bits16(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ unsigned bits16(__half v) {
  return __half_as_ushort(v);
}

// 16 small integers, widened to T, into 16 consecutive elements of
// shared memory at `dst` (16-byte aligned): two or four 16-byte stores
template <typename T>
__device__ __forceinline__ void store_widened(T* dst, const int (&v)[16]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      reinterpret_cast<float4*>(dst)[q] =
          make_float4((float)v[4 * q], (float)v[4 * q + 1],
                      (float)v[4 * q + 2], (float)v[4 * q + 3]);
  } else {
    unsigned wd[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      wd[i] = bits16(pt::from_f<T>((float)v[2 * i])) |
              (bits16(pt::from_f<T>((float)v[2 * i + 1])) << 16);
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(wd[4], wd[5], wd[6], wd[7]);
  }
}

// the K split of an (m, k, n) product with chunks of bk rows: `splits`
// ranges of `cps` chunks each (the last may be shorter), never empty
struct Split {
  int splits, cps;
};
inline Split split_of(int m, int k, int n, int bk) {
  const int tiles = ((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  const int chunks = (k + bk - 1) / bk;
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int want = (kBlocksPerSm * sms + tiles - 1) / tiles;
  want = want < kMaxSplits ? want : kMaxSplits;
  want = want < chunks ? want : chunks;
  if (want <= 1) return {1, chunks};
  const int cps = (chunks + want - 1) / want;
  return {(chunks + cps - 1) / cps, cps};
}

template <typename T, bool kInt4>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dequant_matmul_kernel(const T* __restrict__ x,
                      const signed char* __restrict__ w,
                      const float* __restrict__ scale, T* __restrict__ out,
                      float* __restrict__ partial, int m, int k, int n,
                      int cps) {
  constexpr bool kTc = !std::is_same<T, float>::value;
  constexpr int kBK = Chunk<T>::kBK;
  constexpr int kVx = 16 / sizeof(T);                 // x elements / vector
  constexpr int kXv = kBM * kBK / kVx / kThreads;     // x vectors / thread
  constexpr int kWr = kInt4 ? kBK / 2 : kBK;          // packed rows / chunk
  constexpr int kWv = kWr * kBN / 16 / kThreads;      // W vectors / thread
  // shared layouts: tensor cores As[r][k], f32 As[k][r] (transposed for
  // the SIMT loop); Bs[k][c] in both, the widened weight
  constexpr int kLdA = kTc ? kBK + 8 : kBM + 4;
  constexpr int kLdB = kBN + 8;
  constexpr int kLdC = kBN + 4;                       // f32 epilogue tile
  static_assert(sizeof(T) * (kTc ? kBM * kLdA : kBK * kLdA) +
                        sizeof(T) * kBK * kLdB <=
                    kSmem,
                "shared tiles");
  static_assert(!kTc || sizeof(float) * kBM * kLdC <= kSmem, "epilogue");

  __shared__ __align__(128) unsigned char smem[kSmem];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + (kTc ? kBM * kLdA : kBK * kLdA);

  using EX = typename Raw<sizeof(T)>::E;
  const EX* xr = reinterpret_cast<const EX*>(x);
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
      if constexpr (kTc) {
        *reinterpret_cast<uint4*>(As + r * kLdA + c) = xreg[i];
      } else {
        const uint4 u = xreg[i];
        As[(c + 0) * kLdA + r] = __uint_as_float(u.x);
        As[(c + 1) * kLdA + r] = __uint_as_float(u.y);
        As[(c + 2) * kLdA + r] = __uint_as_float(u.z);
        As[(c + 3) * kLdA + r] = __uint_as_float(u.w);
      }
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
  if constexpr (kTc) {
    using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, T,
                                 wmma::row_major>;
    using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, T,
                                 wmma::row_major>;
    using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
    const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) live[i] = m0 + wm * 32 + i * 16 < m;
    FragC acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    if (c0 < c1) fetch(c0 * kBK);
    for (int ch = c0; ch < c1; ++ch) {
      stash();
      __syncthreads();
      if (ch + 1 < c1) fetch((ch + 1) * kBK);
      if (live[0]) {   // warp-uniform: a warp whose rows are all past M idles
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          FragB b[2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(b[j], Bs + kk * kLdB + wn * 32 + j * 16,
                                   kLdB);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (!live[i]) continue;
            FragA a;
            wmma::load_matrix_sync(a, As + (wm * 32 + i * 16) * kLdA + kk,
                                   kLdA);
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
    // epilogue: fragments -> f32 tile in shared memory -> scale, round,
    // store the rows and columns that exist (split: the f32 sum to this
    // split's partial)
    float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live[i]) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLdC + wn * 32 +
                                    j * 16,
                                acc[i][j], kLdC, wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < kBM * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int row = m0 + r, col = n0 + c;
      if (row >= m || col >= n) continue;
      const float v = Cs[r * kLdC + c];
      if (split)
        part[(size_t)row * n + col] = v;
      else
        out[(size_t)row * n + col] = pt::from_f<T>(v * scale[col]);
    }
  } else {
    // f32: 16 x 8 threads, each rows ty*8 .. +8 and columns tx*4 .. +4
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
}

// pass 2 of a split product: the partials added in split order, scaled
// and rounded once
template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scale,
                                  T* __restrict__ out, int splits, int m,
                                  int n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)m * n;
  if (i >= total) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(size_t)p * total + i];
  out[i] = pt::from_f<T>(s * scale[i % n]);
}

// the product split as `sp` says (pass 2 only with sp.splits > 1)
template <typename T, bool kInt4>
int run_split(const void* x, const void* w, const void* scale, void* out,
              void* partial, int m, int k, int n, Split sp,
              cudaStream_t stream) {
  if (sp.splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN, sp.splits);
  dequant_matmul_kernel<T, kInt4><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const signed char*>(w),
      static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<float*>(partial), m, k, n, sp.cps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || sp.splits == 1) return (int)e;
  const size_t total = (size_t)m * n;
  sum_splits_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale),
      static_cast<T*>(out), sp.splits, m, n);
  return (int)cudaGetLastError();
}

template <typename T, bool kInt4>
int run(const void* x, const void* w, const void* scale, void* out,
        void* partial, int m, int k, int n, cudaStream_t stream) {
  return run_split<T, kInt4>(x, w, scale, out, partial, m, k, n,
                             split_of(m, k, n, Chunk<T>::kBK), stream);
}

// x (m, k) of `dtype`; w (k, n) int8, or (k/2, n) packed for kInt4;
// scale (n,) f32 -> out (m, n) of `dtype`; `partial` f32 scratch of
// scratch_elems(m, k, n, dtype) elements (may be null when that is 0).
// m, n >= 1; k >= 0 (even for kInt4).  No alignment needed.
template <bool kInt4>
int launch(const void* x, const void* w, const void* scale, void* out,
           void* partial, int m, int k, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || k < 0 || (kInt4 && k % 2)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (dtype) {
    case PT_F32:
      return run<float, kInt4>(x, w, scale, out, partial, m, k, n, s);
    case PT_BF16:
      return run<bf16, kInt4>(x, w, scale, out, partial, m, k, n, s);
    case PT_F16:
      return run<__half, kInt4>(x, w, scale, out, partial, m, k, n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// f32 elements of the partial scratch `launch` needs (0: no K split)
inline long long scratch_elems(int m, int k, int n, int dtype) {
  const int bk = dtype == PT_F32 ? Chunk<float>::kBK : Chunk<bf16>::kBK;
  const Split sp = split_of(m, k, n, bk);
  return sp.splits > 1 ? (long long)sp.splits * m * n : 0;
}

}  // namespace dq
