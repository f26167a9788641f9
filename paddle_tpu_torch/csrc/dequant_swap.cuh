// Weight-only int4 GEMM for 16-bit activations, out = round(x @ unpack(W) *
// scale[n]), on sm_90a wgmma with the operands swapped: the bf16 and f16
// body of int4_matmul.cu.
//
// Contract (paddle_tpu/ops/pallas/int4_matmul.py, nn/quant.py
// `_pack_int4`): x (M, K) bf16 or f16; W packed (K/2, N) int8, row 2i of
// the (K, N) weight the low nibble and row 2i+1 the high nibble of packed
// row i, each sign-extended; scale (N,) f32; the nibbles widen exactly to
// x's type; the products sum in f32; the scale multiplies the f32 sum;
// one rounding to x's type.  Device memory carries the packed bytes only.
//
// Bound on an H100.  At the serving M = 128 the kernel reads K*N/2 bytes
// against 2*M*K*N operations, 512 per byte, above the card's ~295 bf16
// operations per byte of memory rate: the tensor cores bound it (0.0043
// ms at 4096 x 4096); at the LM head's M = 8 the packed bytes.
//
// Design: the product runs transposed, outᵀ (N, M) = Wᵀ (N, K) . xᵀ, so
// the weight is wgmma's A operand, taken from registers, and x its B
// operand, K-major in shared memory with n = the M tile (8, 64 or 128
// rows).  A block is two warpgroups, each the A rows of 64 output
// columns, and walks 64-deep contraction steps:
//   x      by cp.async into a ring of 128-byte-swizzled K-major tiles;
//          rows past M zero-filled by the copy;
//   codes  the packed bytes, by cp.async into a ring of tiles of 32
//          packed rows by 128 columns (4 KB a step), 16-byte chunks
//          swizzled so ldmatrix reads them without bank conflicts;
//          where N % 16 != 0 or W is unaligned each thread loads its chunk
//          through registers (dequant_matmul.cuh `load16`) and stores it;
//   A      in wgmma's register fragment (sm90.cuh), lane l of warp w holds
//          for k16 step s four registers, each a pair of adjacent
//          contraction rows 2i, 2i + 1 of one output column: exactly the
//          two nibbles of one packed byte.  One ldmatrix.x4.trans per
//          64-deep step hands each lane those bytes: its matrix s is the
//          step's 8 packed rows in the order (0, 4, 1, 5, 2, 6, 3, 7) by
//          the warp's 16 output columns as 8 byte pairs, so lane l's
//          register s holds {P[c][2g], P[c][2g+1], P[c+4][2g],
//          P[c+4][2g+1]} (g = l / 4, c = l % 4, P the packed rows of step
//          s), the bytes of a0 .. a3 once fragment rows g and g + 8 stand
//          for the output columns 2g and 2g + 1 (the column pairing);
//   widen  each byte, offset by 0x88, becomes one A register by masks and
//          a magic OR (the nibble plus 8 in the low mantissa bits of bf16
//          128.0 or f16 1024.0) and one packed subtraction of 136 or 1032:
//          exact for every byte.  Step s + 1 is widened while the products
//          of step s run (keep_regs holds the registers until the wait).
// So no thread writes shared memory that wgmma reads, except the x tiles
// the copy unit fills, and no widened weight tile exists anywhere.
//
// Epilogue.  The accumulator is outᵀ: thread (w, g, c) holds output
// columns 16w + 2g and 16w + 2g + 1 of rows 8j + 2c + e, so the column
// pairing puts each output pair in one thread.  One split: each pair is
// scaled in f32, rounded once and written into a swizzled shared tile,
// which goes out as 16-byte row stores.  Split K (only where the tiles
// are fewer than the SMs, into as many splits as one wave of two blocks
// per SM holds: ops/cuda/int4_plan.py): each split writes its f32 sum to
// a partial (splits, M, N) and dequant_gemm.cuh's sum kernel, a dependent
// launch, adds them in split order, scales and rounds once -- no atomics,
// two calls give the same bits.
//
// What bounds it now (PERF.md section 6): a block's 64-deep step is a
// chain -- wait for the copies, barrier, ldmatrix, widen, products, wait
// for them -- and two blocks an SM interleave two such chains; at M = 128
// the kernel runs at ~4x its bound, at the LM head at ~2.3x.  Tried on an
// H100 and not kept: the products of step j left in flight while step j
// + 1 is widened (two A register sets, wait<1>: no faster, and it spills
// at n = 128); rings of 2 to 8 stages (no change); blocks of four
// warpgroups and 256 columns, which halve the x tiles' reads from L2 (no
// faster: one block an SM); one fence before a step's four products (slower
// at n = 8); 64-column tiles, and 64-row tiles at M = 128 (slower).
#pragma once

#include "common.cuh"
#include "dequant_gemm.cuh"
#include "dequant_matmul.cuh"
#include "mlp_gemm.cuh"
#include "sm90.cuh"

namespace dsw {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kBN = 128;        // output columns per block, 64 a warpgroup
constexpr int kBK = 64;         // contraction step (the split-K unit too)
constexpr int kPR = kBK / 2;    // packed rows per step

// ring depth: x tiles dominate at n = 128; at small n the packed bytes do,
// and a weight stream wants more of them in flight
template <int NM>
__host__ __device__ constexpr int stages() {
  return NM >= 64 ? 3 : 6;
}

// dynamic shared memory of a block: the x ring, then the code ring (+ 1024
// to align the x tiles for the swizzle)
template <int NM>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + (size_t)stages<NM>() * (NM * kBK * 2 + kPR * kBN);
}

// Byte offset of 16-byte chunk q of row r in a code tile (128-byte rows):
// the 8 rows of one ldmatrix matrix land on 8 distinct bank groups.
__device__ __forceinline__ uint32_t code_off(int r, int q) {
  return r * kBN + ((q ^ (r & 7)) << 4);
}

// Byte offset of element col of row r in the output tile of kBN 16-bit
// values a row: chunk q at q ^ (r % 8) within each group of 8 chunks.
__device__ __forceinline__ uint32_t out_off(int r, int col) {
  const int q = col >> 3;
  return r * kBN * 2 + (((q & ~7) | ((q ^ r) & 7)) << 4) + ((col & 7) << 1);
}

// An A register from one packed byte (bits 0-7 of u, already XORed with
// 0x88): the low nibble + 8 in the low half and the high nibble + 8 in
// the high half, as the low mantissa bits of 128.0 (bf16) or 1024.0
// (f16), less 136 or 1032 in one packed subtraction.
template <typename T>
__device__ __forceinline__ uint32_t widen_byte(uint32_t u);
template <>
__device__ __forceinline__ uint32_t widen_byte<__nv_bfloat16>(uint32_t u) {
  const uint32_t v = (u & 0xFu) | ((u << 12) & 0xF0000u) | 0x43004300u;
  const uint32_t off = 0x43084308u;   // 136.0, twice
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<const uint32_t*>(&r);
}
template <>
__device__ __forceinline__ uint32_t widen_byte<__half>(uint32_t u) {
  const uint32_t v = (u & 0xFu) | ((u << 12) & 0xF0000u) | 0x64006400u;
  const uint32_t off = 0x64086408u;   // 1032.0, twice
  const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&v),
                            *reinterpret_cast<const __half2*>(&off));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The four A registers of one k16 step from the ldmatrix register that
// holds their four packed bytes.
template <typename T>
__device__ __forceinline__ void widen_frag(uint32_t bytes,
                                           uint32_t (&a)[4]) {
  const uint32_t u = bytes ^ 0x88888888u;
#pragma unroll
  for (int p = 0; p < 4; ++p) a[p] = widen_byte<T>(u >> (8 * p));
}

// grid (row tiles of NM, column tiles of kBN, splits); split z owns the
// contraction steps [z kps, (z + 1) kps).  x rows are ldx apart (ldx % 8
// == 0, 16-byte aligned; columns k .. ldx - 1 are zero); wasync: w is
// 16-byte aligned and n % 16 == 0, so its chunks go by cp.async.
template <typename T, int NM>
__global__ void __launch_bounds__(kThreads, 2)
swap_gemm_kernel(const T* __restrict__ x, int ldx,
                 const unsigned char* __restrict__ w,
                 const float* __restrict__ scale, T* __restrict__ out,
                 float* __restrict__ partial, int m, int k, int n, int kps,
                 int wasync) {
  constexpr int S = stages<NM>();
  constexpr uint32_t XB = NM * kBK * 2, CB = kPR * kBN;
  constexpr int CPR = kBN / 16;   // code chunks per row: one per thread
  static_assert(kPR * CPR == kThreads, "one code chunk per thread");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = mlp::align1024(smem_raw);
  sm90::launch_dependents();   // the split sum may start its launch
  unsigned char* ct = sm + S * XB;
  const uint32_t sx = sm90::smem_addr(sm), sc = sm90::smem_addr(ct);
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32 % 4,
            lane = tid % 32;
  const int m0 = blockIdx.x * NM, n0 = blockIdx.y * kBN;
  const int nk = (k + kBK - 1) / kBK, k2 = k / 2;
  const int kb = blockIdx.z * kps, steps = min(nk, kb + kps) - kb;

  // the thread's code chunk: packed row rc, 16 columns from 16 cc
  const int rc = tid / CPR, cc = tid % CPR;
  const uint32_t dc = code_off(rc, cc);
  // its ldmatrix row: matrix lane / 8 (k16 step), row lane % 8 of the
  // order (0, 4, 1, 5, 2, 6, 3, 7), the warp's 16 output columns
  const int q8 = lane % 8;
  const uint32_t la =
      code_off(8 * (lane / 8) + (q8 >> 1) + 4 * (q8 & 1), 4 * wg + warp);

  // step j into slot j % S: the x tile and the packed bytes
  auto load = [&](int j) {
    const int k0 = (kb + j) * kBK;
    const uint32_t xs = sx + (j % S) * XB;
#pragma unroll
    for (int e = tid; e < NM * 8; e += kThreads) {
      const int r = e / 8, c = e % 8 * 8;
      const bool in = m0 + r < m && k0 + c < ldx;
      sm90::cp_async16(xs + sm90::swz<NM>(r, c),
                       in ? x + (size_t)(m0 + r) * ldx + k0 + c : x,
                       in ? 16 : 0);
    }
    const int pr = k0 / 2 + rc, c0 = n0 + 16 * cc;
    if (wasync) {
      const bool in = pr < k2 && c0 < n;
      sm90::cp_async16(sc + (j % S) * CB + dc,
                       in ? w + (size_t)pr * n + c0 : w, in ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(ct + (j % S) * CB + dc) =
          dq::load16(w, k2, n, n, pr, c0, false);
    }
  };

  float acc[NM / 2];
#pragma unroll
  for (int i = 0; i < NM / 2; ++i) acc[i] = 0.f;
  // steps 0 .. S - 2 in flight, one commit group each
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < steps) load(j);
    sm90::cp_async_commit();
  }
  for (int j = 0; j < steps; ++j) {
    // step j has landed; every warpgroup has retired step j - 1's
    // products, so its slot takes step j + S - 1
    sm90::cp_async_wait<S - 2>();
    sm90::fence_proxy_async();
    __syncthreads();
    if (j + S - 1 < steps) load(j + S - 1);
    sm90::cp_async_commit();
    uint32_t bytes[4], a[4][4];
    sm90::ldmatrix_x4_trans(bytes, sc + (j % S) * CB + la);
    const uint32_t xs = sx + (j % S) * XB;
#pragma unroll
    for (int s = 0; s < 4; ++s) {   // widen step s while s - 1 multiplies
      widen_frag<T>(bytes[s], a[s]);
      sm90::wgmma_fence();
      sm90::mma_rs_k<T, NM>(acc, a[s], sm90::desc_k<NM>(xs, 0, s), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::keep_regs(a);
  }
  sm90::cp_async_wait<0>();

  // thread (w, g, c): output columns col, col + 1 of rows 8 j + 2 c + e,
  // in acc[4 j + e] and acc[4 j + 2 + e]
  const int g = lane / 4, c = lane % 4;
  const int col = 64 * wg + 16 * warp + 2 * g;
  if (gridDim.z == 1) {
    const float s0 = n0 + col < n ? scale[n0 + col] : 0.f;
    const float s1 = n0 + col + 1 < n ? scale[n0 + col + 1] : 0.f;
    __syncthreads();   // every warpgroup is done with the ring
#pragma unroll
    for (int j = 0; j < NM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<uint32_t*>(sm + out_off(8 * j + 2 * c + e, col)) =
            sm90::pack2<T>(acc[4 * j + e] * s0, acc[4 * j + 2 + e] * s1);
    __syncthreads();
    constexpr int OC = kBN / 8;   // 16-byte chunks of an output row
    for (int e = tid; e < NM * OC; e += kThreads) {
      const int r = e / OC, cn = n0 + e % OC * 8;
      if (m0 + r >= m || cn >= n) continue;
      const uint4 v =
          *reinterpret_cast<const uint4*>(sm + out_off(r, e % OC * 8));
      T* dst = out + (size_t)(m0 + r) * n + cn;
      if (n % 8 == 0) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const T* ve = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (cn + i < n) dst[i] = ve[i];
      }
    }
    return;
  }
  float* p = partial + (size_t)blockIdx.z * m * n;
  const int cn = n0 + col;
#pragma unroll
  for (int j = 0; j < NM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = m0 + 8 * j + 2 * c + e;
      if (r >= m) continue;
      float* prow = p + (size_t)r * n;
      const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
      if (n % 2 == 0) {
        if (cn < n) *reinterpret_cast<float2*>(prow + cn) = make_float2(v0, v1);
      } else {
        if (cn < n) prow[cn] = v0;
        if (cn + 1 < n) prow[cn + 1] = v1;
      }
    }
}

// x (m, k) T, rows ldx apart; w (k/2, n) packed; scale (n,) f32 -> out
// (m, n) T; partial: f32 scratch of splits x m x n values when splits > 1.
template <typename T, int NM>
int run_tile(const void* x, int ldx, const void* w, const void* scale,
             void* out, void* partial, int m, int k, int n, int splits,
             cudaStream_t s) {
  const int kps = dg::steps_per_split(m, k, n, splits);
  if (kps == 0 || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<NM>();
  // the shared-memory limit is raised once per device (a bit each): a
  // call costs the host only its launches
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !(raised >> dev & 1u)) {
    e = mlp::allow_smem(swap_gemm_kernel<T, NM>, smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) raised |= 1u << dev;
  }
  const int wasync =
      n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 ? 1 : 0;
  dim3 grid((m + NM - 1) / NM, (n + kBN - 1) / kBN, splits);
  swap_gemm_kernel<T, NM><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), ldx, static_cast<const unsigned char*>(w),
      static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<float*>(partial), m, k, n, kps, wasync);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t total = (size_t)m * n;
  return (int)mlp::launch_dependent(
      dg::sum_splits_kernel<T>, dim3((unsigned)((total + 255) / 256)), 256,
      0, s, static_cast<const float*>(partial),
      static_cast<const float*>(scale), static_cast<T*>(out), splits, n,
      total);
}

// The plan's tile: bm (the wgmma n) in {8, 64, 128} rows of x by bn = 128
// output columns; anything else is refused.
template <typename T>
int run(const void* x, int ldx, const void* w, const void* scale, void* out,
        void* partial, int m, int k, int n, int bm, int bn, int splits,
        cudaStream_t s) {
  if (ldx < k || ldx % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      bn != kBN)
    return (int)cudaErrorInvalidValue;
  switch (bm) {
    case 8:
      return run_tile<T, 8>(x, ldx, w, scale, out, partial, m, k, n, splits,
                            s);
    case 64:
      return run_tile<T, 64>(x, ldx, w, scale, out, partial, m, k, n, splits,
                             s);
    case 128:
      return run_tile<T, 128>(x, ldx, w, scale, out, partial, m, k, n,
                              splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dsw
