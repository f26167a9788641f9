// Grouped BGMV for batched multi-LoRA serving, for sm_90a:
// out[b] = round(round(x[b] @ A[idx[b]]) @ B[idx[b]]) per batch slot.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/lora_matmul.py
// (`grouped_bgmv`, pallas_call at :109).  The contract is
// paddle_tpu/incubate/nn/functional.py `_lora_bgmv_ref`: the shrink
// x_b (C, d_in) @ A (d_in, r) accumulated in f32 and rounded to the
// storage type, then the expand (C, r) @ B (r, d_out) accumulated in f32
// and rounded.  Slot index 0 is the reserved no-op: its rows are written
// as exact zeros and no product is formed, so base requests stay bitwise
// equal to a LoRA-less engine.
//
// Bound on an H100: bytes, and tiny: x and out (1 MiB each at the 7B
// step, C = 16, B = 8, d = 4096, bf16) plus each distinct adapter's A/B
// (256 KiB at r = 16): under 1 us, so a call is bound by its launch and
// by the latency of its dependent passes (shrink, sum, expand).
//
// bf16 (`tc::`): one launch, a thread-block cluster of 16 blocks per slot
// (each block's d_in slice from ops/cuda/bgmv_plan.py), so the shrink
// runs once per slot and needs no scratch and no second launch -- on the
// serving step, which the host sets, a second launch and a scratch
// allocation per call cost more host time than they saved on the card.
// - Shrink: block q of a cluster takes d_in piece q (`slice` wide) in
//   256-column stages on a two-stage ring of 16-byte cp.async copies of x
//   and A[idx]; its 4 warps take the 16-deep steps in turn (mma.sync
//   m16n8k16, bf16 in, f32 sums; 16 x rows is mma's M, the rank padded
//   with zero columns to the next multiple of 16 its N); the warps' sums,
//   added in warp order, are the block's partial.
// - Sum: the cluster's partials are read through distributed shared
//   memory and added in rank order in f32, then rounded to bf16 -- the
//   contract's (16, r) intermediate, the same in every block.
// - Expand: each block takes output tiles q, q + 16, ... (128 columns),
//   its B[idx] tiles on a two-stage ring whose first two tiles are copied
//   during the shrink; mma.sync with the padded rank as K; the rounded
//   rows staged in shared memory for 16-byte stores.
// - Index 0: the whole cluster writes zeros with 16-byte stores and forms
//   no product.  Rows come in passes of 16.  Rows of x, A, B and out go
//   by 16 bytes where their width is a multiple of 8 elements, element by
//   element otherwise (d_in 100 is an edge case).
// f32 (`simt::`): one launch, blocks over (d_out stripe, slot) in
// thread-block clusters of 8 along the stripes; the shrink split over the
// cluster, its 8 partials read through distributed shared memory and
// added in a fixed order, the expand against the stripe's B columns held
// in registers, SIMT products.
#include "common.cuh"
#include "sm90.cuh"

#include <cooperative_groups.h>
#include <cstdint>

namespace {

namespace cg = cooperative_groups;

namespace simt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;    // x rows per shrink pass
constexpr int kCluster = 8;  // blocks sharing one shrink

template <int RP>
__host__ __device__ constexpr int cols_per_thread() {
  return RP <= 16 ? 2 : 1;
}

// Dynamic shared memory: per-warp staging of x (32 k x 16 rows) and A
// (32 k x RP), which the cross-warp partials reuse after the k loop; the
// block's partial, read by its cluster; the rounded intermediate.
template <int RP>
__host__ __device__ constexpr size_t smem_floats() {
  return (size_t)kWarps * 32 * (kRows + RP) + 2 * kRows * RP;
}

template <typename T, int RP>
__global__ void __launch_bounds__(kThreads) __cluster_dims__(kCluster, 1, 1)
grouped_bgmv_kernel(const T* __restrict__ x, const T* __restrict__ a,
                    const T* __restrict__ bst, const int* __restrict__ idx,
                    T* __restrict__ out, int c, int d_in, int r, int d_out,
                    int n) {
  constexpr int CPT = cols_per_thread<RP>();
  constexpr int SW = kThreads * CPT;          // stripe width
  constexpr int RQ = RP / 4;                  // ranks per lane
  extern __shared__ __align__(16) float smem[];
  float* xw = smem;                                 // [warp][32][kRows]
  float* aw = xw + kWarps * 32 * kRows;             // [warp][32][RP]
  float* red = smem;                    // [warp][kRows][RP], after the loop
  float* pb = aw + kWarps * 32 * RP;                // [kRows][RP]
  float* hs = pb + kRows * RP;                      // [kRows][RP]

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int slot = blockIdx.y;
  const int col0 = blockIdx.x * SW;
  // one slot per cluster: the whole cluster takes the same branch here
  const int ad = min(max(idx[slot], 0), n - 1);
  T* orows = out + (size_t)slot * c * d_out;

  if (ad == 0) {                 // the base no-op: exact zeros
    for (int row = 0; row < c; ++row)
      for (int j = 0; j < CPT; ++j) {
        const int col = col0 + j * kThreads + tid;
        if (col < d_out)
          orows[(size_t)row * d_out + col] = pt::from_f<T>(0.f);
      }
    return;
  }

  const T* xb = x + (size_t)slot * c * d_in;
  const T* aa = a + (size_t)ad * d_in * r;
  const T* bb = bst + (size_t)ad * r * d_out;
  float breg[CPT][RP];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int col = col0 + j * kThreads + tid;
#pragma unroll
    for (int q = 0; q < RP; ++q)
      breg[j][q] = (col < d_out && q < r)
                       ? pt::to_f(bb[(size_t)q * d_out + col]) : 0.f;
  }

  // this block's d_in slice, in sub-chunks of 32
  const int per = ((d_in + kCluster * 32 - 1) / (kCluster * 32)) * 32;
  const int k_lo = (int)cluster.block_rank() * per;
  const int k_hi = min(d_in, k_lo + per);
  const int nsub = k_hi > k_lo ? (k_hi - k_lo + 31) / 32 : 0;
  const int ri0 = 2 * (lane / 4), q0 = (lane % 4) * RQ;
  float* xme = xw + warp * 32 * kRows;
  float* ame = aw + warp * 32 * RP;

  for (int c0 = 0; c0 < c; c0 += kRows) {
    float acc[2][RQ];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) acc[i][j] = 0.f;
    float xr[kRows], ar[RP];
    auto load = [&](int sub) {   // lane: k = k_lo + 32 sub + lane
      const int k = k_lo + sub * 32 + lane;
      const bool in = k < k_hi;
#pragma unroll
      for (int row = 0; row < kRows; ++row)
        xr[row] = (in && c0 + row < c)
                      ? pt::to_f(xb[(size_t)(c0 + row) * d_in + k]) : 0.f;
#pragma unroll
      for (int q = 0; q < RP; ++q)
        ar[q] = (in && q < r) ? pt::to_f(aa[(size_t)k * r + q]) : 0.f;
    };
    if (warp < nsub) load(warp);
    for (int sub = warp; sub < nsub; sub += kWarps) {
#pragma unroll
      for (int row = 0; row < kRows; row += 4)
        *reinterpret_cast<float4*>(xme + lane * kRows + row) =
            make_float4(xr[row], xr[row + 1], xr[row + 2], xr[row + 3]);
#pragma unroll
      for (int q = 0; q < RP; q += 4)
        *reinterpret_cast<float4*>(ame + lane * RP + q) =
            make_float4(ar[q], ar[q + 1], ar[q + 2], ar[q + 3]);
      __syncwarp();
      if (sub + kWarps < nsub) load(sub + kWarps);   // next, in flight
#pragma unroll 4
      for (int kk = 0; kk < 32; ++kk) {
        const float2 xv =
            *reinterpret_cast<const float2*>(xme + kk * kRows + ri0);
#pragma unroll
        for (int j = 0; j < RQ; j += 4) {
          const float4 av =
              *reinterpret_cast<const float4*>(ame + kk * RP + q0 + j);
          acc[0][j] += xv.x * av.x; acc[0][j + 1] += xv.x * av.y;
          acc[0][j + 2] += xv.x * av.z; acc[0][j + 3] += xv.x * av.w;
          acc[1][j] += xv.y * av.x; acc[1][j + 1] += xv.y * av.y;
          acc[1][j + 2] += xv.y * av.z; acc[1][j + 3] += xv.y * av.w;
        }
      }
      __syncwarp();
    }
    __syncthreads();             // every warp is out of its staging area
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j)
        red[(warp * kRows + ri0 + i) * RP + q0 + j] = acc[i][j];
    __syncthreads();
    for (int o = tid; o < kRows * RP; o += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w * kRows * RP + o];
      pb[o] = s;
    }
    cluster.sync();              // every block's partial is written
    for (int o = tid; o < kRows * RP; o += kThreads) {
      float s = 0.f;
      for (int q = 0; q < kCluster; ++q)
        s += cluster.map_shared_rank(pb, q)[o];
      hs[o] = pt::round_to<T>(s);
    }
    cluster.sync();              // no block reads pb any more
    // expand: each thread its CPT columns of the stripe
    const int nrow = min(kRows, c - c0);
    for (int row = 0; row < nrow; ++row) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = col0 + j * kThreads + tid;
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < RP; ++q) s += hs[row * RP + q] * breg[j][q];
        if (col < d_out)
          orows[(size_t)(c0 + row) * d_out + col] = pt::from_f<T>(s);
      }
    }
    __syncthreads();
  }
}

template <typename T, int RP>
int launch(const void* x, const void* a, const void* b, const int* idx,
           void* out, int bsz, int c, int d_in, int r, int d_out, int n,
           cudaStream_t stream) {
  constexpr int SW = kThreads * cols_per_thread<RP>();
  constexpr size_t smem = smem_floats<RP>() * sizeof(float);
  const cudaError_t e =
      pt::allow_smem_once<grouped_bgmv_kernel<T, RP>>(smem);
  if (e != cudaSuccess) return (int)e;
  const int stripes = (d_out + SW - 1) / SW;
  dim3 grid((stripes + kCluster - 1) / kCluster * kCluster, bsz);
  grouped_bgmv_kernel<T, RP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b), idx, static_cast<T*>(out), c, d_in, r, d_out,
      n);
  return 0;
}

template <typename T>
int dispatch_rank(const void* x, const void* a, const void* b,
                  const int* idx, void* out, int bsz, int c, int d_in, int r,
                  int d_out, int n, cudaStream_t s) {
  if (r <= 16)
    return launch<T, 16>(x, a, b, idx, out, bsz, c, d_in, r, d_out, n, s);
  if (r <= 32)
    return launch<T, 32>(x, a, b, idx, out, bsz, c, d_in, r, d_out, n, s);
  if (r <= 64)
    return launch<T, 64>(x, a, b, idx, out, bsz, c, d_in, r, d_out, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace simt

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;    // rows per product (mma M)
constexpr int kTN = 128;     // expand columns per tile, 32 per warp
constexpr int kKC = 256;     // shrink columns per ring stage
constexpr int kCluster = 16; // blocks per slot, one d_in slice each

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// rows x n elements of a row-major source (row pitch `pitch`, `valid`
// columns from `src`) into shared rows of `ld` elements, zero past
// `valid` and past `rows_valid`: 16-byte cp.async where `vec`, element
// copies otherwise.  n is a multiple of 8.
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          size_t pitch, int rows,
                                          int rows_valid, int n, int valid,
                                          bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * (n / 8); e += kThreads) {
      const int i = e / (n / 8), col = (e % (n / 8)) * 8;
      const bool ok = i < rows_valid && col < valid;
      sm90::cp_async16(sm90::smem_addr(dst + i * ld + col),
                       ok ? src + i * pitch + col : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * n; e += kThreads) {
      const int i = e / n, col = e % n;
      dst[i * ld + col] = i < rows_valid && col < valid
                              ? src[i * pitch + col] : __float2bfloat16_rn(0.f);
    }
  }
}

// Shared memory of one block: the shrink's ring of x and A stages, the
// expand's ring of B tiles, the warps' sums, the block's partial (read by
// its cluster), the rounded intermediate and the output staging.
template <int RP>
struct Smem {
  static constexpr int LX = kKC + 8, LA = RP + 8, LB = kTN + 8, LH = RP + 8;
  static constexpr size_t xs = 0;
  static constexpr size_t as = xs + 2 * kRows * LX * 2;
  static constexpr size_t bs = as + 2 * kKC * LA * 2;
  static constexpr size_t red = bs + 2 * RP * LB * 2;
  static constexpr size_t part = red + kWarps * kRows * RP * 4;
  static constexpr size_t hs = part + kRows * RP * 4;
  static constexpr size_t os = hs + kRows * LH * 2;
  static constexpr size_t bytes = os + kRows * LB * 2;
};

// One slot per thread-block cluster of 16 blocks (grid: 16 x slots).
// Block q shrinks d_in piece q ([q slice, (q + 1) slice)) in 256-column
// ring stages, its 4 warps taking the 16-deep steps in turn; the warps'
// sums are added in warp order into the block's partial; the cluster's
// partials are read through distributed shared memory and added in rank
// order and rounded to bf16 -- the contract's intermediate, the same in
// every block -- and each block expands output tiles q, q + 16, ... (128
// columns) from it, B tiles on a two-stage ring, rounded rows staged for
// 16-byte stores.  Rows go in passes of 16.  Index 0 writes zeros and
// forms no product.
template <int RP>
__global__ void __launch_bounds__(kThreads)
bgmv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
            const bf16* __restrict__ bst, const int* __restrict__ idx,
            bf16* __restrict__ out, int c, int d_in, int r, int d_out, int n,
            int slice) {
  using S = Smem<RP>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int slot = blockIdx.y;
  const int ad = min(max(idx[slot], 0), n - 1);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gi = lane / 4, ci = lane % 4;
  const int ntiles = (d_out + kTN - 1) / kTN;
  const int passes = (c + kRows - 1) / kRows;
  const bool vo = d_out % 8 == 0 && aligned16(out);
  bf16* orows = out + (size_t)slot * c * d_out;

  // store rows [row0, row0 + nrow) x columns of tile j from `src` (shared,
  // pitch LB), or zeros when src is null
  auto store_tile = [&](int j, int row0, int nrow, const bf16* src) {
    const int col0 = j * kTN, ncol = min(kTN, d_out - col0);
    bf16* dst = orows + (size_t)row0 * d_out + col0;
    if (vo) {
      for (int e = tid; e < nrow * (ncol / 8); e += kThreads) {
        const int i = e / (ncol / 8), col = (e % (ncol / 8)) * 8;
        *reinterpret_cast<uint4*>(dst + (size_t)i * d_out + col) =
            src ? *reinterpret_cast<const uint4*>(src + i * S::LB + col)
                : make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int e = tid; e < nrow * ncol; e += kThreads) {
        const int i = e / ncol, col = e % ncol;
        dst[(size_t)i * d_out + col] =
            src ? src[i * S::LB + col] : __float2bfloat16_rn(0.f);
      }
    }
  };
  if (ad == 0) {                 // the base no-op: the whole cluster
    for (int j = rank; j < ntiles; j += kCluster)
      store_tile(j, 0, c, nullptr);
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + S::xs);    // [2][16][LX]
  bf16* as = reinterpret_cast<bf16*>(smem + S::as);    // [2][kKC][LA]
  bf16* bs = reinterpret_cast<bf16*>(smem + S::bs);    // [2][RP][LB]
  float* red = reinterpret_cast<float*>(smem + S::red);  // [4][16][RP]
  float* part = reinterpret_cast<float*>(smem + S::part);  // [16][RP]
  bf16* hs = reinterpret_cast<bf16*>(smem + S::hs);    // [16][LH]
  bf16* os = reinterpret_cast<bf16*>(smem + S::os);    // [16][LB]

  const int k0 = rank * slice, k1 = min(d_in, k0 + slice);
  const int chunks = k1 > k0 ? (k1 - k0 + kKC - 1) / kKC : 0;
  const bool vx = d_in % 8 == 0 && aligned16(x);
  const bool va = r % 8 == 0 && aligned16(a);
  const bool vb = d_out % 8 == 0 && aligned16(bst);
  const bf16* bb = bst + (size_t)ad * r * d_out;
  auto load_b = [&](int j, int buf) {
    load_rows(bs + buf * RP * S::LB, S::LB, bb + j * kTN, d_out, RP, r, kTN,
              min(kTN, d_out - j * kTN), vb);
  };
  auto load_k = [&](int t, int ch, int buf) {
    const int kc = k0 + ch * kKC, kn = min(kKC, k1 - kc);
    load_rows(xs + buf * kRows * S::LX, S::LX,
              x + ((size_t)slot * c + t * kRows) * d_in + kc, d_in, kRows,
              min(kRows, c - t * kRows), kKC, kn, vx);
    load_rows(as + buf * kKC * S::LA, S::LA, a + ((size_t)ad * d_in + kc) * r,
              r, kKC, kn, RP, r, va);
  };

  for (int t = 0; t < passes; ++t) {
    // the block's first two B tiles: in flight during the shrink
    if (rank < ntiles) load_b(rank, 0);
    if (rank + kCluster < ntiles) load_b(rank + kCluster, 1);
    if (chunks) load_k(t, 0, 0);
    sm90::cp_async_commit();
    float acc[RP / 8][4];
#pragma unroll
    for (int j = 0; j < RP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int ch = 0; ch < chunks; ++ch) {
      const int buf = ch & 1;
      if (ch + 1 < chunks) load_k(t, ch + 1, buf ^ 1);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
      __syncthreads();
      const int steps = (min(kKC, k1 - k0 - ch * kKC) + 15) / 16;
      const uint32_t x_lane = sm90::smem_addr(
          xs + buf * kRows * S::LX +
          (8 * ((lane / 8) % 2) + lane % 8) * S::LX + 8 * (lane / 16));
      const uint32_t a_lane = sm90::smem_addr(
          as + buf * kKC * S::LA +
          (8 * ((lane / 8) % 2) + lane % 8) * S::LA + 8 * (lane / 16));
      for (int kk = warp; kk < steps; kk += kWarps) {
        uint32_t fa[4];
        sm90::ldmatrix_x4(fa, x_lane + kk * 32);
#pragma unroll
        for (int j = 0; j < RP / 16; ++j) {
          uint32_t fb[4];
          sm90::ldmatrix_x4_trans(fb, a_lane + (kk * 16 * S::LA + j * 16) * 2);
          sm90::mma_16816(acc[2 * j], fa, fb[0], fb[1]);
          sm90::mma_16816(acc[2 * j + 1], fa, fb[2], fb[3]);
        }
      }
      __syncthreads();           // the stage's buffer may be refilled
    }
    // an empty group: the expand's first wait then covers the B tiles
    // even where this block's piece was empty
    sm90::cp_async_commit();
#pragma unroll
    for (int j = 0; j < RP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(red + (warp * kRows + gi + 8 * i) * RP +
                                   8 * j + 2 * ci) =
            make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    __syncthreads();
    for (int o = tid; o < kRows * RP; o += kThreads) {
      float s = red[o];
      for (int w = 1; w < kWarps; ++w) s += red[w * kRows * RP + o];
      part[o] = s;
    }
    cluster.sync();              // every block's partial is written
    for (int o = tid; o < kRows * RP; o += kThreads) {
      float s = 0.f;
      for (int q = 0; q < kCluster; ++q)
        s += cluster.map_shared_rank(part, q)[o];
      hs[(o / RP) * S::LH + o % RP] = __float2bfloat16_rn(s);
    }
    cluster.sync();              // no block reads a partial any more
    const int nrow = min(kRows, c - t * kRows);
    const uint32_t h_lane = sm90::smem_addr(
        hs + (8 * ((lane / 8) % 2) + lane % 8) * S::LH + 8 * (lane / 16));
    int buf = 0;
    for (int j = rank; j < ntiles; j += kCluster, buf ^= 1) {
      // tile j landed; tile j + kCluster may be in flight
      sm90::cp_async_wait<1>();
      __syncthreads();
      float o4[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) o4[q][e] = 0.f;
      const uint32_t b_lane = sm90::smem_addr(
          bs + buf * RP * S::LB + (8 * ((lane / 8) % 2) + lane % 8) * S::LB +
          warp * 32 + 8 * (lane / 16));
#pragma unroll
      for (int kk = 0; kk < RP / 16; ++kk) {
        uint32_t fa[4];
        sm90::ldmatrix_x4(fa, h_lane + kk * 32);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t fb[4];
          sm90::ldmatrix_x4_trans(fb, b_lane + (kk * 16 * S::LB + q * 16) * 2);
          sm90::mma_16816(o4[2 * q], fa, fb[0], fb[1]);
          sm90::mma_16816(o4[2 * q + 1], fa, fb[2], fb[3]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(os + (gi + 8 * i) * S::LB + warp * 32 +
                                       8 * q + 2 * ci) =
              sm90::pack2<bf16>(o4[q][2 * i], o4[q][2 * i + 1]);
      __syncthreads();           // os is written, the B buffer read
      if (j + 2 * kCluster < ntiles) load_b(j + 2 * kCluster, buf);
      sm90::cp_async_commit();
      store_tile(j, t * kRows, nrow, os);
      __syncthreads();           // os is refilled next
    }
  }
}

template <int RP>
int launch(const void* x, const void* a, const void* b, const int* idx,
           void* out, int bsz, int c, int d_in, int r, int d_out, int n,
           int slice, cudaStream_t stream) {
  cudaError_t e = pt::allow_smem_once<bgmv_kernel<RP>>(Smem<RP>::bytes);
  if (e == cudaSuccess)          // clusters of 16 exceed the portable 8
    e = pt::func_attr_once<bgmv_kernel<RP>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed>(1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, bsz);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Smem<RP>::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, bgmv_kernel<RP>, static_cast<const bf16*>(x),
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), idx,
      static_cast<bf16*>(out), c, d_in, r, d_out, n, slice);
}

}  // namespace tc

}  // namespace

// x (bsz, c, d_in); a (n, d_in, r); b (n, r, d_out); idx (bsz,) int32
// -> out (bsz, c, d_out).  x, a, b and out of one dtype (f32 or bf16),
// contiguous; 1 <= r <= 64.  An index outside [0, n) is clamped.  bf16
// takes the plan's d_in slice (a multiple of 64 with 16 x slice >= d_in);
// f32 ignores it.
extern "C" int pt_grouped_bgmv(const void* x, const void* a, const void* b,
                               const void* idx, void* out, int bsz, int c,
                               int d_in, int r, int d_out, int n,
                               int slice, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  int rc;
  if (r < 1 || r > 64) {
    rc = (int)cudaErrorInvalidValue;
  } else if (dtype == PT_F32) {
    rc = simt::dispatch_rank<float>(x, a, b, ix, out, bsz, c, d_in, r, d_out,
                                    n, s);
  } else if (dtype == PT_BF16) {
    if (slice < 64 || slice % 64 || (long long)tc::kCluster * slice < d_in ||
        bsz > 65535) {
      rc = (int)cudaErrorInvalidValue;
    } else if (r <= 16) {
      rc = tc::launch<16>(x, a, b, ix, out, bsz, c, d_in, r, d_out, n, slice,
                          s);
    } else if (r <= 32) {
      rc = tc::launch<32>(x, a, b, ix, out, bsz, c, d_in, r, d_out, n, slice,
                          s);
    } else if (r <= 48) {
      rc = tc::launch<48>(x, a, b, ix, out, bsz, c, d_in, r, d_out, n, slice,
                          s);
    } else {
      rc = tc::launch<64>(x, a, b, ix, out, bsz, c, d_in, r, d_out, n, slice,
                          s);
    }
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
