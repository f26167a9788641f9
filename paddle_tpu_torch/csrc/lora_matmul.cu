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
// (256 KiB at r = 16): ~0.7 us, so a call is bound by its launch.
//
// Design: one launch, blocks over (d_out stripe, slot), grouped in
// thread-block clusters of 8 along the stripes (the grid is padded to a
// multiple of 8 stripes; a padding block has no columns but does its
// share of the shrink).  Each block reads its slot's adapter index and
// gathers A[idx]/B[idx] straight from the stacks (no gathered copy).  The
// shrink is split over the cluster: block q of 8 sums d_in slice q, its
// 8 warps each streaming their own 32-wide k sub-chunks (a register
// prefetch of the next sub-chunk, staged through the warp's own shared
// memory, no block-wide barrier inside the k loop; each lane a 2-row x
// r/4-rank register tile).  The warps' partials are summed in a fixed
// order, the cluster's 8 partials read through distributed shared memory
// and summed in a fixed order, rounded to the storage type -- the (16, r)
// intermediate -- and expanded against the stripe's B columns held in
// registers.  Rows go in passes of 16; the rank is padded to 16, 32 or 64
// (a template parameter) with zero columns.  Every product runs on the
// SIMT units in f32, for both storage types.
#include "common.cuh"

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

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
  const cudaError_t e = cudaFuncSetAttribute(
      grouped_bgmv_kernel<T, RP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

}  // namespace

// x (bsz, c, d_in); a (n, d_in, r); b (n, r, d_out); idx (bsz,) int32
// -> out (bsz, c, d_out).  x, a, b and out of one dtype (f32 or bf16),
// contiguous; 1 <= r <= 64.  An index outside [0, n) is clamped.
extern "C" int pt_grouped_bgmv(const void* x, const void* a, const void* b,
                               const void* idx, void* out, int bsz, int c,
                               int d_in, int r, int d_out, int n, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  int rc;
  if (r < 1) {
    rc = (int)cudaErrorInvalidValue;
  } else if (dtype == PT_F32) {
    rc = dispatch_rank<float>(x, a, b, ix, out, bsz, c, d_in, r, d_out, n, s);
  } else if (dtype == PT_BF16) {
    rc = dispatch_rank<__nv_bfloat16>(x, a, b, ix, out, bsz, c, d_in, r,
                                      d_out, n, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
