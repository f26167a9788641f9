// Fused RMSNorm -> Q/K/V projections -> rotate-half RoPE, for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_norm_qkv.py
// (`fused_rms_rope_qkv`, pallas_call at :158).  The numerical contract is
// paddle_tpu/incubate/nn/functional.py `_fused_rms_rope_qkv_ref`:
//   nx = round(x * rsqrt(mean(x^2) + eps) * g)          (f32 math)
//   y  = nx @ W                                          (f32 accumulation)
//   q/k: rope(round(y)) in f32, rounded;  v: round(y)
// where round() is a cast to the storage type.
//
// Bound on an H100: at serving token counts (T = B*C = 128) the kernel
// reads the H x (Nq + 2 Nk) weights once (100.7 MB at llama2-7b) and does
// 2*T*H*(Nq+2Nk) operations, ~64 per weight byte in bf16: below the
// card's ~295 operations per byte, so the weight read bounds it
// (0.031 ms).  At the training T = 4096 the operations bound it (0.42 ms).
//
// Design (bf16).  The TPU kernel norms its x tile in VMEM for each head;
// on this card that made every one of the 96 blocks of a head column sum
// and norm x again.  Here one call is two or three kernels:
//   norm:  one block per row sums x^2 in f32 and writes nx, rounded, to a
//          (T, H) scratch in the storage type -- a rounding point of the
//          contract, so nothing is lost, and 1 MB at T = 128;
//   gemm:  a programmatic dependent launch (it requests its first weight
//          stages before it waits for nx) on csrc/mlp_gemm.cuh's
//          `gemm_tiles`: blocks of two warpgroups own 128 token rows by
//          128 output columns of one of q, k, v (one head at HD = 128, two
//          at HD = 64), wgmma products from a 3-stage cp.async ring of
//          K-major nx and MN-major weight tiles (64-deep steps, a 32-wide
//          tail zero-filled by the copy);
//   RoPE in registers: in the m64n128 accumulator, column c and c + HD/2
//          of a head belong to the same thread (column block j and
//          j + HD/16), so each thread rounds y, rotates in f32 with its
//          row's cos/sin (explicit __fmul_rn/__fadd_rn keep y*c + rot*s
//          unfused, as in the reference), and the result is rounded once
//          more through a swizzled tile into 16-byte stores;
//   split: only where the 128 x 128 tiles are fewer than the SMs (96 at
//          llama2-7b and T = 128, 80 at llama2-70b) is the contraction
//          split (ops/cuda/qkv_plan.py: ceil(SMs / tiles) splits, f32
//          partials within 16 MiB; none at T = 4096); then each split
//          writes an f32 partial and a dependent sum kernel adds them in
//          split order, rounds, applies RoPE and rounds again.  No atomics:
//          two calls give the same bits.
//
// f32 keeps the SIMT tile of norm_qkv_tile.cuh (64 token rows by one head
// per block, full f32 products on the SIMT units), which mega_decode.cu
// shares.
#include "mlp_gemm.cuh"
#include "norm_qkv_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kNormThreads = 128;
constexpr int kBN = 128;   // output columns per bf16 GEMM block

// nx (t, h) = round(x * rsqrt(mean(x^2) + eps) * g), one block per row,
// 16-byte vectors (h % 8 == 0).  The GEMM after it is a dependent launch.
__global__ void __launch_bounds__(kNormThreads)
rms_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                bf16* __restrict__ nx, int h, float eps) {
  sm90::launch_dependents();   // the GEMM may start fetching its weights
  __shared__ float warp_sums[kNormThreads / 32];
  const bf16* xr = x + (size_t)blockIdx.x * h;
  float s = 0.f;
  for (int c = threadIdx.x * 8; c < h; c += kNormThreads * 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = pt::to_f(e[i]);
      s += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kNormThreads / 32; ++w) total += warp_sums[w];
  const float rstd = rsqrtf(total / (float)h + eps);
  bf16* out = nx + (size_t)blockIdx.x * h;
  for (int c = threadIdx.x * 8; c < h; c += kNormThreads * 8) {
    const uint4 ux = *reinterpret_cast<const uint4*>(xr + c);
    const uint4 ug = *reinterpret_cast<const uint4*>(g + c);
    const bf16* ex = reinterpret_cast<const bf16*>(&ux);
    const bf16* eg = reinterpret_cast<const bf16*>(&ug);
    uint32_t p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = sm90::pack2<bf16>(pt::to_f(ex[2 * i]) * rstd * pt::to_f(eg[2 * i]),
                               pt::to_f(ex[2 * i + 1]) * rstd *
                                   pt::to_f(eg[2 * i + 1]));
    *reinterpret_cast<uint4*>(out + c) = make_uint4(p[0], p[1], p[2], p[3]);
  }
}

// lo, hi = round(lo), round(hi) rotated by cos/sin (c_lo, s_lo of column
// j, c_hi, s_hi of column j + HD/2), in f32 with explicit roundings so
// y*c + rot*s stays unfused.
__device__ __forceinline__ void rope_pair(float& lo, float& hi, float c_lo,
                                          float s_lo, float c_hi,
                                          float s_hi) {
  const float a = pt::round_to<bf16>(lo), b = pt::round_to<bf16>(hi);
  lo = __fadd_rn(__fmul_rn(a, c_lo), __fmul_rn(-b, s_lo));
  hi = __fadd_rn(__fmul_rn(b, c_hi), __fmul_rn(a, s_hi));
}

// RoPE on the block's m64n128 accumulator in place (sm90.cuh gives the
// layout): column block j (8 columns) of a head pairs with j + HD/16.
template <int HD>
__device__ __forceinline__ void rope_regs(float (&d)[kBN / 2],
                                          const bf16* __restrict__ cos,
                                          const bf16* __restrict__ sin,
                                          int t, int m0) {
  constexpr int HALF = HD / 2, PJ = HALF / 8;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    if ((8 * j) % HD >= HALF) continue;
    const int c = mlp::acc_col(j, 0) % HD;   // even, < HALF
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + mlp::acc_row(i);
      if (r >= t) continue;
      const size_t o = (size_t)r * HD + c;
      const __nv_bfloat162 cl = *reinterpret_cast<const __nv_bfloat162*>(cos + o);
      const __nv_bfloat162 ch =
          *reinterpret_cast<const __nv_bfloat162*>(cos + o + HALF);
      const __nv_bfloat162 sl = *reinterpret_cast<const __nv_bfloat162*>(sin + o);
      const __nv_bfloat162 sh =
          *reinterpret_cast<const __nv_bfloat162*>(sin + o + HALF);
      rope_pair(d[4 * j + 2 * i], d[4 * (j + PJ) + 2 * i],
                __low2float(cl), __low2float(sl), __low2float(ch),
                __low2float(sh));
      rope_pair(d[4 * j + 2 * i + 1], d[4 * (j + PJ) + 2 * i + 1],
                __high2float(cl), __high2float(sl), __high2float(ch),
                __high2float(sh));
    }
  }
}

// y = nx @ W over 128 x 128 tiles; grid (row tiles, column tiles of
// [q | k | v], splits).  One split: round, RoPE on q and k, round, store.
// Splits: split z's f32 product over contraction steps [z kps, (z + 1)
// kps) into partial + z t (nq + 2 nk), columns in [q | k | v] order.
template <int HD>
__global__ void __launch_bounds__(mlp::kThreads, mlp::kMinBlocks)
qkv_gemm_kernel(const bf16* __restrict__ nx, const bf16* __restrict__ wq,
                const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                const bf16* __restrict__ cos, const bf16* __restrict__ sin,
                bf16* __restrict__ q, bf16* __restrict__ k,
                bf16* __restrict__ v, float* __restrict__ partial, int t,
                int h, int nq, int nk, int kps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = mlp::align1024(smem_raw);
  sm90::launch_dependents();   // the split sum may start its launch
  const int tq = (nq + kBN - 1) / kBN, tk = (nk + kBN - 1) / kBN;
  int tile = blockIdx.y, kind, nw, coff;
  const bf16* w;
  bf16* out;
  if (tile < tq) {
    kind = 0; w = wq; out = q; nw = nq; coff = 0;
  } else if (tile < tq + tk) {
    tile -= tq; kind = 1; w = wk; out = k; nw = nk; coff = nq;
  } else {
    tile -= tq + tk; kind = 2; w = wv; out = v; nw = nk; coff = nq + nk;
  }
  const int m0 = blockIdx.x * mlp::kBM, n0 = tile * kBN;
  const int ncols = min(kBN, nw - n0);
  const int steps = (h + mlp::kBK - 1) / mlp::kBK;
  const int kb = blockIdx.z * kps, ke = min(steps, kb + kps);
  float acc[1][kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[0][i] = 0.f;
  const bf16* const ws[1] = {w};
  mlp::gemm_tiles<1, kBN, true, true>(sm, nx, h, t, m0, ws, nw, n0, kb, ke,
                                      acc, h, ncols);
  if (gridDim.z == 1) {
    if (kind != 2) rope_regs<HD>(acc[0], cos, sin, t, m0);
    mlp::store_rows<kBN>(out, nw, t, m0, n0, sm, acc[0], ncols);
    return;
  }
  const int ntot = nq + 2 * nk;
  float* p = partial + (size_t)blockIdx.z * t * ntot + coff + n0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + mlp::acc_row(i);
    if (r >= t) continue;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = mlp::acc_col(j, 0);
      if (c < ncols)
        *reinterpret_cast<float2*>(p + (size_t)r * ntot + c) =
            make_float2(acc[0][4 * j + 2 * i], acc[0][4 * j + 2 * i + 1]);
    }
  }
}

// The splits' partials added in split order for columns j and j + HD/2 of
// one head of one row, rounded, RoPE on q and k, rounded again.  A
// dependent launch after the GEMM.
template <int HD>
__global__ void qkv_sum_kernel(const float* __restrict__ partial,
                               const bf16* __restrict__ cos,
                               const bf16* __restrict__ sin,
                               bf16* __restrict__ q, bf16* __restrict__ k,
                               bf16* __restrict__ v, int t, int nq, int nk,
                               int splits) {
  constexpr int HALF = HD / 2;
  const int half_cols = (nq + 2 * nk) / 2;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  sm90::grid_dependency_wait();
  if (idx >= (size_t)t * half_cols) return;
  const int r = (int)(idx / half_cols), u = (int)(idx % half_cols);
  const int col = u / HALF * HD + u % HALF, j = u % HALF;
  const size_t plane = (size_t)t * 2 * half_cols;
  const float* p = partial + (size_t)r * 2 * half_cols + col;
  float lo = 0.f, hi = 0.f;
  for (int s = 0; s < splits; ++s) {
    lo += p[s * plane];
    hi += p[s * plane + HALF];
  }
  bf16* out;
  int ld, oc;
  if (col < nq) {
    out = q; ld = nq; oc = col;
  } else if (col < nq + nk) {
    out = k; ld = nk; oc = col - nq;
  } else {
    out = v; ld = nk; oc = col - nq - nk;
  }
  if (col < nq + nk) {   // q or k
    const bf16* cr = cos + (size_t)r * HD;
    const bf16* sr = sin + (size_t)r * HD;
    rope_pair(lo, hi, pt::to_f(cr[j]), pt::to_f(sr[j]),
              pt::to_f(cr[HALF + j]), pt::to_f(sr[HALF + j]));
  }
  out[(size_t)r * ld + oc] = pt::from_f<bf16>(lo);
  out[(size_t)r * ld + oc + HALF] = pt::from_f<bf16>(hi);
}

template <int HD>
int launch_bf16(const bf16* x, const bf16* g, const bf16* wq,
                const bf16* wk, const bf16* wv, const bf16* cos,
                const bf16* sin, bf16* nx, float* partial, bf16* q,
                bf16* k, bf16* v, int t, int h, int nq, int nk, float eps,
                int splits, cudaStream_t s) {
  const int steps = (h + mlp::kBK - 1) / mlp::kBK;
  const int kps = splits >= 1 ? (steps + splits - 1) / splits : 0;
  if (kps == 0 || (splits - 1) * kps >= steps || nx == nullptr ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = mlp::smem_bytes<1, kBN>();
  cudaError_t e = mlp::allow_smem(qkv_gemm_kernel<HD>, smem);
  if (e != cudaSuccess) return (int)e;
  rms_norm_kernel<<<t, kNormThreads, 0, s>>>(x, g, nx, h, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = (nq + kBN - 1) / kBN + 2 * ((nk + kBN - 1) / kBN);
  dim3 grid((t + mlp::kBM - 1) / mlp::kBM, tiles, splits);
  e = mlp::launch_dependent(qkv_gemm_kernel<HD>, grid, mlp::kThreads, smem,
                            s, (const bf16*)nx, wq, wk, wv, cos, sin, q, k,
                            v, partial, t, h, nq, nk, kps);
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t pairs = (size_t)t * ((nq + 2 * nk) / 2);
  return (int)mlp::launch_dependent(
      qkv_sum_kernel<HD>, dim3((unsigned)((pairs + 255) / 256)), 256, 0, s,
      (const float*)partial, cos, sin, q, k, v, t, nq, nk, splits);
}

// f32: one 64-row SIMT tile of one head per block (norm_qkv_tile.cuh).
template <int HD>
__global__ void __launch_bounds__(pt_tile::kThreads)
qkv_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ wq, const float* __restrict__ wk,
               const float* __restrict__ wv, const float* __restrict__ cos,
               const float* __restrict__ sin, float* __restrict__ q,
               float* __restrict__ k, float* __restrict__ v, int t, int h,
               int nq, int nk, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  pt_tile::qkv_tile<float, HD>(x, g, wq, wk, wv, cos, sin, q, k, v, t, h,
                               nq, nk, eps, blockIdx.x * pt_tile::kBT,
                               blockIdx.y, smem);
}

template <int HD>
int launch_f32(const float* x, const float* g, const float* wq,
               const float* wk, const float* wv, const float* cos,
               const float* sin, float* q, float* k, float* v, int t, int h,
               int nq, int nk, float eps, int splits, cudaStream_t s) {
  if (splits != 1) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = pt_tile::smem_bytes<float, HD>();
  cudaError_t e = mlp::allow_smem(qkv_f32_kernel<HD>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((t + pt_tile::kBT - 1) / pt_tile::kBT, nq / HD + 2 * (nk / HD));
  qkv_f32_kernel<HD><<<grid, pt_tile::kThreads, smem, s>>>(
      x, g, wq, wk, wv, cos, sin, q, k, v, t, h, nq, nk, eps);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch(const void* x, const void* g, const void* wq, const void* wk,
             const void* wv, const void* cos, const void* sin, void* nx,
             void* partial, void* q, void* k, void* v, int t, int h, int nq,
             int nk, float eps, int dtype, int splits, cudaStream_t s) {
  if (dtype == PT_BF16)
    return launch_bf16<HD>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g),
        static_cast<const bf16*>(wq), static_cast<const bf16*>(wk),
        static_cast<const bf16*>(wv), static_cast<const bf16*>(cos),
        static_cast<const bf16*>(sin), static_cast<bf16*>(nx),
        static_cast<float*>(partial), static_cast<bf16*>(q),
        static_cast<bf16*>(k), static_cast<bf16*>(v), t, h, nq, nk, eps,
        splits, s);
  if (dtype == PT_F32)
    return launch_f32<HD>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(wq), static_cast<const float*>(wk),
        static_cast<const float*>(wv), static_cast<const float*>(cos),
        static_cast<const float*>(sin), static_cast<float*>(q),
        static_cast<float*>(k), static_cast<float*>(v), t, h, nq, nk, eps,
        splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (t, h); g (h,); wq (h, nq); wk/wv (h, nk); cos/sin (t, head_dim)
// -> q (t, nq), k/v (t, nk).  All row-major, all of one dtype (PT_F32 or
// PT_BF16), 16-byte aligned.  Needs t >= 1, h % 32 == 0, head_dim in
// {64, 128}, nq and nk multiples of it.  The plan (ops/cuda/qkv_plan.py):
// bf16 takes nx, a (t, h) bf16 scratch, and `splits` contraction splits
// (partial: f32 scratch of splits x t x (nq + 2 nk) values when splits >
// 1); f32 takes splits == 1 and no scratch.  A plan this source cannot
// run returns cudaErrorInvalidValue before any launch.
extern "C" int pt_fused_rms_rope_qkv(const void* x, const void* g,
                                     const void* wq, const void* wk,
                                     const void* wv, const void* cos,
                                     const void* sin, void* nx,
                                     void* partial, void* q, void* k,
                                     void* v, int t, int h, int nq, int nk,
                                     int head_dim, float eps, int dtype,
                                     int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t < 1 || h < 32 || h % 32 || nq < head_dim || nk < head_dim ||
      (head_dim != 64 && head_dim != 128) || nq % head_dim ||
      nk % head_dim)
    return (int)cudaErrorInvalidValue;
  if (head_dim == 128)
    return dispatch<128>(x, g, wq, wk, wv, cos, sin, nx, partial, q, k, v,
                         t, h, nq, nk, eps, dtype, splits, s);
  return dispatch<64>(x, g, wq, wk, wv, cos, sin, nx, partial, q, k, v, t,
                      h, nq, nk, eps, dtype, splits, s);
}
