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
// reads the H x (Nq + 2 Nk) weights once and does 2*T*H*(Nq+2Nk)
// operations, ~64 per weight byte in bf16: below the card's ~295
// operations per byte, so the weight read bounds it.  bf16 runs its
// products on the tensor cores (WMMA, mma.sync 16x16x16 with f32
// accumulation); f32 runs them on the SIMT units so it stays full f32,
// and is bound by their rate.  Neither main loop overlaps its loads with
// its products yet (PERF.md has the measured times against the bound).
//
// Design: one block computes a BT=64 token tile of exactly one head
// (HD columns) of one of q, k, v, so the RoPE pair (j, j +- HD/2) of
// every output column lies in the same block: the f32 result tile is
// staged in shared memory and the epilogue reads both halves from there
// (the TPU kernel's {0,+-1} selector matmuls are a matrix-unit device,
// not part of the contract).  The per-row RMS scale is computed once per
// block into shared memory; the x tile is normed, rounded and staged in
// shared memory as it is read, so x is read from device memory once per
// head and never written back normed.  The device code is
// norm_qkv_tile.cuh, which mega_decode.cu shares.
#include "norm_qkv_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using pt_tile::kBT;
using pt_tile::kThreads;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fused_rms_rope_qkv_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          const T* __restrict__ wq, const T* __restrict__ wk,
                          const T* __restrict__ wv, const T* __restrict__ cos,
                          const T* __restrict__ sin, T* __restrict__ q,
                          T* __restrict__ k, T* __restrict__ v, int t, int h,
                          int nq, int nk, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  pt_tile::qkv_tile<T, HD>(x, g, wq, wk, wv, cos, sin, q, k, v, t, h, nq, nk,
                           eps, blockIdx.x * kBT, blockIdx.y, smem);
}

template <typename T, int HD>
int launch(const void* x, const void* g, const void* wq, const void* wk,
           const void* wv, const void* cos, const void* sin, void* q,
           void* k, void* v, int t, int h, int nq, int nk, float eps,
           cudaStream_t stream) {
  constexpr size_t smem = pt_tile::smem_bytes<T, HD>();
  cudaError_t e = cudaFuncSetAttribute(
      fused_rms_rope_qkv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((t + kBT - 1) / kBT, nq / HD + 2 * (nk / HD));
  fused_rms_rope_qkv_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(wq), static_cast<const T*>(wk),
      static_cast<const T*>(wv), static_cast<const T*>(cos),
      static_cast<const T*>(sin), static_cast<T*>(q), static_cast<T*>(k),
      static_cast<T*>(v), t, h, nq, nk, eps);
  return 0;
}

template <typename T>
int dispatch_hd(const void* x, const void* g, const void* wq, const void* wk,
                const void* wv, const void* cos, const void* sin, void* q,
                void* k, void* v, int t, int h, int nq, int nk, int head_dim,
                float eps, cudaStream_t stream) {
  if (head_dim == 128)
    return launch<T, 128>(x, g, wq, wk, wv, cos, sin, q, k, v, t, h, nq, nk,
                          eps, stream);
  if (head_dim == 64)
    return launch<T, 64>(x, g, wq, wk, wv, cos, sin, q, k, v, t, h, nq, nk,
                         eps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (t, h); g (h,); wq (h, nq); wk/wv (h, nk); cos/sin (t, head_dim)
// -> q (t, nq), k/v (t, nk).  All row-major, all of one dtype, 16-byte
// aligned.  Needs h % 32 == 0, head_dim in {64, 128}, nq and nk
// multiples of it.
extern "C" int pt_fused_rms_rope_qkv(const void* x, const void* g,
                                     const void* wq, const void* wk,
                                     const void* wv, const void* cos,
                                     const void* sin, void* q, void* k,
                                     void* v, int t, int h, int nq, int nk,
                                     int head_dim, float eps, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == PT_F32) {
    rc = dispatch_hd<float>(x, g, wq, wk, wv, cos, sin, q, k, v, t, h, nq,
                            nk, head_dim, eps, s);
  } else if (dtype == PT_BF16) {
    rc = dispatch_hd<bf16>(x, g, wq, wk, wv, cos, sin, q, k, v, t, h, nq,
                           nk, head_dim, eps, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
