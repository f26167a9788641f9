// Weight-only int8 matmul, round(x @ float(W) * scale[n]), for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/int8_matmul.py
// (`int8_matmul`, pallas_call at :92 and, for K > 8192, the K-blocked
// form at :109): one kernel here takes any M, K and N.  Device memory
// carries the raw int8 codes; each block widens its weight tile in shared
// memory, never a widened copy in device memory.
//
// Bound on an H100: at the serving M = 128 the code bytes and the tensor
// cores about equally (256 operations per code byte against the card's
// ~295 per byte of memory rate); at the LM head's M = 8 the code bytes.
//
// bf16 and f16 x run dequant_gemm.cuh: 128 x 128 tiles of two wgmma
// warpgroups, x by a cp.async ring, the codes through registers and
// widened into a ring of swizzled B tiles while the previous step's
// products run, the contraction split only where the tiles are too few
// to fill the card (ops/cuda/int8_plan.py).  f32 x runs the SIMT body of
// dequant_matmul.cuh (64 x 64 tiles, full f32 products) with the split
// count of its own rule, which the plan reproduces.
#include "dequant_gemm.cuh"

// x (m, k) f32/bf16/f16; w (k, n) int8; scale (n,) f32 -> out (m, n) in
// x's type; `splits` is the plan's contraction split count and `partial`
// f32 scratch of splits x m x n values when splits > 1.  Contiguous
// row-major; no alignment needed.  A plan this source cannot run returns
// cudaErrorInvalidValue before any launch.
extern "C" int pt_int8_matmul(const void* x, const void* w,
                              const void* scale, void* out, void* partial,
                              int m, int k, int n, int dtype, int splits,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case PT_BF16:
      return dg::run<__nv_bfloat16>(x, w, scale, out, partial, m, k, n,
                                    splits, s);
    case PT_F16:
      return dg::run<__half>(x, w, scale, out, partial, m, k, n, splits, s);
    case PT_F32: {
      constexpr int bk = dq::Chunk<float>::kBK;
      const int chunks = (k + bk - 1) / bk;
      const int cps = splits >= 1 ? (chunks + splits - 1) / splits : 0;
      const bool ok = m >= 1 && n >= 1 && k >= 0 && splits >= 1 &&
                      (chunks == 0 ? splits == 1 : (splits - 1) * cps < chunks);
      if (!ok) return (int)cudaErrorInvalidValue;
      return dq::run_split<float, false>(x, w, scale, out, partial, m, k, n,
                                         {splits, cps}, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
