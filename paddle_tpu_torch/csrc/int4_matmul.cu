// Weight-only int4 matmul, round(x @ float(unpack(W)) * scale[n]), for
// sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/int4_matmul.py
// (`int4_matmul`, pallas_call at :143 and, for K/2 > 6144, the K-blocked
// form at :161).  The TPU kernel splits the contraction by parity
// (x[:, 0::2] @ lo + x[:, 1::2] @ hi) to keep the MXU on the byte-shaped
// layout.  Here bf16 and f16 x run dequant_swap.cuh: the product runs
// transposed, each packed byte widens in registers straight into one
// register of wgmma's A fragment (its two nibbles are the adjacent
// contraction rows 2i and 2i + 1 that the fragment pairs), and x is the
// B operand with n = the M tile; device memory and shared memory carry
// the packed bytes only.  f32 x runs the SIMT body of dequant_matmul.cuh.
// The tiles and the contraction split come from ops/cuda/int4_plan.py.
#include "dequant_swap.cuh"

// x (m, k) f32/bf16/f16 with k even, rows ldx apart; w (k/2, n) int8, two
// nibbles per byte; scale (n,) f32 -> out (m, n) in x's type.  The plan:
// bm rows of x by bn columns of W per block, `splits` contraction splits,
// `partial` f32 scratch of splits x m x n values when splits > 1.  bf16
// and f16 take bm in {8, 64, 128}, bn = 128, x 16-byte aligned with
// ldx % 8 == 0 (columns k .. ldx - 1 zero); f32 takes bm = bn = 64 and
// ldx == k, no alignment needed.  W and the output need no alignment.  A
// plan this source cannot run returns cudaErrorInvalidValue before any
// launch.
extern "C" int pt_int4_matmul(const void* x, const void* w,
                              const void* scale, void* out, void* partial,
                              int m, int k, int n, int ldx, int dtype,
                              int bm, int bn, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || k < 0 || k % 2) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case PT_BF16:
      return dsw::run<__nv_bfloat16>(x, ldx, w, scale, out, partial, m, k,
                                     n, bm, bn, splits, s);
    case PT_F16:
      return dsw::run<__half>(x, ldx, w, scale, out, partial, m, k, n, bm,
                              bn, splits, s);
    case PT_F32: {
      const dq::Split sp = dq::split_for(m, k, n, splits);
      if (sp.splits == 0 || bm != dq::kBM || bn != dq::kBN || ldx != k)
        return (int)cudaErrorInvalidValue;
      return dq::run_split<true>(x, w, scale, out, partial, m, k, n, sp, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
