// Weight-only int4 matmul, round(x @ float(unpack(W)) * scale[n]), for
// sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/int4_matmul.py
// (`int4_matmul`, pallas_call at :143 and, for K/2 > 6144, the K-blocked
// form at :161).  The TPU kernel splits the contraction by parity
// (x[:, 0::2] @ lo + x[:, 1::2] @ hi) to keep the MXU on the byte-shaped
// layout; here each block unpacks its (K/2, N) byte tile into the
// interleaved K rows in shared memory (row 2i the low nibble, 2i+1 the
// high) and runs one product.  The kernel, its bound and its design are
// in dequant_matmul.cuh: HBM streams the packed nibbles only.
#include "dequant_matmul.cuh"

// x (m, k) f32/bf16/f16 with k even; w (k/2, n) int8, two nibbles per
// byte; scale (n,) f32 -> out (m, n) in x's type; `partial` is f32
// scratch of pt_int4_matmul_scratch() elements.  Contiguous row-major;
// no alignment needed.
extern "C" int pt_int4_matmul(const void* x, const void* w,
                              const void* scale, void* out, void* partial,
                              int m, int k, int n, int dtype, void* stream) {
  return dq::launch<true>(x, w, scale, out, partial, m, k, n, dtype,
                            stream);
}

// f32 elements of the `partial` scratch pt_int4_matmul needs (0: none)
extern "C" long long pt_int4_matmul_scratch(int m, int k, int n,
                                             int dtype) {
  return dq::scratch_elems(m, k, n, dtype);
}
