// Weight-only int8 matmul, round(x @ float(W) * scale[n]), for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/int8_matmul.py
// (`int8_matmul`, pallas_call at :92 and, for K > 8192, the K-blocked
// form at :109): one kernel here takes any M, K and N.  The kernel, its
// bound and its design are in dequant_matmul.cuh: HBM streams the raw
// int8 bytes, each block widens its weight tile in shared memory.
#include "dequant_matmul.cuh"

// x (m, k) f32/bf16/f16; w (k, n) int8; scale (n,) f32 -> out (m, n) in
// x's type; `partial` is f32 scratch of pt_int8_matmul_scratch()
// elements.  Contiguous row-major; no alignment needed.
extern "C" int pt_int8_matmul(const void* x, const void* w,
                              const void* scale, void* out, void* partial,
                              int m, int k, int n, int dtype, void* stream) {
  return dq::launch<false>(x, w, scale, out, partial, m, k, n, dtype,
                            stream);
}

// f32 elements of the `partial` scratch pt_int8_matmul needs (0: none)
extern "C" long long pt_int8_matmul_scratch(int m, int k, int n,
                                             int dtype) {
  return dq::scratch_elems(m, k, n, dtype);
}
