// Multi-tensor fused AdamW update, in place, for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_adamw.py
// (`fused_adamw_update`, pallas_call at :89), whose formula (:40-54) this
// keeps, in f32, per element:
//   m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
//   p <- p - lr ((m c1) / (sqrt(v c2) + eps) + wd p)      (wd term if wd)
// with c1 = 1 / (1 - b1^t), c2 = 1 / (1 - b2^t).  lr, c1 and c2 change every
// step and arrive as launch arguments from the host's step counter, so
// nothing waits on the card.
//
// Bound on an H100: bytes.  Per element it reads p, m, v (f32) and g (its
// own type) and writes p, m, v, plus the low-precision parameter under
// master weights: 28 bytes for a bf16 grad and parameter, against ~15
// operations.
//
// Design.  The TPU kernel runs once per parameter over a (rows, 128)
// view; the H100 version runs ONCE per optimizer step over every eligible
// tensor.  A table on the card gives each tensor's pointers, size, weight
// decay and types (8 int64 words each), and a prefix sum of chunk counts:
// block i updates chunk i (4096 elements) of the tensor its thread 0 finds
// by binary search.  Each thread moves 4 elements per access (16-byte f32
// vectors); the wrapper admits only sizes that are multiples of 1024
// (the reference's `eligible()`), so no vector straddles a tensor's end.
// Under master weights the same pass writes the rounded bf16 parameter.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 4096;

struct Row {   // one tensor's table entry, as the wrapper packs it
  long long p, g, m, v, low, n, wd_bits, flags;
};

__device__ __forceinline__ void load4(const void* base, long long i, int bf,
                                      float out[4]) {
  if (bf) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(base) + i);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = __bfloat162float(h[c]);
  } else {
    const float4 f = *reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + i);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(const Row* __restrict__ table,
                   const long long* __restrict__ chunk_start, int ntensors,
                   float lr, float c1, float c2, float b1, float omb1,
                   float b2, float omb2, float eps) {
  __shared__ int ti;
  if (threadIdx.x == 0) {
    int lo = 0, hi = ntensors - 1;   // last t with chunk_start[t] <= block
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (chunk_start[mid] <= (long long)blockIdx.x)
        lo = mid;
      else
        hi = mid - 1;
    }
    ti = lo;
  }
  __syncthreads();
  const Row r = table[ti];
  float* p = reinterpret_cast<float*>(r.p);
  float* m = reinterpret_cast<float*>(r.m);
  float* v = reinterpret_cast<float*>(r.v);
  const void* g = reinterpret_cast<const void*>(r.g);
  __nv_bfloat16* low = reinterpret_cast<__nv_bfloat16*>(r.low);
  const float wd = __int_as_float((int)r.wd_bits);
  const int g_bf16 = (int)(r.flags & 1);
  const long long base = ((long long)blockIdx.x - chunk_start[ti]) * kChunk;
  const long long end = min(base + kChunk, r.n);
  for (long long i = base + 4LL * threadIdx.x; i < end; i += 4LL * kThreads) {
    float gg[4];
    load4(g, i, g_bf16, gg);
    float4 pp = *reinterpret_cast<float4*>(p + i);
    float4 mm = *reinterpret_cast<float4*>(m + i);
    float4 vv = *reinterpret_cast<float4*>(v + i);
    float* pa = &pp.x;
    float* ma = &mm.x;
    float* va = &vv.x;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float mc = b1 * ma[c] + omb1 * gg[c];
      const float vc = b2 * va[c] + omb2 * (gg[c] * gg[c]);
      float upd = (mc * c1) / (sqrtf(vc * c2) + eps);
      if (wd != 0.f) upd = upd + wd * pa[c];
      pa[c] = pa[c] - lr * upd;
      ma[c] = mc;
      va[c] = vc;
    }
    *reinterpret_cast<float4*>(p + i) = pp;
    *reinterpret_cast<float4*>(m + i) = mm;
    *reinterpret_cast<float4*>(v + i) = vv;
    if (low) {
      __align__(8) __nv_bfloat16 h[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) h[c] = __float2bfloat16_rn(pa[c]);
      *reinterpret_cast<uint2*>(low + i) = *reinterpret_cast<uint2*>(h);
    }
  }
}

}  // namespace

// `table` holds ntensors rows of 8 int64 (p, g, m, v, low or 0, n,
// f32 bits of wd, flags: bit 0 = g is bf16), followed by ntensors + 1
// int64 chunk prefix sums (chunk_start[t] = chunks of tensors before t);
// nchunks = chunk_start[ntensors] blocks are launched.  p/m/v f32, 16-byte
// aligned, n % 1024 == 0.
extern "C" int pt_fused_adamw(const void* table, int ntensors,
                              long long nchunks, float lr, float c1,
                              float c2, float b1, float omb1, float b2,
                              float omb2, float eps, void* stream) {
  if (ntensors <= 0 || nchunks <= 0 || nchunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Row* rows = static_cast<const Row*>(table);
  const long long* starts =
      reinterpret_cast<const long long*>(rows + ntensors);
  fused_adamw_kernel<<<(unsigned)nchunks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      rows, starts, ntensors, lr, c1, c2, b1, omb1, b2, omb2, eps);
  return (int)cudaGetLastError();
}
