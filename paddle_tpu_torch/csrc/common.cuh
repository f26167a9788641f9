// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel takes f32 or bf16 storage (the dequant GEMMs also f16) and
// does its arithmetic in f32.  `round_to<T>` is the contract's
// `astype(x.dtype)`: a float rounded (round-to-nearest-even) through the
// storage type and widened again.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

enum { PT_F32 = 0, PT_BF16 = 1, PT_F16 = 2 };

namespace pt {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// cudaFuncSetAttribute(Kern, Attr, value), made once per kernel,
// attribute and device for the largest value asked so far: the attribute
// outlives the call, and a kernel launched on every serving step pays for
// each CUDA API call on the host.
template <auto Kern, cudaFuncAttribute Attr>
cudaError_t func_attr_once(int value) {
  static int set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && value <= set[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(Kern, Attr, value);
  if (e == cudaSuccess && dev < 64) set[dev] = value;
  return e;
}

// Kern may use `bytes` of dynamic shared memory.
template <auto Kern>
cudaError_t allow_smem_once(size_t bytes) {
  return func_attr_once<Kern, cudaFuncAttributeMaxDynamicSharedMemorySize>(
      (int)bytes);
}

}  // namespace pt

// The message of a CUDA error code returned by a `pt_*` entry point.
extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
