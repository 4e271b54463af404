// Shared helpers of the repro_torch CUDA kernels: the export macro, dtype
// conversion and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

// dtype codes shared with the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1 };

// the masked-score value of the TPU kernels (not -inf: exp(NEG - NEG) is
// finite, so a fully masked tile never makes a NaN)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA
}

// Load N consecutive elements starting at p (N * sizeof(T) bytes aligned)
// and widen them to float.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float* out) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
}
template <>
__device__ __forceinline__ void load_f32<float, 4>(const float* __restrict__ p,
                                                   float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <>
__device__ __forceinline__ void load_f32<__nv_bfloat16, 4>(
    const __nv_bfloat16* __restrict__ p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
template <>
__device__ __forceinline__ void load_f32<float, 8>(const float* __restrict__ p,
                                                   float* out) {
  load_f32<float, 4>(p, out);
  load_f32<float, 4>(p + 4, out + 4);
}
template <>
__device__ __forceinline__ void load_f32<__nv_bfloat16, 8>(
    const __nv_bfloat16* __restrict__ p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Allow a kernel more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace repro
