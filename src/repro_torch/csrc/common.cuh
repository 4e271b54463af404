// Shared helpers of the repro_torch CUDA kernels: the export macro, dtype
// conversion, warp reductions, and the async copies, ldmatrix and mma.sync
// wrappers of the two tensor-core attention kernels.
#pragma once

#include <cstdint>

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

// ---- Hopper building blocks of the tensor-core kernels (flash_attention,
// decode_attention): async copies, ldmatrix, mma.sync, ex2 ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1 (L2 fetches whole 128-byte
// lines); zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// mma.sync fragment coordinates: lane = 4 * g + t.  A (16x16): regs 0..3
// hold rows (g, g+8, g, g+8) at columns (2t, 2t, 2t+8, 2t+8) and +1.
// B (16x8): regs 0,1 hold rows (2t, 2t+8) and +1 of column g.  C (16x8):
// regs 0,1 row g, regs 2,3 row g+8, columns 2t and 2t+1.  An ldmatrix.x4
// lane gives the row address of matrix lane / 8; thread lane receives
// (row lane / 4, columns 2 (lane % 4) and +1) of each matrix, or with
// .trans (rows 2 (lane % 4) and +1, column lane / 4).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (flush-to-zero; 2^(-1e30) is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Allow a kernel more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// out: registers a thread, local bytes a thread (spills and stack),
// dynamic shared bytes and resident blocks per SM of one instance, as its
// launcher starts it (chip_smoke.py phase 1 logs them)
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int threads, int smem, int* out) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = smem;
  out[3] = blocks;
  return err;
}

}  // namespace repro
