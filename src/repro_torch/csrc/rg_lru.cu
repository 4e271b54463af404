// RG-LRU recurrence for Hopper (sm_90a): the full-sequence scan of every
// Griffin "rec" layer of the embed path (recurrentgemma-9b's
// llm_embedding).
//
// Replaces repro/kernels/rg_lru/kernel.py: rg_lru_flat (_lru_kernel).
// Same function, per batch row b and channel c:
//   h_t = a_t * h_{t-1} + b_t,  h_{-1} = 0,
// with the carry in f32.  a, b: (B, S, di) f32 or bf16 (one dtype);
// h: (B, S, di) in that dtype.  Any S and di: the ragged edges are masked
// here, nothing is padded by the host.
//
// What bounds it on this card: bytes.  One FMA per element against 12
// bytes moved in f32 (read a and b, write h).  At the embed shape (B=64
// texts, S=128, di=4096, f32, as the model computes its gates) that is
// 3 x 134.2 MB = 402.7 MB, 0.120 ms at 3.35 TB/s.
//
// Design: the TPU kernel carries a (block_d,) state in VMEM across a
// sequential grid axis of time chunks.  Blocks on Hopper run in no order,
// so here one thread owns one (batch row, channel) walk with h in a
// register, and the loop over t is the carry.  A block is 256 consecutive
// channels of one batch row, so every load and store of a warp is one
// coalesced 128-byte line (f32) along di.  Each step's FMA depends on the
// last, so time goes in tiles of 8 steps: a thread issues its 16 loads of
// a tile before the first FMA, keeping them in flight together.  Steps
// past S load a = 1, b = 0 (identity, as the TPU wrapper pads) and are
// not stored.  At the embed shape the grid is 16 x 64 blocks: 262,144
// walks, one wave on 132 SMs.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;  // channels per block
constexpr int kT = 8;          // time steps per tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
rg_lru_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ h_out, int S, int di) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= di) return;
  const size_t base = (size_t)blockIdx.y * S * di + c;
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += kT) {
    const int tn = min(kT, S - t0);
    float av[kT], bv[kT];
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      const size_t off = base + (size_t)(t0 + tt) * di;
      av[tt] = tt < tn ? to_f32(a[off]) : 1.f;
      bv[tt] = tt < tn ? to_f32(b[off]) : 0.f;
    }
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      h = fmaf(av[tt], h, bv[tt]);
      if (tt < tn) h_out[base + (size_t)(t0 + tt) * di] = from_f32<T>(h);
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* h, int B, int S,
                   int di, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  rg_lru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      S, di);
  return cudaGetLastError();
}

}  // namespace

// a, b, h: (B, S, di), contiguous, of dtype code `dtype`.
REPRO_EXPORT int rg_lru_fwd(const void* a, const void* b, void* h, int B,
                            int S, int di, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(a, b, h, B, S, di, s);
  if (dtype == kBF16) return launch<__nv_bfloat16>(a, b, h, B, S, di, s);
  return cudaErrorInvalidValue;
}
