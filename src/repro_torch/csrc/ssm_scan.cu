// Mamba-1 selective scan for Hopper (sm_90a): the full-sequence SSM of
// every Mamba layer of the embed path (falcon-mamba-7b's llm_embedding).
//
// Replaces repro/kernels/ssm_scan/kernel.py: ssm_scan_flat (_ssm_kernel).
// Same function, per batch row b and channel c:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,  A = -exp(A_log[c]),
//   y_t = h_t . C_t + D[c] * x_t,
// with a zero initial state and f32 arithmetic inside.  x, dt: (B, S, di)
// and Bm, Cm: (B, S, N) in x's dtype (f32 or bf16); A_log: (di, N) f32;
// D: (di,) f32; y: (B, S, di) in x's dtype.  Any S and di: the ragged
// edges are masked here, nothing is padded by the host.  N <= 16: one
// instance with room for 16 states serves every N, the states past N
// masked.
//
// What bounds it on this card: the B*S*di*N exponentials.  At the embed
// shape (B=64 texts, S=128, di=8192, N=16) they are 1.07e9, 0.26 ms on the
// special-function units (16 per clock per SM); x, dt and y are 403 MB in
// bf16, 0.12 ms at 3.35 TB/s; the 6.4e9 other f32 flops (two products
// and two fused multiply-adds per state element) 0.10 ms at 67 TFLOP/s.
//
// Design: the TPU kernel keeps the state of a block of channels in VMEM
// and carries it across a sequential grid axis of time chunks.  Here the
// channels are independent walks: one thread owns one (batch row, channel),
// holds h[N] and A[N] (pre-scaled by log2 e) in registers, and walks t; the
// cross-chunk carry becomes the loop itself.  A block is 128 consecutive
// channels of one batch row, so x, dt and y are read and written coalesced
// along di.  Time goes in tiles of 8 steps: each thread loads its 8 x and
// dt values before using any, and the tile's Bm and Cm rows, which all
// channels of the row share, are staged once per block in shared memory
// and read back as float4 broadcasts.  Steps past S have dt = 0, so they
// leave h unchanged and are not stored.  At the embed shape the grid is
// 64 x 64 blocks of 128.
//
// Two choices bring it toward that limit: the exponential is one
// ex2.approx.ftz instruction (exp2f, which keeps results below 2^-126 as
// subnormals, ran at half the speed; only a decay that zeroes the state
// anyway gives such a result), and the block asks for at most 128
// registers a thread so that 4 blocks share an SM (with 16-step tiles and
// no such cap the compiler took 154 registers and 3 blocks fitted).
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kT = 8;          // time steps per tile
constexpr int kMinBlocks = 4;  // blocks an SM must hold (<= 128 registers)
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit; flushes a result below 2^-126 to 0
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int NS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ A_log, const float* __restrict__ Dp,
                T* __restrict__ y, int S, int di, int N) {
  static_assert(NS % 4 == 0, "state padded to whole float4s");
  __shared__ __align__(16) float sB[kT * NS];
  __shared__ __align__(16) float sC[kT * NS];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < di;
  const size_t row0 = (size_t)blockIdx.y * S;   // first (b, t) row of b

  // A * log2(e) of this channel; padded states (n >= N) get A = 0 and a
  // zero Bm, so their h stays 0 and adds nothing to y
  float a2[NS], h[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a2[n] = (live && n < N) ? -expf(A_log[(size_t)c * N + n]) * kLog2e : 0.f;
    h[n] = 0.f;
  }
  const float d_c = live ? Dp[c] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int tn = min(kT, S - t0);
    for (int i = threadIdx.x; i < kT * NS; i += kThreads) {
      const int tt = i / NS, n = i % NS;
      const bool ok = tt < tn && n < N;
      const size_t off = (row0 + t0 + tt) * N + n;
      sB[i] = ok ? to_f32(Bm[off]) : 0.f;
      sC[i] = ok ? to_f32(Cm[off]) : 0.f;
    }
    float xv[kT], dv[kT];
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      const bool ok = live && tt < tn;
      const size_t off = (row0 + t0 + tt) * di + c;
      xv[tt] = ok ? to_f32(x[off]) : 0.f;
      dv[tt] = ok ? to_f32(dt[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      const float dtx = dv[tt] * xv[tt];
      const float4* b4 = reinterpret_cast<const float4*>(sB + tt * NS);
      const float4* c4 = reinterpret_cast<const float4*>(sC + tt * NS);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < NS / 4; ++q) {
        const float4 bq = b4[q], cq = c4[q];
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * q + e;
          h[n] = fmaf(ex2_ftz(dv[tt] * a2[n]), h[n], dtx * bv[e]);
          acc = fmaf(h[n], cv[e], acc);
        }
      }
      if (live && tt < tn)
        y[(row0 + t0 + tt) * di + c] = from_f32<T>(fmaf(d_c, xv[tt], acc));
    }
    __syncthreads();
  }
}

template <typename T, int NS>
cudaError_t launch(const void* x, const void* dt, const void* Bm,
                   const void* Cm, const float* A_log, const float* D,
                   void* y, int B, int S, int di, int N,
                   cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<T, NS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), A_log, D,
      static_cast<T*>(y), S, di, N);
  return cudaGetLastError();
}

}  // namespace

// x, dt: (B, S, di); Bm, Cm: (B, S, N), all of dtype code `dtype`;
// A_log: (di, N) f32; D: (di,) f32; y: (B, S, di) of dtype code `dtype`.
REPRO_EXPORT int ssm_scan_fwd(const void* x, const void* dt, const void* Bm,
                              const void* Cm, const void* A_log,
                              const void* D, void* y, int B, int S, int di,
                              int N, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0 || N <= 0 || N > 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* al = static_cast<const float*>(A_log);
  const float* dp = static_cast<const float*>(D);
  if (dtype == kF32)
    return launch<float, 16>(x, dt, Bm, Cm, al, dp, y, B, S, di, N, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, 16>(x, dt, Bm, Cm, al, dp, y, B, S, di, N,
                                     s);
  return cudaErrorInvalidValue;
}
