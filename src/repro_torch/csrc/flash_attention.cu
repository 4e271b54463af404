// Flash-attention forward for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention/kernel.py: flash_attention_bhsd
// (_flash_kernel), the FlashAttention-2 forward behind every full-sequence
// pass of the model (the embed step of llm_embedding runs the stack in
// "train" mode).  Same function: online softmax over KV tiles with f32
// (m, l, acc); scores scaled in f32; causal, sliding-window and kv_len
// masks with the TPU kernel's -1e30 masked score; KV tiles that no row of
// the block can see are skipped; the final l is floored at 1e-37; GQA maps
// q head h to KV head h / (H/KH).
//
// What bounds it on this card: at the main-path shape (64 texts x 16
// heads, L=128, hd=128, bf16, causal) q, k, v and o are 33.6 MB each, so
// the bytes are 134 MB (40 us at 3.35 TB/s) and the causal products 4.3
// GFLOP (4.3 us on the tensor cores): memory bounds it.  The same holds
// at recurrentgemma-9b's (16 q heads over 1 KV head, hd=256): q and o 67
// MB each, k and v 4.2 MB each, 143 MB (43 us); 8.7 GFLOP (8.8 us).
//
// Design.  The TPU kernel carries (m, l, acc) across a sequential grid
// axis; here a loop over tiles of 64 keys inside each block takes its
// place, and the kernel reads the model's (B, S, H, hd) layout directly
// (no transpose or padding copy; ragged edges are masked in the kernel).
//  * bf16 (the model's dtype): one block of 4 warps per (batch*head, 64 q
//    rows), 16 rows per warp.  Both products run on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate): S = Q K^T with the warp's
//    Q fragments held in registers and K from shared memory, then O += P V
//    with P taken straight from the S accumulators (rounded to bf16, as
//    FlashAttention-2 does) and V stored transposed in shared memory.  The
//    products of bf16 values are exact in f32, and the scale is applied to
//    the f32 scores, so only P's rounding differs from the f32 reference.
//    Shared rows are padded by 8 bf16 so a warp's fragment loads hit 32
//    different banks.  The K and V^T tiles sit in dynamic shared memory
//    (70,656 bytes at hd 256, above the 48 KB a static array may take).
//    At hd 256 (recurrentgemma-9b) the Q fragments would take 64 registers
//    beside the 128 of the O accumulators and spill, so there the warp's Q
//    rows are staged in shared memory too and read one 16-wide k-step at a
//    time (104,448 bytes a block, 2 blocks per SM).
//  * f32 (tests and f32 configurations): the products stay in f32 on the
//    CUDA cores.  One block of 8 warps per (batch*head, 32 q rows); q, K
//    and V tiles are staged in shared memory (K rows padded by a word);
//    each warp owns 4 rows and a lane scores 2 keys for all 4, so each
//    shared K value feeds 4 FMAs.
#include <cstdint>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kBK = 64;  // keys per KV tile

// ---------------------------------------------------------------- bf16 ---
constexpr int kMmaWarps = 4;
constexpr int kMmaBQ = 16 * kMmaWarps;  // q rows per block

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared-memory layout of the bf16 kernel: padded K rows, padded V^T rows
// and, above hd 128, the block's padded Q rows.
template <int HD>
struct MmaSmem {
  static constexpr int KS = HD + 8;            // padded K (and Q) row
  static constexpr int VS = kBK + 8;           // padded V^T row
  static constexpr bool kQShared = HD > 128;   // Q fragments from smem
  static constexpr int kBytes =
      (kBK * KS + HD * VS + (kQShared ? kMmaBQ * KS : 0)) * 2;
};

// mma.sync fragment coordinates: lane = 4 * g + t.  A (16x16): regs 0..3
// hold rows (g, g+8, g, g+8) at columns (2t, 2t, 2t+8, 2t+8) and +1.
// B (16x8): regs 0,1 hold rows (2t, 2t+8) and +1 of column g.  C (16x8):
// regs 0,1 row g, regs 2,3 row g+8, columns 2t and 2t+1.
template <int HD>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                     int KH, int causal, int window, float scale) {
  using L = MmaSmem<HD>;
  constexpr int KSTEPS = HD / 16;   // k-steps of Q K^T
  constexpr int OT = HD / 8;        // n-tiles of O
  constexpr int ST = kBK / 8;       // n-tiles of S
  constexpr int KS = L::KS;
  constexpr int VS = L::VS;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* vt = ks + kBK * KS;
  __nv_bfloat16* qsm = vt + HD * VS;  // [kMmaBQ][KS] when kQShared

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kh = h / (H / KH);
  const int q0 = blockIdx.y * kMmaBQ;
  const int r0 = q0 + warp * 16;    // first q row of this warp
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KH * HD;
  const __nv_bfloat16* qb = q + ((size_t)b * Sq * H + h) * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * Sk * KH + kh) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * Sk * KH + kh) * HD;
  __nv_bfloat16* ob = o + ((size_t)b * Sq * H + h) * HD;

  // the warp's Q rows as A fragments (in registers, or staged in shared
  // memory above hd 128), zero past Sq
  uint32_t qa[L::kQShared ? 1 : KSTEPS][4];
  if constexpr (L::kQShared) {
    __nv_bfloat16* qw = qsm + warp * 16 * KS;
    for (int i = lane; i < 16 * HD / 2; i += 32) {
      const int row = i / (HD / 2), d = 2 * (i % (HD / 2));
      *reinterpret_cast<uint32_t*>(qw + row * KS + d) =
          r0 + row < Sq ? *reinterpret_cast<const uint32_t*>(
                              qb + (r0 + row) * q_stride + d)
                        : 0u;
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + 8 * (i & 1);
        const int col = s * 16 + 2 * t + 8 * (i >> 1);
        qa[s][i] = row < Sq ? *reinterpret_cast<const uint32_t*>(
                                  qb + row * q_stride + col)
                            : 0u;
      }
    }
  }

  const int q_last = min(q0 + kMmaBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / kBK) * kBK;

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kt = k_lo; kt < k_hi; kt += kBK) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = tid; i < kBK * HD / 2; i += kMmaWarps * 32) {
      const int key = i / (HD / 2), d = 2 * (i % (HD / 2)), kj = kt + key;
      uint32_t kw = 0u, vw = 0u;
      if (kj < Sk) {
        kw = *reinterpret_cast<const uint32_t*>(kb + kj * kv_stride + d);
        vw = *reinterpret_cast<const uint32_t*>(vb + kj * kv_stride + d);
      }
      *reinterpret_cast<uint32_t*>(ks + key * KS + d) = kw;
      const __nv_bfloat162 v2 = *reinterpret_cast<__nv_bfloat162*>(&vw);
      vt[d * VS + key] = v2.x;
      vt[(d + 1) * VS + key] = v2.y;
    }
    __syncthreads();

    // S = Q K^T for 64 keys
    float s[ST][4];
    if constexpr (L::kQShared) {
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
      const __nv_bfloat16* qw = qsm + (warp * 16 + g) * KS + 2 * t;
#pragma unroll
      for (int st = 0; st < KSTEPS; ++st) {
        const uint32_t a[4] = {
            *reinterpret_cast<const uint32_t*>(qw + st * 16),
            *reinterpret_cast<const uint32_t*>(qw + 8 * KS + st * 16),
            *reinterpret_cast<const uint32_t*>(qw + st * 16 + 8),
            *reinterpret_cast<const uint32_t*>(qw + 8 * KS + st * 16 + 8)};
#pragma unroll
        for (int j = 0; j < ST; ++j) {
          const __nv_bfloat16* kp = ks + (j * 8 + g) * KS + st * 16 + 2 * t;
          mma_bf16(s[j], a, *reinterpret_cast<const uint32_t*>(kp),
                   *reinterpret_cast<const uint32_t*>(kp + 8));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < ST; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
        for (int st = 0; st < KSTEPS; ++st) {
          const __nv_bfloat16* kp = ks + (j * 8 + g) * KS + st * 16 + 2 * t;
          mma_bf16(s[j], qa[st], *reinterpret_cast<const uint32_t*>(kp),
                   *reinterpret_cast<const uint32_t*>(kp + 8));
        }
      }
    }

    // scale, mask, online softmax (rows g and g + 8 of the warp)
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = r0 + g + 8 * (i >> 1);
        const int kj = kt + j * 8 + 2 * t + (i & 1);
        bool ok = kj < Sk;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && qi - kj < window;
        s[j][i] = ok ? s[j][i] * scale : kNeg;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = expf(s[j][i] - m[i >> 1]);
        sum[i >> 1] += s[j][i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V, P from the S accumulators (16 keys per k-step)
#pragma unroll
    for (int st = 0; st < kBK / 16; ++st) {
      const uint32_t pa[4] = {pack_bf16(s[2 * st][0], s[2 * st][1]),
                              pack_bf16(s[2 * st][2], s[2 * st][3]),
                              pack_bf16(s[2 * st + 1][0], s[2 * st + 1][1]),
                              pack_bf16(s[2 * st + 1][2], s[2 * st + 1][3])};
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        const __nv_bfloat16* vp = vt + (n * 8 + g) * VS + st * 16 + 2 * t;
        mma_bf16(acc[n], pa, *reinterpret_cast<const uint32_t*>(vp),
                 *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + g + 8 * r;
    if (qi >= Sq) continue;
    const float lr = fmaxf(l[r], 1e-37f);
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      *reinterpret_cast<uint32_t*>(ob + qi * q_stride + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] / lr, acc[n][2 * r + 1] / lr);
    }
  }
}

// ----------------------------------------------------------------- f32 ---
constexpr int kBQ = 32;             // q rows per block
constexpr int kWarps = 8;
constexpr int kRPW = kBQ / kWarps;  // q rows per warp

template <int HD>
constexpr int smem_bytes() {
  return (kBQ * HD + kBK * (HD + 1) + kBK * HD + kBQ * kBK) * 4;
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int Sq, int Sk, int H, int KH, int causal, int window,
                     float scale) {
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;  // output dims per lane
  constexpr int KS = HD + 1;                   // padded K row stride
  extern __shared__ float smem[];
  float* qs = smem;              // [kBQ][HD], scaled
  float* ks = qs + kBQ * HD;     // [kBK][KS]
  float* vs = ks + kBK * KS;     // [kBK][HD]
  float* ps = vs + kBK * HD;     // [kBQ][kBK] probabilities of the tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kh = h / (H / KH);
  const int q0 = blockIdx.y * kBQ;
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KH * HD;
  const float* qb = q + ((size_t)b * Sq * H + h) * HD;
  const float* kb = k + ((size_t)b * Sk * KH + kh) * HD;
  const float* vb = v + ((size_t)b * Sk * KH + kh) * HD;
  float* ob = o + ((size_t)b * Sq * H + h) * HD;

  for (int i = tid; i < kBQ * HD; i += kWarps * 32) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    qs[i] = qi < Sq ? qb[qi * q_stride + d] * scale : 0.f;
  }

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / kBK) * kBK;

  float m[kRPW], l[kRPW], acc[kRPW][EPL];
#pragma unroll
  for (int j = 0; j < kRPW; ++j) {
    m[j] = kNeg;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[j][e] = 0.f;
  }
  const int r0 = warp * kRPW;  // first q row (in the block) of this warp

  for (int kt = k_lo; kt < k_hi; kt += kBK) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = tid; i < kBK * HD; i += kWarps * 32) {
      const int r = i / HD, d = i % HD, kj = kt + r;
      const bool in = kj < Sk;
      ks[r * KS + d] = in ? kb[kj * kv_stride + d] : 0.f;
      vs[r * HD + d] = in ? vb[kj * kv_stride + d] : 0.f;
    }
    __syncthreads();

    // scores of keys (lane, lane + 32) for the warp's 4 rows
    float s[kRPW][2];
#pragma unroll
    for (int j = 0; j < kRPW; ++j) s[j][0] = s[j][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float k0 = ks[lane * KS + d];
      const float k1 = ks[(lane + 32) * KS + d];
#pragma unroll
      for (int j = 0; j < kRPW; ++j) {
        const float qd = qs[(r0 + j) * HD + d];
        s[j][0] = fmaf(qd, k0, s[j][0]);
        s[j][1] = fmaf(qd, k1, s[j][1]);
      }
    }

    // online softmax per row
#pragma unroll
    for (int j = 0; j < kRPW; ++j) {
      const int qi = q0 + r0 + j;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kj = kt + lane + 32 * c;
        bool ok = kj < Sk;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && qi - kj < window;
        if (!ok) s[j][c] = kNeg;
      }
      const float m_new = fmaxf(m[j], warp_max(fmaxf(s[j][0], s[j][1])));
      const float p0 = expf(s[j][0] - m_new);
      const float p1 = expf(s[j][1] - m_new);
      const float corr = expf(m[j] - m_new);
      l[j] = l[j] * corr + warp_sum(p0 + p1);
      m[j] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[j][e] *= corr;
      ps[(r0 + j) * kBK + lane] = p0;
      ps[(r0 + j) * kBK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P . V over the tile; lane owns dims lane + 32 * e
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane + 32 * e;
        vv[e] = d < HD ? vs[kk * HD + d] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRPW; ++j) {
        const float p = ps[(r0 + j) * kBK + kk];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[j][e] = fmaf(p, vv[e], acc[j][e]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int j = 0; j < kRPW; ++j) {
    const int qi = q0 + r0 + j;
    if (qi >= Sq) continue;
    const float lj = fmaxf(l[j], 1e-37f);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      if (d < HD) ob[qi * q_stride + d] = acc[j][e] / lj;
    }
  }
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, int B, int Sq, int Sk, int H, int KH, int causal,
                   int window, float scale, cudaStream_t stream) {
  if (dtype == kBF16) {
    constexpr int smem = MmaSmem<HD>::kBytes;
    if (smem > 48 * 1024) {
      const cudaError_t err = set_smem(flash_fwd_mma_kernel<HD>, smem);
      if (err != cudaSuccess) return err;
    }
    const dim3 grid(B * H, (Sq + kMmaBQ - 1) / kMmaBQ);
    flash_fwd_mma_kernel<HD><<<grid, kMmaWarps * 32, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        Sq, Sk, H, KH, causal, window, scale);
    return cudaGetLastError();
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = set_smem(flash_fwd_f32_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_f32_kernel<HD><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KH,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, Sq, H, hd); k, v: (B, Sk, KH, hd); contiguous, one dtype.
REPRO_EXPORT int flash_attention_fwd(const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Sk, int H, int KH, int hd,
                                     int causal, int window, float scale,
                                     int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KH <= 0 || H % KH != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(dtype, q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
    case 32: return launch<32>(dtype, q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
    case 64: return launch<64>(dtype, q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
    case 128: return launch<128>(dtype, q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
    case 256: return launch<256>(dtype, q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
