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
// axis; here a loop over KV tiles inside each block takes its place, and
// the kernel reads the model's (B, S, H, hd) layout directly (no transpose
// or padding copy; ragged edges are masked in the kernel).
//  * bf16 (the model's dtype).  A block of 4 warps owns 64 "folded" rows
//    of one (batch, KV head), 16 a warp: row r is query position r / G of
//    query head kh * G + r % G, G = H / KH.  So one K/V tile in shared
//    memory feeds every query head of its KV head, and the causal and
//    window masks use the row's position.  With G = 16 (recurrentgemma-9b)
//    a block's 64 rows are 4 positions x 16 heads, which lie side by side
//    in memory; with G = 1 (olmo-1b) they are 64 positions of one head.
//    The grid is one block per 64 rows of each (batch, KV head), latest
//    positions (most tiles) first: 2,048 blocks at both main-path shapes,
//    3 resident per SM at hd 128 and 2 at hd 256 (5.2 and 7.8 waves on 132
//    SMs).  64 rows a block is what fills the SMs: 128 rows (two 16-row
//    m-tiles a warp, FlashAttention-2's layout at hd 128) would double
//    the accumulators and leave 8 warps an SM instead of 12.
//    Copies: Q, K and V tiles move by 16-byte cp.async.cg (zero-filled past
//    Sq and Sk) into shared rows padded by 16 bytes, so the 8 rows an
//    ldmatrix phase reads start in 8 different 4-bank groups and a warp's
//    16-byte copies land on consecutive banks: no bank conflicts either
//    way.  K and V tiles pass in turn through a ring of 4 slots (2 stages
//    of each): the prologue puts Q and the first two K and V tiles in
//    flight at once, each its own commit group, so S = Q K^T starts when
//    Q and K_0 have landed while V_0, K_1 and V_1 are on their way; a slot
//    is refilled as soon as every warp is done with it, so for long
//    sequences the ring wraps.  Tiles are 32 keys above hd 64 (64 up to
//    it): at hd 256 two blocks then fit an SM's shared memory, at hd 128
//    the registers stay under 168 for 3 blocks an SM.  A tile that every
//    row of the block sees whole is not masked.  At hd 96 (phi-3-vision)
//    a padded row is 104 bf16, 208 bytes = 13 x 16, odd, so the rows of an
//    ldmatrix phase still start in 8 different 4-bank groups; the 12 O
//    n-tiles go in pairs as at every hd; 39,936 shared bytes a block.
//    Products: mma.sync m16n8k16 (bf16 in, f32 accumulate).  Fragments
//    come by ldmatrix.x4: Q's (held in registers up to hd 128; at hd 256,
//    beside the 128 O accumulators, read from shared memory each k-step),
//    K's, and V's by ldmatrix.x4.trans from V stored row-major as it
//    arrives (no transpose in shared memory).  P is taken straight from
//    the S accumulators, rounded to bf16 as FlashAttention-2 does;
//    products of bf16 values are exact in f32 and the scale (times
//    log2(e), for ex2) is applied to the f32 scores, so only P's rounding
//    and ex2's approximation differ from the f32 reference.  The output is
//    staged in the warp's own Q rows and leaves by 16-byte coalesced stores.
//    Why mma.sync and not wgmma: the products take 4.4 and 8.8 us at the
//    bf16 peak against 40 and 43 us for the bytes, so the tensor-core rate
//    is not what bounds this kernel.  What wgmma would add is asynchrony,
//    products overlapping the softmax of a latency-bound warp, at the price
//    of 64-row warpgroup tiles, K and V in its own swizzled layout and the
//    S accumulator relaid as P: left for a later version.
//  * f32 (tests and f32 configurations): the products stay in f32 on the
//    CUDA cores.  One block of 8 warps per (batch*head, 32 q rows); q, K
//    and V tiles are staged in shared memory (K rows padded by a word);
//    each warp owns 4 rows and a lane scores 2 keys for all 4, so each
//    shared K value feeds 4 FMAs.
//
// chip_smoke.py phase 1 logs each instance's registers, spills, shared
// bytes and resident blocks per SM (flash_attention_info).
#include <climits>
#include <cstdint>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kBK = 64;  // keys per KV tile of the f32 kernel

// ---------------------------------------------------------------- bf16 ---
constexpr int kMmaWarps = 4;
constexpr int kMmaBM = 16 * kMmaWarps;  // folded rows per block, 16 a warp

// Tiles of the bf16 kernel.  Shared memory holds the block's Q rows (later
// its output rows), then a ring of NS slots of BN keys through which the
// tiles K_0, V_0, K_1, V_1, ... pass in turn; every row is padded by 8 bf16
// (16 bytes).
template <int HD>
struct MmaTile {
  static constexpr int BN = HD > 64 ? 32 : 64;    // keys per tile
  static constexpr int NS = 4;                    // ring slots: 2 K/V stages
  static constexpr int kMinBlocks = HD > 128 ? 2 : 3;   // per SM
  static constexpr int RS = HD + 8;               // padded row, bf16
  static constexpr int CH = HD / 8;               // 16-byte chunks per row
  static constexpr bool kQRegs = HD <= 128;       // Q fragments in registers
  static constexpr int kBytes = (kMmaBM + NS * BN) * RS * 2;
};

// (fragment coordinates: see mma_bf16 in common.cuh)
template <int HD>
__global__ void __launch_bounds__(kMmaWarps * 32, MmaTile<HD>::kMinBlocks)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                     int KH, int causal, int window, float scale,
                     int row_blocks) {
  using T = MmaTile<HD>;
  constexpr int BM = kMmaBM, BN = T::BN, NS = T::NS, RS = T::RS, CH = T::CH;
  constexpr int KSTEPS = HD / 16;   // k-steps of Q K^T
  constexpr int OT = HD / 8;        // n-tiles of O
  constexpr int ST = BN / 8;        // n-tiles of S
  constexpr int NT = kMmaWarps * 32;
  static_assert((BN * CH) % NT == 0 && (BM * CH) % NT == 0,
                "tile copies split evenly over the block");
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* ring = qs + BM * RS;                // [NS][BN][RS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int G = H / KH;
  const int bkh = blockIdx.x / row_blocks;
  const int rb = row_blocks - 1 - blockIdx.x % row_blocks;  // latest first
  const int b = bkh / KH, kh = bkh % KH;
  const int rows = Sq * G;          // folded rows of this (batch, KV head)
  const int r0 = rb * BM;
  const size_t q_pos_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KH * HD;
  const __nv_bfloat16* qb = q + ((size_t)b * Sq * H + (size_t)kh * G) * HD;
  __nv_bfloat16* ob = o + ((size_t)b * Sq * H + (size_t)kh * G) * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * Sk * KH + kh) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * Sk * KH + kh) * HD;
  // element offset of folded row r in q and o (no division for one query
  // head per KV head or for one KV head, the main path's two layouts)
  auto row_off = [&](int r) -> size_t {
    if (G == 1) return (size_t)r * q_pos_stride;
    if (KH == 1) return (size_t)r * HD;
    return (size_t)(r / G) * q_pos_stride + (size_t)(r % G) * HD;
  };

  // the KV tiles some row of the block can see
  const int p_first = r0 / G;
  const int p_last = (min(r0 + BM, rows) - 1) / G;
  const int k_hi = causal ? min(Sk, p_last + 1) : Sk;
  int k_lo = window > 0 ? max(0, p_first - window + 1) : 0;
  k_lo = (k_lo / BN) * BN;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  // ring item i is K_(i/2) (even i) or V_(i/2) (odd i), in slot i % NS
  auto load_item = [&](int item) {
    const __nv_bfloat16* src = item & 1 ? vb : kb;
    __nv_bfloat16* dst = ring + (item % NS) * BN * RS;
    const int kt = k_lo + (item >> 1) * BN;
#pragma unroll
    for (int it = 0; it < BN * CH / NT; ++it) {
      const int i = tid + it * NT, key = i / CH, c = i % CH, kj = kt + key;
      const bool in = kj < Sk;
      cp_async16(smem_u32(dst + key * RS + c * 8),
                 src + (in ? (size_t)kj * kv_stride : 0) + c * 8, in);
    }
  };

  // prologue: Q, then the first NS ring items, one commit group each
  // (empty groups past the last item keep the counts below uniform)
#pragma unroll
  for (int it = 0; it < BM * CH / NT; ++it) {
    const int i = tid + it * NT, rr = i / CH, c = i % CH, r = r0 + rr;
    const bool in = r < rows;
    cp_async16(smem_u32(qs + rr * RS + c * 8),
               qb + (in ? row_off(r) : 0) + c * 8, in);
  }
  cp_async_commit();
  const int n_items = 2 * n_tiles;
#pragma unroll
  for (int it = 0; it < NS; ++it) {
    if (it < n_items) load_item(it);
    cp_async_commit();
  }

  // this warp's rows wr + [0, 16); query positions of the lane's rows g
  // and g + 8
  const int wr = r0 + warp * 16;
  const int qpos[2] = {(wr + g) / G, (wr + g + 8) / G};
  // ldmatrix row addresses of this lane (see the fragment note at mma_bf16)
  const uint32_t q_addr =
      smem_u32(qs + (warp * 16 + (lane & 15)) * RS + (lane >> 4) * 8);
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = (lane >> 3) & 1;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = lane >> 4;

  // scores are kept scaled by log2(e), so exp(x) is ex2 of them
  const float scale_log2 = scale * 1.4426950408889634f;
  uint32_t qa[T::kQRegs ? KSTEPS : 1][4];
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const __nv_bfloat16* kst = ring + (2 * j % NS) * BN * RS;
    const __nv_bfloat16* vst = ring + ((2 * j + 1) % NS) * BN * RS;
    const int kt = k_lo + j * BN;
    // does every row of the block see every key of the tile?
    const bool whole = kt + BN <= Sk && (!causal || kt + BN - 1 <= p_first) &&
                       (window <= 0 || p_last - kt < window);
    // committed after K_j: the NS - 1 items up to 2j + NS - 1
    cp_async_wait<NS - 1>();
    __syncthreads();
    if constexpr (T::kQRegs) {
      if (j == 0) {
#pragma unroll
        for (int st = 0; st < KSTEPS; ++st) ldsm_x4(qa[st], q_addr + st * 32);
      }
    }

    // S = Q K^T for BN keys
    float s[ST][4];
#pragma unroll
    for (int jj = 0; jj < ST; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[jj][i] = 0.f;
    const uint32_t k_addr = smem_u32(kst + k_row * RS + k_col * 8);
#pragma unroll
    for (int st = 0; st < KSTEPS; ++st) {
      uint32_t af[4];
      const uint32_t* a = af;
      if constexpr (T::kQRegs) {
        a = qa[st];
      } else {
        ldsm_x4(af, q_addr + st * 32);
      }
#pragma unroll
      for (int jj = 0; jj < ST; jj += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, k_addr + (jj * 8 * RS + st * 16) * 2);
        mma_bf16(s[jj], a, bk[0], bk[1]);
        mma_bf16(s[jj + 1], a, bk[2], bk[3]);
      }
    }

    // scale, mask (unless every row sees the whole tile), online softmax
    // (rows g and g + 8 of the warp)
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int jj = 0; jj < ST; ++jj) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = qpos[i >> 1];
        const int kj = kt + jj * 8 + 2 * t + (i & 1);
        bool ok = whole || kj < Sk;
        if (causal) ok = ok && (whole || kj <= qi);
        if (window > 0) ok = ok && (whole || qi - kj < window);
        s[jj][i] = ok ? s[jj][i] * scale_log2 : kNeg;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[jj][i]);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int jj = 0; jj < ST; ++jj) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[jj][i] = ex2(s[jj][i] - m[i >> 1]);
        sum[i >> 1] += s[jj][i];
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

    // committed after V_j: the NS - 2 items up to 2j + NS - 1.  Past this
    // barrier every warp is done with K_j, whose slot takes item 2j + NS.
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (2 * j + NS < n_items) load_item(2 * j + NS);
    cp_async_commit();

    // O += P V, P from the S accumulators (16 keys per k-step)
    const uint32_t v_addr = smem_u32(vst + v_row * RS + v_col * 8);
#pragma unroll
    for (int st = 0; st < BN / 16; ++st) {
      const uint32_t pa[4] = {pack_bf16(s[2 * st][0], s[2 * st][1]),
                              pack_bf16(s[2 * st][2], s[2 * st][3]),
                              pack_bf16(s[2 * st + 1][0], s[2 * st + 1][1]),
                              pack_bf16(s[2 * st + 1][2], s[2 * st + 1][3])};
#pragma unroll
      for (int n = 0; n < OT; n += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_addr + (st * 16 * RS + n * 8) * 2);
        mma_bf16(acc[n], pa, bv[0], bv[1]);
        mma_bf16(acc[n + 1], pa, bv[2], bv[3]);
      }
    }
    if (2 * j + 1 + NS < n_items) {   // the same in every thread
      __syncthreads();                 // every warp is done with V_j
      load_item(2 * j + 1 + NS);
    }
    cp_async_commit();
  }

  // epilogue: no copy may still land in Q's rows, which now take the
  // warp's output; then 16-byte stores of whole rows
  cp_async_wait<0>();
  __syncthreads();
  __nv_bfloat16* ow = qs + warp * 16 * RS;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / fmaxf(l[r], 1e-37f);
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      *reinterpret_cast<uint32_t*>(ow + (g + 8 * r) * RS + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < CH / 2; ++it) {        // 16 rows x CH chunks
    const int i = lane + it * 32, rr = i / CH, c = i % CH, r = wr + rr;
    if (r < rows) {
      *reinterpret_cast<uint4*>(ob + row_off(r) + c * 8) =
          *reinterpret_cast<const uint4*>(ow + rr * RS + c * 8);
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
    constexpr int smem = MmaTile<HD>::kBytes;
    if (smem > 48 * 1024) {
      const cudaError_t err = set_smem(flash_fwd_mma_kernel<HD>, smem);
      if (err != cudaSuccess) return err;
    }
    // one block per 64 folded rows of each (batch, KV head)
    const long long rows = (long long)Sq * (H / KH);
    const long long row_blocks = (rows + kMmaBM - 1) / kMmaBM;
    const long long blocks = row_blocks * B * KH;
    if (rows > INT_MAX || blocks > INT_MAX) return cudaErrorInvalidValue;
    flash_fwd_mma_kernel<HD><<<(unsigned)blocks, kMmaWarps * 32, smem,
                               stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        Sq, Sk, H, KH, causal, window, scale, (int)row_blocks);
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

template <int HD>
cudaError_t info(int dtype, int* out) {
  if (dtype == kBF16)
    return kernel_info(flash_fwd_mma_kernel<HD>, kMmaWarps * 32,
                       MmaTile<HD>::kBytes, out);
  if (dtype != kF32) return cudaErrorInvalidValue;
  return kernel_info(flash_fwd_f32_kernel<HD>, kWarps * 32, smem_bytes<HD>(),
                     out);
}

}  // namespace

// What the instance for (hd, dtype) takes on this card: out[4] as
// kernel_info gives it.
REPRO_EXPORT int flash_attention_info(int hd, int dtype, int* out) {
  switch (hd) {
    case 16: return info<16>(dtype, out);
    case 32: return info<32>(dtype, out);
    case 64: return info<64>(dtype, out);
    case 96: return info<96>(dtype, out);
    case 128: return info<128>(dtype, out);
    case 256: return info<256>(dtype, out);
    default: return cudaErrorInvalidValue;
  }
}

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
    case 96: return launch<96>(dtype, q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
    case 128: return launch<128>(dtype, q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
    case 256: return launch<256>(dtype, q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
