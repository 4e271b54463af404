// Flash-decoding attention for Hopper (sm_90a): one new token per row
// against its KV cache.
//
// Replaces repro/kernels/decode_attention/kernel.py: decode_attention_flat
// (_decode_kernel), the attention of every engine decode step.  Same
// function: the G query heads that share a KV head attend over the cache
// positions [lo[b], hi[b]] of their row, softmax in f32, the final l
// floored at 1e-37, output in q's dtype.  A single card's call gives each
// row's position as hi and no lo: the kernel takes lo = max(0, hi - window
// + 1) (0 without a window), the Pallas kernel's valid set, so the call
// stays one launch; a sequence shard of a cache on a mesh gets each row's
// global range cut to the shard, lo and hi in the shard's own positions,
// which may be empty.  The valid set is computed here from the per-row
// int32 bounds; no (B*KH, S) mask tensor is made.  Where asked, the call
// also writes each (row, head)'s log-sum-exp of the scaled scores in f32
// (natural log; -inf, with o = 0, for an empty range), which the mesh's
// merge of shards weighs them by.
//
// What bounds it on this card: reading the valid K and V.  At olmo-1b's
// decode shape (4 slots x 16 KV heads of 128, bf16, positions 1900, 1024,
// 300, 37) that is 26.7 MB (8.0 us at 3.35 TB/s); at recurrentgemma-9b's
// (4 slots x 1 KV head of 256, window 2048) 6.4 MB (1.9 us).  The
// products are 4 x G x hd operations per position: 0.1 and 0.2 us on the
// tensor cores.  At these sizes a launch and a few memory latencies are
// most of the time, so the design keeps every block's loads in flight at
// once and the call to one launch.
//
// Design of the bf16 kernel (the models' dtype):
//  * Rows of one MMA tile.  A block serves one (batch row b, KV head kh)
//    and all G <= 16 of its query heads: they are the rows of one 16-row
//    mma.sync m16n8k16 tile (rows past G are zero).  So every K/V tile is
//    read once per KV head for all its heads, and both products, S = q K^T
//    and O += P V, run on the tensor cores with fragments by ldmatrix (V's
//    by .trans from V stored as it arrives).  q is bf16 and enters the
//    product as it is; the scale (times log2 e, for ex2) multiplies the f32
//    scores, so q * scale is never rounded (products of bf16 values are
//    exact in f32).  P is rounded to bf16 for P V, as FlashAttention-2 does.
//  * Splits by valid length.  Row b's valid positions [lo, hi] are cut
//    into chunks of `chunk` keys (the wrapper's choice, a multiple of the
//    64-key tile), one block each; the grid holds enough blocks for the
//    longest possible row, split-major, and a block past its row's last
//    chunk exits at once.  So every working block has the same number of
//    positions (but each row's last) and none gets an empty chunk.
//  * Loads in flight.  A chunk's K/V tiles arrive by 16-byte cp.async.cg
//    (zero-filled past the chunk) into rows padded by 16 bytes, through a
//    ring of NS stages (a K and a V tile each; 3 at hd 256, 4 below, as
//    many as fit one block's shared memory) refilled as soon as every warp
//    is done with a stage.
//  * Work of the 4 warps.  With one block an SM a warp has its SM
//    sub-partition to itself, so its chains of dependent ldmatrix and
//    mma.sync are not hidden by other warps; what keeps it busy is
//    independent work and registers to run ahead.  For S each warp takes
//    16 keys of the tile against all G rows, q's fragments held in
//    registers, the k-steps in two independent chains.  The tile's row
//    maxima and sums meet in shared memory, P goes there as bf16, and for
//    P V the warps split the output dims (hd / 4 each; at hd 96, 32 each
//    of 3 warps, since the n-tiles go in pairs of 16 dims and 24 is not a
//    pair: the fourth warp idles there, as warps do at hd 16 and 32), so
//    a thread keeps hd / 8 accumulators (hd / 6 at hd 96; not hd / 2, as
//    when every warp covered all dims) and the warps' states need no
//    merge at the end.
//  * One partial per block, the merge fused.  A row served by one block
//    writes its output at once.  Otherwise each block writes one (m, l,
//    acc) partial for its G heads, and the last block of the row to finish
//    (a per-row counter, atomicAdd by one thread after the block's stores
//    and a __threadfence) merges the row's partials: batches of them are
//    staged in the idle ring by cp.async, so one batch is one round trip
//    of loads.  It writes the output and sets the counter back to 0 for
//    the next call.  One launch per call; the wrapper keeps the counters,
//    zeroed once per device.
//
// The f32 kernel (tests and the f32 decode step) stays on the CUDA cores:
// a block scores at most 8 query heads of a KV head (a lane's
// accumulators would not fit registers beyond), one key per lane, and a
// second launch merges the per-warp partials of the row's n_split chunks.
//
// chip_smoke.py phase 1 logs each instance's registers, local bytes,
// shared bytes and resident blocks per SM (decode_attention_info).
#include "common.cuh"

using namespace repro;

namespace {

constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------- bf16 ---
constexpr int kMmaWarps = 4;
constexpr int kRows = 16;      // MMA rows: the G query heads of a KV head
constexpr int kBN = 64;        // keys per K/V tile, 16 a warp for q K^T

// P V warps: the most of the block's warps that split hd into equal
// shares of whole 16-dim pairs of n-tiles (the loop takes n-tiles two at a
// time by one ldmatrix.x4.trans): 1 at hd 16, 2 at 32, 3 at 96 (32 dims
// each), 4 at 64, 128 and 256.  The warps past it idle in P V.
constexpr int pv_warps(int hd) {
  int w = kMmaWarps;
  while ((hd / 16) % w) --w;
  return w;
}

// Shared memory: the 16 q rows, the tile's P (16 rows x 64 keys), then NS
// stages of a K and a V tile; rows padded by 8 bf16 (16 bytes).  The last
// block of a row later stages batches of the row's partials in the ring.
template <int HD>
struct DecTile {
  static constexpr int RS = HD + 8;            // padded q, K, V row, bf16
  static constexpr int CH = HD / 8;            // 16-byte chunks per row
  static constexpr int PS = kBN + 8;           // padded P row, bf16
  static constexpr int NS = HD > 128 ? 3 : 4;  // ring stages
  // P V: the warps split the output dims, a multiple of 16 each
  static constexpr int WPV = pv_warps(HD);
  static constexpr int DW = HD / WPV;          // output dims of a P V warp
  static_assert(HD % 16 == 0 && DW % 16 == 0 && WPV * DW == HD,
                "P V takes whole pairs of n-tiles");
  static constexpr int kStageBytes = 2 * kBN * RS * 2;
  static constexpr int kHeadBytes = kRows * RS * 2 + kRows * PS * 2;
  static_assert(kStageBytes >= kRows * (HD + 2) * 4,
                "a stage holds the partial of one split at G = 16");
  static constexpr int bytes(int stages) {
    return kHeadBytes + stages * kStageBytes;
  }
};

template <int HD>
__global__ void __launch_bounds__(kMmaWarps * 32)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ kc,
                  const __nv_bfloat16* __restrict__ vc,
                  const int* __restrict__ lo_b, const int* __restrict__ hi_b,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  float* __restrict__ acc_part, float* __restrict__ m_part,
                  float* __restrict__ l_part, int* __restrict__ counters,
                  int rows, int S, int KH, int G, int window,
                  float scale_log2, int chunk, int max_splits) {
  using T = DecTile<HD>;
  constexpr int RS = T::RS, CH = T::CH, PS = T::PS, NS = T::NS;
  constexpr int WPV = T::WPV, DW = T::DW;
  constexpr int NT = kMmaWarps * 32;
  constexpr int KSTEPS = HD / 16;   // k-steps of q K^T
  constexpr int OTW = DW / 8;       // n-tiles of a P V warp's output
  static_assert((kBN * CH) % NT == 0, "tile copies split evenly");
  extern __shared__ __align__(16) unsigned char dec_smem[];
  __shared__ float tile_m[kMmaWarps][kRows], tile_l[kMmaWarps][kRows];
  __shared__ int last_block;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(dec_smem);
  __nv_bfloat16* ps = qs + kRows * RS;         // [kRows][PS]
  __nv_bfloat16* ring = ps + kRows * PS;       // [NS][K, V][kBN][RS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x / rows, row = blockIdx.x % rows;
  const int b = row / KH, kh = row % KH;
  // the G heads of this KV head are consecutive in q's and o's (B, H, hd);
  // q (zeros past G) is fetched before the bounds are read
  const size_t q_off = (size_t)row * G * HD;
  for (int i = tid; i < kRows * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool in = r < G;
    cp_async16(smem_u32(qs + r * RS + c * 8),
               q + q_off + (in ? r * HD : 0) + c * 8, in);
  }
  cp_async_commit();
  // the row's valid positions [lo, hi] and this block's chunk [t0, t1);
  // the wrapper keeps hi - lo below max_splits chunks (the clamp only
  // keeps the row's counter whole)
  const int p = hi_b[b];
  const int hi = min(p, S - 1);
  const int lo = lo_b != nullptr ? max(lo_b[b], 0)
                                 : (window > 0 ? max(0, p - window + 1) : 0);
  const int n = hi - lo + 1;
  const int n_split = n > 0 ? min((n + chunk - 1) / chunk, max_splits) : 0;
  __nv_bfloat16* orow = o + q_off;
  if (split >= max(n_split, 1)) {
    cp_async_wait<0>();
    return;
  }
  if (n_split == 0) {               // nothing valid: the plain version's 0
    for (int i = tid; i < G * HD; i += NT) orow[i] = __float2bfloat16(0.f);
    if (lse != nullptr && tid < G) lse[(size_t)row * G + tid] = -INFINITY;
    cp_async_wait<0>();
    return;
  }
  const int t0 = lo + split * chunk;
  const int t1 = min(t0 + chunk, hi + 1);
  const int n_tiles = (t1 - t0 + kBN - 1) / kBN;

  const size_t kv_stride = (size_t)KH * HD;
  const __nv_bfloat16* kb = kc + ((size_t)b * S * KH + kh) * HD;
  const __nv_bfloat16* vb = vc + ((size_t)b * S * KH + kh) * HD;
  auto load_tile = [&](int j) {
    __nv_bfloat16* ks = ring + (j % NS) * 2 * kBN * RS;
    __nv_bfloat16* vs = ks + kBN * RS;
    const int kt = t0 + j * kBN;
#pragma unroll
    for (int it = 0; it < kBN * CH / NT; ++it) {
      const int i = tid + it * NT, key = i / CH, c = i % CH, kj = kt + key;
      const bool in = kj < t1;
      const size_t off = (in ? (size_t)kj * kv_stride : 0) + c * 8;
      cp_async16(smem_u32(ks + key * RS + c * 8), kb + off, in);
      cp_async16(smem_u32(vs + key * RS + c * 8), vb + off, in);
    }
  };
  // the first NS tiles, a commit group each (empty groups past the last
  // tile keep the counts uniform)
#pragma unroll
  for (int it = 0; it < NS; ++it) {
    if (it < n_tiles) load_tile(it);
    cp_async_commit();
  }

  // lane = 4 g + t holds rows g and g + 8 (the fragment note at mma_bf16)
  const int g = lane >> 2, t = lane & 3;
  const int k_row = warp * 16 + (lane & 7) + (lane >> 4) * 8;
  const int k_col = (lane >> 3) & 1;
  const int dw = warp * DW;                    // this warp's P V dims
  const uint32_t p_addr = smem_u32(ps + (lane & 15) * PS + (lane >> 4) * 8);
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = dw + (lane >> 4) * 8;
  uint32_t qa[KSTEPS][4];
  // the running max and sum of rows g and g + 8, the same in every warp
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[OTW][4];
#pragma unroll
  for (int nn = 0; nn < OTW; ++nn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nn][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const __nv_bfloat16* ks = ring + (j % NS) * 2 * kBN * RS;
    const __nv_bfloat16* vs = ks + kBN * RS;
    // committed after tile j: the NS - 1 groups of tiles j+1 .. j+NS-1
    cp_async_wait<NS - 1>();
    __syncthreads();
    if (j == 0) {
      const uint32_t q_addr =
          smem_u32(qs + (lane & 15) * RS + (lane >> 4) * 8);
#pragma unroll
      for (int st = 0; st < KSTEPS; ++st) ldsm_x4(qa[st], q_addr + st * 32);
    }

    // S = q K^T for this warp's 16 keys: two chains of k-steps per n-tile
    float s[2][4], s2[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[0][i] = s[1][i] = s2[0][i] = s2[1][i] = 0.f;
    const uint32_t k_addr = smem_u32(ks + k_row * RS + k_col * 8);
#pragma unroll
    for (int st = 0; st < KSTEPS; st += 2) {
      uint32_t bk[4];
      ldsm_x4(bk, k_addr + st * 32);
      mma_bf16(s[0], qa[st], bk[0], bk[1]);
      mma_bf16(s[1], qa[st], bk[2], bk[3]);
      if (st + 1 < KSTEPS) {
        uint32_t bk2[4];
        ldsm_x4(bk2, k_addr + (st + 1) * 32);
        mma_bf16(s2[0], qa[st + 1], bk2[0], bk2[1]);
        mma_bf16(s2[1], qa[st + 1], bk2[2], bk2[3]);
      }
    }

    // scale, mask keys past the chunk; the warp's row maxima
    const int kw = t0 + j * kBN + warp * 16;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = kw + jj * 8 + 2 * t + (i & 1);
        s[jj][i] = kj < t1 ? (s[jj][i] + s2[jj][i]) * scale_log2 : kNeg;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[jj][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (t == 0) {
      tile_m[warp][g] = mx[0];
      tile_m[warp][g + 8] = mx[1];
    }
    __syncthreads();

    // the tile's row maxima over all warps; P = 2^(s - m) into shared
    // memory as bf16 and the warp's row sums
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w)
        m_new = fmaxf(m_new, tile_m[w][g + 8 * r]);
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[jj][i] = ex2(s[jj][i] - m[i >> 1]);
        sum[i >> 1] += s[jj][i];
      }
      const int col = warp * 16 + jj * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(ps + g * PS + col) =
          pack_bf16(s[jj][0], s[jj][1]);
      *reinterpret_cast<uint32_t*>(ps + (g + 8) * PS + col) =
          pack_bf16(s[jj][2], s[jj][3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
    if (t == 0) {
      tile_l[warp][g] = sum[0];
      tile_l[warp][g + 8] = sum[1];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tl = 0.f;
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w) tl += tile_l[w][g + 8 * r];
      l[r] = l[r] * corr[r] + tl;
    }

    // O = O * corr + P V over the tile's 64 keys, for this warp's dims
    if (warp < WPV) {
#pragma unroll
      for (int nn = 0; nn < OTW; ++nn) {
        acc[nn][0] *= corr[0];
        acc[nn][1] *= corr[0];
        acc[nn][2] *= corr[1];
        acc[nn][3] *= corr[1];
      }
#pragma unroll
      for (int kst = 0; kst < kBN / 16; ++kst) {
        uint32_t pa[4];
        ldsm_x4(pa, p_addr + kst * 32);
        const uint32_t v_addr =
            smem_u32(vs + (kst * 16 + v_row) * RS + v_col);
#pragma unroll
        for (int nn = 0; nn < OTW; nn += 2) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, v_addr + nn * 16);
          mma_bf16(acc[nn], pa, bv[0], bv[1]);
          mma_bf16(acc[nn + 1], pa, bv[2], bv[3]);
        }
      }
    }

    // every warp is done with this stage, P and the tile sums: refill
    __syncthreads();
    if (j + NS < n_tiles) load_tile(j + NS);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // rows g and g + 8 of this warp's dims [dw, dw + DW)
  const bool single = n_split == 1;
  const size_t part = (size_t)row * max_splits + split;
  if (warp < WPV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = g + 8 * r;
      if (rr >= G) continue;
      if (single) {
        const float inv = 1.f / fmaxf(l[r], 1e-37f);
#pragma unroll
        for (int nn = 0; nn < OTW; ++nn)
          *reinterpret_cast<__nv_bfloat162*>(orow + rr * HD + dw + nn * 8 +
                                             2 * t) =
              __floats2bfloat162_rn(acc[nn][2 * r] * inv,
                                    acc[nn][2 * r + 1] * inv);
        // m and l are in log2 units, the same in every warp
        if (lse != nullptr && warp == 0 && t == 0)
          lse[(size_t)row * G + rr] = (m[r] + log2f(l[r])) * kLn2;
      } else {
        if (warp == 0 && t == 0) {
          m_part[part * G + rr] = m[r];
          l_part[part * G + rr] = l[r];
        }
#pragma unroll
        for (int nn = 0; nn < OTW; ++nn)
          *reinterpret_cast<float2*>(acc_part + (part * G + rr) * HD + dw +
                                     nn * 8 + 2 * t) =
              make_float2(acc[nn][2 * r], acc[nn][2 * r + 1]);
      }
    }
  }
  if (single) return;

  // the last block of the row to finish merges the row's partials: the
  // block's stores, then one release by thread 0 with the count
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last_block = atomicAdd(counters + row, 1) == n_split - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last_block) return;

  // in batches of SB splits staged in the idle ring: a batch's
  // accumulators arrive by 16-byte cp.async.cg (from L2, where the other
  // blocks wrote them), its m and l by __ldcg, all in flight at once; the
  // running max, sum and output of each row are rescaled batch by batch
  constexpr int D4 = HD / 4;                          // float4 of a row
  constexpr int IPT = (kRows * D4 + NT - 1) / NT;     // float4 a thread owns
  const int SB = min(NS, chunk / kBN) * T::kStageBytes / (G * (HD + 2) * 4);
  float* sa = reinterpret_cast<float*>(ring);         // [SB][G][HD]
  float* sw = sa + SB * G * HD;                       // [SB][G] m, weights
  float* sl = sw + SB * G;                            // [SB][G] l
  __shared__ float run_m[kRows], run_l[kRows], run_c[kRows];
  if (tid < kRows) {
    run_m[tid] = kNeg;
    run_l[tid] = 0.f;
    run_c[tid] = 0.f;
  }
  float4 A[IPT];
#pragma unroll
  for (int it = 0; it < IPT; ++it) A[it] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < n_split; s0 += SB) {
    const int nb = min(SB, n_split - s0);
    const size_t pb = ((size_t)row * max_splits + s0) * G;
    for (int i = tid; i < nb * G * D4; i += NT)
      cp_async16(smem_u32(sa + i * 4), acc_part + pb * HD + i * 4, true);
    cp_async_commit();
    for (int i = tid; i < nb * G; i += NT) {
      sw[i] = __ldcg(m_part + pb + i);
      sl[i] = __ldcg(l_part + pb + i);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (tid < G) {                  // row tid: new max, weights, sum
      float mb = run_m[tid];
      for (int sp = 0; sp < nb; ++sp) mb = fmaxf(mb, sw[sp * G + tid]);
      const float c = ex2(run_m[tid] - mb);
      float L = run_l[tid] * c;
      for (int sp = 0; sp < nb; ++sp) {
        const float w = ex2(sw[sp * G + tid] - mb);
        sw[sp * G + tid] = w;
        L += w * sl[sp * G + tid];
      }
      run_m[tid] = mb;
      run_l[tid] = L;
      run_c[tid] = c;
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int r = min((tid + it * NT) / D4, kRows - 1);
      const float c = run_c[r];
      A[it].x *= c; A[it].y *= c; A[it].z *= c; A[it].w *= c;
    }
    for (int sp = 0; sp < nb; ++sp) {
#pragma unroll
      for (int it = 0; it < IPT; ++it) {
        const int i = tid + it * NT, r = i / D4;
        if (r < G) {
          const float w = sw[sp * G + r];
          const float4 a = *reinterpret_cast<const float4*>(
              sa + (sp * G + r) * HD + (i % D4) * 4);
          A[it].x += w * a.x; A[it].y += w * a.y;
          A[it].z += w * a.z; A[it].w += w * a.w;
        }
      }
    }
    __syncthreads();               // the next batch may overwrite the ring
  }
#pragma unroll
  for (int it = 0; it < IPT; ++it) {
    const int i = tid + it * NT, r = i / D4, d = (i % D4) * 4;
    if (r < G) {
      const float inv = 1.f / fmaxf(run_l[r], 1e-37f);
      __nv_bfloat162* out =
          reinterpret_cast<__nv_bfloat162*>(orow + r * HD + d);
      out[0] = __floats2bfloat162_rn(A[it].x * inv, A[it].y * inv);
      out[1] = __floats2bfloat162_rn(A[it].z * inv, A[it].w * inv);
    }
  }
  if (lse != nullptr && tid < G)
    lse[(size_t)row * G + tid] = (run_m[tid] + log2f(run_l[tid])) * kLn2;
  if (tid == 0) counters[row] = 0;   // ready for the next call
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* kc, const void* vc,
                       const int* lo, const int* hi, void* o, float* lse,
                       float* acc_part, float* m_part, float* l_part,
                       int* counters, int B, int S, int KH, int G,
                       int max_len, int window, float scale, int chunk,
                       cudaStream_t stream) {
  using T = DecTile<HD>;
  // the ring needs no more stages than a chunk has tiles
  const int smem = T::bytes(min(T::NS, chunk / kBN));
  if (T::bytes(T::NS) > 48 * 1024) {
    const cudaError_t err = set_smem(decode_mma_kernel<HD>, T::bytes(T::NS));
    if (err != cudaSuccess) return err;
  }
  const int n_max = max_len > 0 ? min(S, max_len) : S;
  const int max_splits = (n_max + chunk - 1) / chunk;
  const int rows = B * KH;
  decode_mma_kernel<HD><<<rows * max_splits, kMmaWarps * 32, smem,
                          stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), lo, hi,
      static_cast<__nv_bfloat16*>(o), lse, acc_part, m_part, l_part,
      counters, rows, S, KH, G, window, scale * 1.4426950408889634f, chunk,
      max_splits);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 ---
constexpr int kWarps = 4;

// G: the query heads this block scores; a row is (batch b, KV head kh,
// sub-group of G heads), n_sub sub-groups per KV head.
template <int HD, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_partial_kernel(const float* __restrict__ q,
                      const float* __restrict__ kc,
                      const float* __restrict__ vc,
                      const int* __restrict__ lo_b,
                      const int* __restrict__ hi_b,
                      float* __restrict__ m_part, float* __restrict__ l_part,
                      float* __restrict__ acc_part, int S, int KH,
                      int n_sub, int window, float scale) {
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;  // V dims per lane
  constexpr int LANES = HD / EPL;              // lanes that own V dims
  __shared__ __align__(16) float qs[G * HD];   // scaled q rows
  const int split = blockIdx.x, n_split = gridDim.x;
  const int row = blockIdx.y, b = row / n_sub / KH, kh = row / n_sub % KH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool owner = lane < LANES;

  // the row's G heads are consecutive in q's (B, H, hd) layout
  for (int i = threadIdx.x; i < G * HD; i += kWarps * 32)
    qs[i] = q[(size_t)row * G * HD + i] * scale;
  __syncthreads();

  // valid positions of this row: [lo, hi]; this block's chunk [t0, t1)
  const int p = hi_b[b];
  const int hi = min(p, S - 1);
  const int lo = lo_b != nullptr ? max(lo_b[b], 0)
                                 : (window > 0 ? max(0, p - window + 1) : 0);
  const int n = max(0, hi - lo + 1);
  const int chunk = (n + n_split - 1) / n_split;
  const int t0 = lo + split * chunk;
  const int t1 = min(t0 + chunk, hi + 1);

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const size_t pos_stride = (size_t)KH * HD;
  const float* kbase = kc + ((size_t)b * S * KH + kh) * HD;
  const float* vbase = vc + ((size_t)b * S * KH + kh) * HD + lane * EPL;
  for (int base = t0 + warp * 32; base < t1; base += kWarps * 32) {
    const int t = base + lane;
    const bool in = t < t1;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (in) {
      const float* kr = kbase + t * pos_stride;
#pragma unroll 4
      for (int d = 0; d < HD; d += 8) {
        float kx[8];
        load_f32<float, 8>(kr + d, kx);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float qv[8];
          load_f32<float, 8>(qs + g * HD + d, qv);
#pragma unroll
          for (int e = 0; e < 8; ++e) s[g] = fmaf(qv[e], kx[e], s[g]);
        }
      }
    }
    float pr[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sg = in ? s[g] : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(sg));
      const float corr = expf(m[g] - m_new);
      pr[g] = expf(sg - m_new);
      l[g] = l[g] * corr + warp_sum(pr[g]);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
    }
    const int nk = min(32, t1 - base);
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float vx[EPL] = {};
      if (owner) load_f32<float, EPL>(vbase + (base + j) * pos_stride, vx);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = __shfl_sync(0xffffffffu, pr[g], j);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pj, vx[e], acc[g][e]);
      }
    }
  }

  const int P = n_split * kWarps;
  const size_t part = (size_t)row * P + split * kWarps + warp;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      m_part[part * G + g] = m[g];
      l_part[part * G + g] = l[g];
    }
    if (owner) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc_part[(part * G + g) * HD + lane * EPL + e] = acc[g][e];
    }
  }
}

// One block per row; thread (g, d) merges the row's P partial triples
// (and, with lse, thread (g, 0) writes the head's log-sum-exp).
__global__ void decode_combine_kernel(const float* __restrict__ m_part,
                                      const float* __restrict__ l_part,
                                      const float* __restrict__ acc_part,
                                      float* __restrict__ o,
                                      float* __restrict__ lse, int P, int G,
                                      int HD) {
  const int row = blockIdx.x;
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    const size_t base = (size_t)row * P;
    float M = kNeg;
    for (int p = 0; p < P; ++p) M = fmaxf(M, m_part[(base + p) * G + g]);
    float L = 0.f, A = 0.f;
    for (int p = 0; p < P; ++p) {
      const float w = expf(m_part[(base + p) * G + g] - M);
      L += w * l_part[(base + p) * G + g];
      A += w * acc_part[((base + p) * G + g) * HD + d];
    }
    o[((size_t)row * G + g) * HD + d] = A / fmaxf(L, 1e-37f);
    if (lse != nullptr && d == 0)
      lse[(size_t)row * G + g] = L > 0.f ? M + logf(L) : -INFINITY;
  }
}

template <int HD, int G>
cudaError_t launch_f32(const void* q, const void* kc, const void* vc,
                       const int* lo, const int* hi, void* o, float* lse,
                       float* m_part, float* l_part, float* acc_part, int B,
                       int S, int KH, int n_sub, int window, float scale,
                       int n_split, cudaStream_t stream) {
  const int rows = B * KH * n_sub;
  const dim3 grid(n_split, rows);
  decode_partial_kernel<HD, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), lo, hi, m_part, l_part, acc_part, S, KH,
      n_sub, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = min(1024, ((G * HD + 31) / 32) * 32);
  decode_combine_kernel<<<rows, threads, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<float*>(o), lse,
      n_split * kWarps, G, HD);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_f32(int G, const void* q, const void* kc,
                         const void* vc, const int* lo, const int* hi,
                         void* o, float* lse, float* m_part, float* l_part,
                         float* acc_part, int B, int S, int KH, int n_sub,
                         int window, float scale, int n_split,
                         cudaStream_t stream) {
  switch (G) {
    case 1: return launch_f32<HD, 1>(q, kc, vc, lo, hi, o, lse, m_part, l_part, acc_part, B, S, KH, n_sub, window, scale, n_split, stream);
    case 2: return launch_f32<HD, 2>(q, kc, vc, lo, hi, o, lse, m_part, l_part, acc_part, B, S, KH, n_sub, window, scale, n_split, stream);
    case 4: return launch_f32<HD, 4>(q, kc, vc, lo, hi, o, lse, m_part, l_part, acc_part, B, S, KH, n_sub, window, scale, n_split, stream);
    case 8: return launch_f32<HD, 8>(q, kc, vc, lo, hi, o, lse, m_part, l_part, acc_part, B, S, KH, n_sub, window, scale, n_split, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int HD>
cudaError_t info(int dtype, int* out) {
  if (dtype == kBF16)
    return kernel_info(decode_mma_kernel<HD>, kMmaWarps * 32,
                       DecTile<HD>::bytes(DecTile<HD>::NS), out);
  if (dtype != kF32) return cudaErrorInvalidValue;
  return kernel_info(decode_partial_kernel<HD, 8>, kWarps * 32, 0, out);
}

}  // namespace

// What the instance for (hd, dtype) takes on this card, out[4] as
// kernel_info gives it: the bf16 kernel with its largest ring (one
// instance serves every G), the f32 partial kernel at 8 heads a block.
REPRO_EXPORT int decode_attention_info(int hd, int dtype, int* out) {
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

// bf16.  q, o: (B, 1, H, hd); k_cache, v_cache: (B, S, KH, hd); lo, hi:
// (B,) int32, row b's valid keys [lo[b], hi[b]], with hi - lo < max_len
// (0: S); lo null: lo[b] = max(0, hi[b] - window + 1), or 0 where window
// is 0; lse: (B, H) f32, or null; chunk: keys per block, a multiple of
// 64; acc_part: (B*KH, max_splits, H/KH, hd) f32 and m_part, l_part:
// (B*KH, max_splits, H/KH) f32, max_splits = ceil(min(S, max_len or S) /
// chunk); counters: B*KH int32, zero, and zero again when the call's work
// is done.
REPRO_EXPORT int decode_attention_mma(const void* q, const void* kc,
                                      const void* vc, const void* lo,
                                      const void* hi, void* o, void* lse,
                                      void* acc_part, void* m_part,
                                      void* l_part, void* counters, int B,
                                      int S, int H, int KH, int hd,
                                      int max_len, int window, float scale,
                                      int chunk, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || H / KH > kRows
      || chunk <= 0 || chunk % kBN != 0)
    return cudaErrorInvalidValue;
  const int G = H / KH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(lo);
  const int* hb = static_cast<const int*>(hi);
  float* ls = static_cast<float*>(lse);
  float* ap = static_cast<float*>(acc_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  int* cnt = static_cast<int*>(counters);
  switch (hd) {
    case 16: return launch_mma<16>(q, kc, vc, lb, hb, o, ls, ap, mp, lp, cnt, B, S, KH, G, max_len, window, scale, chunk, s);
    case 32: return launch_mma<32>(q, kc, vc, lb, hb, o, ls, ap, mp, lp, cnt, B, S, KH, G, max_len, window, scale, chunk, s);
    case 64: return launch_mma<64>(q, kc, vc, lb, hb, o, ls, ap, mp, lp, cnt, B, S, KH, G, max_len, window, scale, chunk, s);
    case 96: return launch_mma<96>(q, kc, vc, lb, hb, o, ls, ap, mp, lp, cnt, B, S, KH, G, max_len, window, scale, chunk, s);
    case 128: return launch_mma<128>(q, kc, vc, lb, hb, o, ls, ap, mp, lp, cnt, B, S, KH, G, max_len, window, scale, chunk, s);
    case 256: return launch_mma<256>(q, kc, vc, lb, hb, o, ls, ap, mp, lp, cnt, B, S, KH, G, max_len, window, scale, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

// f32.  Shapes as above; a block scores `group_block` of the H/KH query
// heads of a KV head; m_part, l_part: (B*H/group_block, n_split*4,
// group_block) f32; acc_part: (..., group_block, hd) f32.
REPRO_EXPORT int decode_attention_f32(const void* q, const void* kc,
                                      const void* vc, const void* lo,
                                      const void* hi, void* o, void* lse,
                                      void* m_part, void* l_part,
                                      void* acc_part, int B, int S, int H,
                                      int KH, int hd, int window, float scale,
                                      int n_split, int group_block,
                                      void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || n_split <= 0
      || group_block <= 0 || (H / KH) % group_block != 0)
    return cudaErrorInvalidValue;
  const int n_sub = H / KH / group_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(lo);
  const int* hb = static_cast<const int*>(hi);
  float* ls = static_cast<float*>(lse);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  switch (hd) {
    case 16: return dispatch_f32<16>(group_block, q, kc, vc, lb, hb, o, ls, mp, lp, ap, B, S, KH, n_sub, window, scale, n_split, s);
    case 32: return dispatch_f32<32>(group_block, q, kc, vc, lb, hb, o, ls, mp, lp, ap, B, S, KH, n_sub, window, scale, n_split, s);
    case 64: return dispatch_f32<64>(group_block, q, kc, vc, lb, hb, o, ls, mp, lp, ap, B, S, KH, n_sub, window, scale, n_split, s);
    case 96: return dispatch_f32<96>(group_block, q, kc, vc, lb, hb, o, ls, mp, lp, ap, B, S, KH, n_sub, window, scale, n_split, s);
    case 128: return dispatch_f32<128>(group_block, q, kc, vc, lb, hb, o, ls, mp, lp, ap, B, S, KH, n_sub, window, scale, n_split, s);
    case 256: return dispatch_f32<256>(group_block, q, kc, vc, lb, hb, o, ls, mp, lp, ap, B, S, KH, n_sub, window, scale, n_split, s);
    default: return cudaErrorInvalidValue;
  }
}
