// Flash-decoding attention for Hopper (sm_90a): one new token per row
// against its KV cache.
//
// Replaces repro/kernels/decode_attention/kernel.py: decode_attention_flat
// (_decode_kernel), the attention of every engine decode step.  Same
// function: the G query heads that share a KV head attend over cache
// positions k_pos <= pos[b] (and pos[b] - k_pos < window when windowed),
// softmax in f32, q scaled in f32 before the product, the final l floored
// at 1e-37, output in q's dtype.  The valid set is computed here from the
// per-row int32 positions; no (B*KH, S) mask tensor is made.
//
// What bounds it on this card: reading K and V.  At the main-path shape
// (4 slots x 16 KV heads, S=2048, hd=128, bf16) the whole cache is 67 MB
// (20 us at 3.35 TB/s), but only positions <= pos are valid, and the
// kernel reads only those, so the bound of a step is the valid prefix.
//
// Design (split-K flash-decoding): B*KH = 64 rows are fewer than the 132
// SMs, so one block per row would leave half the card idle.  Each row's
// valid range is cut into n_split chunks, one block of 4 warps per (chunk,
// row), and a second small kernel merges the n_split * 4 partial
// (m, l, acc) triples of each row.  Inside a chunk a warp takes 32
// positions at a time, one per lane: a lane reads its key's whole K row
// (16-byte loads; the G scaled q rows sit in shared memory and are read
// as broadcasts) and scores it for all G heads, so the softmax update is
// one warp max and one warp sum per 32 keys, not per key.  P.V then walks
// the 32 keys with the probability broadcast by a shuffle; a lane owns
// hd/32 dims, so each V row is one coalesced 256-byte read per warp (hd
// 128, bf16).
//
// A block scores at most 8 query heads (GB): with more, as the 16 heads
// over one KV head of recurrentgemma-9b (hd 256), a lane's accumulators
// (GB x hd/32) and per-head softmax state would no longer fit in
// registers, so each KV row is served by G/GB blocks side by side, each
// for GB of its heads (the second reads the row's K and V again, mostly
// from L2).  A split's chunk holds at least 16 * GB positions (the
// wrapper's rule), so the partials it writes stay at a quarter of the K
// and V bytes it reads.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kWarps = 4;

// G: the query heads this block scores; a row is (batch b, KV head kh,
// sub-group of G heads), n_sub sub-groups per KV head.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int* __restrict__ pos,
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
    qs[i] = to_f32(q[(size_t)row * G * HD + i]) * scale;
  __syncthreads();

  // valid positions of this row: [lo, hi]; this block's chunk [t0, t1)
  const int p = pos[b];
  const int hi = min(p, S - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
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
  const T* kbase = kc + ((size_t)b * S * KH + kh) * HD;
  const T* vbase = vc + ((size_t)b * S * KH + kh) * HD + lane * EPL;
  for (int base = t0 + warp * 32; base < t1; base += kWarps * 32) {
    const int t = base + lane;
    const bool in = t < t1;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (in) {
      const T* kr = kbase + t * pos_stride;
#pragma unroll 4
      for (int d = 0; d < HD; d += 8) {
        float kx[8];
        load_f32<T, 8>(kr + d, kx);
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
      if (owner) load_f32<T, EPL>(vbase + (base + j) * pos_stride, vx);
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

// One block per row; thread (g, d) merges the row's P partial triples.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ m_part,
                                      const float* __restrict__ l_part,
                                      const float* __restrict__ acc_part,
                                      T* __restrict__ o, int P, int G,
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
    o[((size_t)row * G + g) * HD + d] = from_f32<T>(A / fmaxf(L, 1e-37f));
  }
}

template <typename T, int HD, int G>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* pos, void* o, float* m_part, float* l_part,
                   float* acc_part, int B, int S, int KH, int n_sub,
                   int window, float scale, int n_split,
                   cudaStream_t stream) {
  const int rows = B * KH * n_sub;
  const dim3 grid(n_split, rows);
  decode_partial_kernel<T, HD, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), pos, m_part, l_part, acc_part, S, KH, n_sub,
      window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = min(1024, ((G * HD + 31) / 32) * 32);
  decode_combine_kernel<T><<<rows, threads, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<T*>(o), n_split * kWarps, G, HD);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(int G, const void* q, const void* kc, const void* vc,
                       const int* pos, void* o, float* m_part,
                       float* l_part, float* acc_part, int B, int S, int KH,
                       int n_sub, int window, float scale, int n_split,
                       cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, HD, 1>(q, kc, vc, pos, o, m_part, l_part, acc_part, B, S, KH, n_sub, window, scale, n_split, stream);
    case 2: return launch<T, HD, 2>(q, kc, vc, pos, o, m_part, l_part, acc_part, B, S, KH, n_sub, window, scale, n_split, stream);
    case 4: return launch<T, HD, 4>(q, kc, vc, pos, o, m_part, l_part, acc_part, B, S, KH, n_sub, window, scale, n_split, stream);
    case 8: return launch<T, HD, 8>(q, kc, vc, pos, o, m_part, l_part, acc_part, B, S, KH, n_sub, window, scale, n_split, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int hd, int G, const void* q, const void* kc,
                     const void* vc, const int* pos, void* o, float* m_part,
                     float* l_part, float* acc_part, int B, int S, int KH,
                     int n_sub, int window, float scale, int n_split,
                     cudaStream_t stream) {
  switch (hd) {
    case 16: return dispatch_g<T, 16>(G, q, kc, vc, pos, o, m_part, l_part, acc_part, B, S, KH, n_sub, window, scale, n_split, stream);
    case 32: return dispatch_g<T, 32>(G, q, kc, vc, pos, o, m_part, l_part, acc_part, B, S, KH, n_sub, window, scale, n_split, stream);
    case 64: return dispatch_g<T, 64>(G, q, kc, vc, pos, o, m_part, l_part, acc_part, B, S, KH, n_sub, window, scale, n_split, stream);
    case 128: return dispatch_g<T, 128>(G, q, kc, vc, pos, o, m_part, l_part, acc_part, B, S, KH, n_sub, window, scale, n_split, stream);
    case 256: return dispatch_g<T, 256>(G, q, kc, vc, pos, o, m_part, l_part, acc_part, B, S, KH, n_sub, window, scale, n_split, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, 1, H, hd); k_cache, v_cache: (B, S, KH, hd); pos: (B,) int32;
// a block scores `group_block` of the H/KH query heads of a KV head;
// m_part, l_part: (B*H/group_block, n_split*4, group_block) f32;
// acc_part: (..., group_block, hd) f32.
REPRO_EXPORT int decode_attention_fwd(const void* q, const void* kc,
                                      const void* vc, const void* pos,
                                      void* o, void* m_part, void* l_part,
                                      void* acc_part, int B, int S, int H,
                                      int KH, int hd, int window,
                                      float scale, int n_split,
                                      int group_block, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || n_split <= 0
      || group_block <= 0 || (H / KH) % group_block != 0)
    return cudaErrorInvalidValue;
  const int n_sub = H / KH / group_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  if (dtype == kF32)
    return dispatch<float>(hd, group_block, q, kc, vc, p, o, mp, lp, ap, B,
                           S, KH, n_sub, window, scale, n_split, s);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(hd, group_block, q, kc, vc, p, o, mp, lp,
                                   ap, B, S, KH, n_sub, window, scale,
                                   n_split, s);
  return cudaErrorInvalidValue;
}
