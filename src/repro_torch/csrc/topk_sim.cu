// Block-max similarity scan for Hopper (sm_90a): phase 1 of the exact
// cosine top-k of VectorIndex.topk (paper Query 3, step 2).
//
// Replaces repro/kernels/topk_sim/kernel.py: block_max_scores
// (_blockmax_kernel).  Same function: for every query and every block of
// block_n consecutive corpus rows, the largest dot product q . c of the
// block; rows past N never count, so the last block's max is over its real
// rows.  Output (Q, ceil(N / block_n)) f32.  Phase 2 (top-k blocks, gather,
// exact rescore, duplicate mask, top-k) stays plain PyTorch in ops.py, as
// the JAX package leaves it to XLA.
//
// What bounds it on this card: one streaming read of the f32 corpus.  At
// the Query 3 shape (N=100,000 passages, D=2048, Q=8) that is 819 MB, or
// 245 us at 3.35 TB/s; the 3.3 GFLOP of products take 49 us on the f32
// CUDA cores.
//
// Design: a tile of 8 queries (64 KB at D=2048) is staged once per block
// in shared memory; the grid's y axis walks query tiles, its x axis
// ranges of corpus blocks, a few blocks each so the query tile load is
// amortised.  A warp scores 4 corpus rows at a time: lanes stream the rows
// with coalesced 16-byte loads and each shared-memory query value feeds 4
// FMAs; warp sums give the 32 scores, each warp keeps the running max per
// query, and the 8 warps' maxima are merged through shared memory.  No
// (Q, N) score matrix is written.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kWarps = 8;
constexpr int kQT = 8;    // queries per block
constexpr int kRows = 4;  // corpus rows a warp scores at once

template <int VEC>
__global__ void __launch_bounds__(kWarps * 32)
block_max_kernel(const float* __restrict__ corpus,
                 const float* __restrict__ queries, float* __restrict__ out,
                 int N, int D, int Q, int block_n, int n_blocks,
                 int blocks_per_cta) {
  extern __shared__ float smem[];
  float* qs = smem;              // [kQT][D]
  float* red = qs + kQT * D;     // [kWarps][kQT]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qbase = blockIdx.y * kQT;
  const int nq = min(kQT, Q - qbase);

  for (int i = tid; i < kQT * D; i += kWarps * 32) {
    const int j = i / D;
    qs[i] = j < nq ? queries[(size_t)(qbase + j) * D + (i % D)] : 0.f;
  }
  __syncthreads();

  const int cb0 = blockIdx.x * blocks_per_cta;
  const int cb1 = min(n_blocks, cb0 + blocks_per_cta);
  for (int cb = cb0; cb < cb1; ++cb) {
    const int row0 = cb * block_n;
    float best[kQT];
#pragma unroll
    for (int j = 0; j < kQT; ++j) best[j] = -INFINITY;

    for (int r = warp * kRows; r < block_n; r += kWarps * kRows) {
      bool valid[kRows];
      const float* crow[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int rr = row0 + r + i;
        valid[i] = r + i < block_n && rr < N;
        crow[i] = corpus + (size_t)(valid[i] ? rr : 0) * D;
      }
      float s[kRows][kQT];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kQT; ++j) s[i][j] = 0.f;

      for (int d = lane * VEC; d < D; d += 32 * VEC) {
        float c[kRows][VEC];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (valid[i]) {
            load_f32<float, VEC>(crow[i] + d, c[i]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) c[i][e] = 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < kQT; ++j) {
          float qv[VEC];
          load_f32<float, VEC>(qs + j * D + d, qv);
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e) s[i][j] = fmaf(c[i][e], qv[e], s[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kQT; ++j) {
          const float t = warp_sum(s[i][j]);
          if (valid[i]) best[j] = fmaxf(best[j], t);
        }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kQT; ++j) red[warp * kQT + j] = best[j];
    }
    __syncthreads();
    if (tid < nq) {
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[w * kQT + tid]);
      out[(size_t)(qbase + tid) * n_blocks + cb] = mx;
    }
    __syncthreads();
  }
}

template <int VEC>
cudaError_t launch(const float* corpus, const float* queries, float* out,
                   int N, int D, int Q, int block_n, int blocks_per_cta,
                   cudaStream_t stream) {
  const int n_blocks = (N + block_n - 1) / block_n;
  const int smem = (kQT * D + kWarps * kQT) * 4;
  auto kernel = block_max_kernel<VEC>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_blocks + blocks_per_cta - 1) / blocks_per_cta,
                  (Q + kQT - 1) / kQT);
  kernel<<<grid, kWarps * 32, smem, stream>>>(corpus, queries, out, N, D, Q,
                                              block_n, n_blocks,
                                              blocks_per_cta);
  return cudaGetLastError();
}

}  // namespace

// corpus: (N, D) f32; queries: (Q, D) f32; out: (Q, ceil(N / block_n)) f32.
REPRO_EXPORT int block_max_scores_fwd(const void* corpus, const void* queries,
                                      void* out, int N, int D, int Q,
                                      int block_n, int blocks_per_cta,
                                      void* stream) {
  if (N <= 0 || D <= 0 || Q <= 0 || block_n <= 0 || blocks_per_cta <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(corpus);
  const float* qp = static_cast<const float*>(queries);
  float* o = static_cast<float*>(out);
  if (D % 4 == 0)
    return launch<4>(c, qp, o, N, D, Q, block_n, blocks_per_cta, s);
  return launch<1>(c, qp, o, N, D, Q, block_n, blocks_per_cta, s);
}
