// Exact top-k of dense scores emb @ q + base, batched over queries, on
// Hopper.
//
// Replaces: src/repro/kernels/dense_scoring/dense_scoring.py::
// dense_topk_pallas, the TPU kernel that streams [1024, dim] embedding
// tiles through VMEM, scores each tile on the MXU, adds the per-row base
// (the sparse score of a fused rerank; NEG = -3e38 masks a padded row) and
// merges the tile into a running [k] scratch across its sequential grid,
// skipping tiles whose best score cannot enter.  Hopper's blocks run in
// parallel and in no order, so the kernel computes the function instead,
// in two stages:
//
//   1. A block owns one segment of rows.  It scores the segment for a
//      group of queries into shared memory (a thread per row, fp32 dot
//      products in the kernel's own body, summed over d = 0..dim-1, then
//      + base) and takes each query's top-k of the segment with
//      repro::block_topk_row (topk_block.cuh), into a candidate list.
//   2. repro::launch_topk_merge (topk.cu) merges each query's candidate
//      lists, as the top-k kernel merges its segments.
//
// The embeddings are either shared by the queries (query stride 0: brute
// force over the whole store) or the query's own gathered rows (IVF
// candidates, a rerank's candidates).  Shared rows are scored for a group
// of up to 8 queries by one block, the groups of a segment in adjacent
// blocks, so a chunk of 16 queries reads the store from HBM about once and
// not 16 times; gathered rows are a group of one.
//
// Bound on this card: reading the embeddings once.  Brute force over the
// Robust04-scale store, [528155, 64] f32 for 16 queries: 135.2 MB, 40 us at
// 3.35 TB/s, against 1.08 GFLOP of dot products (16 us at 67 TFLOP/s).  A
// thread reads its row with 16-byte loads; the top-k passes of stage 1 run
// on shared memory.  The build's --fmad=false applies here too: the dot
// product is a multiply and an add per term.
//
// Contract: values sorted descending, ties to the lowest index (the
// lax.top_k rule), 1 <= k <= 128, k <= n <= INT_MAX.  The wrapper
// (kernels/dense_scoring/ops.py) plans the segments and allocates the
// candidate scratch.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "topk_block.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int MAX_GROUP = 8;
// dynamic shared memory a block may ask for (the card allows 227 KB less
// the block's static TopKSmem)
constexpr int64_t MAX_DYN_SMEM = 200 * 1024;

// A 1-D grid of n_seg * n_groups blocks, the groups of one segment
// adjacent (so a segment of shared rows is read from HBM once and then
// from L2).  G bounds the group (1, 4 or 8).  Dynamic shared memory: the
// group's query vectors [group, dim], then its scores [group, seg_len].
template <bool VEC4, int G>
__global__ void __launch_bounds__(THREADS)
dense_segments_kernel(const float* __restrict__ emb, int64_t emb_qstride,
                      const float* __restrict__ q,
                      const float* __restrict__ base, int64_t nq, int64_t n,
                      int dim, int64_t seg_len, int group, int64_t n_groups,
                      int k, float* __restrict__ out_vals,
                      int* __restrict__ out_idxs, int64_t out_qstride) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ repro::TopKSmem<THREADS> sm;
  const int tid = threadIdx.x;
  const int64_t s = (int64_t)blockIdx.x / n_groups;
  const int64_t q0 = ((int64_t)blockIdx.x % n_groups) * group;
  const int g_n = nq - q0 < group ? (int)(nq - q0) : group;
  const int64_t lo = s * seg_len;
  const int64_t len = n - lo < seg_len ? n - lo : seg_len;
  float* qs = dyn;
  float* scores = dyn + (int64_t)group * dim;

  for (int i = tid; i < g_n * dim; i += THREADS) qs[i] = q[q0 * dim + i];
  __syncthreads();

  // a group of more than one query shares its rows (emb_qstride == 0)
  const float* rows = emb + q0 * emb_qstride + lo * dim;
  for (int64_t r = tid; r < len; r += THREADS) {
    const float* row = rows + r * dim;
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0f;
    if constexpr (VEC4) {
      for (int d = 0; d < dim; d += 4) {
        const float4 e = __ldg(reinterpret_cast<const float4*>(row + d));
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < g_n) {
            const float4 v = *reinterpret_cast<const float4*>(qs + g * dim + d);
            float a = acc[g];
            a = a + e.x * v.x;
            a = a + e.y * v.y;
            a = a + e.z * v.z;
            a = a + e.w * v.w;
            acc[g] = a;
          }
        }
      }
    } else {
      for (int d = 0; d < dim; ++d) {
        const float e = __ldg(row + d);
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (g < g_n) acc[g] = acc[g] + e * qs[g * dim + d];
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < g_n) {
        float v = acc[g];
        if (base != nullptr) v = v + base[(q0 + g) * n + lo + r];
        scores[(int64_t)g * seg_len + r] = v;
      }
    }
  }
  __syncthreads();

  for (int g = 0; g < g_n; ++g) {
    const int64_t out = (q0 + g) * out_qstride + s * k;
    repro::segment_topk<THREADS>(scores + (int64_t)g * seg_len, len, k, lo,
                                 out_vals + out, out_idxs + out, sm);
  }
}

template <bool VEC4, int G>
cudaError_t launch_segments(int64_t blocks, int64_t smem, cudaStream_t st,
                            const float* emb, int64_t emb_qstride,
                            const float* q, const float* base, int64_t nq,
                            int64_t n, int dim, int64_t seg_len, int group,
                            int64_t n_groups, int k, float* ov, int* oi,
                            int64_t out_qstride) {
  const cudaError_t err = cudaFuncSetAttribute(
      dense_segments_kernel<VEC4, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dense_segments_kernel<VEC4, G><<<(unsigned int)blocks, THREADS,
                                   (size_t)smem, st>>>(
      emb, emb_qstride, q, base, nq, n, dim, seg_len, group, n_groups, k, ov,
      oi, out_qstride);
  return cudaGetLastError();
}

template <bool VEC4>
cudaError_t launch_segments(int64_t blocks, int64_t smem, cudaStream_t st,
                            const float* emb, int64_t emb_qstride,
                            const float* q, const float* base, int64_t nq,
                            int64_t n, int dim, int64_t seg_len, int group,
                            int64_t n_groups, int k, float* ov, int* oi,
                            int64_t out_qstride) {
  if (group == 1)
    return launch_segments<VEC4, 1>(blocks, smem, st, emb, emb_qstride, q,
                                    base, nq, n, dim, seg_len, group,
                                    n_groups, k, ov, oi, out_qstride);
  if (group <= 4)
    return launch_segments<VEC4, 4>(blocks, smem, st, emb, emb_qstride, q,
                                    base, nq, n, dim, seg_len, group,
                                    n_groups, k, ov, oi, out_qstride);
  return launch_segments<VEC4, MAX_GROUP>(blocks, smem, st, emb, emb_qstride,
                                          q, base, nq, n, dim, seg_len, group,
                                          n_groups, k, ov, oi, out_qstride);
}

}  // namespace

// emb [n, dim] (emb_qstride 0) or [nq, n, dim] (emb_qstride n * dim, group
// 1); q [nq, dim]; base [nq, n] or null -> vals/idxs [nq, k].  n_seg > 1
// needs cand_vals and cand_idxs of nq * n_seg * k elements each.
extern "C" int repro_dense_topk(const float* emb, int64_t emb_qstride,
                                const float* q, const float* base, int64_t nq,
                                int64_t n, int dim, int k, int group,
                                int n_seg, int64_t seg_len, float* cand_vals,
                                int* cand_idxs, float* vals, int* idxs,
                                void* stream) {
  if (k < 1 || k > repro::TOPK_MAX_K || n < k || n > INT_MAX || nq < 1 ||
      dim < 1 || group < 1 || group > MAX_GROUP ||
      (emb_qstride != 0 && group != 1) || n_seg < 1 || seg_len < 1 ||
      (int64_t)(n_seg - 1) * seg_len >= n || (int64_t)n_seg * seg_len < n ||
      (n_seg > 1 && seg_len < k))
    return (int)cudaErrorInvalidValue;
  const int64_t n_groups = (nq + group - 1) / group;
  const int64_t blocks = n_groups * n_seg;
  const int64_t smem = ((int64_t)group * dim + (int64_t)group * seg_len) * 4;
  if (blocks > INT_MAX || smem > MAX_DYN_SMEM)
    return (int)cudaErrorInvalidValue;
  const bool vec4 = dim % 4 == 0 && ((uintptr_t)emb & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  float* ov = n_seg == 1 ? vals : cand_vals;
  int* oi = n_seg == 1 ? idxs : cand_idxs;
  const int64_t out_qstride = (int64_t)n_seg * k;
  const cudaError_t err =
      vec4 ? launch_segments<true>(blocks, smem, st, emb, emb_qstride, q,
                                   base, nq, n, dim, seg_len, group, n_groups,
                                   k, ov, oi, out_qstride)
           : launch_segments<false>(blocks, smem, st, emb, emb_qstride, q,
                                    base, nq, n, dim, seg_len, group,
                                    n_groups, k, ov, oi, out_qstride);
  if (err != cudaSuccess || n_seg == 1) return (int)err;
  return (int)repro::launch_topk_merge(cand_vals, cand_idxs, nq,
                                      (int64_t)n_seg * k, k, vals, idxs, st);
}
