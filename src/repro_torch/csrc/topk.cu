// Exact top-k of batched score rows on Hopper.
//
// Replaces: src/repro/kernels/topk/topk.py::streaming_topk_pallas, the
// TPU kernel that streams one score vector through VMEM in 4096-wide
// blocks and merges each block into a running [k] scratch (block-max skip,
// k rounds of argmax/argmin).  That design leans on the TPU's sequential
// grid; here the blocks of a grid run in parallel and in no order, so the
// kernel computes the function instead.
//
// Bound on this card: reading the scores once, NQ * N * 4 bytes (16 x
// 528,155 f32 = 33.8 MB on the RQ1 path, about 10 us at 3.35 TB/s).
// A chunk holds only 16 rows, so one block per row would leave 116 of the
// 132 SMs idle and each SM latency-bound on its 2 MB row.  The design cuts
// every row into segments, one wave of two 512-thread blocks an SM (16
// segments a row at RQ1's shape), and takes the top-k in two stages:
//
//   1. Each segment is read once, by the warp select of topk_block.cuh:
//      each warp streams its 32-wide tiles, two batches of eight loads a
//      lane in flight, holds each batch against the bar its block shares
//      and does more only where an element reaches it; the block's 16 warp
//      queues (32, 64 or 128 keys, by k) then merge in shared memory.
//   2. repro::launch_topk_merge merges each row's candidate lists with the
//      same select.  It is exported for the dense-scoring kernel, which
//      merges its segments the same way.
//
// Contract: values sorted descending, -0.0 below +0.0, ties to the lowest
// index (the lax.top_k rule of the reference), 1 <= k <= 128 and k <= N.
// The wrapper plans the segments (kernels/segments.py; only the last may
// hold fewer than k, and repro::segment_topk pads its list) and allocates
// the candidate scratch.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "topk_block.cuh"
#include "launch_count.cuh"

REPRO_LAUNCH_COUNTER(repro_launches_topk)

namespace {

constexpr int THREADS = 512;
constexpr int MERGE_THREADS = 256;

// k <= 32: two blocks an SM, at most 64 registers a thread; a larger warp
// queue gets one block an SM
template <int WQ>
__global__ void __launch_bounds__(THREADS, WQ == 1 ? 2 : 1)
topk_segments_kernel(const float* __restrict__ scores, int64_t n,
                     int64_t row_stride, int64_t seg_len, int k,
                     float* __restrict__ out_vals,
                     int* __restrict__ out_idxs) {
  count_launch();
  __shared__ repro::TopKSmem<THREADS, WQ> sm;
  const int64_t q = blockIdx.y;
  const int64_t s = blockIdx.x;
  const int64_t lo = s * seg_len;
  const int64_t len = n - lo < seg_len ? n - lo : seg_len;
  const int64_t out = (q * gridDim.x + s) * k;
  repro::segment_topk<THREADS, WQ, true>(scores + q * row_stride + lo, len,
                                         k, lo, out_vals + out,
                                         out_idxs + out, sm);
}

template <int WQ>
__global__ void __launch_bounds__(MERGE_THREADS)
topk_merge_kernel(const float* __restrict__ cand_vals,
                  const int* __restrict__ cand_idxs, int64_t m, int k,
                  float* __restrict__ vals, int* __restrict__ idxs) {
  __shared__ repro::TopKSmem<MERGE_THREADS, WQ> sm;
  const int64_t q = blockIdx.x;
  const float* cv = cand_vals + q * m;
  const int* ci = cand_idxs + q * m;
  // a candidate's index does not grow with its position
  repro::block_warp_topk<MERGE_THREADS, false>(
      m, k, [=](int64_t i) { return __ldg(cv + i); },
      [=](int64_t i) { return __ldg(ci + i); }, vals + q * k, idxs + q * k,
      sm);
}

template <int WQ>
void launch_segments(const float* scores, int64_t nq, int64_t n,
                     int64_t row_stride, int k, int n_seg, int64_t seg_len,
                     float* ov, int* oi, cudaStream_t st) {
  topk_segments_kernel<WQ><<<dim3((unsigned int)n_seg, (unsigned int)nq),
                             THREADS, 0, st>>>(scores, n, row_stride, seg_len,
                                               k, ov, oi);
}

template <int WQ>
void launch_merge(const float* cand_vals, const int* cand_idxs, int64_t nq,
                  int64_t m, int k, float* vals, int* idxs, cudaStream_t st) {
  topk_merge_kernel<WQ><<<(unsigned int)nq, MERGE_THREADS, 0, st>>>(
      cand_vals, cand_idxs, m, k, vals, idxs);
}

}  // namespace

cudaError_t repro::launch_topk_merge(const float* cand_vals,
                                     const int* cand_idxs, int64_t nq,
                                     int64_t m, int k, float* vals, int* idxs,
                                     cudaStream_t stream) {
  if (k < 1 || k > repro::TOPK_MAX_K || m < k || m > INT_MAX || nq < 1 ||
      nq > INT_MAX)
    return cudaErrorInvalidValue;
  switch (repro::warp_slots(k)) {
    case 1: launch_merge<1>(cand_vals, cand_idxs, nq, m, k, vals, idxs,
                            stream); break;
    case 2: launch_merge<2>(cand_vals, cand_idxs, nq, m, k, vals, idxs,
                            stream); break;
    default: launch_merge<4>(cand_vals, cand_idxs, nq, m, k, vals, idxs,
                             stream);
  }
  return cudaGetLastError();
}

// scores [nq, n] (rows row_stride floats apart) -> vals/idxs [nq, k], in
// n_seg segments of seg_len.
// n_seg > 1 needs cand_vals and cand_idxs of nq * n_seg * k elements each.
extern "C" int repro_topk_f32(const float* scores, int64_t nq, int64_t n,
                              int64_t row_stride, int k, int n_seg,
                              int64_t seg_len,
                              float* cand_vals, int* cand_idxs, float* vals,
                              int* idxs, void* stream) {
  if (k < 1 || k > repro::TOPK_MAX_K || n < k || n > INT_MAX || nq < 1 ||
      nq > 65535 || row_stride < n || n_seg < 1 || seg_len < 1 ||
      (int64_t)(n_seg - 1) * seg_len >= n || (int64_t)n_seg * seg_len < n ||
      (n_seg > 1 && seg_len < k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* ov = n_seg == 1 ? vals : cand_vals;
  int* oi = n_seg == 1 ? idxs : cand_idxs;
  switch (repro::warp_slots(k)) {
    case 1: launch_segments<1>(scores, nq, n, row_stride, k, n_seg, seg_len,
                               ov, oi, st); break;
    case 2: launch_segments<2>(scores, nq, n, row_stride, k, n_seg, seg_len,
                               ov, oi, st); break;
    default: launch_segments<4>(scores, nq, n, row_stride, k, n_seg, seg_len,
                                ov, oi, st);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_seg == 1) return (int)err;
  return (int)repro::launch_topk_merge(cand_vals, cand_idxs, nq,
                                      (int64_t)n_seg * k, k, vals, idxs, st);
}
