// Exact top-k of product-quantised (ADC) scores, batched over queries, on
// Hopper.
//
// Replaces: src/repro/kernels/pq_scoring/pq_scoring.py::pq_topk_pallas,
// the TPU kernel that streams [512, m] uint8 code tiles through VMEM, turns
// each subspace's lookup into a one-hot [512, n_codes] matmul against the
// query's table row on the MXU, adds the per-row base (NEG = -3e38 masks a
// padded row) and merges the tile into a running [k] scratch across its
// sequential grid, finishing with lexsort((idx, -val)).  A one-hot matmul
// is the TPU's way to gather; here a thread reads the table from shared
// memory directly.  In two stages, as dense_topk.cu:
//
//   1. A block owns one segment of one query's candidate rows.  It loads
//      the query's table [m, n_codes] (16 KB at m = 16) into shared memory,
//      scores its rows into shared memory, score = table[0][c_0] + ... +
//      table[m-1][c_{m-1}], then + base, added in exactly that order (the
//      plain version's, so the two agree bit for bit), and takes the
//      segment's top-k with repro::block_topk_row.
//   2. repro::launch_topk_merge (topk.cu) merges each query's candidate
//      lists.
//
// Bound on this card: reading the codes and the base once, (m + 4) bytes a
// row: 20 bytes at m = 16, a row's codes in one 16-byte load.  ADC ties are
// expected (documents that share a code word score alike), and the lax.top_k
// rule of block_topk_row (ties to the lowest index) decides them.
//
// Contract: codes [nq, n, m] uint8, each code < n_codes; table
// [nq, m, n_codes] f32; base [nq, n] or null; values sorted descending,
// ties to the lowest index, 1 <= k <= 128, k <= n <= INT_MAX.  The wrapper
// (kernels/pq_scoring/ops.py) plans the segments and allocates the
// candidate scratch.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "topk_block.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int64_t MAX_DYN_SMEM = 200 * 1024;

// grid (n_seg, nq).  Dynamic shared memory: the query's table
// [m, n_codes], then the segment's scores [seg_len].
template <bool VEC16>
__global__ void __launch_bounds__(THREADS)
pq_segments_kernel(const uint8_t* __restrict__ codes,
                   const float* __restrict__ table,
                   const float* __restrict__ base, int64_t n, int m,
                   int n_codes, int64_t seg_len, int k,
                   float* __restrict__ out_vals, int* __restrict__ out_idxs,
                   int64_t out_qstride) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ repro::TopKSmem<THREADS> sm;
  const int tid = threadIdx.x;
  const int64_t s = blockIdx.x;
  const int64_t qi = blockIdx.y;
  const int64_t lo = s * seg_len;
  const int64_t len = n - lo < seg_len ? n - lo : seg_len;
  const int tab_len = m * n_codes;
  float* tab = dyn;
  float* scores = dyn + tab_len;

  for (int i = tid; i < tab_len; i += THREADS)
    tab[i] = table[qi * tab_len + i];
  __syncthreads();

  const uint8_t* rows = codes + (qi * n + lo) * m;
  for (int64_t r = tid; r < len; r += THREADS) {
    const uint8_t* row = rows + r * m;
    float acc = 0.0f;
    if constexpr (VEC16) {
      for (int j = 0; j < m; j += 16) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + j));
        const unsigned int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const int sub = j + b;
          const float t =
              tab[sub * n_codes + ((words[b >> 2] >> (8 * (b & 3))) & 255u)];
          acc = sub == 0 ? t : acc + t;
        }
      }
    } else {
      acc = tab[row[0]];
      for (int sub = 1; sub < m; ++sub) acc = acc + tab[sub * n_codes + row[sub]];
    }
    if (base != nullptr) acc = acc + base[qi * n + lo + r];
    scores[r] = acc;
  }
  __syncthreads();

  const int64_t out = qi * out_qstride + s * k;
  repro::segment_topk<THREADS>(scores, len, k, lo, out_vals + out,
                               out_idxs + out, sm);
}

}  // namespace

// codes [nq, n, m] uint8, table [nq, m, n_codes], base [nq, n] or null ->
// vals/idxs [nq, k].  n_seg > 1 needs cand_vals and cand_idxs of
// nq * n_seg * k elements each.
extern "C" int repro_pq_topk(const uint8_t* codes, const float* table,
                             const float* base, int64_t nq, int64_t n, int m,
                             int n_codes, int k, int n_seg, int64_t seg_len,
                             float* cand_vals, int* cand_idxs, float* vals,
                             int* idxs, void* stream) {
  if (k < 1 || k > repro::TOPK_MAX_K || n < k || n > INT_MAX || nq < 1 ||
      nq > 65535 || m < 1 || n_codes < 1 || n_codes > 256 || n_seg < 1 ||
      seg_len < 1 || (int64_t)(n_seg - 1) * seg_len >= n ||
      (int64_t)n_seg * seg_len < n || (n_seg > 1 && seg_len < k))
    return (int)cudaErrorInvalidValue;
  const int64_t smem = ((int64_t)m * n_codes + seg_len) * 4;
  if (smem > MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  const bool vec16 = m % 16 == 0 && ((uintptr_t)codes & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  float* ov = n_seg == 1 ? vals : cand_vals;
  int* oi = n_seg == 1 ? idxs : cand_idxs;
  const int64_t out_qstride = (int64_t)n_seg * k;
  const dim3 grid((unsigned int)n_seg, (unsigned int)nq);
  cudaError_t err;
  if (vec16) {
    err = cudaFuncSetAttribute(pq_segments_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    pq_segments_kernel<true><<<grid, THREADS, (size_t)smem, st>>>(
        codes, table, base, n, m, n_codes, seg_len, k, ov, oi, out_qstride);
  } else {
    err = cudaFuncSetAttribute(pq_segments_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    pq_segments_kernel<false><<<grid, THREADS, (size_t)smem, st>>>(
        codes, table, base, n, m, n_codes, seg_len, k, ov, oi, out_qstride);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || n_seg == 1) return (int)err;
  return (int)repro::launch_topk_merge(cand_vals, cand_idxs, nq,
                                      (int64_t)n_seg * k, k, vals, idxs, st);
}
