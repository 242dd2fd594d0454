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
//   1. A block owns one segment of rows and a group of queries.  It scores
//      the segment tile by tile for the group into shared memory (a thread
//      per row and query group, fp32 dot products in the kernel's own
//      body, summed over d = 0..dim-1, then + base).  The block's warps
//      split the group's score rows after each tile (16 / G warps a query)
//      and feed them to the warp select of topk_block.cuh; a warp's queue
//      waits in shared memory between tiles, so a segment may be any
//      length, and the wrapper plans one wave of blocks.  The warp queues
//      of a query then merge in shared memory into its candidate list.
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
// 3.35 TB/s, against 1.08 GFLOP of dot products (16 us at 67 TFLOP/s, 32 us
// as the separate multiplies and adds that --fmad=false makes of them).
// What holds the kernel back is the read: a thread owns a row so that its
// sum runs in order, and a warp's 16-byte loads touch 32 rows 256 bytes
// apart.  Shared rows are read a 32-byte sector a row at a time from
// global memory, two blocks an SM; gathered rows (a group of one, whose
// few blocks leave the card idle) go through shared memory with cp.async,
// whole lines at a time.
//
// Contract: values sorted descending, -0.0 below +0.0, ties to the lowest
// index (the lax.top_k rule), 1 <= k <= 128, k <= n <= INT_MAX.  The wrapper
// (kernels/dense_scoring/ops.py) plans the segments and their tiles and
// allocates the candidate scratch.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "topk_block.cuh"
#include "launch_count.cuh"

REPRO_LAUNCH_COUNTER(repro_launches_dense_topk)

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUP = 8;
// the seeding of the warp select reads the whole first tile
constexpr int SEED_BATCHES = 1 << 20;
// shared memory a block may hold, its static TopKSmem included
constexpr int64_t MAX_SMEM = 227 * 1024;
// The staged scoring reads rows through shared memory: each warp copies a
// group of 32 rows, STAGE_F4 16-byte pieces (32 dims) of each at a time,
// with cp.async into one of its two slabs (rows of STAGE_F4 + 1 pieces, so
// that the lanes reading their rows hit distinct banks), whole 128-byte
// lines at a time, while it scores the other slab.
constexpr int STAGE_F4 = 8;
constexpr int SLAB_ROW = STAGE_F4 + 1;
constexpr int SLAB_F4 = 32 * SLAB_ROW;
constexpr int64_t SLAB_BYTES = (int64_t)WARPS * 2 * SLAB_F4 * 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int dst = (unsigned int)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc + e . v, multiplied and added term by term in the order x, y, z, w
__device__ __forceinline__ float dot4(float acc, float4 e, float4 v) {
  acc = acc + e.x * v.x;
  acc = acc + e.y * v.y;
  acc = acc + e.z * v.z;
  acc = acc + e.w * v.w;
  return acc;
}

__device__ __host__ __forceinline__ int64_t round_up4(int64_t x) {
  return (x + 3) & ~(int64_t)3;
}

// The scores of a tile's rows [0, t_len) (rows: its first row, dim floats
// each) for the group's g_n queries (qs [g_n, dim]) into
// scores[g * tile + r], + base[g * n + r] when base is given: each row by
// one thread, two rows a thread (r and r + THREADS), so that a query
// vector read from shared memory serves two rows.
template <bool VEC4, int G>
__device__ __forceinline__ void score_tile_direct(
    const float* __restrict__ rows, int64_t t_len, int dim,
    const float* qs, int g_n, const float* __restrict__ base, int64_t n,
    float* scores, int64_t tile) {
  for (int64_t r = threadIdx.x; r < t_len; r += 2 * THREADS) {
    const bool two = r + THREADS < t_len;
    const float* row0 = rows + r * dim;
    const float* row1 = two ? row0 + (int64_t)THREADS * dim : row0;
    float acc0[G], acc1[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc0[g] = acc1[g] = 0.0f;
    if constexpr (VEC4) {
      // a whole 32-byte sector of each row a step (two 16-byte loads), so
      // that no sector is fetched for half of it
      int d = 0;
      for (; d + 8 <= dim; d += 8) {
        const float4 a0 = __ldg(reinterpret_cast<const float4*>(row0 + d));
        const float4 a1 = __ldg(reinterpret_cast<const float4*>(row0 + d + 4));
        const float4 b0 = __ldg(reinterpret_cast<const float4*>(row1 + d));
        const float4 b1 = __ldg(reinterpret_cast<const float4*>(row1 + d + 4));
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < g_n) {
            const float4* v = reinterpret_cast<const float4*>(qs + g * dim + d);
            acc0[g] = dot4(dot4(acc0[g], a0, v[0]), a1, v[1]);
            acc1[g] = dot4(dot4(acc1[g], b0, v[0]), b1, v[1]);
          }
        }
      }
      for (; d < dim; d += 4) {
        const float4 a0 = __ldg(reinterpret_cast<const float4*>(row0 + d));
        const float4 b0 = __ldg(reinterpret_cast<const float4*>(row1 + d));
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < g_n) {
            const float4 v =
                *reinterpret_cast<const float4*>(qs + g * dim + d);
            acc0[g] = dot4(acc0[g], a0, v);
            acc1[g] = dot4(acc1[g], b0, v);
          }
        }
      }
    } else {
      for (int d = 0; d < dim; ++d) {
        const float e0 = __ldg(row0 + d);
        const float e1 = __ldg(row1 + d);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < g_n) {
            const float v = qs[g * dim + d];
            acc0[g] = acc0[g] + e0 * v;
            acc1[g] = acc1[g] + e1 * v;
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < g_n) {
        float v0 = acc0[g], v1 = acc1[g];
        if (base != nullptr) {
          v0 = v0 + base[g * n + r];
          if (two) v1 = v1 + base[g * n + r + THREADS];
        }
        scores[(int64_t)g * tile + r] = v0;
        if (two) scores[(int64_t)g * tile + r + THREADS] = v1;
      }
    }
  }
}

// The same scores (dim a multiple of 4, rows 16-byte aligned), with the
// rows read through the warp's slabs: warp w scores the 32-row groups w,
// w + WARPS, ..., lane l its row l of each; a group's rows go through in
// stages of STAGE_F4 pieces, the next stage's copies issued before the
// current one is scored.  Each score's sum still runs d = 0..dim-1.
template <int G>
__device__ __forceinline__ void score_tile_staged(
    const float* __restrict__ rows, int64_t t_len, int dim,
    const float* qs, int g_n, const float* __restrict__ base, int64_t n,
    float* scores, int64_t tile, float4* slabs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_f4 = dim / 4;
  const int n_stages = (n_f4 + STAGE_F4 - 1) / STAGE_F4;
  const int64_t n_rg = (t_len + 31) / 32;
  const int64_t my_rg = n_rg > warp ? (n_rg - warp + WARPS - 1) / WARPS : 0;
  const int64_t n_items = my_rg * n_stages;
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  // item it: row group warp + (it / n_stages) * WARPS, stage it % n_stages
  const auto issue = [&](int64_t it) {
    const int64_t r0 = (warp + (it / n_stages) * WARPS) * 32;
    const int f0 = (int)(it % n_stages) * STAGE_F4;
    float4* slab = slabs + (it & 1) * SLAB_F4;
#pragma unroll
    for (int j = lane; j < 32 * STAGE_F4; j += 32) {
      const int rr = j / STAGE_F4;
      const int c = j % STAGE_F4;
      if (f0 + c < n_f4 && r0 + rr < t_len)
        cp_async16(slab + rr * SLAB_ROW + c,
                   rows + (r0 + rr) * dim + (f0 + c) * 4);
    }
  };
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;
  if (n_items > 0) issue(0);
  cp_async_commit();
  for (int64_t it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int st = (int)(it % n_stages);
    const int f0 = st * STAGE_F4;
    const float4* mine = slabs + (it & 1) * SLAB_F4 + lane * SLAB_ROW;
#pragma unroll
    for (int c = 0; c < STAGE_F4; ++c) {
      if (f0 + c < n_f4) {
        const float4 e = mine[c];
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (g < g_n) acc[g] = dot4(acc[g], e, q4[g * n_f4 + f0 + c]);
      }
    }
    __syncwarp();  // the slab is refilled two items on
    if (st == n_stages - 1) {
      const int64_t r = (warp + (it / n_stages) * WARPS) * 32 + lane;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < g_n && r < t_len) {
          float v = acc[g];
          if (base != nullptr) v = v + base[g * n + r];
          scores[(int64_t)g * tile + r] = v;
        }
        acc[g] = 0.0f;
      }
    }
  }
  cp_async_wait<0>();
}

// A 1-D grid of n_seg * n_groups blocks, the groups of one segment
// adjacent (so a segment of shared rows is read from HBM once and then
// from L2).  G bounds the group (1, 4 or 8); WQ is the warp queue's slots
// a lane (warp_slots(k)).  Dynamic shared memory: the group's query
// vectors [group, dim], its scores [group, tile], and for 16-byte gathered
// rows the warps' slabs.  Groups of more than one query run two blocks an
// SM (at most 64 registers a thread) for k <= 32; a group of one, whose
// slabs and scores take 210 KB, and a larger warp queue, one.
template <bool VEC4, int G, int WQ>
__global__ void __launch_bounds__(THREADS, G == 1 || WQ > 1 ? 1 : 2)
dense_segments_kernel(const float* __restrict__ emb, int64_t emb_qstride,
                      const float* __restrict__ q,
                      const float* __restrict__ base, int64_t nq, int64_t n,
                      int dim, int64_t seg_len, int64_t tile, int group,
                      int64_t n_groups, int k, float* __restrict__ out_vals,
                      int* __restrict__ out_idxs, int64_t out_qstride) {
  count_launch();
  extern __shared__ __align__(16) float dyn[];
  __shared__ repro::TopKSmem<THREADS, WQ> sm;
  // warps a query in the warp select, and this warp's query and part
  constexpr int RUN = WARPS / G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int my_g = warp / RUN;
  const int part = warp % RUN;
  const int64_t s = (int64_t)blockIdx.x / n_groups;
  const int64_t q0 = ((int64_t)blockIdx.x % n_groups) * group;
  const int g_n = nq - q0 < group ? (int)(nq - q0) : group;
  const int64_t lo = s * seg_len;
  const int64_t len = n - lo < seg_len ? n - lo : seg_len;
  float* qs = dyn;
  float* scores = dyn + (int64_t)group * dim;
  float4* slabs =
      reinterpret_cast<float4*>(scores + round_up4((int64_t)group * tile)) +
      (int64_t)warp * 2 * SLAB_F4;

  for (int i = tid; i < g_n * dim; i += THREADS) qs[i] = q[q0 * dim + i];
  if (tid < WARPS) sm.run_bar[tid] = repro::PAD_KEY;
  __syncthreads();

  // a group of more than one query shares its rows (emb_qstride == 0)
  const float* rows = emb + q0 * emb_qstride + lo * dim;
  for (int64_t t0 = 0; t0 < len; t0 += tile) {
    const int64_t t_len = len - t0 < tile ? len - t0 : tile;
    const float* t_base = base == nullptr ? nullptr : base + q0 * n + lo + t0;
    if constexpr (VEC4 && G == 1) {
      score_tile_staged<G>(rows + t0 * dim, t_len, dim, qs, g_n, t_base, n,
                           scores, tile, slabs);
    } else {
      score_tile_direct<VEC4, G>(rows + t0 * dim, t_len, dim, qs, g_n,
                                 t_base, n, scores, tile);
    }
    __syncthreads();
    // the tile's scores of this warp's query to its warp queue (a warp of
    // no query reads nothing); the first tile seeds the bar.  Between tiles
    // the warp queue waits in shared memory (sm.queues, flushed of its
    // thread queues) and the bar in run_bar, so that the scoring holds no
    // select state in registers
    repro::WarpSelect<WQ> ws;
    ws.init();
    if (t0 > 0) {
#pragma unroll
      for (int t = 0; t < WQ; ++t) ws.wq[t] = sm.queues[t * THREADS + tid];
    }
    repro::Key* run_bar = &sm.run_bar[my_g];
    const int64_t n_mine = my_g < g_n ? t_len : 0;
    const float* srow = scores + (int64_t)my_g * tile;
    const int64_t idx0 = lo + t0;
    const auto value = [=](int64_t i) { return srow[i]; };
    const auto index = [=](int64_t i) { return (int)(idx0 + i); };
    if (t0 == 0) {
      repro::block_stream<THREADS, true>(ws, n_mine, part, RUN, k,
                                         SEED_BATCHES, run_bar, sm.queues,
                                         value, index);
    } else {
      repro::warp_stream<true>(ws, n_mine, part, RUN, (int64_t)part * 32, k,
                               run_bar, value, index);
    }
    ws.merge(k, tid & 31, run_bar);
#pragma unroll
    for (int t = 0; t < WQ; ++t) sm.queues[t * THREADS + tid] = ws.wq[t];
    __syncthreads();  // before the next tile overwrites the scores
  }

  repro::Key top[WQ];
#pragma unroll
  for (int t = 0; t < WQ; ++t) top[t] = sm.queues[t * THREADS + tid];
  repro::block_merge_queues<THREADS, WQ>(top, RUN, sm.queues);
  if (part == 0 && my_g < g_n) {
    const int64_t out = (q0 + my_g) * out_qstride + s * k;
    repro::write_queue<WQ>(top, k, out_vals + out, out_idxs + out);
  }
}

template <bool VEC4, int G, int WQ>
cudaError_t launch_segments(int64_t blocks, int64_t smem, cudaStream_t st,
                            const float* emb, int64_t emb_qstride,
                            const float* q, const float* base, int64_t nq,
                            int64_t n, int dim, int64_t seg_len, int64_t tile,
                            int group, int64_t n_groups, int k, float* ov,
                            int* oi, int64_t out_qstride) {
  if (smem + (int64_t)sizeof(repro::TopKSmem<THREADS, WQ>) > MAX_SMEM)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      dense_segments_kernel<VEC4, G, WQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dense_segments_kernel<VEC4, G, WQ><<<(unsigned int)blocks, THREADS,
                                       (size_t)smem, st>>>(
      emb, emb_qstride, q, base, nq, n, dim, seg_len, tile, group, n_groups,
      k, ov, oi, out_qstride);
  return cudaGetLastError();
}

template <bool VEC4, int G>
cudaError_t launch_segments(int64_t blocks, int64_t smem, cudaStream_t st,
                            const float* emb, int64_t emb_qstride,
                            const float* q, const float* base, int64_t nq,
                            int64_t n, int dim, int64_t seg_len, int64_t tile,
                            int group, int64_t n_groups, int k, float* ov,
                            int* oi, int64_t out_qstride) {
  switch (repro::warp_slots(k)) {
    case 1:
      return launch_segments<VEC4, G, 1>(blocks, smem, st, emb, emb_qstride,
                                         q, base, nq, n, dim, seg_len, tile,
                                         group, n_groups, k, ov, oi,
                                         out_qstride);
    case 2:
      return launch_segments<VEC4, G, 2>(blocks, smem, st, emb, emb_qstride,
                                         q, base, nq, n, dim, seg_len, tile,
                                         group, n_groups, k, ov, oi,
                                         out_qstride);
    default:
      return launch_segments<VEC4, G, 4>(blocks, smem, st, emb, emb_qstride,
                                         q, base, nq, n, dim, seg_len, tile,
                                         group, n_groups, k, ov, oi,
                                         out_qstride);
  }
}

template <bool VEC4>
cudaError_t launch_segments(int64_t blocks, int64_t smem, cudaStream_t st,
                            const float* emb, int64_t emb_qstride,
                            const float* q, const float* base, int64_t nq,
                            int64_t n, int dim, int64_t seg_len, int64_t tile,
                            int group, int64_t n_groups, int k, float* ov,
                            int* oi, int64_t out_qstride) {
  if (group == 1)
    return launch_segments<VEC4, 1>(blocks, smem, st, emb, emb_qstride, q,
                                    base, nq, n, dim, seg_len, tile, group,
                                    n_groups, k, ov, oi, out_qstride);
  if (group <= 4)
    return launch_segments<VEC4, 4>(blocks, smem, st, emb, emb_qstride, q,
                                    base, nq, n, dim, seg_len, tile, group,
                                    n_groups, k, ov, oi, out_qstride);
  return launch_segments<VEC4, MAX_GROUP>(blocks, smem, st, emb, emb_qstride,
                                          q, base, nq, n, dim, seg_len, tile,
                                          group, n_groups, k, ov, oi,
                                          out_qstride);
}

}  // namespace

// emb [n, dim] (emb_qstride 0) or [nq, n, dim] (emb_qstride n * dim, group
// 1); q [nq, dim]; base [nq, n] or null -> vals/idxs [nq, k], in n_seg
// segments of seg_len scored tile rows at a time.  n_seg > 1 needs
// cand_vals and cand_idxs of nq * n_seg * k elements each.
extern "C" int repro_dense_topk(const float* emb, int64_t emb_qstride,
                                const float* q, const float* base, int64_t nq,
                                int64_t n, int dim, int k, int group,
                                int n_seg, int64_t seg_len, int64_t tile,
                                float* cand_vals, int* cand_idxs, float* vals,
                                int* idxs, void* stream) {
  if (k < 1 || k > repro::TOPK_MAX_K || n < k || n > INT_MAX || nq < 1 ||
      dim < 1 || group < 1 || group > MAX_GROUP ||
      (emb_qstride != 0 && group != 1) || n_seg < 1 || seg_len < 1 ||
      (int64_t)(n_seg - 1) * seg_len >= n || (int64_t)n_seg * seg_len < n ||
      (n_seg > 1 && seg_len < k) || tile < 1 || tile > seg_len)
    return (int)cudaErrorInvalidValue;
  const int64_t n_groups = (nq + group - 1) / group;
  const int64_t blocks = n_groups * n_seg;
  // gathered rows go through the warps' slabs where they allow 16-byte
  // loads
  const bool vec4 = dim % 4 == 0 && ((uintptr_t)emb & 15) == 0;
  const int64_t smem = ((int64_t)group * dim + round_up4(group * tile)) * 4 +
                       (vec4 && group == 1 ? SLAB_BYTES : 0);
  if (blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* ov = n_seg == 1 ? vals : cand_vals;
  int* oi = n_seg == 1 ? idxs : cand_idxs;
  const int64_t out_qstride = (int64_t)n_seg * k;
  const cudaError_t err =
      vec4 ? launch_segments<true>(blocks, smem, st, emb, emb_qstride, q,
                                   base, nq, n, dim, seg_len, tile, group,
                                   n_groups, k, ov, oi, out_qstride)
           : launch_segments<false>(blocks, smem, st, emb, emb_qstride, q,
                                    base, nq, n, dim, seg_len, tile, group,
                                    n_groups, k, ov, oi, out_qstride);
  if (err != cudaSuccess || n_seg == 1) return (int)err;
  return (int)repro::launch_topk_merge(cand_vals, cand_idxs, nq,
                                      (int64_t)n_seg * k, k, vals, idxs, st);
}

