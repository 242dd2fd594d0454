// Block-level exact top-k of one row of floats, with the lax.top_k rule:
// values sorted descending, ties going to the lowest index.
//
// One thread block owns one row.  It finds the key of the k-th largest
// value by a 4-pass radix select (8 bits a pass, a 256-bin histogram in
// shared memory with warp-aggregated atomics), collects the elements above
// that key plus the lowest-indexed elements equal to it, and ranks those k
// candidates in shared memory.  The topk, dense-scoring and PQ-scoring
// kernels all take their top-k with `block_topk_row`, and all merge their
// segments' candidate lists with `launch_topk_merge` (defined in topk.cu).
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int TOPK_MAX_K = 128;
// loads each thread keeps in flight in the streaming passes
constexpr int TOPK_UNROLL = 4;

// Order-preserving map float -> uint32 (a larger float gets a larger key).
// -0.0 maps to the key of +0.0, so the two tie as they do in a float sort.
__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int THREADS>
struct TopKSmem {
  unsigned int hist[256];
  unsigned int warp_count[THREADS / 32];
  float vals[TOPK_MAX_K];
  uint32_t keys[TOPK_MAX_K];
  int idxs[TOPK_MAX_K];
  uint32_t prefix;   // key bits of the k-th largest found so far
  int remaining;     // elements equal to the threshold still to take
  int n_gt;          // slots handed to elements above the threshold
  int eq_taken;      // equal elements numbered in earlier tiles
};

// Top-k (1 <= k <= TOPK_MAX_K, k <= n) of row[0, n) into out_vals and
// out_idxs.  The index reported for row[i] is src_idx[i] when src_idx is
// given, else idx_base + i; with src_idx, equal values must appear in the
// row in ascending order of their reported index (a merge of sorted
// candidate lists from index-ordered segments does).  Every thread of the
// block must call it (it synchronises the block).
template <int THREADS>
__device__ void block_topk_row(const float* __restrict__ row, int64_t n,
                               int k, const int* __restrict__ src_idx,
                               int64_t idx_base, float* __restrict__ out_vals,
                               int* __restrict__ out_idxs,
                               TopKSmem<THREADS>& sm) {
  constexpr int64_t STEP = (int64_t)THREADS * TOPK_UNROLL;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. radix select: the exact key of the k-th largest element
  if (tid == 0) {
    sm.prefix = 0;
    sm.remaining = k;
  }
  uint32_t mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += THREADS) sm.hist[b] = 0;
    __syncthreads();
    const uint32_t prefix = sm.prefix;
    // the loop bound is uniform across the block, so every lane of a
    // warp reaches __match_any_sync together
    for (int64_t base = 0; base < n; base += STEP) {
      float v[TOPK_UNROLL];
#pragma unroll
      for (int u = 0; u < TOPK_UNROLL; ++u) {
        const int64_t i = base + (int64_t)u * THREADS + tid;
        v[u] = i < n ? row[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < TOPK_UNROLL; ++u) {
        const int64_t i = base + (int64_t)u * THREADS + tid;
        int bin = -1;
        if (i < n) {
          const uint32_t key = order_key(v[u]);
          if ((key & mask) == prefix) bin = (int)((key >> shift) & 255u);
        }
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1)
          atomicAdd(&sm.hist[bin], (unsigned int)__popc(peers));
      }
    }
    __syncthreads();
    // the bin holding the k-th largest: the highest bin b with at least
    // `remaining` elements in bins >= b.  Warp 0 finds it: lane l sums bins
    // [8l, 8l + 8), a suffix scan over the lanes gives the count above each
    // lane's bins, and the one lane whose range holds the crossing walks
    // its 8 bins down (the shuffles keep every read of sm.remaining ahead
    // of the one write)
    if (warp == 0) {
      const unsigned int rem = (unsigned int)sm.remaining;
      unsigned int local = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) local += sm.hist[lane * 8 + j];
      unsigned int suffix = local;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned int v = __shfl_down_sync(0xffffffffu, suffix, off);
        if (lane + off < 32) suffix += v;
      }
      unsigned int above = suffix - local;
      if (above < rem && rem <= suffix) {
        int b = lane * 8 + 7;
        for (; b > lane * 8; --b) {
          if (above + sm.hist[b] >= rem) break;
          above += sm.hist[b];
        }
        sm.remaining = (int)(rem - above);
        sm.prefix = prefix | ((uint32_t)b << shift);
      }
    }
    mask |= 255u << shift;
    __syncthreads();
  }

  const uint32_t thr = sm.prefix;
  const int need = sm.remaining;
  const int n_gt = k - need;
  __syncthreads();
  if (tid == 0) {
    sm.n_gt = 0;
    sm.eq_taken = 0;
  }
  __syncthreads();

  // 2a. every element above the threshold, in any order
  for (int64_t base = 0; base < n; base += STEP) {
    float v[TOPK_UNROLL];
#pragma unroll
    for (int u = 0; u < TOPK_UNROLL; ++u) {
      const int64_t i = base + (int64_t)u * THREADS + tid;
      v[u] = i < n ? row[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < TOPK_UNROLL; ++u) {
      const int64_t i = base + (int64_t)u * THREADS + tid;
      const uint32_t key = order_key(v[u]);
      if (i < n && key > thr) {
        const int s = atomicAdd(&sm.n_gt, 1);
        sm.vals[s] = v[u];
        sm.keys[s] = key;
        sm.idxs[s] = src_idx ? src_idx[i] : (int)(idx_base + i);
      }
    }
  }

  // 2b. the `need` lowest-indexed elements equal to it: tiles run in index
  //     order, a block-wide scan numbers the equal elements of a tile, and
  //     the loop stops once enough are taken (a uniform test: eq_taken is
  //     read after the barrier that published it)
  for (int64_t base = 0; base < n; base += THREADS) {
    if (sm.eq_taken >= need) break;
    const int64_t i = base + tid;
    float v = 0.0f;
    bool eq = false;
    if (i < n) {
      v = row[i];
      eq = order_key(v) == thr;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) sm.warp_count[warp] = (unsigned int)__popc(ball);
    __syncthreads();
    if (eq) {
      int ord = sm.eq_taken + __popc(ball & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) ord += (int)sm.warp_count[w];
      if (ord < need) {
        const int s = n_gt + ord;
        sm.vals[s] = v;
        sm.keys[s] = thr;
        sm.idxs[s] = src_idx ? src_idx[i] : (int)(idx_base + i);
      }
    }
    __syncthreads();
    if (tid == 0) {
      int tot = 0;
      for (int w = 0; w < THREADS / 32; ++w) tot += (int)sm.warp_count[w];
      sm.eq_taken += tot;
    }
    __syncthreads();
  }
  __syncthreads();

  // 3. rank the k candidates: descending key, then ascending index
  if (tid < k) {
    const uint32_t kk = sm.keys[tid];
    const int ii = sm.idxs[tid];
    int r = 0;
    for (int j = 0; j < k; ++j) {
      const uint32_t kj = sm.keys[j];
      r += (kj > kk) || (kj == kk && sm.idxs[j] < ii);
    }
    out_vals[r] = sm.vals[tid];
    out_idxs[r] = ii;
  }
  __syncthreads();
}

// One segment's candidate list for a later merge: the top min(k, len) of
// row[0, len) (indices lo + i), then (-inf, INT_MAX) pads up to k slots.
// Only the last segment of a row is shorter than k, and its pads sit past
// every real candidate of the row in the merge's order, so the merge (which
// holds at least k real candidates) never takes one.
template <int THREADS>
__device__ void segment_topk(const float* __restrict__ row, int64_t len,
                             int k, int64_t lo, float* __restrict__ out_vals,
                             int* __restrict__ out_idxs,
                             TopKSmem<THREADS>& sm) {
  const int kk = len < k ? (int)len : k;
  block_topk_row<THREADS>(row, len, kk, nullptr, lo, out_vals, out_idxs, sm);
  for (int j = kk + (int)threadIdx.x; j < k; j += THREADS) {
    out_vals[j] = -__int_as_float(0x7f800000);  // -inf
    out_idxs[j] = INT_MAX;
  }
}

// Merge each row's candidate lists, cand_vals/cand_idxs [nq, m] (the
// segments' sorted top-k lists in segment order, so equal values appear in
// ascending index order), into vals/idxs [nq, k].  Launches one block per
// row on `stream` and returns cudaGetLastError().  Defined in topk.cu.
cudaError_t launch_topk_merge(const float* cand_vals, const int* cand_idxs,
                              int64_t nq, int64_t m, int k, float* vals,
                              int* idxs, cudaStream_t stream);

}  // namespace repro
