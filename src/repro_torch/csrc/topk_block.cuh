// Block-level exact top-k of rows of floats, with the lax.top_k rule:
// values sorted descending, ties going to the lowest index.
//
// Two selects serve the topk, dense-scoring and PQ-scoring kernels, chosen
// by k (segment_topk, and the merge behind launch_topk_merge in topk.cu):
//
//   k <= 32: a warp select (after FAISS's WarpSelect/BlockSelect: Johnson,
//     Douze and Jegou, "Billion-scale similarity search with GPUs", 2017).
//     Every element becomes one 64-bit key, (order_key(value) << 32) |
//     ~index, so that a larger key is a larger value or an equal value at
//     a lower index: the lax.top_k order as one integer order, whatever
//     order the elements are visited in.  Each warp streams its share of
//     the row once.  A lane admits an element to its thread queue
//     (THREAD_Q keys in registers) only if its key beats the bar, which
//     every lane holds: the warp's k-th key, or a higher k-th key that
//     another warp on the same row published in shared memory.  When a
//     thread queue is full (a warp vote), the warp merges the thread
//     queues into its warp queue of 32 keys, one a lane, sorted descending
//     (a bitonic sort of each queue slot across the lanes, then a bitonic
//     merge, by shuffles), and publishes its new k-th key.  The bar starts
//     from a seed: each lane's largest value of its first batch enters the
//     warp queue at once, and the k-th of the block's merged seeds becomes
//     the bar.  The warps' queues then merge pairwise through shared
//     memory.
//   32 < k <= 128: a block radix select (block_topk_row), which finds the
//     key of the k-th largest value in four 8-bit passes, collects the
//     elements above it and the lowest-indexed ones equal to it, and ranks
//     the k candidates in shared memory.
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

// shared memory of block_topk_row
template <int THREADS>
struct RadixSmem {
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

// Top-k (1 <= k <= TOPK_MAX_K, k <= n) of row[0, n) by radix select into
// out_vals and out_idxs.  The index reported for row[i] is src_idx[i] when
// src_idx is given, else idx_base + i; with src_idx, equal values must
// appear in the row in ascending order of their reported index (a merge of
// sorted candidate lists from index-ordered segments does).  Every thread
// of the block must call it (it synchronises the block).
template <int THREADS>
__device__ __forceinline__ void block_topk_row(
    const float* __restrict__ row, int64_t n, int k,
    const int* __restrict__ src_idx, int64_t idx_base,
    float* __restrict__ out_vals, int* __restrict__ out_idxs,
    RadixSmem<THREADS>& sm) {
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

// ---------------------------------------------------------------------------
// The warp select (k <= WARP_K)
// ---------------------------------------------------------------------------

using Key = unsigned long long;

// the largest k the warp select serves: its warp queue holds 32 keys
constexpr int WARP_K = 32;
// keys each lane's thread queue holds
constexpr int THREAD_Q = 2;
// loads each lane keeps in flight in warp_stream
constexpr int WARP_UNROLL = 8;
constexpr unsigned int FULL_MASK = 0xffffffffu;
// the key of a pad, (-inf, INT_MAX): below every real element's key, a real
// -inf's included (its low word ~index is above ~INT_MAX = 0x80000000).  An
// empty queue slot holds it, so a short segment's list ends in pads.
constexpr Key PAD_KEY = 0x007FFFFF80000000ull;

__device__ __forceinline__ Key make_key(float v, int idx) {
  return ((Key)order_key(v) << 32) | (Key)(uint32_t)~idx;
}

// the value of a key (-0.0 comes back as +0.0, which compares equal)
__device__ __forceinline__ float key_value(Key key) {
  const uint32_t hi = (uint32_t)(key >> 32);
  return __uint_as_float((hi & 0x80000000u) ? (hi ^ 0x80000000u) : ~hi);
}

__device__ __forceinline__ int key_index(Key key) {
  return (int)~(uint32_t)key;
}

__device__ __forceinline__ Key key_max(Key a, Key b) { return a > b ? a : b; }
__device__ __forceinline__ Key key_min(Key a, Key b) { return a < b ? a : b; }

// The warp's 32 keys (one a lane) sorted ascending by lane: a bitonic sort
// network, each compare-exchange a shuffle with the partner lane.
__device__ __forceinline__ Key warp_sort_ascending(Key x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const Key y = __shfl_xor_sync(FULL_MASK, x, stride);
      // a run of `size` lanes sorts ascending when (lane & size) == 0, so
      // the runs pair up into bitonic sequences; the lower lane of a pair
      // takes the minimum in an ascending run
      const bool take_min = ((lane & stride) == 0) == ((lane & size) == 0);
      x = take_min ? key_min(x, y) : key_max(x, y);
    }
  }
  return x;
}

// A bitonic sequence of 32 keys (one a lane) sorted descending by lane.
__device__ __forceinline__ Key warp_merge_descending(Key x, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const Key y = __shfl_xor_sync(FULL_MASK, x, stride);
    x = (lane & stride) == 0 ? key_max(x, y) : key_min(x, y);
  }
  return x;
}

// One warp's running top-k.  Lane l holds the warp queue's key of rank l
// (wq, sorted descending across the lanes) and its thread queue tq (newest
// first, PAD_KEY where empty).  Every lane holds the bar an element's key
// must beat to enter: the warp's own k-th key, or a higher one that another
// warp working on the same row published in shared memory (run_bar: that
// warp holds k elements above it, so nothing below it can be in the row's
// top-k).  Every member function is called by the whole warp together.
struct WarpSelect {
  Key wq;
  Key tq[THREAD_Q];
  Key bar;
  float bar_value;
  int n_tq;

  __device__ __forceinline__ void init() {
    wq = PAD_KEY;
#pragma unroll
    for (int t = 0; t < THREAD_Q; ++t) tq[t] = PAD_KEY;
    bar = PAD_KEY;
    bar_value = -__int_as_float(0x7f800000);  // -inf
    n_tq = 0;
  }

  __device__ __forceinline__ void raise_bar(Key key) {
    if (key > bar) {
      bar = key;
      bar_value = key_value(key);
    }
  }

  // The warp's k-th key to the bar, and published to the warps that share
  // the row.
  __device__ __forceinline__ void publish(int k, int lane, Key* run_bar) {
    const Key kth = __shfl_sync(FULL_MASK, wq, k - 1);
    raise_bar(kth);
    if (lane == 0 && kth != PAD_KEY) atomicMax(run_bar, kth);
  }

  // The thread queues into the warp queue: each slot t of the thread queues
  // is 32 keys, one a lane; sorted ascending against the descending warp
  // queue, the larger of each pair is a bitonic sequence that holds the top
  // 32 of both, and a bitonic merge sorts it.  Then the new k-th key.
  __device__ __forceinline__ void merge(int k, int lane, Key* run_bar) {
#pragma unroll
    for (int t = 0; t < THREAD_Q; ++t) {
      if (__any_sync(FULL_MASK, tq[t] != PAD_KEY)) {
        wq = warp_merge_descending(
            key_max(wq, warp_sort_ascending(tq[t], lane)), lane);
        tq[t] = PAD_KEY;
      }
    }
    n_tq = 0;
    publish(k, lane, run_bar);
  }

  // Offer this lane's key (admit: whether it has one); merges when a
  // thread queue is full.
  __device__ __forceinline__ void offer(bool admit, Key key, int k, int lane,
                                        Key* run_bar) {
    if (admit && key > bar) {
#pragma unroll
      for (int t = THREAD_Q - 1; t > 0; --t) tq[t] = tq[t - 1];
      tq[0] = key;
      ++n_tq;
    }
    if (__any_sync(FULL_MASK, n_tq == THREAD_Q)) merge(k, lane, run_bar);
  }
};

// A warp's share of a row of n elements: the row cut into 32-wide tiles
// dealt round robin to the `parts` warps that share it, so that warp
// `part` reads the elements i = base + lane, for base = 32 * part,
// 32 * (part + parts), ...; a batch is WARP_UNROLL such tiles, one load a
// lane each.  value(i) and index(i) give an element's value and index;
// run_bar is the bar in shared memory that the row's warps share.  The
// loop bounds depend on the warp only, so every lane reaches every vote
// and shuffle, the ragged last tile included.

template <class Value>
__device__ __forceinline__ void load_batch(float (&v)[WARP_UNROLL],
                                           int64_t base, int64_t stride,
                                           int64_t n, Value value) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < WARP_UNROLL; ++u) {
    const int64_t i = base + u * stride + lane;
    v[u] = i < n ? value(i) : 0.0f;
  }
}

// Hold a batch against the bar's value and offer the elements that reach
// it.  Only a batch in which some lane has a hit takes the slow path, which
// offers the batch's elements one u at a time, the u at which some lane
// hits (reloading them, so that no register array is indexed at run time).
// A value equal to the bar's can enter only at a lower index, so where
// indices grow with i (ASCENDING) and the bar's element lies before the
// batch, the test is strict: rows of ties stay on the fast path.  `first`
// is the u of this lane's element that the seeding entered already (-1:
// none).
template <bool ASCENDING, class Value, class Index>
__device__ __forceinline__ void offer_batch(WarpSelect& ws,
                                            const float (&v)[WARP_UNROLL],
                                            int64_t base, int64_t stride,
                                            int64_t n, int first, int k,
                                            Key* run_bar, Value value,
                                            Index index) {
  const int lane = threadIdx.x & 31;
  ws.raise_bar(*(volatile Key*)run_bar);
  const bool strict = ASCENDING && key_index(ws.bar) < index(base);
  unsigned int hits = 0;
#pragma unroll
  for (int u = 0; u < WARP_UNROLL; ++u) {
    const int64_t i = base + u * stride + lane;
    const bool hit =
        v[u] > ws.bar_value || (!strict && v[u] == ws.bar_value);
    hits |= (i < n && u != first && hit) ? 1u << u : 0u;
  }
  // the slow path visits only the u at which some lane hits
  unsigned int todo = __reduce_or_sync(FULL_MASK, hits);
  while (todo != 0) {
    const int u = __ffs(todo) - 1;
    todo &= todo - 1;
    const int64_t i = base + u * stride + lane;
    const bool hit = (hits >> u) & 1u;
    const Key key = hit ? make_key(value(i), index(i)) : PAD_KEY;
    ws.offer(hit, key, k, lane, run_bar);
  }
}

// The warp's batches from the one at `start` on, each batch's loads
// issued before the one ahead of it is held against the bar: two batches
// in flight.  seeded: the index i of this lane's element
// that the seeding entered already (-1: none).
template <bool ASCENDING, class Value, class Index>
__device__ __forceinline__ void warp_stream(WarpSelect& ws, int64_t n,
                                            int part, int parts,
                                            int64_t start, int k,
                                            Key* run_bar, Value value,
                                            Index index, int64_t seeded = -1) {
  const int64_t stride = (int64_t)parts * 32;
  const int64_t step = stride * WARP_UNROLL;
  float v[WARP_UNROLL];
  load_batch(v, start, stride, n, value);
  for (int64_t base = start; base < n; base += step) {
    float ahead[WARP_UNROLL];
    load_batch(ahead, base + step, stride, n, value);
    const int first = seeded >= base && seeded < base + step
                          ? (int)((seeded - base) / stride)
                          : -1;
    offer_batch<ASCENDING>(ws, v, base, stride, n, first, k, run_bar, value,
                           index);
#pragma unroll
    for (int u = 0; u < WARP_UNROLL; ++u) v[u] = ahead[u];
  }
}

// Merge the warp queues (q: this lane's key) of each run of `run`
// consecutive warps (a power of two dividing THREADS / 32) pairwise through
// sq[THREADS] in shared memory; the first warp of each run returns the
// run's merged queue (this lane's key, sorted descending across the
// lanes).  Every thread of the block calls it.
template <int THREADS>
__device__ __forceinline__ Key block_merge_queues(Key q, int run, Key* sq) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int span = 1; span < run; span <<= 1) {
    sq[threadIdx.x] = q;
    __syncthreads();
    if ((warp & (2 * span - 1)) == 0) {
      // a descending queue against its partner's read backwards: the
      // larger of each pair is bitonic and holds the top 32 of both
      const Key other = sq[(warp + span) * 32 + 31 - lane];
      q = warp_merge_descending(key_max(q, other), lane);
    }
    __syncthreads();
  }
  return q;
}

// A row's stream by a run of `run` warps (this warp is `part` of it).
// First each lane's largest value among its first seed_batches batches
// enters the warp queue (one sort across the lanes), and the k-th of the
// run's merged seeds becomes the run's bar, so that every warp's stream is
// held against a bar drawn from 32 * run * WARP_UNROLL * seed_batches
// elements; then the stream, from the first batch (re-read from the L1 or
// shared memory), passing over the seeded elements.  Every thread of the
// block calls it (it synchronises the block); a warp with nothing to read
// passes n = 0.
template <int THREADS, bool ASCENDING, class Value, class Index>
__device__ __forceinline__ void block_stream(WarpSelect& ws, int64_t n,
                                             int part, int run, int k,
                                             int seed_batches, Key* run_bar,
                                             Key* sq, Value value,
                                             Index index) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)run * 32;
  const int64_t start = (int64_t)part * 32;
  int64_t seeded = -1;
  float top = 0.0f;
  for (int b = 0; b < seed_batches; ++b) {
    const int64_t base = start + b * stride * WARP_UNROLL;
    if (base >= n) break;
    float v[WARP_UNROLL];
    load_batch(v, base, stride, n, value);
#pragma unroll
    for (int u = 0; u < WARP_UNROLL; ++u) {
      const int64_t i = base + u * stride + lane;
      if (i < n && (seeded < 0 || v[u] > top)) {
        top = v[u];
        seeded = i;
      }
    }
  }
  const Key seed = seeded < 0 ? PAD_KEY : make_key(top, index(seeded));
  ws.wq = warp_merge_descending(key_max(ws.wq, warp_sort_ascending(seed, lane)),
                                lane);
  const Key merged = block_merge_queues<THREADS>(ws.wq, run, sq);
  if (part == 0 && lane == k - 1 && merged != PAD_KEY) *run_bar = merged;
  __syncthreads();
  warp_stream<ASCENDING>(ws, n, part, run, start, k, run_bar, value, index,
                         seeded);
}

// Lanes [0, k) write the queue's first k keys as (value, index); a PAD_KEY
// slot writes the pad (-inf, INT_MAX).
__device__ __forceinline__ void write_queue(Key q, int k,
                                            float* __restrict__ out_vals,
                                            int* __restrict__ out_idxs) {
  const int lane = threadIdx.x & 31;
  if (lane < k) {
    out_vals[lane] = key_value(q);
    out_idxs[lane] = key_index(q);
  }
}

// shared memory of either select
template <int THREADS>
struct TopKSmem {
  union {
    RadixSmem<THREADS> radix;
    Key queues[THREADS];  // a warp queue a warp, for block_merge_queues
  };
  Key run_bar[THREADS / 32];  // the bar of each row a block's warps share
};

// Top-k (k <= WARP_K) of a row of n elements by warp select, each warp
// streaming its share, into out_vals/out_idxs (pads past the row's n).
// ASCENDING: index(i) grows with i.  Every thread of the block calls it.
template <int THREADS, bool ASCENDING, class Value, class Index>
__device__ __forceinline__ void block_warp_topk(
    int64_t n, int k, Value value, Index index, float* __restrict__ out_vals,
    int* __restrict__ out_idxs, TopKSmem<THREADS>& sm) {
  constexpr int WARPS = THREADS / 32;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) sm.run_bar[0] = PAD_KEY;
  __syncthreads();
  WarpSelect ws;
  ws.init();
  block_stream<THREADS, ASCENDING>(ws, n, warp, WARPS, k, 1, sm.run_bar,
                                   sm.queues, value, index);
  ws.merge(k, threadIdx.x & 31, sm.run_bar);
  const Key q = block_merge_queues<THREADS>(ws.wq, WARPS, sm.queues);
  if (warp == 0) write_queue(q, k, out_vals, out_idxs);
}

// One segment's candidate list for a later merge: the top min(k, len) of
// row[0, len) (indices lo + i), then (-inf, INT_MAX) pads up to k slots.
// Only the last segment of a row is shorter than k, and its pads sit past
// every real candidate of the row in the merge's order, so the merge (which
// holds at least k real candidates) never takes one.  LDG: the row lies in
// global memory, read-only for the kernel's lifetime, and the warp select
// loads it through the non-coherent cache.
template <int THREADS, bool LDG = false>
__device__ __forceinline__ void segment_topk(
    const float* __restrict__ row, int64_t len, int k, int64_t lo,
    float* __restrict__ out_vals, int* __restrict__ out_idxs,
    TopKSmem<THREADS>& sm) {
  if (k <= WARP_K) {
    block_warp_topk<THREADS, true>(
        len, k,
        [=](int64_t i) {
          if constexpr (LDG) return __ldg(row + i);
          else return row[i];
        },
        [=](int64_t i) { return (int)(lo + i); }, out_vals, out_idxs, sm);
    return;
  }
  const int kk = len < k ? (int)len : k;
  block_topk_row<THREADS>(row, len, kk, nullptr, lo, out_vals, out_idxs,
                          sm.radix);
  for (int j = kk + (int)threadIdx.x; j < k; j += THREADS) {
    out_vals[j] = -__int_as_float(0x7f800000);  // -inf
    out_idxs[j] = INT_MAX;
  }
}

// Merge each row's candidate lists, cand_vals/cand_idxs [nq, m] (the
// segments' top-k lists in segment order), into vals/idxs [nq, k]: by warp
// select for k <= WARP_K, else by radix select, which needs equal values in
// ascending index order (the radix path's sorted lists give it).  Launches
// one block per row on `stream` and returns cudaGetLastError().  Defined in
// topk.cu.
cudaError_t launch_topk_merge(const float* cand_vals, const int* cand_idxs,
                              int64_t nq, int64_t m, int k, float* vals,
                              int* idxs, cudaStream_t stream);

}  // namespace repro
