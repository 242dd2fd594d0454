// Block-level exact top-k of rows of floats, with the lax.top_k rule:
// values sorted descending, -0.0 just below +0.0, ties going to the lowest
// index.
//
// One select serves the topk, dense-scoring and PQ-scoring kernels for
// every k <= TOPK_MAX_K: a warp select (after FAISS's WarpSelect/BlockSelect:
// Johnson, Douze and Jegou, "Billion-scale similarity search with GPUs",
// 2017).  Every element becomes one 64-bit key, (order_key(value) << 32) |
// ~index, so that a larger key is a larger value or an equal value at a
// lower index: the lax.top_k order as one integer order, whatever order the
// elements are visited in.  Each warp streams its share of the row once.  A
// lane admits an element to its thread queue (THREAD_Q keys in registers)
// only if its key beats the bar, which every lane holds: the warp's k-th
// key, or a higher k-th key that another warp on the same row published in
// shared memory.  When a thread queue is full (a warp vote), the warp merges
// the thread queues into its warp queue of 32 * WQ keys, WQ = 1, 2 or 4 a
// lane (k <= 32, 64, 128; warp_slots), sorted descending with the key of
// rank 32 t + l in slot t of lane l: each thread-queue slot, sorted across
// the lanes by a bitonic network of shuffles, displaces the queue's lowest
// keys (its last slot), and a bitonic merge across the slots (in a lane)
// and the lanes (by shuffles) sorts the queue again.  The warp then
// publishes its new k-th key.  The bar starts from a seed: each lane's
// largest value of its first batch enters the warp queue at once, and the
// k-th of the block's merged seeds becomes the bar.  The warps' queues then
// merge pairwise through shared memory.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// the warp queue's largest size, in keys a lane
constexpr int MAX_WQ = 4;
constexpr int TOPK_MAX_K = 32 * MAX_WQ;

// The warp queue's slots a lane for k (1 <= k <= TOPK_MAX_K): 1, 2 or 4.
__host__ __device__ constexpr int warp_slots(int k) {
  return k <= 32 ? 1 : k <= 64 ? 2 : 4;
}

// Order-preserving map float -> uint32 (a larger float gets a larger key);
// -0.0 maps just below +0.0, as lax.top_k orders them.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
// order_key(-0.0f): the one float whose key lies above a float-equal one's
constexpr uint32_t NEG_ZERO_KEY = 0x7FFFFFFFu;

using Key = unsigned long long;

// keys each lane's thread queue holds
constexpr int THREAD_Q = 2;
// loads each lane keeps in flight in warp_stream
constexpr int WARP_UNROLL = 8;
constexpr unsigned int FULL_MASK = 0xffffffffu;
// the key of a pad, (-inf, INT_MAX): below every real element's key, a real
// -inf's included (its low word ~index is above ~INT_MAX = 0x80000000).  An
// empty queue slot holds it, so a short row's list ends in pads.
constexpr Key PAD_KEY = 0x007FFFFF80000000ull;

__device__ __forceinline__ Key make_key(float v, int idx) {
  return ((Key)order_key(v) << 32) | (Key)(uint32_t)~idx;
}

// the value of a key (-0.0 comes back as -0.0)
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

// the larger of a and b to a, the smaller to b
__device__ __forceinline__ void exchange_descending(Key& a, Key& b) {
  const Key x = a;
  a = key_max(x, b);
  b = key_min(x, b);
}

// A bitonic sequence of 32 * WQ keys (rank 32 t + l in q[t] of lane l)
// sorted descending: the compare-exchanges of strides 32 * WQ / 2 .. 32
// pair a lane's own slots (written out, so that no slot is indexed at run
// time), the shorter ones are shuffles within a slot.
template <int WQ>
__device__ __forceinline__ void queue_merge_descending(Key (&q)[WQ],
                                                       int lane) {
  static_assert(WQ == 1 || WQ == 2 || WQ == 4, "a warp queue of 1, 2 or 4");
  if constexpr (WQ == 4) {
    exchange_descending(q[0], q[2]);
    exchange_descending(q[1], q[3]);
    exchange_descending(q[2], q[3]);
  }
  if constexpr (WQ >= 2) exchange_descending(q[0], q[1]);
#pragma unroll
  for (int t = 0; t < WQ; ++t) q[t] = warp_merge_descending(q[t], lane);
}

// 32 keys (x, one a lane, in any order) into the descending queue q, which
// keeps its top 32 * WQ.  The keys x displaces are the queue's lowest, all
// in its last slot: x sorted ascending against that slot gives, pair by
// pair, the top 32 of both as a bitonic sequence, sorted into the last
// slot.  For WQ > 1 that slot, reversed across the lanes, follows the
// others ascending, so the queue is bitonic, and a merge sorts it.
template <int WQ>
__device__ __forceinline__ void queue_insert(Key (&q)[WQ], Key x, int lane) {
  q[WQ - 1] = warp_merge_descending(
      key_max(q[WQ - 1], warp_sort_ascending(x, lane)), lane);
  if constexpr (WQ > 1) {
    q[WQ - 1] = __shfl_sync(FULL_MASK, q[WQ - 1], 31 - lane);
    queue_merge_descending<WQ>(q, lane);
  }
}

// The queue's key of rank r (the same r in every lane), in every lane.
// Each slot's lane r % 32 is shuffled out and the slot r / 32 picked among
// the results, so that no slot is indexed at run time.
template <int WQ>
__device__ __forceinline__ Key queue_at(const Key (&q)[WQ], int r) {
  Key x = __shfl_sync(FULL_MASK, q[0], r & 31);
#pragma unroll
  for (int t = 1; t < WQ; ++t) {
    const Key y = __shfl_sync(FULL_MASK, q[t], r & 31);
    if ((r >> 5) == t) x = y;
  }
  return x;
}

// 32 * WQ keys (q[t] of lane l, in any order) sorted descending into the
// queue's order: each slot sorted across the lanes, descending and
// ascending in turn so that neighbouring slots make bitonic sequences,
// merged in pairs (for WQ = 4 the second pair's merge reversed to
// ascending), then merged whole.
template <int WQ>
__device__ __forceinline__ void queue_sort_descending(Key (&q)[WQ],
                                                      int lane) {
  static_assert(WQ == 2 || WQ == 4, "a warp queue of 2 or 4");
  // ~ reverses the key order: an ascending sort of ~x is x descending
  q[0] = ~warp_sort_ascending(~q[0], lane);
  q[1] = warp_sort_ascending(q[1], lane);
  if constexpr (WQ == 4) {
    q[2] = ~warp_sort_ascending(~q[2], lane);
    q[3] = warp_sort_ascending(q[3], lane);
    exchange_descending(q[0], q[1]);
    exchange_descending(q[2], q[3]);
#pragma unroll
    for (int t = 0; t < 4; ++t) q[t] = warp_merge_descending(q[t], lane);
    const Key hi = __shfl_sync(FULL_MASK, q[2], 31 - lane);
    q[2] = __shfl_sync(FULL_MASK, q[3], 31 - lane);
    q[3] = hi;
  }
  queue_merge_descending<WQ>(q, lane);
}

// One warp's running top-k.  Lane l holds the warp queue's keys of rank
// 32 t + l (wq[t], sorted descending) and its thread queue tq (newest first,
// PAD_KEY where empty).  Every lane holds the bar an element's key must beat
// to enter: the warp's own k-th key, or a higher one that another warp
// working on the same row published in shared memory (run_bar: that warp
// holds k elements above it, so nothing below it can be in the row's
// top-k).  Every member function is called by the whole warp together.
template <int WQ>
struct WarpSelect {
  Key wq[WQ];
  Key tq[THREAD_Q];
  Key bar;
  float bar_value;
  int n_tq;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int t = 0; t < WQ; ++t) wq[t] = PAD_KEY;
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
    const Key kth = queue_at<WQ>(wq, k - 1);
    raise_bar(kth);
    if (lane == 0 && kth != PAD_KEY) atomicMax(run_bar, kth);
  }

  // The thread queues into the warp queue, a slot (32 keys, one a lane) at
  // a time; then the new k-th key.
  __device__ __forceinline__ void merge(int k, int lane, Key* run_bar) {
#pragma unroll
    for (int t = 0; t < THREAD_Q; ++t) {
      if (__any_sync(FULL_MASK, tq[t] != PAD_KEY)) {
        queue_insert<WQ>(wq, tq[t], lane);
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
// batch, the test is strict: rows of ties stay on the fast path.  The one
// exception is a bar at -0.0, which a float-equal +0.0 beats at any index:
// there the test stays non-strict, and the key comparison of offer decides.
// `first` is the u of this lane's element that the seeding entered already
// (-1: none).
template <bool ASCENDING, int WQ, class Value, class Index>
__device__ __forceinline__ void offer_batch(WarpSelect<WQ>& ws,
                                            const float (&v)[WARP_UNROLL],
                                            int64_t base, int64_t stride,
                                            int64_t n, int first, int k,
                                            Key* run_bar, Value value,
                                            Index index) {
  const int lane = threadIdx.x & 31;
  ws.raise_bar(*(volatile Key*)run_bar);
  const bool strict = ASCENDING && key_index(ws.bar) < index(base) &&
                      (uint32_t)(ws.bar >> 32) != NEG_ZERO_KEY;
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
template <bool ASCENDING, int WQ, class Value, class Index>
__device__ __forceinline__ void warp_stream(WarpSelect<WQ>& ws, int64_t n,
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

// Merge the warp queues (q: this lane's keys) of each run of `run`
// consecutive warps (a power of two dividing THREADS / 32) pairwise through
// sq[THREADS * WQ] in shared memory (slot t of thread j at t * THREADS + j);
// the first warp of each run ends with the run's merged queue in q.  Every
// thread of the block calls it.
template <int THREADS, int WQ>
__device__ __forceinline__ void block_merge_queues(Key (&q)[WQ], int run,
                                                   Key* sq) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int span = 1; span < run; span <<= 1) {
#pragma unroll
    for (int t = 0; t < WQ; ++t) sq[t * THREADS + threadIdx.x] = q[t];
    __syncthreads();
    if ((warp & (2 * span - 1)) == 0) {
      // a descending queue against its partner's read backwards (rank
      // 32 t + l against 32 (WQ - 1 - t) + 31 - l): the larger of each pair
      // is bitonic and holds the top 32 * WQ of both
      const Key* other = sq + (warp + span) * 32 + 31 - lane;
#pragma unroll
      for (int t = 0; t < WQ; ++t)
        q[t] = key_max(q[t], other[(WQ - 1 - t) * THREADS]);
      queue_merge_descending<WQ>(q, lane);
    }
    __syncthreads();
  }
}

// A row's stream by a run of `run` warps (this warp is `part` of it).
// With a queue of 2 or 4 slots and no warp's share longer than its queue
// (a block-wide vote), each warp sorts its share into its queue whole.
// Otherwise, first each lane's largest value among its first seed_batches
// batches
// enters the warp queue (one sort across the lanes), and the k-th of the
// run's merged seeds becomes the run's bar, so that every warp's stream is
// held against a bar drawn from 32 * run * WARP_UNROLL * seed_batches
// elements; then the stream, from the first batch (re-read from the L1 or
// shared memory), passing over the seeded elements.  Every thread of the
// block calls it (it synchronises the block); a warp with nothing to read
// passes n = 0.
template <int THREADS, bool ASCENDING, int WQ, class Value, class Index>
__device__ __forceinline__ void block_stream(WarpSelect<WQ>& ws, int64_t n,
                                             int part, int run, int k,
                                             int seed_batches, Key* run_bar,
                                             Key* sq, Value value,
                                             Index index) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)run * 32;
  const int64_t start = (int64_t)part * 32;
  if constexpr (WQ > 1) {
    // rows of at most WQ tiles a warp (in every warp of the block: a vote):
    // each warp's share fits its queue, and one sort of it is the warp's
    // whole stream (its tiles j go to slots j; the queue starts empty here)
    if (!__syncthreads_or(n > stride * WQ)) {
#pragma unroll
      for (int j = 0; j < WQ; ++j) {
        const int64_t i = start + j * stride + lane;
        ws.wq[j] = i < n ? make_key(value(i), index(i)) : PAD_KEY;
      }
      queue_sort_descending<WQ>(ws.wq, lane);
      ws.publish(k, lane, run_bar);
      return;
    }
  }
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
  queue_insert<WQ>(ws.wq, seed, lane);
  Key merged[WQ];
#pragma unroll
  for (int t = 0; t < WQ; ++t) merged[t] = ws.wq[t];
  block_merge_queues<THREADS, WQ>(merged, run, sq);
  const Key kth = queue_at<WQ>(merged, k - 1);
  if (part == 0 && lane == 0 && kth != PAD_KEY) *run_bar = kth;
  __syncthreads();
  warp_stream<ASCENDING>(ws, n, part, run, start, k, run_bar, value, index,
                         seeded);
}

// The queue's first k keys as (value, index) to out_vals/out_idxs (rank
// 32 t + l from slot t of lane l); a PAD_KEY slot writes the pad
// (-inf, INT_MAX).
template <int WQ>
__device__ __forceinline__ void write_queue(const Key (&q)[WQ], int k,
                                            float* __restrict__ out_vals,
                                            int* __restrict__ out_idxs) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < WQ; ++t) {
    const int r = t * 32 + lane;
    if (r < k) {
      out_vals[r] = key_value(q[t]);
      out_idxs[r] = key_index(q[t]);
    }
  }
}

// shared memory of the select
template <int THREADS, int WQ>
struct TopKSmem {
  Key queues[THREADS * WQ];   // a warp queue a warp, for block_merge_queues
  Key run_bar[THREADS / 32];  // the bar of each row a block's warps share
};

// Top-k of a row of n elements by warp select, each warp streaming its
// share, into out_vals/out_idxs (pads past the row's n).  ASCENDING:
// index(i) grows with i.  Every thread of the block calls it.
template <int THREADS, bool ASCENDING, int WQ, class Value, class Index>
__device__ __forceinline__ void block_warp_topk(
    int64_t n, int k, Value value, Index index, float* __restrict__ out_vals,
    int* __restrict__ out_idxs, TopKSmem<THREADS, WQ>& sm) {
  constexpr int WARPS = THREADS / 32;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) sm.run_bar[0] = PAD_KEY;
  __syncthreads();
  WarpSelect<WQ> ws;
  ws.init();
  block_stream<THREADS, ASCENDING>(ws, n, warp, WARPS, k, 1, sm.run_bar,
                                   sm.queues, value, index);
  ws.merge(k, threadIdx.x & 31, sm.run_bar);
  block_merge_queues<THREADS, WQ>(ws.wq, WARPS, sm.queues);
  if (warp == 0) write_queue<WQ>(ws.wq, k, out_vals, out_idxs);
}

// One segment's candidate list for a later merge: the top min(k, len) of
// row[0, len) (indices lo + i), then (-inf, INT_MAX) pads up to k slots.
// Only the last segment of a row is shorter than k, and its pads sit past
// every real candidate of the row in the merge's order, so the merge (which
// holds at least k real candidates) never takes one.  LDG: the row lies in
// global memory, read-only for the kernel's lifetime, and the warp select
// loads it through the non-coherent cache.
template <int THREADS, int WQ, bool LDG = false>
__device__ __forceinline__ void segment_topk(
    const float* __restrict__ row, int64_t len, int k, int64_t lo,
    float* __restrict__ out_vals, int* __restrict__ out_idxs,
    TopKSmem<THREADS, WQ>& sm) {
  block_warp_topk<THREADS, true>(
      len, k,
      [=](int64_t i) {
        if constexpr (LDG) return __ldg(row + i);
        else return row[i];
      },
      [=](int64_t i) { return (int)(lo + i); }, out_vals, out_idxs, sm);
}

// Merge each row's candidate lists, cand_vals/cand_idxs [nq, m] (the
// segments' top-k lists in segment order, in any order within a list),
// into vals/idxs [nq, k] by warp select.  Launches one block per row on
// `stream` and returns cudaGetLastError().  Defined in topk.cu.
cudaError_t launch_topk_merge(const float* cand_vals, const int* cand_idxs,
                              int64_t nq, int64_t m, int k, float* vals,
                              int* idxs, cudaStream_t stream);

}  // namespace repro
