// Exact top-k of product-quantised (ADC) scores, batched over queries, on
// Hopper: one launch a call, a thread-block cluster a query.
//
// Replaces: src/repro/kernels/pq_scoring/pq_scoring.py::pq_topk_pallas,
// the TPU kernel that streams [512, m] uint8 code tiles through VMEM, turns
// each subspace's lookup into a one-hot [512, n_codes] matmul against the
// query's table row on the MXU, adds the per-row base (NEG = -3e38 masks a
// padded row) and merges the tile into a running [k] scratch across its
// sequential grid, finishing with lexsort((idx, -val)).  A one-hot matmul
// is the TPU's way to gather; here a thread reads the table from shared
// memory directly.
//
// Bound on this card: reading the codes and the base once, (m + 4) bytes a
// row, and the table once: 2.2 MB at D4 ([16, 6888, 16] codes), under a
// microsecond at 3.35 TB/s, less than a launch's own fixed cost.  So the
// kernel is held back by latency, not bytes, and the design cuts the
// latency: one launch, no scores or candidate lists through global memory,
// and copies that one thread issues.  The C CTAs of a cluster (C = 8, the
// portable maximum: 16 queries x 8 = 128 CTAs, one wave on 132 SMs) share
// one query, a segment of its rows each:
//
//   1. Loads.  One thread of each CTA issues cp.async.bulk copies into
//      shared memory, each completing on an mbarrier: the query's table
//      [m, n_codes] (16 KB at m = 16, a copy a subspace row, so that a
//      table laid out [m, nq, n_codes], as the ADC einsum leaves it, needs
//      no copy of its own; a copy a CTA: multicast to the cluster in slices
//      measured no faster), and the segment's codes and
//      base rows, tile by tile through a ring of two slots (a slot's
//      mbarrier phase flips at each reuse), so that a segment of any length
//      streams through.  A bulk copy needs 16-byte addresses and sizes: the
//      wrapper cuts segments and tiles at multiples of 16 rows, and what
//      still does not allow a copy (codes with m % 16 != 0, a base or table
//      row off a 16-byte boundary, the last rows of a base tile short of 16
//      bytes) is read with ordinary loads in the same kernel.
//   2. Scoring.  A thread a row: score = table[0][c_0] + ... +
//      table[m-1][c_{m-1}], then + base, added in exactly that order (the
//      plain version's, so the two agree bit for bit), into the tile's
//      scores in shared memory.
//   3. Select.  The warp select of topk_block.cuh (a warp queue of 32, 64
//      or 128 keys a warp for k <= 128) over the tile's scores, seeded from
//      the first tile, the queues kept in registers across tiles; then
//      block_merge_queues merges the CTA's 8 warp queues.
//   4. Cluster merge.  Each CTA writes its queue into the cluster's first
//      CTA's shared memory (distributed shared memory: the inbox, a queue a
//      CTA), arrives at the cluster barrier and leaves; the first CTA waits
//      there for all of them, merges the C queues (one warp a queue) and
//      writes [k], sorted descending, -0.0 below +0.0, ties (documents that
//      share a code word score alike) to the lowest index, by the one 64-bit
//      key of the select.  A first barrier phase, arrived at on entry and
//      waited for just before the writes, makes sure every CTA of the
//      cluster has started before its shared memory is written.
//
// Contract: codes [nq, n, m] uint8, each code < n_codes; table
// [nq, m, n_codes] f32, rows of n_codes contiguous, at any query and
// subspace strides; base [nq, n] or null; 1 <= k <= 128, k <= n <=
// INT_MAX.  The wrapper (kernels/pq_scoring/ops.py) plans the cluster, the
// segment and the tile.
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "topk_block.cuh"
#include "launch_count.cuh"

namespace cg = cooperative_groups;

REPRO_LAUNCH_COUNTER(repro_launches_pq_topk)

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// the largest cluster (the portable maximum): a CTA queue a warp of the
// first CTA in its merge
constexpr int MAX_CLUSTER = 8;
// rows a segment and a tile are multiples of: 16-byte bulk copies of the
// codes (m % 16 == 0) and of the base (4 bytes a row)
constexpr int ROW_ALIGN = 16;
// dynamic shared memory a CTA may ask for, beside its static part
constexpr int DYN_SMEM_KB = 200;
// the seeding of the warp select reads the whole first tile
constexpr int SEED_BATCHES = 1 << 20;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// This thread's arrival, and `bytes` more to come from copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both addresses on 16 bytes) from global to
// this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The cluster barrier, split: this thread's arrival (release: its writes
// before it are seen by the threads that wait; relaxed: nothing to
// publish), and the wait for every thread of the cluster that has not
// exited.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__host__ __device__ __forceinline__ int64_t round_up16(int64_t x) {
  return (x + 15) & ~(int64_t)15;
}

// the dynamic shared memory of a plan: the table, the ring's slots (two
// where the segment takes more than one tile), the tile's scores
__host__ __device__ __forceinline__ int64_t slot_bytes(int64_t tile, int m) {
  return round_up16(tile * m) + tile * 4;
}
__host__ __device__ __forceinline__ int64_t table_bytes(int m, int n_codes) {
  return round_up16((int64_t)m * n_codes * 4);
}

// grid (C, nq), clusters of (C, 1, 1): CTA `rank` of query blockIdx.y owns
// rows [rank * seg_len, (rank + 1) * seg_len) of it, in tiles of `tile`.
// BULK_CODES: m % 16 == 0 and the codes on 16 bytes (a row's codes in one
// 16-byte load), else the codes are read from global memory a byte at a
// time.
template <int WQ, bool BULK_CODES>
__global__ void __launch_bounds__(THREADS, 1)
pq_cluster_kernel(const uint8_t* __restrict__ codes,
                  const float* __restrict__ table,
                  const float* __restrict__ base, int64_t tab_qstride,
                  int64_t tab_sstride, int64_t n, int m, int n_codes,
                  int64_t seg_len, int64_t tile, int k,
                  float* __restrict__ vals, int* __restrict__ idxs) {
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ repro::TopKSmem<THREADS, WQ> sm;
  // the first CTA's: the cluster's CTA queues, slot t of CTA c's lane l at
  // t * THREADS + 32 c + l (as warp c's queue in sm.queues)
  __shared__ repro::Key inbox[THREADS * WQ];
  __shared__ __align__(8) uint64_t bars[3];  // the table, the ring's slots
  count_launch();
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_cta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t qi = blockIdx.y;
  const int64_t lo = rank * seg_len;
  const int64_t len = n - lo < seg_len ? (n > lo ? n - lo : 0) : seg_len;
  const int64_t n_tiles = (len + tile - 1) / tile;
  const int tab_len = m * n_codes;
  const int64_t tab_b = table_bytes(m, n_codes);
  float* tab = reinterpret_cast<float*>(dyn);
  unsigned char* ring = dyn + tab_b;
  const int64_t slot_b = slot_bytes(tile, m);
  float* scores = reinterpret_cast<float*>(ring + (n_tiles > 1 ? 2 : 1) *
                                                      slot_b);
  const float* qtab = table + qi * tab_qstride;
  const uint8_t* qcodes = codes + (qi * n + lo) * m;
  const float* qbase = base == nullptr ? nullptr : base + qi * n + lo;
  // what the bulk copies may take
  const bool bulk_tab = (n_codes & 3) == 0 && (tab_qstride & 3) == 0 &&
                        (tab_sstride & 3) == 0 && ((uintptr_t)table & 15) == 0;
  const bool bulk_base = base != nullptr && (n & 3) == 0 &&
                         ((uintptr_t)base & 15) == 0;
  // the first phase of the cluster barrier: this CTA has started
  cluster_arrive_relaxed();
  if (tid == 0) {
    for (int b = 0; b < 3; ++b) mbar_init(&bars[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    sm.run_bar[0] = repro::PAD_KEY;
  }
  if (!bulk_tab)
    for (int i = tid; i < tab_len; i += THREADS)
      tab[i] = qtab[(i / n_codes) * tab_sstride + i % n_codes];
  __syncthreads();

  // tile t's codes and base rows into slot t & 1 (the thread that issues)
  const auto issue = [&](int64_t t) {
    const int64_t r0 = t * tile;
    const int64_t t_len = len - r0 < tile ? len - r0 : tile;
    unsigned char* slot = ring + (t & 1) * slot_b;
    const uint32_t code_b = BULK_CODES ? (uint32_t)(t_len * m) : 0u;
    const uint32_t base_b = bulk_base ? (uint32_t)((t_len & ~3) * 4) : 0u;
    uint64_t* bar = &bars[1 + (t & 1)];
    mbar_expect_tx(bar, code_b + base_b);
    if (code_b) bulk_load(slot, qcodes + r0 * m, code_b, bar);
    if (base_b)
      bulk_load(slot + round_up16(tile * m), qbase + r0, base_b, bar);
  };
  if (tid == 0) {
    if (bulk_tab) {
      const uint32_t row_b = (uint32_t)n_codes * 4;
      mbar_expect_tx(&bars[0], row_b * m);
      if (tab_sstride == n_codes) {
        bulk_load(tab, qtab, row_b * m, &bars[0]);
      } else {
        for (int s = 0; s < m; ++s)
          bulk_load(tab + s * n_codes, qtab + s * tab_sstride, row_b,
                    &bars[0]);
      }
    }
    for (int64_t t = 0; t < n_tiles && t < 2; ++t) issue(t);
  }
  if (bulk_tab) mbar_wait(&bars[0], 0);

  repro::WarpSelect<WQ> ws;
  ws.init();
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t r0 = t * tile;
    const int64_t t_len = len - r0 < tile ? len - r0 : tile;
    const unsigned char* slot = ring + (t & 1) * slot_b;
    const float* sbase =
        reinterpret_cast<const float*>(slot + round_up16(tile * m));
    const int64_t n_sbase = bulk_base ? (t_len & ~3) : 0;
    mbar_wait(&bars[1 + (t & 1)], (uint32_t)((t >> 1) & 1));
    for (int64_t r = tid; r < t_len; r += THREADS) {
      float acc = 0.0f;
      if constexpr (BULK_CODES) {
        const uint4* row = reinterpret_cast<const uint4*>(slot + r * m);
        for (int j = 0; j < m; j += 16) {
          const uint4 w = row[j >> 4];
          const unsigned int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            const int sub = j + b;
            const float x =
                tab[sub * n_codes + ((words[b >> 2] >> (8 * (b & 3))) & 255u)];
            acc = sub == 0 ? x : acc + x;
          }
        }
      } else {
        const uint8_t* row = qcodes + (r0 + r) * m;
        acc = tab[row[0]];
        for (int sub = 1; sub < m; ++sub)
          acc = acc + tab[sub * n_codes + row[sub]];
      }
      if (qbase != nullptr)
        acc = acc + (r < n_sbase ? sbase[r] : qbase[r0 + r]);
      scores[r] = acc;
    }
    __syncthreads();
    // every thread is done with the slot: its next tile may come in
    if (tid == 0 && t + 2 < n_tiles) issue(t + 2);
    const auto value = [=](int64_t i) { return scores[i]; };
    const auto index = [=](int64_t i) { return (int)(lo + r0 + i); };
    if (t == 0) {
      repro::block_stream<THREADS, true>(ws, t_len, warp, WARPS, k,
                                         SEED_BATCHES, sm.run_bar, sm.queues,
                                         value, index);
    } else {
      repro::warp_stream<true>(ws, t_len, warp, WARPS, (int64_t)warp * 32, k,
                               sm.run_bar, value, index);
    }
    __syncthreads();  // before the next tile overwrites the scores
  }
  ws.merge(k, lane, sm.run_bar);
  repro::block_merge_queues<THREADS, WQ>(ws.wq, WARPS, sm.queues);
  // the CTA's queue (warp 0's) to the first CTA's inbox, once every CTA of
  // the cluster has started; then the second phase: the first CTA waits for
  // every queue, the others leave
  cluster_wait();
  if (warp == 0) {
    repro::Key* dst = cluster.map_shared_rank(inbox, 0) + rank * 32 + lane;
#pragma unroll
    for (int t = 0; t < WQ; ++t) dst[t * THREADS] = ws.wq[t];
  }
  cluster_arrive();
  if (rank != 0) return;
  cluster_wait();
  repro::Key q[WQ];
#pragma unroll
  for (int t = 0; t < WQ; ++t)
    q[t] = warp < n_cta ? inbox[t * THREADS + tid] : repro::PAD_KEY;
  repro::block_merge_queues<THREADS, WQ>(q, n_cta, sm.queues);
  if (warp == 0) repro::write_queue<WQ>(q, k, vals + qi * k, idxs + qi * k);
}

template <int WQ, bool BULK_CODES>
cudaError_t launch(int cluster, int64_t nq, int64_t smem, cudaStream_t st,
                   const uint8_t* codes, const float* table,
                   const float* base, int64_t tab_qstride,
                   int64_t tab_sstride, int64_t n, int m, int n_codes,
                   int64_t seg_len, int64_t tile, int k, float* vals,
                   int* idxs) {
  const auto kernel = pq_cluster_kernel<WQ, BULK_CODES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)cluster, (unsigned int)nq);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned int)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, codes, table, base, tab_qstride,
                           tab_sstride, n, m, n_codes, seg_len, tile, k, vals,
                           idxs);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int WQ>
cudaError_t launch(bool bulk_codes, int cluster, int64_t nq, int64_t smem,
                   cudaStream_t st, const uint8_t* codes, const float* table,
                   const float* base, int64_t tab_qstride,
                   int64_t tab_sstride, int64_t n, int m, int n_codes,
                   int64_t seg_len, int64_t tile, int k, float* vals,
                   int* idxs) {
  return bulk_codes
             ? launch<WQ, true>(cluster, nq, smem, st, codes, table, base,
                                tab_qstride, tab_sstride, n, m, n_codes,
                                seg_len, tile, k, vals, idxs)
             : launch<WQ, false>(cluster, nq, smem, st, codes, table, base,
                                 tab_qstride, tab_sstride, n, m, n_codes,
                                 seg_len, tile, k, vals, idxs);
}

}  // namespace

// codes [nq, n, m] uint8, table [nq, m, n_codes] (query and subspace
// strides in floats, rows contiguous), base [nq, n] or null -> vals/idxs
// [nq, k], in clusters of `cluster` CTAs a query (a power of two <= 8),
// each CTA seg_len rows in tiles of `tile` (both multiples of 16).
extern "C" int repro_pq_topk(const uint8_t* codes, const float* table,
                             int64_t tab_qstride, int64_t tab_sstride,
                             const float* base, int64_t nq, int64_t n, int m,
                             int n_codes, int k, int cluster, int64_t seg_len,
                             int64_t tile, float* vals, int* idxs,
                             void* stream) {
  if (k < 1 || k > repro::TOPK_MAX_K || n < k || n > INT_MAX || nq < 1 ||
      nq > 65535 || m < 1 || n_codes < 1 || n_codes > 256 || cluster < 1 ||
      cluster > MAX_CLUSTER || (cluster & (cluster - 1)) != 0 ||
      seg_len < 1 || seg_len % ROW_ALIGN != 0 ||
      (int64_t)cluster * seg_len < n || tile < 1 || tile % ROW_ALIGN != 0 ||
      tile > seg_len || tab_qstride < 0 || tab_sstride < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = table_bytes(m, n_codes) +
                       (seg_len > tile ? 2 : 1) * slot_bytes(tile, m) +
                       tile * 4;
  if (smem > (int64_t)DYN_SMEM_KB * 1024) return (int)cudaErrorInvalidValue;
  const bool bulk_codes = m % 16 == 0 && ((uintptr_t)codes & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (repro::warp_slots(k)) {
    case 1:
      err = launch<1>(bulk_codes, cluster, nq, smem, st, codes, table, base,
                      tab_qstride, tab_sstride, n, m, n_codes, seg_len, tile,
                      k, vals, idxs);
      break;
    case 2:
      err = launch<2>(bulk_codes, cluster, nq, smem, st, codes, table, base,
                      tab_qstride, tab_sstride, n, m, n_codes, seg_len, tile,
                      k, vals, idxs);
      break;
    default:
      err = launch<4>(bulk_codes, cluster, nq, smem, st, codes, table, base,
                      tab_qstride, tab_sstride, n, m, n_codes, seg_len, tile,
                      k, vals, idxs);
  }
  return (int)err;
}
