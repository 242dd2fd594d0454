// Causal grouped-query flash attention in bf16 (the LM prefill) on Hopper's
// tensor cores: wgmma tiles fed by TMA, one producer warp and two consumer
// warpgroups, in persistent CTAs.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas for bf16 inputs (fp32 inputs keep the CUDA-core
// kernel of csrc/flash_attention.cu, whose C entry dispatches here).  The TPU
// kernel walks the kv blocks of one (batch, head, q block) in order on one
// core, carrying (m, l, acc) in VMEM; here a work tile is one (batch, q
// head, 128-row q tile), a loop inside the CTA takes the place of the kv
// axis, and one CTA per SM walks the work tiles.  The function is the one
// the Pallas kernel and the fp32 kernel compute: causal and chunked-local
// GQA, softmax in fp32, q [B, S, H, D], k/v [B, T, Hkv, D], output in bf16;
// the same edge cases (below).
//
// Bound on this card: the operations, 4 * B * H * D * S(S+1)/2 for a causal
// prefill (two products per visible (query, key) pair), at the tensor
// cores' bf16 rate of 989 TFLOP/s; the bytes (q, k, v read once, the output
// written once) are far below it.  What the design does about the limits of
// the first, CUDA-core kernel:
//
//   * fp32 fmaf on the CUDA cores (67 TFLOP/s) -> bf16 wgmma on the tensor
//     cores, fp32 accumulation.  S = Q K^T is m64n128k16 with both operands
//     read from shared memory through descriptors (K is K-major as it lies
//     in memory); O += P V takes P from registers as the A operand and V
//     from shared memory with the transpose-B bit (its N = d axis is the
//     contiguous one).  No operand is transposed or copied.
//   * An inner loop bound by shared loads, P's round trip through shared
//     memory -> the score tile S stays in the wgmma accumulator registers:
//     the online softmax runs on that fragment (each thread holds parts of
//     2 rows, reduced over the 4 threads of a quad), and P is converted to
//     bf16 in registers, where the accumulator layout of an m64n128 tile is
//     the A-operand layout of the next product.
//   * Synchronous scalar loads -> TMA: one thread of the producer warpgroup
//     brings each tile in with cp.async.bulk.tensor through a 4-D tensor
//     map over the tensor's own [B, S, H, D] layout (d, heads, positions,
//     batch; a box of one head, 128-byte swizzle, so a d = 128 row is two
//     64-column boxes), zero-filling rows past S or T.  K and V tiles go
//     through a 2-stage ring, each on its own full/empty mbarrier, so the
//     loads of tile j+1 overlap the products and softmax of tile j.
//   * Nothing overlapping the softmax -> each consumer issues S_{j+1} =
//     Q K_{j+1} and O += P_j V_j back to back, and runs the softmax of
//     tile j+1 while P_j V_j is on the tensor cores (one S, one P and one
//     O fragment live); the two consumer warpgroups fall into alternating
//     phases by themselves (a ping-pong barrier between them measured no
//     gain).
//   * Low occupancy and spills -> one CTA of 384 threads an SM; setmaxnreg
//     gives the producer warpgroup 24 registers and each consumer 240.
//   * One short CTA after another (the 128-row q tiles of a 1,024-token
//     prefill visit 4.5 kv tiles on average, and each CTA paid its set-up,
//     the latency of its first loads and its epilogue alone) -> persistent
//     CTAs, one an SM, walking the work tiles longest first in a snake
//     order that evens out each CTA's share; Q is double-buffered and the
//     K/V ring runs on across work tiles, so the next tile's loads land
//     while the current one computes.
//
// Numerics: products of bf16 inputs are exact in fp32, only the order of
// summation differs from the plain version.  The scale is applied to the
// fp32 scores after the product, folded with log2(e) (one multiply, or one
// fmaf with the row max on tiles that need no mask, before ex2.approx),
// never to q in bf16.  P is rounded to bf16 for the P V product (at most
// 2^-9 relative on each weight); the row sum l adds the fp32 P.  Out =
// O * (1 / max(l, 1e-20)), rounded to bf16.
//
// Edge cases, as the fp32 kernel: d_head 64 and 128; any S and T (ragged
// tails: TMA zero-fills the rows, the stores skip rows past S); a masked
// column scores -1e30 and a column past T scores -inf, and m starts at
// -1e30, so a fully masked tile never computes -inf - (-inf) and a row
// whose first tiles are all masked is wiped by its first real score; kv
// tiles are skipped as the Pallas kernel skips blocks (causal: past the q
// tile's last row; chunked-local: outside its rows' chunks), except that a
// q tile holding a row whose chunk starts at or past T (no key; only when
// T < S) skips none, so that row averages V over all T keys as the
// reference does; masking runs only on the tiles that cross the diagonal,
// a chunk boundary or T; work tiles are taken longest row first; positions
// count from 0 for q and k.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include "launch_count.cuh"

REPRO_LAUNCH_COUNTER(repro_launches_flash_attention_sm90)

namespace {

constexpr int BQ = 128;       // q rows per CTA, 64 per consumer warpgroup
constexpr int BKV = 128;      // kv rows per tile
constexpr int STAGES = 2;     // the K/V ring
constexpr int QBUFS = 2;      // Q buffers: the next work tile's loads early
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int BOX = 64;       // bf16 columns of one 128-byte swizzled box
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory: two Q buffers [D/64 boxes][128 rows][128 B], then the K
// ring and the V ring, [STAGES][D/64 boxes][128 rows][128 B] each, then the
// mbarriers; every tile starts on a 1024-byte boundary (the 128-byte
// swizzle's period).
template <int D>
struct Smem {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int K_OFF = QBUFS * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int N_BARS = 2 * QBUFS + 4 * STAGES;
  static constexpr int ALLOC = BAR_OFF + 8 * N_BARS + 1024;  // + alignment
};
// barriers: per Q buffer full and empty, then per ring stage K full, V
// full, K empty, V empty
__host__ __device__ constexpr int bar_qfull(int s) { return s; }
__host__ __device__ constexpr int bar_qempty(int s) { return QBUFS + s; }
__host__ __device__ constexpr int bar_kfull(int s) { return 2 * QBUFS + s; }
__host__ __device__ constexpr int bar_vfull(int s) {
  return 2 * QBUFS + STAGES + s;
}
__host__ __device__ constexpr int bar_kempty(int s) {
  return 2 * QBUFS + 2 * STAGES + s;
}
__host__ __device__ constexpr int bar_vempty(int s) {
  return 2 * QBUFS + 3 * STAGES + s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (d, head, position, batch) into shared memory,
// completing `bytes` on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int head,
                                         int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head),
      "r"(pos), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128B).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Tie registers to this point, so the compiler neither reads an
// accumulator before the wait that completes it nor reuses an operand
// register while a wgmma may still read it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define F8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define F32 F8(0), F8(8), F8(16), F8(24)
#define F64 F32, F8(32), F8(40), F8(48), F8(56)
#define R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define R64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d[64x128] (+)= A[64x16] B[16x128], both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 0;\n\t}"
      : F64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64xN] += A[64x16] (registers) B[16xN] (shared memory, N contiguous:
// the transpose-B bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
      : F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the MUFU unit, subnormal results flushed to 0 (weights below
// 2^-126 of the row's largest).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Issue S = Q K^T for the warpgroup's 64 q rows (q_rows) against a K tile:
// D / 16 steps of k16, each 32 bytes further along the swizzled 128-byte
// row, or into the next box.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BKV / 2],
                                         uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n128(sc,
                  desc_sw128(q_rows + (kk / 4) * BQ * 128 + off, 16, 1024),
                  desc_sw128(k_tile + (kk / 4) * BKV * 128 + off, 16, 1024),
                  kk > 0);
  }
}

// Issue O += P V: BKV / 16 steps of k16, 16 kv rows (2048 bytes) each; V's
// d axis crosses boxes at the leading byte offset.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BKV / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_rs(o, pa[kk], desc_sw128(v_tile + kk * 16 * 128, BKV * 128, 1024));
}

// The online softmax of one score tile on its accumulator fragment: rows
// 0 (elements 4j, 4j+1) and 1 (4j+2, 4j+3) of this thread, reduced over
// the quad.  Leaves P (fp32) in sc, updates m and this thread's part of l,
// and returns the rescale factors of O in alpha.  In the log2 domain:
// x = s * scale_log2; a tile that crosses the diagonal, a chunk boundary
// or T first masks (-1e30 outside [lo, hi), -inf past T); any other skips
// the index arithmetic and folds the scale into one fmaf.
__device__ __forceinline__ void softmax_tile(float (&sc)[BKV / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool masked,
                                             int k0, int T_len,
                                             const int (&lo)[2],
                                             const int (&hi)[2], int col0,
                                             float scale_log2) {
  float mx[2], rs[2] = {0.f, 0.f};
  if (masked) {
    mx[0] = m[0];
    mx[1] = m[1];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, col = k0 + 8 * j + col0 + (e & 1);
        float& x = sc[4 * j + e];
        x = col >= T_len
                ? -CUDART_INF_F
                : (col >= lo[r] && col < hi[r] ? x * scale_log2 : NEG);
        mx[r] = fmaxf(mx[r], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      sc[i] = ex2(sc[i] - mx[(i / 2) % 2]);
      rs[(i / 2) % 2] += sc[i];
    }
  } else {
    // scaling is monotone, so the max of the raw scores scales to the max
    // of the scaled ones
    mx[0] = mx[1] = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      sc[i] = ex2(fmaf(sc[i], scale_log2, -mx[(i / 2) % 2]));
      rs[(i / 2) % 2] += sc[i];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// P in bf16 as the A fragment of P V: k16 step kk takes accumulator
// elements 8kk .. 8kk + 7 in order.
__device__ __forceinline__ void to_bf16(uint32_t (&pa)[BKV / 16][4],
                                        const float (&sc)[BKV / 2]) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a)
      pa[kk][a] = pack_bf16(sc[8 * kk + 2 * a], sc[8 * kk + 2 * a + 1]);
}

// One work tile: batch b, q head h (kv head hk), q rows [q0, q0 + 128) and
// the kv tiles [kt_lo, kt_lo + n_tiles) they visit.  Work w counts q tiles
// longest row first, then batch and head: neighbouring CTAs take the heads
// that share a kv head at the same time.
struct Work {
  int b, h, hk, q0, kt_lo, n_tiles;
};

__device__ __forceinline__ Work work_tile(int w, int S, int T_len, int H,
                                          int Hkv, int BH, int n_qt,
                                          int causal, int chunk) {
  Work t;
  const int bh = w % BH;
  t.b = bh / H;
  t.h = bh % H;
  t.hk = t.h / (H / Hkv);
  t.q0 = (n_qt - 1 - w / BH) * BQ;
  const int q_last = min(S, t.q0 + BQ) - 1;
  int kt_lo = 0, kt_hi = (T_len - 1) / BKV;
  if (causal) kt_hi = min(kt_hi, q_last / BKV);
  // chunks start in row order, so a row of the tile sees no key iff the
  // last row's chunk starts at or past T; such a tile visits every kv tile
  if (chunk > 0 && (q_last / chunk) * chunk < T_len) {
    kt_lo = max(kt_lo, (t.q0 / chunk) * chunk / BKV);
    kt_hi = min(kt_hi, ((q_last / chunk + 1) * chunk - 1) / BKV);
  }
  t.kt_lo = kt_lo;
  t.n_tiles = kt_hi - kt_lo + 1;
  return t;
}

// The k-th work tile of CTA c among G: round k of the work tiles, taken
// in a snake order (c on even rounds, G - 1 - c on odd), so that each CTA's
// share of tiles sorted longest first comes out even.
__device__ __forceinline__ int snake(int k, int c, int G) {
  return k * G + ((k & 1) ? G - 1 - c : c);
}

// Persistent: grid min(work tiles, SMs), 384 threads, Smem<D>::ALLOC bytes
// of dynamic shared memory; CTA c takes work tiles snake(0, c, grid),
// snake(1, c, grid), ... while they exist.
// scale_log2 = d_head^-0.5 * log2(e).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                __nv_bfloat16* __restrict__ out, int B, int S,
                                int T_len, int H, int Hkv, int causal,
                                int chunk, float scale_log2) {
  count_launch();
  using L = Smem<D>;
  constexpr int NB = D / BOX;        // boxes per row
  constexpr int BOX_Q = BQ * 128;    // bytes of one Q box
  constexpr int BOX_KV = BKV * 128;  // bytes of one K or V box
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  auto bar = [bars](int i) { return bars + 8u * (uint32_t)i; };
  const int BH = B * H, n_qt = (S + BQ - 1) / BQ, n_work = BH * n_qt;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < QBUFS; ++s) {
      mbar_init(bar(bar_qfull(s)), 1);
      mbar_init(bar(bar_qempty(s)), 8);  // one arrival per consumer warp
    }
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(bar_kfull(s)), 1);
      mbar_init(bar(bar_vfull(s)), 1);
      mbar_init(bar(bar_kempty(s)), 8);
      mbar_init(bar(bar_vempty(s)), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Q buffer j % QBUFS serves this CTA's j-th work tile, ring stage
  // it % STAGES its it-th kv tile over all its work tiles; a barrier's
  // phase parity is the use count's bit (the producer's first round of
  // waits on empty buffers passes at once)
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int j = 0, w = blockIdx.x; w < n_work;
           w = snake(++j, blockIdx.x, gridDim.x)) {
        const Work t =
            work_tile(w, S, T_len, H, Hkv, BH, n_qt, causal, chunk);
        const int qs = j % QBUFS;
        mbar_wait(bar(bar_qempty(qs)), ((j / QBUFS) & 1) ^ 1);
        mbar_expect_tx(bar(bar_qfull(qs)), L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load(sQ + qs * L::Q_BYTES + c * BOX_Q, &tm_q,
                   bar(bar_qfull(qs)), c * BOX, t.h, t.q0, t.b);
        for (int i = 0; i < t.n_tiles; ++i, ++it) {
          const int s = it % STAGES;
          const uint32_t parity = ((it / STAGES) & 1) ^ 1;
          const int k0 = (t.kt_lo + i) * BKV;
          mbar_wait(bar(bar_kempty(s)), parity);
          mbar_expect_tx(bar(bar_kfull(s)), L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < NB; ++c)
            tma_load(sK + s * L::KV_BYTES + c * BOX_KV, &tm_k,
                     bar(bar_kfull(s)), c * BOX, t.hk, k0, t.b);
          mbar_wait(bar(bar_vempty(s)), parity);
          mbar_expect_tx(bar(bar_vfull(s)), L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < NB; ++c)
            tma_load(sV + s * L::KV_BYTES + c * BOX_KV, &tm_v,
                     bar(bar_vfull(s)), c * BOX, t.hk, k0, t.b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg - 1 owns q rows [q0 + 64 (wg - 1),
    // q0 + 64 wg) of each work tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    // this thread's two rows of the accumulator fragment (offsets from the
    // warpgroup's first row) and its columns 8j + 2 (lane % 4) + {0, 1} of
    // each 8-column group j
    const int row_off = 64 * (wg - 1) + 16 * warp + lane / 4;
    const int col0 = 2 * (lane % 4);
    auto release = [&](int id) {  // one arrival per warp
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(id));
    };
    float o[D / 2], sc[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
    uint32_t pa[BKV / 16][4];

    int it = 0;
    for (int j = 0, w = blockIdx.x; w < n_work;
           w = snake(++j, blockIdx.x, gridDim.x)) {
      const Work t = work_tile(w, S, T_len, H, Hkv, BH, n_qt, causal, chunk);
      const int qs = j % QBUFS;
      const int r0 = t.q0 + 64 * (wg - 1);
      const int row[2] = {t.q0 + row_off, t.q0 + row_off + 8};
      // the keys [lo, hi) each row may see
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lo[r] = chunk > 0 ? (row[r] / chunk) * chunk : 0;
        hi[r] = causal ? row[r] + 1 : T_len;
        if (chunk > 0) hi[r] = min(hi[r], lo[r] + chunk);
      }
      // this warpgroup's rows all see every column of a kv tile iff the
      // tile crosses neither the diagonal, a chunk boundary nor T
      const int chunk_r0 = chunk > 0 ? r0 / chunk : 0;
      const bool rows_one_chunk = chunk <= 0 || (r0 + 63) / chunk == chunk_r0;
      auto crosses = [&](int k0) {
        return k0 + BKV > T_len || (causal && k0 + BKV - 1 > r0) ||
               (chunk > 0 && !(rows_one_chunk && k0 / chunk == chunk_r0 &&
                               (k0 + BKV - 1) / chunk == chunk_r0));
      };
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this thread's part
      float alpha[2];
      const uint32_t q_rows = sQ + qs * L::Q_BYTES + (wg - 1) * 64 * 128;

      // kv tile 0: S alone
      const int k00 = t.kt_lo * BKV;
      mbar_wait(bar(bar_qfull(qs)), (j / QBUFS) & 1);
      mbar_wait(bar(bar_kfull(it % STAGES)), (it / STAGES) & 1);
      wgmma_fence();
      issue_qk<D>(sc, q_rows, sK + (it % STAGES) * L::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      release(bar_kempty(it % STAGES));
      if (t.n_tiles == 1) release(bar_qempty(qs));
      softmax_tile(sc, m, l, alpha, crosses(k00), k00, T_len, lo, hi, col0,
                   scale_log2);
      to_bf16(pa, sc);

      // kv tile i: S_i = Q K_i and O += P_{i-1} V_{i-1} issued back to
      // back; the softmax of S_i runs while P_{i-1} V_{i-1} is on the
      // tensor cores
      for (int i = 1; i < t.n_tiles; ++i) {
        const int s = (it + i) % STAGES, ps = (it + i - 1) % STAGES;
        const int k0 = (t.kt_lo + i) * BKV;
        mbar_wait(bar(bar_kfull(s)), ((it + i) / STAGES) & 1);
        mbar_wait(bar(bar_vfull(ps)), ((it + i - 1) / STAGES) & 1);
        wgmma_fence();
        issue_qk<D>(sc, q_rows, sK + s * L::KV_BYTES);
        wgmma_commit();
        issue_pv<D>(o, pa, sV + ps * L::KV_BYTES);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
        release(bar_kempty(s));
        if (i == t.n_tiles - 1) release(bar_qempty(qs));
        softmax_tile(sc, m, l, alpha, crosses(k0), k0, T_len, lo, hi, col0,
                     scale_log2);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        release(bar_vempty(ps));
#pragma unroll
        for (int jj = 0; jj < D / 2; ++jj) o[jj] *= alpha[(jj / 2) % 2];
        to_bf16(pa, sc);
      }

      // the last kv tile's P V
      it += t.n_tiles;
      const int ls = (it - 1) % STAGES;
      mbar_wait(bar(bar_vfull(ls)), ((it - 1) / STAGES) & 1);
      wgmma_fence();
      issue_pv<D>(o, pa, sV + ls * L::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(bar_vempty(ls));

      // out = O / max(l, 1e-20) in bf16, through one reciprocal per row
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(quad_sum(l[r]), 1e-20f);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= S) continue;
        __nv_bfloat16* dst =
            out + (((int64_t)t.b * S + row[r]) * H + t.h) * D + col0;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
              pack_bf16(o[4 * jj + 2 * r] * inv[r],
                        o[4 * jj + 2 * r + 1] * inv[r]);
      }
    }
  }
}

#undef F8
#undef F32
#undef F64
#undef R32
#undef R64

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (d, heads, positions, batch) of a contiguous bf16 tensor
// [batch, positions, heads, d]; a box is 64 columns of one head over `rows`
// positions, swizzled by 128 bytes; rows past `positions` read as zeros.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D,
              int heads, int positions, int batch, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)positions, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)positions * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int T_len, int H, int Hkv, int causal,
                   int chunk, float scale, cudaStream_t st) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, q, D, H, S, B, BQ) ||
      !make_map(enc, &tk, k, D, Hkv, T_len, B, BKV) ||
      !make_map(enc, &tv, v, D, Hkv, T_len, B, BKV))
    return cudaErrorInvalidValue;
  const int smem = Smem<D>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_sm90<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // the work tile counter (and the snake order's last round, up to sms - 1
  // past it) stays an int
  const int64_t n_work = (int64_t)B * H * ((S + BQ - 1) / BQ);
  if (n_work + sms > INT32_MAX) return cudaErrorInvalidValue;
  const int grid = (int)(n_work < sms ? n_work : sms);
  flash_attention_kernel_sm90<D><<<grid, THREADS, (size_t)smem, st>>>(
      tq, tk, tv, (__nv_bfloat16*)out, B, S, T_len, H, Hkv, causal, chunk,
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// The bf16 path of repro_flash_attention (csrc/flash_attention.cu), which
// has checked the shapes: q [B, S, H, D], k/v [B, T, Hkv, D] -> out
// [B, S, H, D], all bf16, contiguous, q, k and v 16-byte aligned.
cudaError_t flash_attention_bf16_sm90(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int T_len, int H, int Hkv, int D,
                                      int causal, int chunk, float scale,
                                      cudaStream_t st) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorInvalidValue;
  return D == 64 ? launch<64>(q, k, v, out, B, S, T_len, H, Hkv, causal,
                              chunk, scale, st)
                 : launch<128>(q, k, v, out, B, S, T_len, H, Hkv, causal,
                               chunk, scale, st);
}

// Bytes of dynamic shared memory the kernel of this d_head takes (0 for a
// d_head it does not take).
extern "C" int repro_flash_attention_sm90_smem(int D) {
  return D == 64 ? Smem<64>::ALLOC : D == 128 ? Smem<128>::ALLOC : 0;
}
