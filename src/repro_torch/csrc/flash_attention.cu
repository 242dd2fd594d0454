// Causal grouped-query flash attention (the LM prefill) on Hopper: the fp32
// kernel on the CUDA cores, and the C entry of both paths (bf16 inputs go to
// the tensor-core kernel of csrc/flash_attention_sm90.cu).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas, the TPU kernel whose grid (batch, q head, q block,
// kv block) walks the kv blocks in order on one core, carrying the online
// softmax state (m, l, acc) in VMEM scratch from one grid step to the next,
// and skipping kv blocks that the causal or chunked-local mask hides
// entirely.  Hopper runs blocks in parallel and in no order, so nothing
// carries over between blocks: here one block owns one (batch, q head,
// 64-row q tile) and a loop inside it takes the place of the sequential kv
// axis.
//
//   * The q tile is staged once in shared memory as fp32, scaled by
//     d_head^-0.5 as the Pallas kernel scales it; each kv tile (64 rows of K
//     and V of the q head's kv head h / G) is staged in turn.
//   * 256 threads as 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3 of the
//     tile and, of the 64 x 64 score tile, columns tx + 16j; of the output,
//     columns tx + 16j of its 4 rows (d_head / 16 each), in registers.
//   * Online softmax in fp32 registers: a row's max and sum reduce over the
//     16 lanes that share it (shuffles inside a half warp).  Sums are cut
//     short for accuracy, as the plain version's blocked products are: a
//     score sums the two halves of d in two chains, and each kv tile's P V
//     is summed alone before acc = acc * alpha + it.  A column that
//     the mask hides scores -1e30, as in the reference, so a row whose
//     first visited tile is all masked carries m = -1e30 and l = its count
//     until a real score arrives, and exp(-1e30 - m) = 0 then wipes them;
//     a column past the ragged end of T scores -inf and weighs 0.
//   * Tiles skipped as the Pallas kernel skips blocks: causal drops the kv
//     tiles wholly past the q tile's last row, chunked-local those wholly
//     outside its rows' chunks, so chunked layers cost O(S * chunk).  A row
//     whose chunk holds no key at all (its chunk starts at or past T, so
//     only when T < S) scores -1e30 on every column, and the reference then
//     averages V over all T keys; a q tile holding such a row skips no kv
//     tile, so that m stays -1e30, every column weighs exp(0) = 1 and the
//     row gets that average too.
//   * Ragged q and kv tails are masked here, so any S and T work; the TPU
//     kernel asks S % bq == T % bkv == 0.
//   * The q tiles of a (batch, head) launch longest-row first.
//
// Bound on this card: the causal operations, 4 * B * H * D * S(S+1)/2 (two
// products per visible (query, key) pair), against the tensor cores' bf16
// rate; the bytes (q, k, v read once, the output written once) are far
// below it.  This kernel computes in fp32 on the CUDA cores, every product
// an explicit fmaf (the global --fmad=false of kernels/_build.py would
// otherwise split each into a multiply and an add), so it sits far above
// that bound; it serves fp32 inputs, whose contract (2e-6 of the exact
// function) no bf16 or TF32 tensor-core product can meet.
//
// Contract: q [B, S, H, D], k and v [B, T, Hkv, D], contiguous, all fp32
// with D in {32, 64, 128}, or (the sm90 kernel) all bf16 with D in {64,
// 128} (the wrapper zero-pads a bf16 head of 32 to 64 and passes the true
// scale); H % Hkv == 0; out [B, S, H, D] in q's type.  Positions count from 0 for both q and k (the prefill at
// offset 0).
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>
#include "launch_count.cuh"

// csrc/flash_attention_sm90.cu: the bf16 path (wgmma fed by TMA)
cudaError_t flash_attention_bf16_sm90(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int T_len, int H, int Hkv, int D,
                                      int causal, int chunk, float scale,
                                      cudaStream_t st);

REPRO_LAUNCH_COUNTER(repro_launches_flash_attention)

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BKV = 64;       // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int LDP = BKV + 1;  // padded: two row groups of a warp, two banks
constexpr float NEG = -1e30f;

template <int D>
constexpr int smem_floats() {
  // Qs [BQ][D + 1], Ks [BKV][D + 1], Vs [BKV][D], Ps [BQ][LDP]
  return BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * LDP;
}

// Rows [row0, row0 + 64) of a matrix whose row r starts at src + r * stride
// into dst [64][ld] as fp32 times mul; rows at or past n_rows are zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int64_t stride, int row0,
                                          int n_rows, float mul) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D, row = row0 + r;
    dst[r * ld + c] =
        row < n_rows ? src[(int64_t)row * stride + c] * mul : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (ceil(S / 64), H, B); dynamic shared memory smem_floats<D>() floats.
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int S,
                       int T_len, int H, int Hkv, int causal, int chunk,
                       float scale) {
  count_launch();
  constexpr int LDQ = D + 1, LDK = D + 1, LDV = D, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BKV * LDK;
  float* Ps = Vs + BKV * LDV;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * BQ;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
  const float* qb = q + ((int64_t)b * S * H + h) * D;
  const float* kb = k + ((int64_t)b * T_len * Hkv + hk) * D;
  const float* vb = v + ((int64_t)b * T_len * Hkv + hk) * D;

  load_tile<D>(Qs, LDQ, qb, q_stride, q0, S, scale);

  const int q_last = min(S, q0 + BQ) - 1;
  int kt_lo = 0, kt_hi = (T_len + BKV - 1) / BKV - 1;
  if (causal) kt_hi = min(kt_hi, q_last / BKV);
  // chunks start in row order, so a row of the tile sees no key iff the
  // last row's chunk starts at or past T; such a tile visits every kv tile
  if (chunk > 0 && (q_last / chunk) * chunk < T_len) {
    kt_lo = max(kt_lo, (q0 / chunk) * chunk / BKV);
    kt_hi = min(kt_hi, ((q_last / chunk + 1) * chunk - 1) / BKV);
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the last tile's Ks, Vs and Ps are consumed
    load_tile<D>(Ks, LDK, kb, kv_stride, k0, T_len, 1.f);
    load_tile<D>(Vs, LDV, vb, kv_stride, k0, T_len, 1.f);
    __syncthreads();

    // scores: the two halves of d in two chains, added at the end
    float s[4][4], s2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = s2[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D / 2; ++d) {
      float a[4], c[4], a2[4], c2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * LDQ + d];
        a2[i] = Qs[(ty * 4 + i) * LDQ + d + D / 2];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = Ks[(tx + 16 * j) * LDK + d];
        c2[j] = Ks[(tx + 16 * j) * LDK + d + D / 2];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          s2[i][j] = fmaf(a2[i], c2[j], s2[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += s2[i][j];

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = (!causal || col <= row) &&
                        (chunk <= 0 || col / chunk == row / chunk);
        s[i][j] = col >= T_len ? -CUDART_INF_F : (ok ? s[i][j] : NEG);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = s[i][j];
      }
      l[i] = l[i] * alpha[i] + half_warp_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();

    // the tile's P V in a fresh sum, then acc = acc * alpha + it: a row's
    // keys are summed in tiles of 64, not in one chain of up to S
    float t[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) t[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = Vs[c * LDV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) t[i][j] = fmaf(p[i], vv, t[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j)
        acc[i][j] = fmaf(acc[i][j], alpha[i], t[i][j]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-20f);
    float* o = out + ((int64_t)b * S + row) * q_stride + (int64_t)h * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) o[tx + 16 * j] = acc[i][j] / den;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int T_len, int H, int Hkv, int causal,
                   int chunk, float scale, cudaStream_t st) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned int)((S + BQ - 1) / BQ), (unsigned int)H,
                  (unsigned int)B);
  flash_attention_kernel<D><<<grid, THREADS, (size_t)smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S,
      T_len, H, Hkv, causal, chunk, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, S, H, D], k/v [B, T, Hkv, D] -> out [B, S, H, D]; is_bf16 selects
// bf16 for all four (the sm90 kernel; q, k, v 16-byte aligned), else fp32;
// causal 0/1; chunk 0 = no chunked-local mask.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int T_len, int H, int Hkv, int D,
                                     int causal, int chunk, int is_bf16,
                                     float scale, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || T_len < 1 || H < 1 || H > 65535 ||
      Hkv < 1 || H % Hkv != 0 || chunk < 0 ||
      (D != 64 && D != 128 && (D != 32 || is_bf16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return (int)flash_attention_bf16_sm90(q, k, v, out, B, S, T_len, H, Hkv,
                                          D, causal, chunk, scale, st);
  switch (D) {
    case 32:
      return (int)launch<32>(q, k, v, out, B, S, T_len, H, Hkv, causal,
                             chunk, scale, st);
    case 64:
      return (int)launch<64>(q, k, v, out, B, S, T_len, H, Hkv, causal,
                             chunk, scale, st);
    default:
      return (int)launch<128>(q, k, v, out, B, S, T_len, H, Hkv, causal,
                              chunk, scale, st);
  }
}
