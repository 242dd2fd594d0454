// Single-pass multi-model postings scoring (fat postings, RQ2) on Hopper.
//
// Replaces: src/repro/kernels/fused_scoring/fused_scoring.py::
// fused_scoring_pallas, the TPU kernel that reads a 2048-row VMEM tile of
// (tf, dl, df, cf) once and writes every weighting model's score for it.
//
// Bound on this card: bytes.  Each posting reads its tf and dl (int32) and
// writes F floats, N * (8 + 4F) bytes, plus the df and cf of its term,
// which the main path passes once per posting list (``group`` postings
// share one) rather than copied out to every posting; the math is a few
// dozen fp32 operations and three transcendental calls per model, far
// below the card's fp32 rate per byte.  So the design is the plainest
// elementwise pass: one thread per posting (grid-stride), coalesced column
// reads, the term statistics read through the cache (neighbouring threads
// share them), all F models computed from the registers holding one
// posting, and the F outputs of neighbouring threads written to one
// contiguous range.  Fusing the postings gather and the scatter-add that
// follow into this pass is a later redesign.
//
// Numerics: the model math follows src/repro/index/scoring.py operation by
// operation in fp32 with the accurate logf/log1pf/log2f, built without
// fast math and without FMA contraction (rtol 2e-5 / atol 1e-5 contract).
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include "launch_count.cuh"

REPRO_LAUNCH_COUNTER(repro_launches_fused_scoring)

namespace {

struct Stats {
  float n_docs, avg_dl, total_terms, avg_len;
};

// model ids: the order of SUPPORTED in kernels/fused_scoring/ops.py
enum Model { BM25 = 0, TF_IDF = 1, QL = 2, DPH = 3, COORD = 4 };

__device__ __forceinline__ float model_score(int model, float tf, float dl,
                                             float df, float cf,
                                             const Stats& st) {
  switch (model) {
    case BM25: {
      const float idf = log1pf((st.n_docs - df + 0.5f) / (df + 0.5f));
      const float denom = tf + 1.2f * (0.25f + 0.75f * dl / st.avg_dl);
      return idf * tf * 2.2f / fmaxf(denom, 1e-9f);
    }
    case TF_IDF: {
      const float idf = logf(st.n_docs / fmaxf(df, 1.0f));
      const float k = 1.2f * (0.25f + 0.75f * dl / st.avg_dl);
      return idf * tf / (tf + k);
    }
    case QL: {
      const float p_c = cf / st.total_terms;
      const float num = tf + 2500.0f * p_c;
      const float den = dl + 2500.0f;
      const float base = 2500.0f * p_c / fmaxf(den, 1.0f);
      return logf(fmaxf(num, 1e-20f) / fmaxf(den, 1.0f)) -
             logf(fmaxf(base, 1e-20f));
    }
    case DPH: {
      const float dl1 = fmaxf(dl, 1.0f);
      const float f = fminf(fmaxf(tf / dl1, 1e-9f), (float)(1.0 - 1e-9));
      const float norm = (1.0f - f) * (1.0f - f) / (tf + 1.0f);
      const float info =
          tf * log2f(fmaxf(tf * st.avg_len / dl1 * st.n_docs / fmaxf(cf, 1.0f),
                           1e-9f));
      const float bonus =
          0.5f * log2f((float)(2.0 * M_PI) * tf * (1.0f - f) + 1e-9f);
      return fmaxf(norm * (info + bonus), 0.0f);
    }
    case COORD:
      return tf > 0.0f ? 1.0f : 0.0f;
  }
  return 0.0f;
}

__global__ void fused_scoring_kernel(const int* __restrict__ tf,
                                     const int* __restrict__ dl,
                                     const int* __restrict__ df,
                                     const int* __restrict__ cf, int64_t n,
                                     int64_t group, int code, int n_models,
                                     Stats st, float* __restrict__ out) {
  count_launch();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float t = (float)tf[i];
    const float d = (float)dl[i];
    const int64_t row = group == 1 ? i : i / group;
    const float f = (float)__ldg(df + row);
    const float c = (float)__ldg(cf + row);
    for (int j = 0; j < n_models; ++j) {
      const int m = (code >> (4 * j)) & 15;
      out[i * n_models + j] = t > 0.0f ? model_score(m, t, d, f, c, st) : 0.0f;
    }
  }
}

}  // namespace

extern "C" int repro_fused_scoring(const int* tf, const int* dl, const int* df,
                                   const int* cf, int64_t n, int64_t group,
                                   int code, int n_models, float n_docs, float avg_dl,
                                   float total_terms, float avg_len,
                                   float* out, void* stream) {
  if (n < 1 || group < 1 || n % group != 0 || n_models < 1 || n_models > 5)
    return (int)cudaErrorInvalidValue;
  constexpr int THREADS = 256;
  const int64_t want = (n + THREADS - 1) / THREADS;
  const unsigned int blocks = (unsigned int)(want < 132 * 64 ? want : 132 * 64);
  const Stats st{n_docs, avg_dl, total_terms, avg_len};
  fused_scoring_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      tf, dl, df, cf, n, group, code, n_models, st, out);
  return (int)cudaGetLastError();
}
