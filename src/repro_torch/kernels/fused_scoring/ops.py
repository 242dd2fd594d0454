"""Wrapper of the fused-scoring kernel (``csrc/fused_scoring.cu``).

For a CUDA tensor it launches the kernel; for a CPU tensor it takes the
plain version.  There is no fallback from a failed launch: it raises.
``fused_scoring.launches`` counts kernel launches, and only those.
In a pricing run (``kernels/pricing.py``) a call is priced by :func:`cost`
and launches nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_scoring.ref import fused_scoring_ref
from repro_torch.kernels.pricing import priced

#: model id order used by the kernel (its ``model_code`` packs these ids)
SUPPORTED = ("BM25", "TF_IDF", "QL", "DPH", "Coord")
#: fp32 operations per posting for each model, counted from the model
#: lines of csrc/fused_scoring.cu (adds, multiplies, divides, min/max and
#: transcendental calls each count one)
MODEL_OPS = {"BM25": 12, "TF_IDF": 8, "QL": 12, "DPH": 23, "Coord": 1}


def models_supported(models) -> bool:
    """Whether every weighting model has a kernel implementation — the
    eligibility predicate the IR fusion pass (core/passes.py) consults
    before lowering a scorer→cutoff chain onto this kernel."""
    return all(m in SUPPORTED for m in models)


def cost(tf, dl, df, cf, *, models: tuple[str, ...],
         stats: dict) -> tuple[float, float]:
    """(flops, bytes) of one call: tf, dl, df and cf read once, the
    [..., F] f32 scores written once, ``MODEL_OPS`` a posting per model."""
    n = tf.numel()
    read = sum(x.numel() * x.element_size() for x in (tf, dl, df, cf))
    return (float(n * sum(MODEL_OPS[m] for m in models)),
            float(read + n * len(models) * 4))


def _outputs(tf, dl, df, cf, *, models: tuple[str, ...], stats: dict):
    return torch.zeros((*tf.shape, len(models)), dtype=torch.float32,
                       device=tf.device)


@priced(cost, _outputs)
def fused_scoring(tf, dl, df, cf, *, models: tuple[str, ...], stats: dict):
    """Postings columns tf, dl [..., L] int32 -> [..., L, F] f32 multi-model
    scores (one read of each posting), 0 where ``tf == 0``.

    ``df`` and ``cf`` have tf's shape, or hold one value per row of tf's
    last axis (shape [..., 1]): the term's statistics, which the kernel
    reads once per row instead of once per posting."""
    if not models or not models_supported(models):
        raise ValueError(f"unsupported models {models!r}; kernel has {SUPPORTED}")
    shape = tuple(tf.shape)
    per_row = (*shape[:-1], 1)
    if tuple(dl.shape) != shape or not (
            tuple(df.shape) == tuple(cf.shape) and tuple(df.shape) in
            (shape, per_row)):
        raise ValueError(f"tf, dl must share a shape and df, cf be of it or "
                         f"of {per_row}: got {tuple(tf.shape)}, "
                         f"{tuple(dl.shape)}, {tuple(df.shape)}, "
                         f"{tuple(cf.shape)}")
    kw = dict(models=tuple(models), n_docs=stats["n_docs"],
              avg_dl=stats["avg_doclen"], total_terms=stats["total_terms"])
    if not tf.is_cuda:
        return fused_scoring_ref(tf, dl, df, cf, **kw)
    cols = [x.reshape(-1).to(torch.int32).contiguous() for x in (tf, dl, df, cf)]
    if any(c.device != cols[0].device for c in cols):
        raise ValueError("tf, dl, df, cf must lie on one device")
    n = cols[0].numel()
    group = 1 if tuple(df.shape) == shape else shape[-1]
    out = torch.empty((*shape, len(models)), dtype=torch.float32,
                      device=cols[0].device)
    code = 0
    for j, m in enumerate(models):
        code |= SUPPORTED.index(m) << (4 * j)
    if n:
        n_docs, total = float(stats["n_docs"]), float(stats["total_terms"])
        err = _build.library().repro_fused_scoring(
            *(c.data_ptr() for c in cols), n, group, code, len(models),
            n_docs, float(stats["avg_doclen"]), total, total / n_docs,
            out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream)
        _build.check(err, "repro_fused_scoring")
        fused_scoring.launches += 1
    return out


fused_scoring.launches = 0
