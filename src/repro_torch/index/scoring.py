"""Weighting models over gathered postings — BM25, TF.IDF, QL-Dirichlet, DPH,
CoordMatch — each with a block-level score upper bound for block-max pruning.

All functions are plain fp32 torch over tensors of (tf, doc_len) with
per-term (df, cf) broadcast alongside; collection stats enter as Python
scalars.  The multi-model single-pass evaluation used by the fat pipeline
is :func:`score_all` (one gather, F model scores) — the paper's RQ2 insight.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common import Registry

WEIGHTING_MODELS = Registry("weighting model")

# Default parameters (Terrier/Anserini defaults)
BM25_K1, BM25_B = 1.2, 0.75
QL_MU = 2500.0

_F32 = torch.float32


def _idf(df, n_docs):
    return torch.log1p((n_docs - df + 0.5) / (df + 0.5))


@WEIGHTING_MODELS.register("BM25")
def bm25(tf, doc_len, df, cf, stats):
    tf = tf.to(_F32)
    dl = doc_len.to(_F32)
    idf = _idf(df.to(_F32), stats["n_docs"])
    denom = tf + BM25_K1 * (1 - BM25_B + BM25_B * dl / stats["avg_doclen"])
    return idf * tf * (BM25_K1 + 1.0) / denom.clamp(min=1e-9)


@WEIGHTING_MODELS.register("TF_IDF")
def tf_idf(tf, doc_len, df, cf, stats):
    tf = tf.to(_F32)
    idf = torch.log(stats["n_docs"] / df.to(_F32).clamp(min=1.0))
    # Robertson's TF with length normalisation
    k = 1.2 * (0.25 + 0.75 * doc_len.to(_F32) / stats["avg_doclen"])
    return idf * tf / (tf + k)


@WEIGHTING_MODELS.register("QL")
def ql_dirichlet(tf, doc_len, df, cf, stats):
    """Query likelihood w/ Dirichlet smoothing (log-space, shifted so that
    tf=0 contributes 0 — rank-equivalent and sparse-friendly)."""
    tf = tf.to(_F32)
    dl = doc_len.to(_F32)
    p_c = cf.to(_F32) / stats["total_terms"]
    num = tf + QL_MU * p_c
    den = dl + QL_MU
    base = QL_MU * p_c / den.clamp(min=1.0)
    return torch.log(num.clamp(min=1e-20) / den.clamp(min=1.0)) - \
        torch.log(base.clamp(min=1e-20))


@WEIGHTING_MODELS.register("DPH")
def dph(tf, doc_len, df, cf, stats):
    tf = tf.to(_F32)
    dl = doc_len.to(_F32).clamp(min=1.0)
    f = (tf / dl).clamp(1e-9, 1.0 - 1e-9)
    norm = (1.0 - f) ** 2 / (tf + 1.0)
    avg = stats["total_terms"] / stats["n_docs"]
    info = tf * torch.log2((
        tf * avg / dl * stats["n_docs"] / cf.to(_F32).clamp(min=1.0)
    ).clamp(min=1e-9))
    bonus = 0.5 * torch.log2(2.0 * math.pi * tf * (1.0 - f) + 1e-9)
    return (norm * (info + bonus)).clamp(min=0.0)


@WEIGHTING_MODELS.register("Coord")
def coord(tf, doc_len, df, cf, stats):
    """Coordination level match (# matching terms)."""
    return (tf > 0).to(_F32)


def upper_bound(model: str, block_max_tf, block_min_dl, df, cf, stats):
    """Per-block score upper bound: evaluate the model at the block's most
    favourable (tf, dl) corner.  Monotone in tf and anti-monotone in dl for
    all registered models."""
    return WEIGHTING_MODELS[model](block_max_tf, block_min_dl, df, cf, stats)


def score_all(models, tf, doc_len, df, cf, stats) -> torch.Tensor:
    """Single-pass multi-model scoring: [..] inputs -> [.., F] scores."""
    outs = [WEIGHTING_MODELS[m](tf, doc_len, df, cf, stats) for m in models]
    return torch.stack(outs, dim=-1)
