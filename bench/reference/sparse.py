"""Plain retrieval: the weighting models as published (BM25 with k1 1.2,
b 0.75; TF-IDF with Robertson's tf; query likelihood with Dirichlet
smoothing, mu 2500, shifted so an absent term adds 0), scores summed over
a query's terms in their order, rankings descending with ties to the
lowest document id.  ``dtype`` is the precision every operation runs in:
float32 as the configuration states, or a lower one for the control."""
from __future__ import annotations

import math

import torch

from reference.postings import Postings

BM25_K1, BM25_B = 1.2, 0.75
QL_MU = 2500.0


def model_scores(model: str, tf, dl, df, cf, stats: dict,
                 dtype=torch.float32) -> torch.Tensor:
    """A term's contribution to each document's score, elementwise over
    tf, dl (document length), df, cf."""
    tf, dl = tf.to(dtype), dl.to(dtype)
    df, cf = torch.as_tensor(df).to(tf.device, dtype), \
        torch.as_tensor(cf).to(tf.device, dtype)
    n, avg = stats["n_docs"], stats["avg_doclen"]
    if model == "BM25":
        idf = torch.log1p((n - df + 0.5) / (df + 0.5))
        denom = tf + BM25_K1 * (1 - BM25_B + BM25_B * dl / avg)
        return idf * tf * (BM25_K1 + 1.0) / denom.clamp(min=1e-9)
    if model == "TF_IDF":
        idf = torch.log(n / df.clamp(min=1.0))
        k = 1.2 * (0.25 + 0.75 * dl / avg)
        return idf * tf / (tf + k)
    if model == "QL":
        p_c = cf / stats["total_terms"]
        num = tf + QL_MU * p_c
        den = dl + QL_MU
        base = QL_MU * p_c / den.clamp(min=1.0)
        return torch.log(num.clamp(min=1e-20) / den.clamp(min=1.0)) - \
            torch.log(base.clamp(min=1e-20))
    raise ValueError(f"no reference for weighting model {model!r}")


def dense_scores(post: Postings, terms, weights, model: str,
                 dtype=torch.float32) -> torch.Tensor:
    """[D] scores of one query (terms, weights: 1-d host sequences; -1
    pads), its terms' contributions added in query order."""
    out = torch.zeros(post.n_docs, dtype=dtype, device=post.doc.device)
    for t, w in zip(terms, weights):
        if t < 0 or w == 0:
            continue
        docs, tfs = post.term(int(t))
        if docs.numel() == 0:
            continue
        s = model_scores(model, tfs, post.doc_len[docs], post.df[t],
                         post.cf[t], post.stats(), dtype)
        out.index_add_(0, docs, s * torch.tensor(w, dtype=dtype,
                                                 device=out.device))
    return out


def ranked(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(docids [k], scores [k]): descending, ties to the lowest id."""
    s, idx = torch.sort(scores, descending=True, stable=True)
    return idx[:k], s[:k]


def doc_features(post: Postings, terms, weights, docids, model: str,
                 dtype=torch.float32) -> torch.Tensor:
    """[K] score of ``model`` for each of ``docids`` under the query."""
    out = torch.zeros(docids.shape[0], dtype=dtype, device=docids.device)
    d = docids.clamp(min=0)
    for t, w in zip(terms, weights):
        if t < 0 or w == 0:
            continue
        pdocs, ptfs = post.term(int(t))
        tf = torch.zeros_like(d)
        if pdocs.numel():
            at = torch.searchsorted(pdocs, d).clamp(max=pdocs.numel() - 1)
            tf = torch.where(pdocs[at] == d, ptfs[at], 0)
        s = model_scores(model, tf, post.doc_len[d], post.df[t], post.cf[t],
                         post.stats(), dtype)
        out += s * torch.tensor(w, dtype=dtype, device=out.device)
    return torch.where(docids >= 0, out, 0)


def relative_gap(a: torch.Tensor, b: torch.Tensor, scale) -> float:
    """max |a - b| / scale, 0 for empty inputs."""
    if a.numel() == 0:
        return 0.0
    gap = float((a.double() - b.double()).abs().max())
    return gap / max(float(scale), 1e-30) if math.isfinite(gap) else math.inf
