"""The reference's interpreter of a pipeline tree (``pipeline.Node``) for
one query: each stage as its plain semantics define it, on the
benchmark's own postings, document terms and projection."""
from __future__ import annotations

import dataclasses

import torch

from reference import dense as RD
from reference import sparse as RS
from reference.postings import DocTerms, Postings


@dataclasses.dataclass
class RefState:
    post: Postings
    default_k: int
    doc_terms: DocTerms | None = None
    proj: torch.Tensor | None = None
    dtype: torch.dtype = torch.float32


def evaluate(node, st: RefState, terms, weights, R=None) -> dict:
    """{"docids" [K], "scores" [K], "features" [K, F] or None} of one
    query through ``node`` (terms, weights: host sequences)."""
    op = node.op
    if op == "then":
        for c in node.children:
            R = evaluate(c, st, terms, weights, R)
        return R
    if op == "cutoff":
        R = evaluate(node.children[0], st, terms, weights, R)
        return {k: (v[:node.k] if v is not None else None)
                for k, v in R.items()}
    if op == "union":
        outs = [evaluate(c, st, terms, weights, R) for c in node.children]
        cols = [o["features"] if o["features"] is not None
                else o["scores"][:, None].to(torch.float32) for o in outs]
        return {**outs[0], "features": torch.cat(cols, -1)}
    name = node.name
    if name == "Retrieve":
        model = node.param(0, "model", "BM25")
        k = min(node.param(1, "k") or st.default_k, st.post.n_docs)
        s = RS.dense_scores(st.post, terms, weights, model, st.dtype)
        d, s = RS.ranked(s, k)
        return {"docids": d, "scores": s, "features": None}
    if name == "Extract":
        f = RS.doc_features(st.post, terms, weights, R["docids"],
                            node.param(0, "model"), st.dtype)[:, None]
        old = R["features"]
        return {**R, "features": f if old is None else torch.cat([old, f], -1)}
    if name == "DenseRerank":
        alpha = float(node.param(0, "alpha", 0.0))
        docs = R["docids"]
        emb = RD.doc_embeddings(st.doc_terms, st.proj, docs.clamp(min=0),
                                st.dtype)
        qv = RD.query_embedding(st.proj, terms, weights, st.dtype)
        s = alpha * R["scores"].to(st.dtype) + emb @ qv
        s = torch.where(docs >= 0, s, float("-inf"))
        order = torch.sort(s, descending=True, stable=True).indices
        out = {"docids": docs[order], "scores": s[order], "features": None}
        if R["features"] is not None:
            out["features"] = R["features"][order]
        return out
    if name == "Generate":
        return R
    raise ValueError(f"no reference for stage {name}")
