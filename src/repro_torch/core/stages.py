"""Concrete IR transformers (paper Table 1) over the torch backend: the
sparse stages of the RQ1/RQ2 path.

Leaf stages close over *static* config only.  Execution is batched over the
query axis and chunked by the backend (``backend.map_query_chunks``).
"""
from __future__ import annotations

import torch

from repro_torch.core.transformer import Transformer
from repro_torch.index import retrieve as RT


# ---------------------------------------------------------------------------
# retrieval stages
# ---------------------------------------------------------------------------

class Retrieve(Transformer):
    """Exhaustive top-k retrieval under one weighting model (Q -> R)."""
    kind = "retrieve"
    reads_results = False

    def __init__(self, model: str = "BM25", k: int | None = None):
        super().__init__(model=model, k=k)

    def execute(self, ctx, Q, R):
        # clamp to corpus size: top-k cannot take more entries than exist,
        # and parity across paths requires every path to clamp identically
        be = ctx.backend
        k = min(self.params["k"] or be.default_k, be.index.n_docs)
        model = self.params["model"]

        def run(terms, weights):
            return RT.retrieve_topk(be.index, terms, weights, model=model,
                                    k=k, max_postings=be.max_postings)

        docs, scores = be.map_query_chunks(run, Q)
        return Q, {"qid": Q["qid"], "docids": docs, "scores": scores}


class PrunedRetrieve(Transformer):
    """Block-max pruned top-k — the RQ1-optimised Retrieve (created by the
    CutoffPushdown rewrite; can also be used directly)."""
    kind = "pruned_retrieve"
    reads_results = False

    def __init__(self, model: str = "BM25", k: int = 10, n_terms: int = 8):
        super().__init__(model=model, k=k, n_terms=n_terms)

    def execute(self, ctx, Q, R):
        be = ctx.backend
        k = min(self.params["k"], be.index.n_docs)
        model = self.params["model"]
        budget = min(RT.block_budget(k, self.params["n_terms"]),
                     be.total_blocks)
        mbt = be.max_blocks_per_term

        def run(terms, weights):
            return RT.retrieve_pruned(be.index, terms, weights, model=model,
                                      k=k, n_blocks=budget,
                                      max_blocks_per_term=mbt)

        docs, scores = be.map_query_chunks(run, Q)
        return Q, {"qid": Q["qid"], "docids": docs, "scores": scores}


class FatRetrieve(Transformer):
    """Single-pass retrieval + multi-model feature extraction (fat postings —
    the RQ2-optimised form of Retrieve >> (Extract ** ... ** Extract))."""
    kind = "fat_retrieve"
    reads_results = False

    def __init__(self, model: str = "BM25",
                 features: tuple[str, ...] = (), k: int | None = None):
        super().__init__(model=model, features=tuple(features), k=k)

    def execute(self, ctx, Q, R):
        be = ctx.backend
        k = min(self.params["k"] or be.default_k, be.index.n_docs)

        def run(terms, weights):
            return RT.retrieve_fat(
                be.index, terms, weights, rank_model=self.params["model"],
                feature_models=self.params["features"], k=k,
                max_postings=be.max_postings)

        docs, scores, feats = be.map_query_chunks(run, Q)
        return Q, {"qid": Q["qid"], "docids": docs, "scores": scores,
                   "features": feats}


class FusedTopKRetrieve(Transformer):
    """``Retrieve >> … % K`` lowered to the top-k kernel path
    (``kernels/topk``), created by the IR lowering pass (core/passes.py).
    Exact — same scores as Retrieve, the top-k is just taken at the cutoff
    depth instead of sort-at-full-k-then-slice."""
    kind = "fused_topk_retrieve"
    reads_results = False

    def __init__(self, model: str = "BM25", k: int = 10):
        super().__init__(model=model, k=int(k))

    def execute(self, ctx, Q, R):
        be = ctx.backend
        k = min(self.params["k"], be.index.n_docs)
        model = self.params["model"]

        def run(terms, weights):
            return RT.retrieve_topk_fused(be.index, terms, weights,
                                          model=model, k=k,
                                          max_postings=be.max_postings)

        docs, scores = be.map_query_chunks(run, Q)
        return Q, {"qid": Q["qid"], "docids": docs, "scores": scores}


class FusedFatRetrieve(Transformer):
    """``Retrieve >> (Extract ** …) % K`` lowered to the fused-scoring
    kernel path (``kernels/fused_scoring``) at the cutoff depth — the
    kernel form of FatRetrieve % K."""
    kind = "fused_fat_retrieve"
    reads_results = False

    def __init__(self, model: str = "BM25",
                 features: tuple[str, ...] = (), k: int = 10):
        super().__init__(model=model, features=tuple(features), k=int(k))

    def execute(self, ctx, Q, R):
        be = ctx.backend
        k = min(self.params["k"], be.index.n_docs)

        def run(terms, weights):
            return RT.retrieve_fat_fused(
                be.index, terms, weights, rank_model=self.params["model"],
                feature_models=self.params["features"], k=k,
                max_postings=be.max_postings)

        docs, scores, feats = be.map_query_chunks(run, Q)
        return Q, {"qid": Q["qid"], "docids": docs, "scores": scores,
                   "features": feats}


# ---------------------------------------------------------------------------
# feature extraction
# ---------------------------------------------------------------------------

class Extract(Transformer):
    """Per-feature doc-vectors pass (Q × R -> R+feature) — the unoptimised
    feature extractor the RQ2 rewrite replaces."""
    kind = "extract"

    def __init__(self, model: str):
        super().__init__(model=model)

    def execute(self, ctx, Q, R):
        be = ctx.backend

        def run(terms, weights, docids):
            return RT.extract_feature_docvectors(
                be.index, terms, weights, docids, model=self.params["model"],
                max_fwd=be.index.max_fwd_len)

        f = be.map_query_chunks(run, Q, R["docids"])[..., None]  # [NQ, K, 1]
        feats = R.get("features")
        feats = f if feats is None else torch.cat([feats, f], -1)
        return Q, {**R, "features": feats}
