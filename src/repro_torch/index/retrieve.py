"""Sparse retrieval operators over the torch inverted index.

Each operator is batched over queries: ``terms``/``weights`` are
[NQ, MAXQ] and every output carries a leading NQ axis.  Three evaluation
strategies — the backend capabilities the pipeline compiler's rewrite rules
target (cf. paper §4):

* ``score_exhaustive``  — term-at-a-time over all postings, dense [NQ, D]
                          scores, full sort. The unoptimised
                          ``Retrieve() % K`` path.
* ``retrieve_pruned``   — block-max pruning: per-block score upper bounds,
                          top-``n_blocks`` block selection (budget is a
                          function of K), sparse aggregation.  The target of
                          the RQ1 rewrite.
* ``retrieve_fat``      — single-pass *multi-model* retrieval: one postings
                          gather scores the ranking model AND every feature
                          model (fat postings [Macdonald et al.]).  The
                          target of the RQ2 rewrite.

Plus the weighted multi-model pass ``retrieve_multi`` (the LinearFusion
target), the kernel lowerings ``retrieve_topk_fused`` /
``retrieve_fat_fused``, the unoptimised counterpart of fat,
``extract_feature_docvectors``, the dense second stage over sparse
candidates, ``retrieve_dense_rerank`` and its kernel lowering
``retrieve_dense_rerank_fused``, and RM3 query expansion,
``rm3_expand``.

Summation order.  A document's score is the sum of its query terms'
contributions in query-slot order, as in the reference's scatter-add over
the flattened [MAXQ, L] postings: one ``index_add_`` per slot.  Within a
slot a posting list holds each document once, so each add is free of
conflicts and deterministic on the card too.  The reference adds each
masked posting's zero to doc 0; here it goes to a spill column of its own
past the last document instead (the same sums, since adding +0 changes
nothing), because tens of thousands of atomic adds on one address per
slot serialise on the card.
Every top-k follows the ``lax.top_k`` rule (descending, ties to the lowest
index) and every sort is stable, as ``jnp.argsort`` is.
"""
from __future__ import annotations

import torch

from repro_torch.common import cdiv, topk
from repro_torch.index import scoring
from repro_torch.index.inverted import BLOCK, InvertedIndex, gather_postings


def _scatter_slots(n_docs: int, post: dict,
                   contrib: torch.Tensor) -> torch.Tensor:
    """Dense per-query sums of the gathered postings' contributions
    contrib [NQ, MAXQ, L, *F] -> [NQ, n_docs, *F], added one query slot at
    a time.  Masked postings (zero contributions) land in spill columns
    n_docs + position, one per posting position, so no address is hit
    twice within a slot."""
    doc_ids, mask = post["doc_ids"], post["mask"]
    NQ, MAXQ, L = doc_ids.shape
    tail = contrib.shape[3:]
    width = n_docs + L
    dense = torch.zeros((NQ * width, *tail), dtype=torch.float32,
                        device=contrib.device)
    ar = torch.arange(L, device=doc_ids.device)
    col = torch.where(mask, doc_ids.long(), n_docs + ar)
    idx = col + (torch.arange(NQ, device=doc_ids.device) * width)[:, None, None]
    for j in range(MAXQ):
        dense.index_add_(0, idx[:, j].reshape(-1),
                         contrib[:, j].reshape(NQ * L, *tail))
    return dense.reshape(NQ, width, *tail)[:, :n_docs]


def _posting_scores(index, post, weights, model):
    """Per-posting weighted scores [NQ, MAXQ, L] for one weighting model."""
    dl = index.doc_len[post["doc_ids"]]
    s = scoring.WEIGHTING_MODELS[model](
        post["tfs"], dl, post["df"][..., None], post["cf"][..., None],
        index.stats)
    return s * weights[..., None] * post["mask"]


def score_exhaustive(index: InvertedIndex, terms, weights, *,
                     model: str = "BM25", max_postings: int) -> torch.Tensor:
    """Dense scores [NQ, n_docs] (terms [NQ, MAXQ])."""
    post = gather_postings(index, terms, max_postings)
    s = _posting_scores(index, post, weights, model)
    return _scatter_slots(index.n_docs, post, s)


def retrieve_topk(index: InvertedIndex, terms, weights, *, model: str,
                  k: int, max_postings: int):
    scores = score_exhaustive(index, terms, weights, model=model,
                              max_postings=max_postings)
    top_s, top_d = topk(scores, k)
    return top_d.to(torch.int32), top_s


# ---------------------------------------------------------------------------
# block-max pruned retrieval
# ---------------------------------------------------------------------------

def block_budget(k: int, n_terms: int) -> int:
    """Block budget as a function of K — the dynamic-pruning dial that the
    RQ1 rewrite turns.  ~4x oversampling plus a floor per query term."""
    return max(4 * n_terms, 4 * cdiv(4 * k, BLOCK) * n_terms)


def _aggregate_sparse(doc_ids, scores, k):
    """Combine duplicate doc ids per row (stable sort + boundary segment
    sum) then top-k.  doc_ids/scores [NQ, n] -> ([NQ, k] int32, [NQ, k])."""
    NQ, n = doc_ids.shape
    order = torch.argsort(doc_ids, dim=1, stable=True)
    d = torch.gather(doc_ids, 1, order)
    s = torch.gather(scores, 1, order)
    new = d[:, 1:] != d[:, :-1]
    first = torch.cat([torch.ones_like(d[:, :1], dtype=torch.bool), new], 1)
    seg = torch.cumsum(first.long(), 1) - 1
    agg = torch.zeros((NQ, n), dtype=s.dtype, device=s.device)
    # an accumulating index_put_ adds a document's contributions in their
    # order on the card too (a sorted, sequential sum), where scatter_add_'s
    # atomics add them in an order that changes from run to run
    rows = torch.arange(NQ, device=s.device)[:, None].expand(NQ, n)
    agg.index_put_((rows, seg), s, accumulate=True)
    rep = torch.where(first, torch.gather(agg, 1, seg), -torch.inf)
    rep = torch.where(d >= 0, rep, -torch.inf)     # drop padding docs
    top_s, idx = topk(rep, k)
    return torch.gather(d, 1, idx).to(torch.int32), top_s


def retrieve_pruned(index: InvertedIndex, terms, weights, *, model: str,
                    k: int, n_blocks: int, max_blocks_per_term: int):
    """Approximate top-k via block-max pruning.

    1. per (term, block): score upper bound from (block_max_tf, block_min_dl)
    2. top-``n_blocks`` blocks by UB per query  (the block skip)
    3. gather + score ONLY those blocks' postings  (k-dependent work)
    4. sparse aggregate + top-k
    """
    NQ = terms.shape[0]
    mbt = max_blocks_per_term
    t = terms.clamp(min=0).long()
    start_blk = index.term_start[t] // BLOCK
    n_blk = (index.term_start[t + 1] - index.term_start[t]) // BLOCK
    ar = torch.arange(mbt, device=terms.device)
    blk_idx = start_blk[..., None] + ar
    blk_valid = (ar < n_blk[..., None]) & (terms >= 0)[..., None]
    blk_idx = blk_idx.clamp(max=index.block_max_tf.shape[0] - 1)

    df_t, cf_t = index.df[t], index.cf[t]
    ub = scoring.upper_bound(
        model, index.block_max_tf[blk_idx], index.block_min_dl[blk_idx],
        df_t[..., None], cf_t[..., None], index.stats)
    ub = torch.where(blk_valid, ub * weights[..., None], -torch.inf)

    flat_ub = ub.reshape(NQ, -1)
    sel_ub, sel = topk(flat_ub, n_blocks)                # block selection
    sel_term = sel // mbt                                # term giving df/cf
    sel_blk = torch.gather(blk_idx.reshape(NQ, -1), 1, sel)
    sel_valid = torch.isfinite(sel_ub)

    pos = sel_blk[..., None] * BLOCK + torch.arange(BLOCK, device=terms.device)
    docs = index.doc_ids[pos]
    tfs = index.tfs[pos]
    mask = sel_valid[..., None] & (docs >= 0)
    dl = index.doc_len[docs.clamp(min=0)]
    df = torch.gather(df_t, 1, sel_term)[..., None]
    cf = torch.gather(cf_t, 1, sel_term)[..., None]
    s = scoring.WEIGHTING_MODELS[model](tfs, dl, df, cf, index.stats)
    s = s * torch.gather(weights, 1, sel_term)[..., None] * mask
    flat_docs = torch.where(mask, docs, -1).reshape(NQ, -1)
    return _aggregate_sparse(flat_docs, s.reshape(NQ, -1), k)


# ---------------------------------------------------------------------------
# fat (single-pass multi-model) retrieval — RQ2 optimised path
# ---------------------------------------------------------------------------

def _fat_topk(dense: torch.Tensor, k: int):
    """dense [NQ, n_docs, F] -> (docids [NQ, k], scores, features
    [NQ, k, F-1]) cut on column 0."""
    top_s, top_d = topk(dense[..., 0], k)
    feats = torch.gather(
        dense[..., 1:], 1,
        top_d[..., None].expand(-1, -1, dense.shape[-1] - 1))
    return top_d.to(torch.int32), top_s, feats


def retrieve_fat(index: InvertedIndex, terms, weights, *, rank_model: str,
                 feature_models: tuple[str, ...], k: int, max_postings: int):
    """One postings pass -> candidate top-k under ``rank_model`` PLUS all
    ``feature_models`` scores for the candidates.  Returns (docids [NQ, k],
    scores [NQ, k], features [NQ, k, F])."""
    post = gather_postings(index, terms, max_postings)
    dl = index.doc_len[post["doc_ids"]]
    models = (rank_model,) + tuple(feature_models)
    all_s = scoring.score_all(models, post["tfs"], dl,
                              post["df"][..., None], post["cf"][..., None],
                              index.stats)
    all_s = all_s * (weights[..., None, None] *
                     post["mask"][..., None].to(torch.float32))
    return _fat_topk(_scatter_slots(index.n_docs, post, all_s), k)


def retrieve_multi(index: InvertedIndex, terms, weights, model_weights, *,
                   models: tuple[str, ...], k: int, max_postings: int):
    """Weighted multi-model retrieval in ONE postings pass — the target of
    the LinearFusion rewrite (w1·Retrieve(m1) + w2·Retrieve(m2) fused).
    ``model_weights`` [F] contracts the per-model scores of each posting
    before the per-slot scatter, as an elementwise product and a sum over
    the F models (as a matrix-vector product with F = 2 it took the most
    device time of the fusion path, ``benchmarks/torch_rq_profile.py``).
    Returns (docids [NQ, k], scores)."""
    post = gather_postings(index, terms, max_postings)
    dl = index.doc_len[post["doc_ids"]]
    all_s = scoring.score_all(models, post["tfs"], dl,
                              post["df"][..., None], post["cf"][..., None],
                              index.stats)
    s = (all_s * model_weights).sum(-1)
    s = s * weights[..., None] * post["mask"]
    top_s, top_d = topk(_scatter_slots(index.n_docs, post, s), k)
    return top_d.to(torch.int32), top_s


# ---------------------------------------------------------------------------
# kernel-fused retrieval — targets of the IR lowering pass (core/passes.py)
# ---------------------------------------------------------------------------

def retrieve_topk_fused(index: InvertedIndex, terms, weights, *, model: str,
                        k: int, max_postings: int):
    """``Retrieve >> … % K`` lowered through the top-k kernel: exhaustive
    scoring feeds ``kernels/topk`` at the *cutoff* depth K, so the dense
    [NQ, n_docs] score rows are never sorted to the retriever's full k."""
    from repro_torch.kernels.topk.ops import streaming_topk
    scores = score_exhaustive(index, terms, weights, model=model,
                              max_postings=max_postings)
    vals, idxs = streaming_topk(scores, k=k)
    return idxs, vals


def retrieve_fat_fused(index: InvertedIndex, terms, weights, *,
                       rank_model: str, feature_models: tuple[str, ...],
                       k: int, max_postings: int):
    """``Retrieve >> (Extract ** …) % K`` lowered through the fused-scoring
    kernel: one postings gather, every weighting model's math in one pass
    over the postings (``kernels/fused_scoring``), candidates cut to K."""
    from repro_torch.kernels.fused_scoring.ops import fused_scoring
    post = gather_postings(index, terms, max_postings)
    dl = index.doc_len[post["doc_ids"]]
    models = (rank_model,) + tuple(feature_models)
    all_s = fused_scoring(post["tfs"], dl, post["df"][..., None],
                          post["cf"][..., None], models=models,
                          stats=index.stats)
    all_s = all_s * (weights[..., None, None] *
                     post["mask"][..., None].to(torch.float32))
    return _fat_topk(_scatter_slots(index.n_docs, post, all_s), k)


# ---------------------------------------------------------------------------
# dense second stage: sparse candidates re-scored by the dense index
# ---------------------------------------------------------------------------

def dense_rerank_scores(emb, qvecs, docids, scores, alpha: float):
    """The dense re-score of result lists docids/scores [NQ, K]:
    ``alpha * score + emb[doc] @ q``, -inf for padding (docid -1)."""
    dots = torch.matmul(emb[docids.clamp(min=0).long()],
                        qvecs[..., None])[..., 0]
    return torch.where(docids >= 0, alpha * scores + dots, -torch.inf)


def retrieve_dense_rerank(index: InvertedIndex, emb, terms, weights, qvecs,
                          *, model: str, k_in: int, k: int, alpha: float,
                          max_postings: int):
    """The unfused ``Retrieve >> DenseRerank % K`` chain: sparse top-k_in
    candidates, dense re-scoring (``alpha * sparse + emb @ q``), full
    stable sort, slice to K — the semantics the fused form below must
    reproduce exactly."""
    docs, scores = retrieve_topk(index, terms, weights, model=model, k=k_in,
                                 max_postings=max_postings)
    ds = dense_rerank_scores(emb, qvecs, docs, scores, alpha)
    order = torch.argsort(-ds, dim=1, stable=True)[:, :k]
    return torch.gather(docs, 1, order), torch.gather(ds, 1, order)


def retrieve_dense_rerank_fused(index: InvertedIndex, emb, terms, weights,
                                qvecs, *, model: str, k_in: int, k: int,
                                alpha: float, max_postings: int):
    """``Retrieve >> DenseRerank % K`` lowered through the dense-scoring
    kernel: the sparse contribution rides in as the kernel's ``base`` and
    its top-k runs at the *cutoff* depth K, so the candidate list is never
    fully sorted (``kernels/dense_scoring``)."""
    from repro_torch.index.dense import NEG
    from repro_torch.kernels.dense_scoring.ops import streaming_dense_topk
    docs, scores = retrieve_topk(index, terms, weights, model=model, k=k_in,
                                 max_postings=max_postings)
    base = torch.where(docs >= 0, alpha * scores, NEG)
    vals, idxs = streaming_dense_topk(emb[docs.clamp(min=0).long()], qvecs,
                                      base, k=k)
    ok = vals > NEG / 2
    out_docs = torch.where(ok, torch.gather(docs, 1, idxs.long()), -1)
    return out_docs.to(torch.int32), torch.where(ok, vals, -torch.inf)


# ---------------------------------------------------------------------------
# doc-vectors feature extraction — the unoptimised per-feature pass
# ---------------------------------------------------------------------------

def extract_feature_docvectors(index: InvertedIndex, terms, weights,
                               docids, *, model: str, max_fwd: int):
    """Score ``docids`` [NQ, K] under one weighting model via the direct
    index (one pass over each candidate's doc vector per feature).

    The reference matches every doc term against every query term in a
    [K, max_fwd, MAXQ] cube; each doc vector holds a term once, so at most
    one doc term matches a query slot and the match is exact in any order.
    Doc vectors are sorted by term, so the port finds that term by binary
    search instead of building the cube."""
    d = docids.clamp(min=0).long()
    start = index.fwd_start[d]
    length = index.fwd_start[d + 1] - start
    ar = torch.arange(max_fwd, device=docids.device)
    in_rng = ar < length[..., None]
    pos = (start[..., None] + ar).clamp(max=index.fwd_terms.shape[0] - 1)
    big = torch.iinfo(torch.int32).max          # keeps padded rows sorted
    dterms = torch.where(in_rng, index.fwd_terms[pos], big)   # [NQ, K, L]
    dtfs = torch.where(in_rng, index.fwd_tfs[pos], 0)

    NQ, K = docids.shape
    q = terms[:, None, :].expand(NQ, K, terms.shape[1]).contiguous()
    hit = torch.searchsorted(dterms, q).clamp(max=max_fwd - 1)
    found = (torch.gather(dterms, 2, hit) == q) & (q >= 0)
    tf_q = torch.where(found, torch.gather(dtfs, 2, hit), 0)   # [NQ, K, MAXQ]

    dl = index.doc_len[d][..., None]
    t = terms.clamp(min=0).long()
    s = scoring.WEIGHTING_MODELS[model](
        tf_q.to(torch.float32), dl, index.df[t][:, None, :],
        index.cf[t][:, None, :], index.stats)
    s = s * weights[:, None, :] * (terms >= 0)[:, None, :]
    s = torch.where((docids >= 0)[..., None], s, 0.0)
    return s.sum(dim=2)                                      # [NQ, K]


# ---------------------------------------------------------------------------
# RM3 query expansion via the direct index
# ---------------------------------------------------------------------------

#: the NaN of the reference's CPU arithmetic (x86's default NaN: sign bit
#: set, quiet).  The top-k rule orders floats by their bits, so a NaN's sign
#: decides whether it ranks above +inf or below -inf, and the card's
#: arithmetic makes NaNs of the other sign
_REF_NAN_BITS = -0x400000                # 0xffc00000 as int32


def _relevance_model(index: InvertedIndex, docids, scores, max_fwd: int):
    """The RM1 relevance model [NQ, vocab] of the feedback lists docids /
    scores [NQ, FB]: each feedback document's term distribution weighted by
    the softmax of its score, summed over the documents.

    The reference adds the flattened [FB, max_fwd] contributions in one
    scatter, in document order on the CPU.  A document vector holds each
    term once, so one ``index_add_`` per document, in document order, is
    free of conflicts and adds in the reference's order on the card too.
    Positions past a document's length (term 0, tf 0) go to spill columns
    past the vocabulary instead of term 0: their contributions are zeros
    (NaN when the document's weight is), and tens of thousands of atomic
    adds on one address would serialise.  Returns (model, and whether a
    padded position carried a NaN [NQ], which the reference adds to term
    0)."""
    NQ, FB = docids.shape
    V = index.vocab
    d = docids.clamp(min=0).long()
    start = index.fwd_start[d]
    length = index.fwd_start[d + 1] - start
    ar = torch.arange(max_fwd, device=docids.device)
    in_rng = ar < length[..., None]                         # [NQ, FB, L]
    pos = (start[..., None] + ar).clamp(max=index.fwd_terms.shape[0] - 1)
    dtfs = torch.where(in_rng, index.fwd_tfs[pos].to(torch.float32), 0.0)

    p_rel = torch.softmax(torch.where(docids >= 0, scores, -torch.inf), 1)
    p_t_d = dtfs / index.doc_len[d][..., None].to(torch.float32).clamp(min=1.0)
    w_contrib = p_rel[..., None] * p_t_d                    # [NQ, FB, L]

    width = V + max_fwd
    col = torch.where(in_rng, index.fwd_terms[pos].long(), V + ar)
    col = col + (torch.arange(NQ, device=docids.device) * width)[:, None, None]
    rm = torch.zeros(NQ * width, dtype=torch.float32, device=docids.device)
    for j in range(FB):
        rm.index_add_(0, col[:, j].reshape(-1), w_contrib[:, j].reshape(-1))
    rm = rm.view(NQ, width)
    return rm[:, :V], rm[:, V:].isnan().any(1)


def rm3_expand(index: InvertedIndex, terms, weights, docids, scores, *,
               fb_terms: int = 10, alpha: float = 0.5, max_fwd: int):
    """Relevance-model expansion from the feedback docs docids / scores
    [NQ, FB] of each query (terms / weights [NQ, MAXQ]).

    Returns (new_terms [NQ, MAXQ] int32, new_weights [NQ, MAXQ]) where the
    expansion terms are appended after the original query terms.

    Two details follow the reference's CPU results exactly.  It zeroes the
    query's own terms in the model by a scatter-set in which every padded
    slot writes term 0's own value back, the writes landing in slot order:
    so term 0 is zeroed only when the last slot that maps to it is a real
    term 0 — a mask here, not an order-dependent ``index_put_``.  And a
    query with no feedback document (all docids -1) has NaN document
    weights, as the reference's softmax over all -inf does; every NaN of
    the model takes the reference's sign, so the top-k ranks them below
    every number on either device."""
    NQ, MAXQ = terms.shape
    rm, pad_nan = _relevance_model(index, docids, scores, max_fwd)
    nan = torch.tensor(_REF_NAN_BITS, dtype=torch.int32,
                       device=rm.device).view(torch.float32)
    rm = torch.cat([torch.where(pad_nan, torch.nan, rm[:, 0])[:, None],
                    rm[:, 1:]], 1)
    rm = torch.where(rm.isnan(), nan, rm)

    # don't re-select original terms
    real = terms >= 0
    V = index.vocab
    zero = torch.zeros((NQ, V + 1), dtype=torch.bool, device=terms.device)
    zero.scatter_(1, torch.where(terms > 0, terms, V).long(), True)
    slots = torch.arange(MAXQ, device=terms.device)
    last0 = torch.where(terms <= 0, slots, -1).amax(1)     # -1: none
    zero[:, 0] = (last0 >= 0) & (
        torch.gather(terms, 1, last0.clamp(min=0)[:, None])[:, 0] == 0)
    rm = torch.where(zero[:, :V], 0.0, rm)

    exp_w, exp_t = topk(rm, fb_terms)
    exp_w = exp_w / exp_w.sum(1, keepdim=True).clamp(min=1e-9)

    n_orig = real.sum(1)
    exp_slot = slots == (n_orig[:, None] + torch.arange(
        fb_terms, device=terms.device))[..., None]          # [NQ, fb, MAXQ]
    new_terms = torch.where(
        real, terms, (exp_slot * (exp_t[..., None] + 1)).sum(1) - 1)
    w_norm = weights / (weights * real).sum(1, keepdim=True).clamp(min=1e-9)
    new_weights = torch.where(real, alpha * w_norm,
                              (1 - alpha) * (exp_slot * exp_w[..., None])
                              .sum(1))
    return new_terms.to(torch.int32), new_weights
