"""Concrete IR transformers (paper Table 1) over the torch backend: the
sparse stages of the RQ1/RQ2 path, the query rewrites, the learning-to-rank
stage, the dense second stage and the RAG answer stage.

Leaf stages close over *static* config only; array state (learned weights)
lives in ``self.state`` and is trained through ``fit()``.  Execution is
batched over the query axis and bucketed by the backend's engine
(``backend.map_query_chunks``, keyed by the stage's ``key()``): each
stage's batched function takes the replica of the card its shard runs on
(``core.compiler.Replica``) and reads the index, the dense state and the
statics from it, never from the backend on the home card.
"""
from __future__ import annotations

import torch

from repro_torch.core.transformer import Transformer
from repro_torch.index import retrieve as RT
from repro_torch.obs.tracing import tracer_for


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

        def run(rep, terms, weights):
            return RT.retrieve_topk(rep.index, terms, weights, model=model,
                                    k=k, max_postings=rep.max_postings)

        docs, scores = be.map_query_chunks(run, Q, key=self.key())
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
        n_terms = self.params["n_terms"]

        def run(rep, terms, weights):
            budget = min(RT.block_budget(k, n_terms), rep.total_blocks)
            return RT.retrieve_pruned(
                rep.index, terms, weights, model=model, k=k, n_blocks=budget,
                max_blocks_per_term=rep.max_blocks_per_term)

        docs, scores = be.map_query_chunks(run, Q, key=self.key())
        return Q, {"qid": Q["qid"], "docids": docs, "scores": scores}


class MultiRetrieve(Transformer):
    """Single-pass weighted multi-model retrieval (created by the
    LinearFusion rewrite — beyond-paper optimisation)."""
    kind = "multi_retrieve"
    reads_results = False

    def __init__(self, models: tuple[str, ...], weights: tuple[float, ...],
                 k: int | None = None):
        super().__init__(models=tuple(models), weights=tuple(weights), k=k)

    def execute(self, ctx, Q, R):
        be = ctx.backend
        k = min(self.params["k"] or be.default_k, be.index.n_docs)
        models = self.params["models"]
        model_w = self.params["weights"]
        on_card = {}

        def run(rep, terms, weights):
            mw = on_card.get(rep.device)
            if mw is None:
                mw = on_card[rep.device] = torch.tensor(
                    model_w, dtype=torch.float32, device=rep.device)
            return RT.retrieve_multi(rep.index, terms, weights, mw,
                                     models=models, k=k,
                                     max_postings=rep.max_postings)

        docs, scores = be.map_query_chunks(run, Q, key=self.key())
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

        def run(rep, terms, weights):
            return RT.retrieve_fat(
                rep.index, terms, weights, rank_model=self.params["model"],
                feature_models=self.params["features"], k=k,
                max_postings=rep.max_postings)

        docs, scores, feats = be.map_query_chunks(run, Q, key=self.key())
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

        def run(rep, terms, weights):
            return RT.retrieve_topk_fused(rep.index, terms, weights,
                                          model=model, k=k,
                                          max_postings=rep.max_postings)

        docs, scores = be.map_query_chunks(run, Q, key=self.key())
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

        def run(rep, terms, weights):
            return RT.retrieve_fat_fused(
                rep.index, terms, weights, rank_model=self.params["model"],
                feature_models=self.params["features"], k=k,
                max_postings=rep.max_postings)

        docs, scores, feats = be.map_query_chunks(run, Q, key=self.key())
        return Q, {"qid": Q["qid"], "docids": docs, "scores": scores,
                   "features": feats}


class DenseRetrieve(Transformer):
    """ANN-style dense candidate generation over the IVF dense index
    (Q -> R): embed the query, probe the ``nprobe`` closest coarse lists,
    score only those lists' documents.  ``nprobe=0`` scores every document
    (exact brute force).  ``pq=True`` scores candidates against the
    compressed IVF-PQ store (ADC table lookups + exact float re-scoring of
    the shortlist) instead of the float list store."""
    kind = "dense_retrieve"
    reads_results = False

    def __init__(self, k: int | None = None, nprobe: int = 8,
                 pq: bool = False):
        super().__init__(k=k, nprobe=int(nprobe), pq=bool(pq))

    def execute(self, ctx, Q, R):
        be = ctx.backend
        k = min(self.params["k"] or be.default_k, be.index.n_docs)
        return _dense_retrieve(be, Q, k=k, nprobe=self.params["nprobe"],
                               pq=self.params["pq"], fused=False,
                               key=self.key())


class FusedDenseRetrieve(Transformer):
    """``DenseRetrieve % K`` lowered to the dense-scoring kernel path
    (``kernels/dense_scoring``, or ``kernels/pq_scoring`` when ``pq=True``)
    at the cutoff depth, created by the cost-gated IR lowering pass
    (core/passes.py).  ``pq_block`` pins the PQ kernel's rows a tile
    (autotuned on the card; ``None`` = the kernel's default, and then not
    a param, so the stage's key is the untuned one); ``pq_shortlist`` pins
    the ADC shortlist depth (the pass sets it to the *unfused* chain's
    depth so fusion is an exact rewrite; ``None`` = refine*k)."""
    kind = "fused_dense_retrieve"
    reads_results = False

    def __init__(self, k: int = 10, nprobe: int = 8, pq: bool = False,
                 pq_shortlist: int | None = None,
                 pq_block: int | None = None):
        super().__init__(
            k=int(k), nprobe=int(nprobe), pq=bool(pq),
            pq_shortlist=None if pq_shortlist is None else int(pq_shortlist),
            **({} if pq_block is None else {"pq_block": int(pq_block)}))

    def execute(self, ctx, Q, R):
        be = ctx.backend
        k = min(self.params["k"], be.index.n_docs)
        return _dense_retrieve(be, Q, k=k, nprobe=self.params["nprobe"],
                               pq=self.params["pq"], fused=True,
                               shortlist=self.params["pq_shortlist"],
                               block=self.params.get("pq_block"),
                               key=self.key())


def _dense_retrieve(be, Q, *, k: int, nprobe: int, pq: bool, fused: bool,
                    key, shortlist: int | None = None,
                    block: int | None = None):
    """The search both dense retrieval stages run, chunk by chunk: IVF-PQ
    (``nprobe`` and ``pq``), IVF-flat (``nprobe``) or brute force."""
    from repro_torch.index import dense as DN
    if nprobe and pq:
        name = "ivfpq"
        search = (DN.ivfpq_retrieve_topk_fused if fused
                  else DN.ivfpq_retrieve_topk)
        kw = {"nprobe": min(nprobe, be.ivfpq.n_lists),
              "refine": be.pq_refine}
        if fused:
            kw.update(shortlist=shortlist, block=block)
    elif nprobe:
        name = "ivf"
        search = DN.ivf_retrieve_topk_fused if fused else DN.ivf_retrieve_topk
        kw = {"nprobe": min(nprobe, be.ivf.n_lists)}
    else:
        name = "dense"
        search = (DN.dense_retrieve_exact_fused if fused
                  else DN.dense_retrieve_exact)
        kw = {}

    def run(rep, terms, weights):
        qv = rep.embed_queries({"terms": terms, "weights": weights})
        return search(getattr(rep, name), qv, k=k, **kw)

    docs, scores = be.map_query_chunks(run, Q, key=key)
    return Q, {"qid": Q["qid"], "docids": docs, "scores": scores}


class FusedDenseRerank(Transformer):
    """``Retrieve >> DenseRerank % K`` lowered to one fused stage: sparse
    candidates at depth ``k_in``, dense re-scoring on the kernel with the
    sparse score as the additive base, top-k at the cutoff depth ``k``
    (core/passes.py)."""
    kind = "fused_dense_rerank"
    reads_results = False

    def __init__(self, model: str = "BM25", k_in: int = 1000, k: int = 10,
                 alpha: float = 0.0):
        super().__init__(model=model, k_in=int(k_in), k=int(k),
                         alpha=float(alpha))

    def execute(self, ctx, Q, R):
        be = ctx.backend
        p = self.params
        k_in = min(p["k_in"], be.index.n_docs)
        k = min(p["k"], be.index.n_docs)

        def run(rep, terms, weights):
            qv = rep.embed_queries({"terms": terms, "weights": weights})
            return RT.retrieve_dense_rerank_fused(
                rep.index, rep.dense.emb, terms, weights, qv,
                model=p["model"], k_in=k_in, k=k, alpha=p["alpha"],
                max_postings=rep.max_postings)

        docs, scores = be.map_query_chunks(run, Q, key=self.key())
        return Q, {"qid": Q["qid"], "docids": docs, "scores": scores}


# ---------------------------------------------------------------------------
# query rewriting / expansion
# ---------------------------------------------------------------------------

class SDMRewrite(Transformer):
    """Sequential-dependence-style rewrite (Q -> Q).

    Positions are not stored in the index, so the proximity operators (#1,
    #uw8) are adapted as weight redistribution over the original terms
    (unigram 0.85 emphasis) plus duplicated high-weight lead terms — a
    rank-affecting, semantics-documented analogue (DESIGN.md §2).
    """
    kind = "sdm_rewrite"
    out_kind = "Q"
    reads_results = False

    def __init__(self, unigram: float = 0.85):
        super().__init__(unigram=unigram)

    def execute(self, ctx, Q, R):
        w = Q["weights"]
        u = self.params["unigram"]
        n = (Q["terms"] >= 0).sum(1, keepdim=True).clamp(min=1)
        lead = torch.arange(w.shape[1], device=w.device) < \
            (n // 2).clamp(min=1)
        w2 = w * (u + (1 - u) * 2 * lead)
        return {**Q, "weights": w2}, R


class StemRewrite(Transformer):
    """Context-sensitive-stemming analogue: adds a same-frequency-band
    variant term (synthetic stem class neighbour) at reduced weight."""
    kind = "stem_rewrite"
    out_kind = "Q"
    reads_results = False

    def __init__(self, weight: float = 0.4):
        super().__init__(weight=weight)

    def execute(self, ctx, Q, R):
        t, w = Q["terms"], Q["weights"]
        n = (t >= 0).sum(1, keepdim=True)
        L = t.shape[1]
        variant = torch.where(t >= 0, t ^ 1, -1)        # stem-class sibling
        shifted = torch.arange(L, device=t.device) - n
        take = (shifted >= 0) & (shifted < n)
        sh = shifted.clamp(0, L - 1)
        t2 = torch.where(t >= 0, t,
                         torch.where(take, torch.gather(variant, 1, sh), -1))
        w2 = torch.where(t >= 0, w,
                         torch.where(take, torch.gather(w, 1, sh)
                                     * self.params["weight"], 0.0))
        return {**Q, "terms": t2, "weights": w2}, R


class RM3Expand(Transformer):
    """Pseudo-relevance-feedback expansion (Q × R -> Q'), paper eq. (5)."""
    kind = "rm3"
    out_kind = "Q"          # R passes through untouched
    reads_results = True    # ... but fb_docs are read from it

    def __init__(self, fb_terms: int = 10, fb_docs: int = 10,
                 alpha: float = 0.5):
        super().__init__(fb_terms=fb_terms, fb_docs=fb_docs, alpha=alpha)

    def execute(self, ctx, Q, R):
        assert R is not None, "RM3 needs retrieved results (use after Retrieve)"
        be = ctx.backend
        fb = self.params["fb_docs"]

        def run(rep, terms, weights, docids, scores):
            return RT.rm3_expand(rep.index, terms, weights, docids, scores,
                                 fb_terms=self.params["fb_terms"],
                                 alpha=self.params["alpha"],
                                 max_fwd=rep.index.max_fwd_len)

        t2, w2 = be.map_query_chunks(run, Q, R["docids"][:, :fb],
                                     R["scores"][:, :fb], key=self.key())
        return {**Q, "terms": t2, "weights": w2}, R


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

        def run(rep, terms, weights, docids):
            return RT.extract_feature_docvectors(
                rep.index, terms, weights, docids, model=self.params["model"],
                max_fwd=rep.index.max_fwd_len)

        f = be.map_query_chunks(run, Q, R["docids"],
                                key=self.key())[..., None]  # [NQ, K, 1]
        feats = R.get("features")
        feats = f if feats is None else torch.cat([feats, f], -1)
        return Q, {**R, "features": feats}


# ---------------------------------------------------------------------------
# re-ranking
# ---------------------------------------------------------------------------

def _sort_by_scores(R, new_scores):
    """R re-ordered by ``new_scores`` [NQ, K], descending (a stable sort:
    ties keep their order in R)."""
    order = torch.argsort(-new_scores, dim=1, stable=True)
    out = {**R, "docids": torch.gather(R["docids"], 1, order),
           "scores": torch.gather(new_scores, 1, order)}
    if "features" in R:
        out["features"] = torch.gather(
            R["features"], 1,
            order[..., None].expand(-1, -1, R["features"].shape[-1]))
    return out


class LTRRerank(Transformer):
    """Learning-to-rank stage over feature columns (LambdaMART slot).

    A pairwise-logistic MLP (``models/ltr.py``) trained by plain gradient
    descent, full batch, for ``epochs`` steps — the xgBoost stage of
    Listing 1.  The gradient comes from torch autograd where the JAX
    package takes ``jax.value_and_grad``.  ``state`` is drawn on first use
    from a generator seeded with ``seed`` on the backend's device (or set,
    e.g. by ``models.ltr.ltr_state_from_arrays``); each fit bumps
    ``version``, which is part of the stage's key, so a shared memo never
    serves scores of an earlier state."""
    kind = "ltr"
    stateful = True

    def __init__(self, n_features: int, hidden: int = 32, lr: float = 0.05,
                 epochs: int = 30, seed: int = 0):
        super().__init__(n_features=n_features, hidden=hidden, lr=lr,
                         epochs=epochs, seed=seed)
        self.state = None

    def _model(self, be):
        """The state, drawn on the backend's device if there is none yet."""
        from repro_torch.models import ltr
        if self.state is None:
            gen = torch.Generator(device=be.device).manual_seed(
                self.params["seed"])
            self.state = ltr.init_state(self.params["n_features"],
                                        self.params["hidden"], gen)
        if self.state.device.type != be.device.type:
            raise ValueError(f"LTRRerank state lies on {self.state.device}, "
                             f"the backend on {be.device}")
        return self.state

    def execute(self, ctx, Q, R):
        assert "features" in R, \
            "LTRRerank needs feature columns (use ** / Extract)"
        model = self._model(ctx.backend)
        with torch.no_grad():
            s = model(R["features"])
        s = torch.where(R["docids"] >= 0, s, -torch.inf)
        return Q, _sort_by_scores(R, s)

    def _fit_local(self, ctx, Q, R, qrels, Q_valid, R_valid, qrels_valid):
        from repro_torch.models.ltr import pairwise_loss
        model = self._model(ctx.backend)
        feats = R["features"]
        labels = ctx.backend.label_results(Q, R, qrels)      # [NQ, K] float
        valid = R["docids"] >= 0
        lr = self.params["lr"]
        params = [model.w1, model.b1, model.w2]
        for _ in range(self.params["epochs"]):
            loss = pairwise_loss(model(feats), labels, valid)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, g in zip(params, grads):
                    p.copy_(p - lr * g)
        self.version += 1


class DenseRerank(Transformer):
    """Dense (embedding) re-scoring of the candidate set — the neural
    re-ranker slot (CEDR/BERT in Listing 1), backed by the dense index:
    ``alpha * score + emb[doc] @ q``."""
    kind = "dense_rerank"

    def __init__(self, alpha: float = 0.0):
        super().__init__(alpha=alpha)

    def execute(self, ctx, Q, R):
        be = ctx.backend
        alpha = self.params["alpha"]

        def run(rep, terms, weights, docids, scores):
            qv = rep.embed_queries({"terms": terms, "weights": weights})
            return RT.dense_rerank_scores(rep.dense.emb, qv, docids, scores,
                                          alpha)

        s = be.map_query_chunks(run, Q, R["docids"], R["scores"],
                                key=self.key())
        return Q, _sort_by_scores(R, s)


# ---------------------------------------------------------------------------
# generation (RAG answer stage)
# ---------------------------------------------------------------------------

def assemble_prompt_fn(index, *, vocab: int, max_prompt_len: int,
                       prompt_docs: int):
    """Batched prompt assembler ``(terms [NQ, MAXQ], weights, docids
    [NQ, K]) -> [NQ, max_prompt_len] int32``.

    Each query's terms followed by the forward-index terms of its top
    ``prompt_docs`` documents, mapped into the LM vocab (ids 0/1 reserved
    for pad/bos), compacted to the front and cyclically repeated to fill
    exactly ``max_prompt_len`` positions, as the JAX package assembles
    them; integer-exact."""
    fwd_start, fwd_terms = index.fwd_start, index.fwd_terms
    max_fwd = int(index.max_fwd_len)
    n_terms = int(fwd_terms.shape[0])
    P = int(max_prompt_len)

    def assemble(terms, weights, docids):
        nq = terms.shape[0]
        dev = terms.device
        d = docids[:, :prompt_docs].long()
        d0 = d.clamp(min=0)
        start = fwd_start[d0]
        count = fwd_start[d0 + 1] - start
        win = torch.arange(max_fwd, device=dev)
        idx = (start[..., None] + win).clamp(0, n_terms - 1)
        dvalid = (win < count[..., None]) & (d >= 0)[..., None]
        dterm = torch.where(dvalid, fwd_terms[idx].long(), -1)
        cand = torch.cat([terms.long(), dterm.reshape(nq, -1)], dim=1)
        valid = cand >= 0
        tok = 2 + cand.clamp(min=0) % (vocab - 2)
        pos = torch.cumsum(valid, dim=1) - 1
        slot = torch.where(valid & (pos < P), pos, P)
        prompt = torch.zeros((nq, P + 1), dtype=torch.long, device=dev)
        prompt = prompt.scatter(1, slot, tok)[:, :P]
        n = valid.sum(dim=1, keepdim=True).clamp(1, P)
        fill = torch.arange(P, device=dev)[None, :]
        rep = torch.gather(prompt, 1, (fill % n).expand(nq, P))
        return torch.where(fill < n, prompt, rep).to(torch.int32)

    return assemble


def greedy_generate_fn(cfg, *, max_prompt_len: int, max_new_tokens: int):
    """Batched greedy decode ``(lm, prompts [B, P]) -> tokens [B, T]``: one
    prefill over the prompt block, then ``T - 1`` greedy decode steps (a
    Python loop in place of the JAX package's ``lax.scan``) against a
    [B, P + T] KV cache, updated in place.  The argmax of each step's
    logits (in ``cfg.dtype``) takes the first maximum, as ``jnp.argmax``
    does.  ``n_rows`` (a 0-d device tensor) counts the real prompts of a
    block padded to its bucket, which an MoE layer's capacity counts alone
    (``transformer_lm.prefill``)."""
    from repro_torch.models import transformer_lm as tlm
    P, T = int(max_prompt_len), int(max_new_tokens)

    def gen(lm, prompts, n_rows=None):
        cache = tlm.init_kv_cache(cfg, prompts.shape[0], P + T,
                                  device=prompts.device)
        logits, cache = tlm.prefill(cfg, lm, prompts, cache, n_rows=n_rows)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [tok]
        for t in range(T - 1):
            logits, cache = tlm.decode_step(cfg, lm, tok[:, None], cache,
                                            P + t, n_rows=n_rows)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
        return torch.stack(out, dim=1)

    return gen


class Generate(Transformer):
    """RAG answer stage (R -> A): assemble the top-``prompt_docs`` documents
    into a fixed-length prompt and decode ``max_new_tokens`` greedy tokens
    with the named backend-registered LM (``backend.register_lm``).

    All params are scalar statics, so the op stays content-addressable.
    The output is the answer-bearing A relation: the incoming ranking plus
    a ``tokens [NQ, max_new_tokens]`` column block; A is terminal, no
    ranking stage may consume it (core/passes.py schema rules).  Prompts
    are prefilled and decoded per chunk of the engine's chunk plan (of
    ``query_chunk`` queries without an engine).  A dense LM's row depends
    on its own prompt alone; an MoE LM's capacity counts the tokens of its
    chunk's real prompts (not the rows that pad it to its bucket), where
    the JAX package's Generate routes all NQ prompts in one call, so the
    two agree where the chunk holds every query, and the reference run
    chunk by chunk otherwise (ROADMAP §3).  Spans: ``generate.assemble``
    around the prompts, ``generate.lm`` around the LM (on the card, the
    replays of the captured prefill-and-decode graphs)."""
    kind = "generate"
    out_kind = "A"
    reads_results = True

    def __init__(self, model: str, max_new_tokens: int = 16,
                 max_prompt_len: int = 64, prompt_docs: int = 4):
        super().__init__(model=model, max_new_tokens=int(max_new_tokens),
                         max_prompt_len=int(max_prompt_len),
                         prompt_docs=int(prompt_docs))

    def _assembler(self, be):
        """The batched assembler ``(replica, terms, weights, docids)``: the
        prompts of a card's shard, from that card's forward file."""
        cfg, _ = be.lm(self.params["model"])
        P, docs = self.params["max_prompt_len"], self.params["prompt_docs"]

        def assemble(rep, terms, weights, docids):
            return assemble_prompt_fn(
                rep.index, vocab=cfg.vocab, max_prompt_len=P,
                prompt_docs=docs)(terms, weights, docids)

        return assemble

    def assemble(self, ctx, Q, R):
        """Prompts [NQ, max_prompt_len] for the incoming ranking, gathered
        on the home card (shared by the offline path below and the server's
        decode pool)."""
        return ctx.backend.map_query_chunks(self._assembler(ctx.backend), Q,
                                            R["docids"], key=self.key())

    def execute(self, ctx, Q, R):
        assert R is not None, "Generate needs retrieved results"
        be = ctx.backend
        tracer = tracer_for(be.descriptor)
        cfg, lm = be.lm(self.params["model"])
        gen = greedy_generate_fn(
            cfg, max_prompt_len=self.params["max_prompt_len"],
            max_new_tokens=self.params["max_new_tokens"])
        if be.engine is not None:
            # one pinned program per ladder rung: a captured CUDA graph of
            # the prefill and every decode step on the home card, where
            # the prompts are gathered and the LM lies
            from repro_torch.core.engine import StageProgram
            with tracer.span("generate.assemble", "generate"):
                prompts = self.assemble(ctx, Q, R)
            prog = StageProgram(key=(be.uid, self.key(), "generate"), fn=gen)
            with tracer.span("generate.lm", "generate"):
                tokens = be.engine.run_pinned_chunks(prog, prompts, lm)
        else:
            assemble = self._assembler(be)

            def run(rep, terms, weights, docids):
                with tracer.span("generate.assemble", "generate"):
                    prompts = assemble(rep, terms, weights, docids)
                with tracer.span("generate.lm", "generate"):
                    return gen(lm, prompts)

            tokens = be.map_query_chunks(run, Q, R["docids"])
        return Q, {"qid": Q["qid"], "docids": R["docids"],
                   "scores": R["scores"], "tokens": tokens}
