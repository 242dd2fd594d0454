"""Pipeline compiler + executor (paper §4).

``run_pipeline`` = lower to the typed IR -> run the pass-manager compiler
(canonicalise, schema inference, rewrite rules, CSE, kernel lowering —
``core/passes.py``) -> execute the IR with hash-consed result caching
(identical sub-pipelines run once per query set — the paper's
grid-search/common-prefix caching).  Combinator ops are interpreted here;
leaf ops delegate to their stage payload.

Result identity is *content-addressed*: the memo key for a node is
``(node.key(), token)`` where ``token`` digests the actual input tensors at
the pipeline source and is then derived structurally
(``token' = H(node.key(), token)``) as data flows through the DAG.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
import weakref

import numpy as np
import torch

from repro_torch.common import resolve_device, topk
from repro_torch.core.descriptor import BackendDescriptor
from repro_torch.core.engine import ShardedQueryEngine, StageProgram
from repro_torch.core.ir import Op, lower
from repro_torch.core.transformer import Transformer
from repro_torch.index.inverted import BLOCK, InvertedIndex


# ---------------------------------------------------------------------------
# backend
# ---------------------------------------------------------------------------

#: monotonic backend ids that scope the engine's cache keys (an id() would
#: be recycled)
_BACKEND_UID = itertools.count()


class TorchBackend:
    """Execution backend over the torch index: capability descriptor plus
    bucketed query execution on one device (the engine), the dense second
    stage's state (embeddings, query projection, IVF and IVF-PQ indexes)
    and the generate stage's LMs (``register_lm``).

    The optimisation surface consulted by the rewrite/fusion passes lives
    on ``self.descriptor``; pass ``descriptor=BackendDescriptor.default(
    capability_set)`` to restrict it.  ``device=None`` means the card and
    raises without one; the index is moved there if it lives elsewhere.

    The dense state is built on first use, so a sparse-only backend pays
    nothing for it: ``dense`` (pass one to share it across backends), the
    query projection (the same draws as the embeddings' projection), the
    IVF-flat index with ``ivf_lists`` lists and the IVF-PQ index with
    ``pq_m`` subspaces (``ivf=`` / ``ivfpq=`` supply ready ones).

    Stages run through a :class:`~repro_torch.core.engine
    .ShardedQueryEngine` with the ladder ``bucket_ladder``, or ``engine=``
    to share one.  Without ``bucket_ladder`` the ladder is
    ``(query_chunk,)`` when ``query_chunk`` is given, so the engine chunks
    the query axis as the sequential loop does, and ``(8, 16, 32)`` when
    neither is.  ``sharded=False``, or ``REPRO_ENGINE=sequential`` in the
    environment, keeps the unpadded loop over chunks of ``query_chunk``
    queries (16 when not given) instead."""

    def __init__(self, index: InvertedIndex, dense=None, *,
                 default_k: int = 1000, query_chunk: int | None = None,
                 descriptor: BackendDescriptor | None = None, device=None,
                 sharded: bool | None = None,
                 engine: ShardedQueryEngine | None = None,
                 bucket_ladder=None, ivf=None, ivf_lists: int | None = None,
                 ivfpq=None, pq_m: int = 8, pq_refine: int = 4):
        self.device = resolve_device(device)
        self.uid = next(_BACKEND_UID)
        if index.device != self.device:
            index = dataclasses.replace(
                index, **{n: a.to(self.device)
                          for n, a in index.arrays().items()})
        self.index = index
        self.default_k = min(default_k, index.n_docs)
        self.query_chunk = 16 if query_chunk is None else int(query_chunk)
        self.descriptor = (descriptor if descriptor is not None
                           else BackendDescriptor.default(device=self.device))
        # stopwords are removed at index time (build_index), so the global
        # max posting-list length is the gather width
        lens = index.term_start[1:] - index.term_start[:-1]
        self.max_postings = int(lens.max())
        self.max_blocks_per_term = self.max_postings // BLOCK
        self.total_blocks = int(index.doc_ids.shape[0]) // BLOCK
        if dense is not None and dense.emb.device != self.device:
            dense = dataclasses.replace(dense, emb=dense.emb.to(self.device))
        self._dense = dense
        self._qproj_t = None
        self._ivf = ivf
        self.ivf_lists = ivf_lists
        self._ivfpq = ivfpq
        #: supplied dense state is digested by content, state built here
        #: by the config it is built from (``plan.backend_digest``)
        self._external = {"dense": dense is not None, "ivf": ivf is not None,
                          "ivfpq": ivfpq is not None}
        self.pq_m = int(pq_m)
        self.pq_refine = int(pq_refine)
        #: name -> (LMConfig, TransformerLM): decoder LMs the generate stage
        #: resolves by name, so its IR params stay scalar
        self._lms: dict = {}
        if sharded is None:
            sharded = os.environ.get("REPRO_ENGINE", "sharded") != "sequential"
        if bucket_ladder is None and query_chunk is not None:
            bucket_ladder = (self.query_chunk,)
        self.engine = (engine if engine is not None
                       else ShardedQueryEngine(self.device, ladder=bucket_ladder)
                       if sharded else None)

    # -- generate-stage LMs --------------------------------------------------
    def register_lm(self, name: str, cfg, params=None, *, seed: int = 0):
        """Register a decoder LM under ``name`` for the generate stage.

        ``cfg`` is a :class:`repro_torch.models.transformer_lm.LMConfig`;
        ``params`` (a ``TransformerLM`` on this backend's device) defaults
        to a fresh :func:`~repro_torch.models.transformer_lm.init_params`
        draw on the device from a generator seeded with ``seed``.  The
        generate stage refers to the model by name only."""
        from repro_torch.models import transformer_lm as tlm
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = tlm.init_params(cfg, gen)
        dev = params.embed.device
        if dev.type != self.device.type:
            raise ValueError(f"LM {name!r} lies on {dev}, the backend on "
                             f"{self.device}")
        self._lms[name] = (cfg, params)
        return self

    def lm(self, name: str):
        """(cfg, params) of a registered LM; KeyError names the gap."""
        try:
            return self._lms[name]
        except KeyError:
            raise KeyError(
                f"no LM registered as {name!r} on this backend "
                f"(have {sorted(self._lms)}); call "
                f"backend.register_lm(name, cfg) first") from None

    # -- dense second stage --------------------------------------------------
    @property
    def dense(self):
        """Dense doc embeddings (``repro_torch.index.dense.DenseIndex``),
        built on first use from the forward file."""
        if self._dense is None:
            from repro_torch.index.dense import build_dense_index
            self._dense = build_dense_index(self.index)
        return self._dense

    @property
    def _qproj(self) -> torch.Tensor:
        """The query projection [vocab, dim]: numpy's draws from the
        embeddings' seed, the same draws as their projection."""
        if self._qproj_t is None:
            from repro_torch.index.dense import projection
            self._qproj_t = projection(self.index.vocab, self.dense.dim,
                                       self.dense.seed, self.device)
        return self._qproj_t

    @property
    def ivf(self):
        """IVF-flat dense index, built on first use from the dense
        embeddings with ``ivf_lists`` lists."""
        if self._ivf is None:
            from repro_torch.index.dense import build_ivf_index
            self._ivf = build_ivf_index(self.dense, n_lists=self.ivf_lists)
        return self._ivf

    @property
    def ivfpq(self):
        """IVF-PQ compressed dense index, built on first use.  Shares the
        coarse quantiser with ``self.ivf`` when that is already built;
        otherwise builds a ``keep_flat=False`` skeleton."""
        if self._ivfpq is None:
            from repro_torch.index.dense import build_ivfpq_index
            self._ivfpq = build_ivfpq_index(self.dense, n_lists=self.ivf_lists,
                                            m=self.pq_m, ivf=self._ivf)
        return self._ivfpq

    def embed_queries(self, Q) -> torch.Tensor:
        """Q's terms/weights [NQ, MAXQ] -> unit query vectors [NQ, dim]."""
        from repro_torch.index.dense import embed_queries
        return embed_queries(self._qproj, Q["terms"], Q["weights"])

    def map_query_chunks(self, fn, Q, *extra, key=None):
        """Run the batched ``fn(terms, weights, *extra)`` (``fn(*extra)``
        when Q is None) over the query axis and return its outputs (a
        tensor or a tuple of tensors) for all queries.  Routed through the
        engine when there is one (the default); ``key`` (the stage's
        structural key) names the engine's cache entry, scoped by this
        backend's uid: stage keys do not embed the index, which ``fn``
        closes over, so an engine shared across backends would otherwise
        mix them.  Without an engine, the sequential loop."""
        if self.engine is not None:
            scoped = None if key is None else (self.uid, key)
            return self.engine.run(StageProgram(key=scoped, fn=fn), Q, *extra)
        return self.map_query_chunks_sequential(fn, Q, *extra)

    def barrier(self, tree=None):
        """Wait until the device has computed ``tree`` (the engine's
        barrier, a synchronize of the card; nothing on the CPU)."""
        if self.engine is not None:
            return self.engine.barrier(tree)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return tree

    def map_query_chunks_sequential(self, fn, Q, *extra):
        """The unpadded loop over chunks of ``query_chunk`` queries, their
        outputs concatenated along the query axis: the engine's baseline
        and escape hatch (``REPRO_ENGINE=sequential``)."""
        args = ((Q["terms"], Q["weights"]) if Q is not None else ()) + extra
        nq = args[0].shape[0]
        if nq == 0:
            raise ValueError("empty query batch")
        c = min(self.query_chunk, nq)
        outs = [fn(*(a[s:s + c] for a in args)) for s in range(0, nq, c)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(xs, 0) for xs in zip(*outs))
        return torch.cat(outs, 0)

    def label_results(self, Q, R, qrels: dict[int, dict[int, int]]):
        """Join a result list with qrels -> dense grade matrix [NQ, K]
        (float32, on this backend's device)."""
        qids = Q["qid"].cpu().numpy()
        docids = R["docids"].cpu().numpy()
        labels = np.zeros(docids.shape, np.float32)
        for i, q in enumerate(qids):
            g = qrels.get(int(q), {})
            if g:
                labels[i] = [g.get(int(d), 0) if d >= 0 else 0
                             for d in docids[i]]
        return torch.as_tensor(labels, device=self.device)


# ---------------------------------------------------------------------------
# combinator semantics (paper Table 2 relational definitions)
# ---------------------------------------------------------------------------

_INT32_MAX = torch.iinfo(torch.int32).max


def _aggregate_rows(docs, scores, k_out):
    """Per-query CombSUM over rows: sum scores of duplicate docids, top
    k_out.  docs/scores [NQ, n]."""
    NQ, n = docs.shape
    order = torch.argsort(docs, dim=1, stable=True)
    d = torch.gather(docs, 1, order)
    s = torch.gather(scores, 1, order)
    first = torch.cat([torch.ones_like(d[:, :1], dtype=torch.bool),
                       d[:, 1:] != d[:, :-1]], 1)
    seg = torch.cumsum(first.long(), 1) - 1
    agg = torch.zeros((NQ, n), dtype=s.dtype, device=s.device)
    agg.scatter_add_(1, seg, s)
    rep = torch.where(first & (d >= 0), torch.gather(agg, 1, seg), -torch.inf)
    top_s, idx = topk(rep, k_out)
    ok = torch.isfinite(top_s)
    return (torch.where(ok, torch.gather(d, 1, idx), -1).to(torch.int32),
            torch.where(ok, top_s, -torch.inf))


def _combine_linear(all_docs, all_scores, weights):
    """all_docs [NQ, C, K]; weights [C] -> CombSUM over the union."""
    NQ, C, K = all_docs.shape
    s = torch.where(all_docs >= 0, all_scores * weights[None, :, None], 0.0)
    return _aggregate_rows(all_docs.reshape(NQ, C * K), s.reshape(NQ, C * K),
                           K)


def _setop_union(d1, s1, d2, s2):
    """Union of two result lists; scores are ⊥ (=0, to be re-ranked)."""
    docs = torch.cat([d1, d2], 1)
    d = torch.gather(docs, 1, torch.argsort(docs, dim=1, stable=True))
    first = torch.cat([torch.ones_like(d[:, :1], dtype=torch.bool),
                       d[:, 1:] != d[:, :-1]], 1) & (d >= 0)
    key = torch.where(first, d, _INT32_MAX)
    order2 = torch.argsort(key, dim=1, stable=True)
    d = torch.where(torch.gather(first, 1, order2),
                    torch.gather(d, 1, order2), -1)
    return d, torch.where(d >= 0, 0.0, -torch.inf)


def _setop_intersect(d1, s1, d2, s2):
    member = ((d1[:, :, None] == d2[:, None, :]) &
              (d1 >= 0)[:, :, None]).any(2)
    key = torch.where(member, d1, _INT32_MAX)
    order = torch.argsort(key, dim=1, stable=True)
    d = torch.where(torch.gather(member, 1, order),
                    torch.gather(d1, 1, order), -1)
    return d, torch.where(d >= 0, 0.0, -torch.inf)


def _concat_rankings(d1, s1, d2, s2, eps=1e-3):
    """Paper ^: append R2\\R1 below R1 with shifted scores."""
    dup = ((d2[:, :, None] == d1[:, None, :]) & (d2 >= 0)[:, :, None]).any(2)
    v1 = d1 >= 0
    v2 = (d2 >= 0) & ~dup
    min1 = torch.where(v1, s1, torch.inf).amin(1, keepdim=True)
    max2 = torch.where(v2, s2, -torch.inf).amax(1, keepdim=True)
    min1 = torch.where(torch.isfinite(min1), min1, 0.0)
    max2 = torch.where(torch.isfinite(max2), max2, 0.0)
    s2n = s2 - max2 + min1 - eps
    docs = torch.cat([torch.where(v1, d1, -1), torch.where(v2, d2, -1)], 1)
    scores = torch.cat([torch.where(v1, s1, -torch.inf),
                        torch.where(v2, s2n, -torch.inf)], 1)
    order = torch.argsort(-scores, dim=1, stable=True)
    return torch.gather(docs, 1, order), torch.gather(scores, 1, order)


def _feature_columns(R):
    if "features" in R:
        return R["features"]
    return R["scores"][..., None]


def _align_features(base_docs, child_docs, child_feats):
    """Align child feature rows onto base docids ((qid,docid) join)."""
    eq = (base_docs[:, :, None] == child_docs[:, None, :]) & \
        (base_docs >= 0)[:, :, None]
    return torch.einsum("qbc,qcf->qbf", eq.to(child_feats.dtype), child_feats)


# op-kind -> executor for combinator IR ops; each receives the content token
# of its input so sub-pipeline results can be memoised soundly
def _exec_then(op, ctx, Q, R, tok):
    for child in op.inputs:
        Q, R, tok = _execute(child, ctx, Q, R, tok)
    return Q, R


def _pad_cols(x, K, value):
    return torch.nn.functional.pad(x, (0, K - x.shape[1]), value=value)


def _exec_linear(op, ctx, Q, R, tok):
    outs = [_execute(c, ctx, Q, R, tok)[1] for c in op.inputs]
    K = max(o["docids"].shape[1] for o in outs)
    docs = torch.stack([_pad_cols(o["docids"], K, -1) for o in outs], 1)
    scores = torch.stack([_pad_cols(o["scores"], K, -torch.inf)
                          for o in outs], 1)
    w = torch.tensor(op.params["weights"], dtype=torch.float32,
                     device=scores.device)
    d, s = _combine_linear(docs, scores, w)
    return Q, {"qid": Q["qid"], "docids": d, "scores": s}


def _exec_scale(op, ctx, Q, R, tok):
    Q, R1, _ = _execute(op.inputs[0], ctx, Q, R, tok)
    a = op.params["alpha"]
    return Q, {**R1, "scores": torch.where(R1["docids"] >= 0,
                                           R1["scores"] * a, -torch.inf)}


def _exec_cutoff(op, ctx, Q, R, tok):
    Q, R1, _ = _execute(op.inputs[0], ctx, Q, R, tok)
    k = op.params["k"]
    out = {**R1, "docids": R1["docids"][:, :k], "scores": R1["scores"][:, :k]}
    if "features" in R1:
        out["features"] = R1["features"][:, :k]
    return Q, out


def _exec_setop(op, ctx, Q, R, tok):
    _, R1, _ = _execute(op.inputs[0], ctx, Q, R, tok)
    _, R2, _ = _execute(op.inputs[1], ctx, Q, R, tok)
    fn = _setop_union if op.params["op"] == "union" else _setop_intersect
    d, s = fn(R1["docids"], R1["scores"], R2["docids"], R2["scores"])
    return Q, {"qid": Q["qid"], "docids": d, "scores": s}


def _exec_concat(op, ctx, Q, R, tok):
    _, R1, _ = _execute(op.inputs[0], ctx, Q, R, tok)
    _, R2, _ = _execute(op.inputs[1], ctx, Q, R, tok)
    d, s = _concat_rankings(R1["docids"], R1["scores"],
                            R2["docids"], R2["scores"])
    return Q, {"qid": Q["qid"], "docids": d, "scores": s}


def _exec_feature_union(op, ctx, Q, R, tok):
    outs = [_execute(c, ctx, Q, R, tok)[1] for c in op.inputs]
    base = outs[0]
    cols = [_feature_columns(base)]
    for o in outs[1:]:
        cols.append(_align_features(base["docids"], o["docids"],
                                    _feature_columns(o)))
    return Q, {**base, "features": torch.cat(cols, -1)}


_COMBINATORS = {
    "then": _exec_then, "linear": _exec_linear, "scale": _exec_scale,
    "cutoff": _exec_cutoff, "setop": _exec_setop, "concat": _exec_concat,
    "feature_union": _exec_feature_union,
}


# ---------------------------------------------------------------------------
# execution engine with content-addressed result caching
# ---------------------------------------------------------------------------

def _flatten(tree):
    """(structure string, leaves) of a nest of dicts/tuples/lists/None with
    tensor or array leaves; dict keys in sorted order."""
    if tree is None:
        return "None", []
    if isinstance(tree, dict):
        parts, leaves = [], []
        for k in sorted(tree):
            s, lv = _flatten(tree[k])
            parts.append(f"{k}:{s}")
            leaves += lv
        return "{" + ",".join(parts) + "}", leaves
    if isinstance(tree, (tuple, list)):
        parts, leaves = [], []
        for x in tree:
            s, lv = _flatten(x)
            parts.append(s)
            leaves += lv
        return "(" + ",".join(parts) + ")", leaves
    return "*", [tree]


def _host(leaf):
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) \
        else leaf


def content_token(tree) -> str:
    """Digest of the actual contents of a (Q, R)-like nest of tensors: the
    *source* token of a pipeline run (unlike ``id()``-keyed tokens it
    cannot alias after garbage collection)."""
    struct, leaves = _flatten(tree)
    h = hashlib.sha256(struct.encode())
    for leaf in leaves:
        a = _host(leaf)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def derive_token(node_key, token_in: str) -> str:
    """Token of a node's output: H(producing node key, input token)."""
    h = hashlib.sha256(repr(node_key).encode())
    h.update(token_in.encode())
    return h.hexdigest()


@dataclasses.dataclass
class Context:
    """Shared execution state: result memo keyed by (node key, input token),
    plus per-node execution counters."""
    backend: TorchBackend
    memo: dict = dataclasses.field(default_factory=dict)
    exec_counts: dict = dataclasses.field(default_factory=dict)
    #: strong refs to executed nodes — node keys embed id()s of non-scalar
    #: params (e.g. Generic fns), which stay unique only while alive
    _pins: dict = dataclasses.field(default_factory=dict)
    #: id -> (weakref, version, digest): avoids re-hashing the same live,
    #: unchanged tensors
    _leaf_tokens: dict = dataclasses.field(default_factory=dict)

    def pin(self, node) -> None:
        self._pins[id(node)] = node

    def _leaf_token(self, leaf) -> str:
        # a tensor's version counter moves with every in-place edit, through
        # any view of it too (views share their base's counter); a leaf that
        # is not a tensor has none and keeps its first digest
        version = getattr(leaf, "_version", None)
        ent = self._leaf_tokens.get(id(leaf))
        if ent is not None and ent[0]() is leaf and ent[1] == version:
            # identity check makes the id-keyed cache sound: a dead ref can
            # never vouch for a recycled id
            return ent[2]
        a = _host(leaf)
        h = hashlib.sha256(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
        tok = h.hexdigest()
        try:
            self._leaf_tokens[id(leaf)] = (weakref.ref(leaf), version, tok)
        except TypeError:
            pass                      # non-weakrefable leaf: just rehash
        return tok

    def source_token(self, Q, R) -> str:
        struct, leaves = _flatten((Q, R))
        h = hashlib.sha256(struct.encode())
        for leaf in leaves:
            h.update(self._leaf_token(leaf).encode())
        return h.hexdigest()


def _execute(op, ctx: Context, Q, R, tok: str | None = None):
    """Execute an IR op on (Q, R); returns ``(Q', R', token')`` where
    ``token'`` content-addresses the output.  A ``Transformer`` is lowered
    on the fly (keys are representation-independent)."""
    if isinstance(op, Transformer):
        op = lower(op)
    if tok is None:
        tok = ctx.source_token(Q, R)
    ctx.pin(op)
    if op.ref is not None:
        ctx.pin(op.ref)
    key = op.key()
    memo_key = (key, tok)
    hit = ctx.memo.get(memo_key)
    if hit is not None:
        return hit
    fn = _COMBINATORS.get(op.kind)
    if fn is not None:
        Q2, R2 = fn(op, ctx, Q, R, tok)
    else:
        ctx.exec_counts[key] = ctx.exec_counts.get(key, 0) + 1
        Q2, R2 = op.ref.execute(ctx, Q, R)
    out = (Q2, R2, derive_token(key, tok))
    ctx.memo[memo_key] = out
    return out


def run_pipeline(node: Transformer | Op, Q, R=None, *, backend: TorchBackend,
                 optimize: bool = True, ctx: Context | None = None):
    from repro_torch.core.passes import compile_pipeline
    # Op inputs go through the same compile path (the passes are idempotent
    # on already-compiled IR)
    op = compile_pipeline(node, backend, optimize=optimize)
    ctx = ctx or Context(backend)
    Q2, R2, _ = _execute(op, ctx, Q, R)
    return R2 if R2 is not None else Q2


def fit_pipeline(root: Transformer, Q_train, qrels_train, Q_valid,
                 qrels_valid, *, backend: TorchBackend):
    """Depth-first fit: run the (uncompiled) pipeline; each stateful node
    receives the (Q, R) flowing into it plus qrels (paper eq. 9 semantics)
    and fits before it executes."""
    ctx = Context(backend)

    def walk(node, st, sv):
        # st / sv: (Q, R, token) train / validation streams
        if node.kind == "then":
            for child in node.children:
                st, sv = walk(child, st, sv)
            return st, sv
        # fit children first (they feed this node)
        for child in node.children:
            walk(child, st, sv)
        return _execute_prefit(node, st), \
            (_execute_prefit(node, sv) if sv is not None else None)

    def _execute_prefit(node, state):
        Q, R, tok = state
        if node.stateful:
            # must fit BEFORE executing (execute needs trained state)
            node._fit_local(ctx, Q, R, qrels_train, None, None, qrels_valid)
        return _execute(node, ctx, Q, R, tok)

    sv0 = None
    if Q_valid is not None:
        sv0 = (Q_valid, None, ctx.source_token(Q_valid, None))
    walk(root, (Q_train, None, ctx.source_token(Q_train, None)), sv0)
    return root
