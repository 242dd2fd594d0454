"""Pass-manager compiler over the typed pipeline IR (paper §4).

An explicit ordered pipeline of IR-to-IR passes:

  canonicalise        — re-establish the canonical variadic forms (flatten
                        Then-of-Then / FeatureUnion nests, inline Scale and
                        Linear children into Linear weights)
  schema_inference    — infer per-op :class:`~repro_torch.core.ir.Schema`
                        (Q/R/F/A stream, static k, feature width) and
                        validate the typing rules (a rank cutoff must attach
                        to an R-producing expression; generate reads R and
                        its A stream is terminal)
  rewrite             — the equivalence rules (cutoff merge/into-then/
                        scale-swap/pushdown, fat fusion, linear fusion,
                        scale folding)
                        applied bottom-up to fixpoint against the backend
                        capability descriptor
  cse                 — hash-cons structurally identical subgraphs into
                        shared op instances
  fusion              — lowering onto the CUDA kernel paths:
                        ``cutoff(retrieve)`` -> FusedTopKRetrieve
                        (kernels/topk), ``cutoff(fat_retrieve)`` ->
                        FusedFatRetrieve (kernels/fused_scoring),
                        ``cutoff(dense_retrieve)`` -> FusedDenseRetrieve
                        (kernels/dense_scoring, kernels/pq_scoring) and
                        ``retrieve >> cutoff(dense_rerank)`` ->
                        FusedDenseRerank (kernels/dense_scoring).  All are
                        exact rewrites, so the gate is the capability plus
                        the kernel-native predicate; every decision is
                        recorded with ``"source": "capability"``
  schema_check        — re-infer/validate schemas on the final graph

``compile_pipeline`` is the single optimization entry point (the executor
and ``Experiment`` go through it); ``explain_pipeline`` renders the
IR before/after each pass for ``pipeline.explain()``.
"""
from __future__ import annotations

import time
from typing import Callable

from repro_torch.core import stages as S
from repro_torch.core.descriptor import BackendDescriptor, as_descriptor
from repro_torch.core.ir import Op, Schema, SchemaError, leaf, lower, pretty
from repro_torch.core.transformer import Transformer
from repro_torch.obs.metrics import CounterMap, MetricsRegistry
from repro_torch.obs.tracing import NOOP_TRACER, get_tracer


# ---------------------------------------------------------------------------
# schema inference
# ---------------------------------------------------------------------------

_RETRIEVER_KINDS = frozenset({"retrieve", "pruned_retrieve", "multi_retrieve",
                              "fused_topk_retrieve", "dense_retrieve",
                              "fused_dense_retrieve", "fused_dense_rerank"})
_FAT_KINDS = frozenset({"fat_retrieve", "fused_fat_retrieve"})


def _carry(s_in: Schema | None):
    return (None, None) if s_in is None else (s_in.k, s_in.width)


def _reject_answer(st: Schema, where: str, child: Op) -> None:
    """A is terminal: no ranking combinator may consume an answer stream."""
    if st.out == "A":
        raise SchemaError(
            f"{where} typed against an answer-bearing (A) expression "
            f"({child.label()}): generate is terminal — no ranking stage "
            f"may consume its output")


def _stage_schema(op: Op, s_in: Schema | None, backend,
                  annot: dict | None) -> Schema:
    """Schema of ``op``'s output stream given the schema of the incoming R
    stream (None = statically unknown / absent)."""
    kind = op.kind
    k_in, w_in = _carry(s_in)
    if s_in is not None and s_in.out == "A":
        raise SchemaError(
            f"stage {op.label()} typed against an answer-bearing (A) "
            f"stream: generate is terminal — no stage may consume its "
            f"output")
    if kind in _RETRIEVER_KINDS:
        k = op.params.get("k") or (backend.default_k if backend else None)
        out = Schema("R", k, None, False)
    elif kind in _FAT_KINDS:
        k = op.params.get("k") or (backend.default_k if backend else None)
        out = Schema("F", k, len(op.params["features"]), False)
    elif kind == "extract":
        out = Schema("F", k_in, None if s_in is None else (w_in or 0) + 1,
                     True)
    elif kind in ("sdm_rewrite", "stem_rewrite"):
        out = Schema("Q", k_in, w_in, False)
    elif kind == "rm3":
        out = Schema("Q", k_in, w_in, True)
    elif kind == "ltr":
        out = Schema("F", k_in, w_in, True)
    elif kind == "dense_rerank":
        out = Schema("F" if s_in is not None and s_in.out == "F" else "R",
                     k_in, w_in, True)
    elif kind == "generate":
        if s_in is None:
            raise SchemaError(
                f"generate ({op.label()}) typed against a pure Q -> Q "
                f"expression: prompt assembly reads ranked results, so "
                f"generate may only follow an R-producing expression")
        # A: answer-bearing results; k carries the result depth the prompt
        # reads, width the static decode length
        out = Schema("A", k_in, op.params["max_new_tokens"], True)
    elif kind == "then":
        r_sch = s_in
        child_outs = []
        for c in op.inputs:
            st = _stage_schema(c, r_sch, backend, annot)
            child_outs.append(st)
            if st.out != "Q":
                r_sch = st
        if all(st.out == "Q" for st in child_outs):
            out = Schema("Q", *_carry(r_sch),
                         any(st.reads_results for st in child_outs))
        else:
            out = Schema(r_sch.out, r_sch.k, r_sch.width,
                         any(st.reads_results for st in child_outs))
    elif kind == "cutoff":
        st = _stage_schema(op.inputs[0], s_in, backend, annot)
        if st.out == "Q":
            raise SchemaError(
                f"rank cutoff %{op.params['k']} typed against a pure "
                f"Q -> Q expression ({op.inputs[0].label()}): a cutoff may "
                f"only attach to an R-producing expression")
        if st.out == "A":
            raise SchemaError(
                f"rank cutoff %{op.params['k']} typed against an "
                f"answer-bearing (A) expression ({op.inputs[0].label()}): "
                f"generate is terminal — apply the cutoff before it")
        K = op.params["k"]
        out = Schema(st.out, K if st.k is None else min(K, st.k), st.width,
                     st.reads_results)
    elif kind == "scale":
        st = _stage_schema(op.inputs[0], s_in, backend, annot)
        _reject_answer(st, "score scale", op.inputs[0])
        out = Schema(st.out, st.k, st.width, st.reads_results)
    elif kind == "linear":
        sts = [_stage_schema(c, s_in, backend, annot) for c in op.inputs]
        for st, c in zip(sts, op.inputs):
            _reject_answer(st, "linear combination", c)
        ks = [st.k for st in sts]
        out = Schema("R", None if any(k is None for k in ks) else max(ks),
                     None, any(st.reads_results for st in sts))
    elif kind in ("setop", "concat"):
        s1 = _stage_schema(op.inputs[0], s_in, backend, annot)
        s2 = _stage_schema(op.inputs[1], s_in, backend, annot)
        _reject_answer(s1, f"{kind} operand", op.inputs[0])
        _reject_answer(s2, f"{kind} operand", op.inputs[1])
        if kind == "setop" and op.params.get("op") == "intersect":
            k = s1.k
        else:
            k = None if s1.k is None or s2.k is None else s1.k + s2.k
        out = Schema("R", k, None, s1.reads_results or s2.reads_results)
    elif kind == "feature_union":
        sts = [_stage_schema(c, s_in, backend, annot) for c in op.inputs]
        for st, c in zip(sts, op.inputs):
            _reject_answer(st, "feature union", c)
        widths = [st.width if st.width else 1 for st in sts]
        out = Schema("F", sts[0].k,
                     None if any(st.out == "F" and st.width is None
                                 for st in sts) else sum(widths),
                     any(st.reads_results for st in sts))
    else:
        # unknown leaf (Generic, user extensions): class attrs, no statics
        ref = op.ref
        out = Schema(ref.out_kind if ref is not None else "R", None, None,
                     ref.reads_results if ref is not None else True)
    if annot is not None:
        annot[id(op)] = out
    return out


def annotate(root: Op, backend=None) -> dict[int, Schema]:
    """id(op) -> Schema for every op in ``root`` (validates as it goes)."""
    annot: dict[int, Schema] = {}
    _stage_schema(root, None, backend, annot)
    return annot


def expr_schema(op: Op, backend=None) -> Schema:
    """Schema of an expression evaluated against an unknown input stream
    (``out == "Q"`` = pure query rewrite) — the bits rewrite rules guard
    on."""
    return _stage_schema(op, None, backend, None)


# ---------------------------------------------------------------------------
# pass infrastructure
# ---------------------------------------------------------------------------

class PassContext:
    """Shared state for one compile: backend + its descriptor, rewrite
    trace, fusion-gate decisions, CSE table, per-pass IR snapshots and
    timings."""

    def __init__(self, backend, *, trace: list | None = None,
                 cse_table: dict | None = None, keep_snapshots: bool = False):
        self.backend = backend
        self.descriptor = as_descriptor(backend)
        self.trace: list = trace if trace is not None else []
        #: CSE interning table (one compile, or shared by the planner across
        #: the pipelines of an Experiment)
        self.cse_table: dict = cse_table if cse_table is not None else {}
        self.decisions: list[dict] = []
        self.snapshots: list[tuple[str, Op]] = []
        self.keep_snapshots = keep_snapshots
        self.timings: list[tuple[str, float]] = []
        #: per-compile metrics registry; the compile report reads the gate
        #: counts through it
        self.metrics = MetricsRegistry()
        #: spans route to the process-global tracer only when the
        #: descriptor opted in — the default is the shared no-op
        self.tracer = (get_tracer() if self.descriptor.observability
                       else NOOP_TRACER)
        self.counters = CounterMap(
            self.metrics.counter(
                "compile_fusion_total", "fusion-gate decisions per compile",
                ("counter",)),
            ("gate_decisions", "fused"))


class Pass:
    name = "pass"

    def run(self, op: Op, pctx: PassContext) -> Op:
        raise NotImplementedError


class PassManager:
    def __init__(self, passes: list[Pass]):
        self.passes = list(passes)

    def run(self, op: Op, pctx: PassContext) -> Op:
        if pctx.keep_snapshots:
            pctx.snapshots.append(("lower", op))
        with pctx.tracer.span("compile.pipeline", "compile",
                              n_passes=len(self.passes)):
            for p in self.passes:
                t0 = time.perf_counter()
                with pctx.tracer.span(f"compile.pass.{p.name}", "compile"):
                    op = p.run(op, pctx)
                pctx.timings.append((p.name, time.perf_counter() - t0))
                if pctx.keep_snapshots:
                    pctx.snapshots.append((p.name, op))
        return op


def _rebuild(op: Op, new_inputs: list[Op]) -> Op:
    if len(new_inputs) == len(op.inputs) and \
            all(a is b for a, b in zip(new_inputs, op.inputs)):
        return op
    return op.with_inputs(new_inputs)


# ---------------------------------------------------------------------------
# canonicalise
# ---------------------------------------------------------------------------

class CanonicalizePass(Pass):
    """Re-establish the canonical variadic node forms on IR (the operator
    constructors guarantee them at build time; rewrites re-run this)."""
    name = "canonicalise"

    def run(self, op: Op, pctx: PassContext) -> Op:
        return self._walk(op)

    def _walk(self, op: Op) -> Op:
        op = _rebuild(op, [self._walk(i) for i in op.inputs])
        if op.kind == "then" and any(i.kind == "then" for i in op.inputs):
            flat: list[Op] = []
            for i in op.inputs:
                flat.extend(i.inputs if i.kind == "then" else [i])
            return Op("then", {}, flat)
        if op.kind == "feature_union" and \
                any(i.kind == "feature_union" for i in op.inputs):
            flat = []
            for i in op.inputs:
                flat.extend(i.inputs if i.kind == "feature_union" else [i])
            return Op("feature_union", {}, flat)
        if op.kind == "linear" and \
                any(i.kind in ("linear", "scale") for i in op.inputs):
            ws, cs = [], []
            for w, c in zip(op.params["weights"], op.inputs):
                if c.kind == "linear":
                    ws.extend(w * wi for wi in c.params["weights"])
                    cs.extend(c.inputs)
                elif c.kind == "scale":
                    ws.append(w * c.params["alpha"])
                    cs.append(c.inputs[0])
                else:
                    ws.append(w)
                    cs.append(c)
            return Op("linear", {"weights": tuple(ws)}, cs)
        return op


# ---------------------------------------------------------------------------
# schema inference / validation
# ---------------------------------------------------------------------------

class SchemaPass(Pass):
    """Infer + validate schemas over the whole graph (raises SchemaError on
    ill-typed pipelines; the inferred annotations drive explain())."""

    def __init__(self, name: str = "schema_inference"):
        self.name = name

    def run(self, op: Op, pctx: PassContext) -> Op:
        annotate(op, pctx.backend)
        return op


# ---------------------------------------------------------------------------
# rewrite rules over IR
# ---------------------------------------------------------------------------

IRRule = Callable[[Op, PassContext], "Op | None"]
#: (name, rule, required capability or None) — capability-gated rules are
#: filtered once at pass construction against the backend descriptor
IR_RULES: list[tuple[str, IRRule, str | None]] = []


def ir_rule(name: str, requires: str | None = None):
    def deco(fn):
        IR_RULES.append((name, fn, requires))
        return fn
    return deco


@ir_rule("cutoff_merge")
def cutoff_merge(op, pctx):
    if op.kind == "cutoff" and op.inputs[0].kind == "cutoff":
        inner = op.inputs[0]
        k = min(op.params["k"], inner.params["k"])
        return Op("cutoff", {"k": k}, (inner.inputs[0],))
    return None


@ir_rule("cutoff_into_then")
def cutoff_into_then(op, pctx):
    """(A >> B) % K -> A >> (B % K), guarded on B's schema: a rank cutoff is
    only typed for R-producing expressions.  Trailing Q -> Q rewrites that
    never read R are hopped over — sound, they cannot observe the
    truncation — so the cutoff lands on the last R-producing stage and stays
    eligible for the RQ1 pushdown / kernel lowering.  An R-*reading* query
    rewrite blocks the push."""
    if not (op.kind == "cutoff" and op.inputs[0].kind == "then"):
        return None
    kids = list(op.inputs[0].inputs)
    be = pctx.backend
    i, st = len(kids) - 1, None
    while i >= 0:
        st = expr_schema(kids[i], be)
        if not (st.out == "Q" and not st.reads_results):
            break
        i -= 1
    if i < 0 or st is None or st.out == "Q":
        return None
    last = Op("cutoff", {"k": op.params["k"]}, (kids[i],))
    return Op("then", {}, (*kids[:i], last, *kids[i + 1:]))


@ir_rule("cutoff_scale_swap")
def cutoff_scale_swap(op, pctx):
    if op.kind == "cutoff" and op.inputs[0].kind == "scale":
        sc = op.inputs[0]
        if sc.params["alpha"] > 0:
            inner = Op("cutoff", {"k": op.params["k"]}, (sc.inputs[0],))
            return Op("scale", {"alpha": sc.params["alpha"]}, (inner,))
    return None


@ir_rule("cutoff_pushdown", requires="pruned_topk")
def cutoff_pushdown(op, pctx):
    """Retrieve % K -> PrunedRetrieve(K): the RQ1 dynamic-pruning rewrite."""
    if op.kind == "cutoff" and op.inputs[0].kind == "retrieve":
        ret = op.inputs[0]
        K = op.params["k"]
        if ret.params["k"] is None or ret.params["k"] >= K:
            return leaf(S.PrunedRetrieve(model=ret.params["model"], k=K))
    return None


def _as_extract_models(inputs) -> tuple[str, ...] | None:
    models = []
    for c in inputs:
        if c.kind != "extract":
            return None
        models.append(c.params["model"])
    return tuple(models)


@ir_rule("fat_fusion", requires="fat")
def fat_fusion(op, pctx):
    """Retrieve >> (Extract ** ... ** Extract) -> FatRetrieve: RQ2 (a single
    Extract is the degenerate one-feature case)."""
    if op.kind != "then":
        return None
    kids = list(op.inputs)
    for i in range(len(kids) - 1):
        a, b = kids[i], kids[i + 1]
        if a.kind != "retrieve":
            continue
        if b.kind == "feature_union":
            models = _as_extract_models(b.inputs)
        elif b.kind == "extract":
            models = (b.params["model"],)
        else:
            continue
        if models is None:
            continue
        fat = leaf(S.FatRetrieve(model=a.params["model"], features=models,
                                 k=a.params["k"]))
        new_kids = kids[:i] + [fat] + kids[i + 2:]
        return new_kids[0] if len(new_kids) == 1 else Op("then", {}, new_kids)
    return None


@ir_rule("linear_fusion", requires="multi_model")
def linear_fusion(op, pctx):
    """Σ wᵢ·Retrieve(mᵢ, k) on one index -> MultiRetrieve (one postings
    pass instead of N — beyond-paper rewrite enabled by score_all).  The
    uniform-k guard is the equivalence boundary."""
    if op.kind != "linear":
        return None
    ks = set()
    models = []
    for c in op.inputs:
        if c.kind != "retrieve":
            return None
        ks.add(c.params["k"])
        models.append(c.params["model"])
    if len(ks) != 1 or len(models) < 2:
        return None
    return leaf(S.MultiRetrieve(models=tuple(models),
                                weights=tuple(op.params["weights"]),
                                k=ks.pop()))


@ir_rule("scale_fold")
def scale_fold(op, pctx):
    if op.kind != "scale":
        return None
    inner = op.inputs[0]
    a = op.params["alpha"]
    if a == 1.0:
        return inner
    if inner.kind == "scale":
        return Op("scale", {"alpha": a * inner.params["alpha"]},
                  (inner.inputs[0],))
    if inner.kind == "linear":
        return Op("linear",
                  {"weights": tuple(a * w for w in inner.params["weights"])},
                  inner.inputs)
    return None


class RewritePass(Pass):
    """Bottom-up application of the equivalence rules to a fixpoint.
    Capability-gated rules are filtered ONCE against the backend descriptor
    at pass construction; the match loop never probes the backend."""
    name = "rewrite"

    MAX_ITERS = 20

    def __init__(self, descriptor: BackendDescriptor):
        self._rules = [(name, rule) for name, rule, req in IR_RULES
                       if req is None or descriptor.supports(req)]

    def run(self, op: Op, pctx: PassContext) -> Op:
        for _ in range(self.MAX_ITERS):
            new = self._walk(op, pctx)
            if new.key() == op.key():
                return new
            op = new
        return op

    def _walk(self, op: Op, pctx: PassContext) -> Op:
        op = _rebuild(op, [self._walk(i, pctx) for i in op.inputs])
        for name, rule in self._rules:
            out = rule(op, pctx)
            if out is not None and out.key() != op.key():
                pctx.trace.append((name, op, out))
                return self._walk(out, pctx)
        return op


# ---------------------------------------------------------------------------
# common-subexpression elimination
# ---------------------------------------------------------------------------

class CSEPass(Pass):
    """Hash-cons structurally identical subgraphs into shared op instances.
    Keys are content keys, so two pipelines building ``Retrieve("BM25")``
    separately intern to ONE op; stateful stages and object-identity params
    embed uid/id in their key, so distinct live objects never merge."""
    name = "cse"

    def run(self, op: Op, pctx: PassContext) -> Op:
        return self._intern(op, pctx.cse_table)

    def _intern(self, op: Op, table: dict) -> Op:
        op = _rebuild(op, [self._intern(i, table) for i in op.inputs])
        hit = table.get(op.key())
        if hit is None:
            table[op.key()] = op
            return op
        return hit


# ---------------------------------------------------------------------------
# kernel lowering
# ---------------------------------------------------------------------------

class FusionPass(Pass):
    """Lower ``cutoff(retrieve)``, ``cutoff(fat_retrieve)``,
    ``cutoff(dense_retrieve)`` and ``retrieve >> cutoff(dense_rerank)``
    onto the CUDA kernel paths.  Every fused form is an exact rewrite of
    the chain it replaces, so the gate is the backend's capability plus the
    kernel-native predicate (a k the kernel itself serves); the measured
    gate over CUDA events is later work.  Every decision (either way) is
    recorded in ``PassContext.decisions``."""
    name = "fusion"

    def __init__(self, descriptor: BackendDescriptor):
        self.descriptor = descriptor

    def run(self, op: Op, pctx: PassContext) -> Op:
        return self._walk(op, pctx)

    def _walk(self, op: Op, pctx: PassContext) -> Op:
        op = _rebuild(op, [self._walk(i, pctx) for i in op.inputs])
        if op.kind == "then":
            return self._fuse_dense_rerank_pairs(op, pctx)
        if op.kind != "cutoff" or not op.inputs[0].is_leaf:
            return op
        desc = self.descriptor
        inner = op.inputs[0]
        be = pctx.backend
        K = op.params["k"]
        k_in = inner.params.get("k") or be.default_k
        if K > k_in:
            return op
        # clamp to the corpus size as the stage executors do
        K = min(K, be.index.n_docs)
        k_in = min(k_in, be.index.n_docs)
        model = inner.params.get("model")
        if inner.kind == "dense_retrieve":
            need = "pq_topk" if (inner.params.get("pq")
                                 and inner.params.get("nprobe")) \
                else "dense_topk"
            if desc.supports(need):
                return self._fuse_dense_retrieve(op, inner, K, k_in, pctx)
        elif inner.kind == "retrieve" and desc.supports("fused_topk"):
            fused = leaf(S.FusedTopKRetrieve(model=model, k=K))
            if self._gate(pctx, "topk", desc.kernel_native("topk", K)):
                pctx.trace.append(("fuse_topk", op, fused))
                return fused
        elif inner.kind == "fat_retrieve" and desc.supports("fused_scoring"):
            from repro_torch.kernels.fused_scoring.ops import models_supported
            feats = tuple(inner.params["features"])
            if not models_supported((model,) + feats):
                return op
            fused = leaf(S.FusedFatRetrieve(model=model, features=feats, k=K))
            if self._gate(pctx, "fat", desc.kernel_native("fat", K)):
                pctx.trace.append(("fuse_fat", op, fused))
                return fused
        return op

    # -- dense candidate generation: cutoff(dense_retrieve) -----------------
    def _fuse_dense_retrieve(self, op: Op, inner: Op, K: int, k_in: int,
                             pctx: PassContext) -> Op:
        from repro_torch.index import dense as DN
        be = pctx.backend
        desc = self.descriptor
        nprobe = inner.params["nprobe"]
        if nprobe and inner.params.get("pq"):
            # two-level IVF-PQ: the fused stage keeps the *unfused* chain's
            # ADC shortlist depth (from the pre-cutoff k_in), so fusion
            # stays exact — the cutoff of the re-scored shortlist commutes
            # with selecting K directly.  The kernel must carry that depth,
            # so kernel_native is evaluated at it
            pqi = be.ivfpq
            npb = min(nprobe, pqi.n_lists)
            r = DN._pq_shortlist_depth(k_in, be.pq_refine,
                                       npb * pqi.max_list_len)
            fused = leaf(S.FusedDenseRetrieve(k=K, nprobe=nprobe, pq=True,
                                              pq_shortlist=r))
            if self._gate(pctx, "pq_topk", desc.kernel_native("pq_topk", r)):
                pctx.trace.append(("fuse_pq_topk", op, fused))
                return fused
            return op
        fused = leaf(S.FusedDenseRetrieve(k=K, nprobe=nprobe))
        if self._gate(pctx, "dense_topk",
                      desc.kernel_native("dense_topk", K)):
            pctx.trace.append(("fuse_dense_topk", op, fused))
            return fused
        return op

    # -- dense second stage: retrieve >> cutoff(dense_rerank) --------------
    def _fuse_dense_rerank_pairs(self, op: Op, pctx: PassContext) -> Op:
        """Within a ``then`` chain, lower each adjacent ``retrieve,
        cutoff(dense_rerank)`` pair to one FusedDenseRerank stage (the
        rewrite pass has already pushed the pipeline-level cutoff onto the
        last R-producer, so the paper's ``bm25 >> neural % K`` arrives here
        in exactly this shape)."""
        if not self.descriptor.supports("fused_dense"):
            return op
        kids = list(op.inputs)
        changed = False
        i = 0
        while i < len(kids) - 1:
            fused = self._try_dense_rerank_pair(kids[i], kids[i + 1], pctx)
            if fused is not None:
                kids[i:i + 2] = [fused]
                changed = True
            else:
                i += 1
        if not changed:
            return op
        return kids[0] if len(kids) == 1 else Op("then", {}, kids)

    def _try_dense_rerank_pair(self, a: Op, b: Op,
                               pctx: PassContext) -> Op | None:
        if not (a.kind == "retrieve" and b.kind == "cutoff"
                and b.inputs[0].kind == "dense_rerank"):
            return None
        be = pctx.backend
        K = b.params["k"]
        k_in = a.params.get("k") or be.default_k
        if K > k_in:
            return None
        K = min(K, be.index.n_docs)
        k_in = min(k_in, be.index.n_docs)
        fused = leaf(S.FusedDenseRerank(model=a.params["model"], k_in=k_in,
                                        k=K,
                                        alpha=b.inputs[0].params["alpha"]))
        if self._gate(pctx, "dense_rerank",
                      self.descriptor.kernel_native("dense_rerank", K)):
            pctx.trace.append(("fuse_dense_rerank", Op("then", {}, (a, b)),
                               fused))
            return fused
        return None

    def _gate(self, pctx: PassContext, pattern: str,
              kernel_native: bool) -> bool:
        pctx.counters["gate_decisions"] += 1
        if kernel_native:
            pctx.counters["fused"] += 1
        pctx.decisions.append({"pattern": pattern, "accepted": kernel_native,
                               "kernel_native": kernel_native,
                               "source": "capability"})
        return kernel_native


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def default_passes(descriptor: BackendDescriptor) -> list[Pass]:
    """The standard pass pipeline, parameterised by the backend
    descriptor."""
    return [CanonicalizePass(), SchemaPass("schema_inference"),
            RewritePass(descriptor), CSEPass(), FusionPass(descriptor),
            SchemaPass("schema_check")]


def compile_pipeline(node: Transformer | Op, backend, *,
                     optimize: bool = True, trace: list | None = None,
                     cse_table: dict | None = None,
                     report: dict | None = None,
                     pctx: PassContext | None = None) -> Op:
    """Lower a pipeline to IR and (optionally) run the pass pipeline.

    ``optimize=False`` lowers only — the unoptimised semantics.  ``trace``
    (a list, appended in place) receives the rewrites as (rule, before,
    after); ``cse_table`` may be shared across calls to intern ops across
    pipelines; ``report`` (a dict, filled in place) receives per-pass
    timings and the fusion gate's decisions; ``pctx`` supplies a context of
    one's own (``explain`` keeps its IR snapshots) and then carries the
    trace and CSE table itself — ``trace=`` and ``cse_table=`` keep
    ``repro.core.passes.compile_pipeline``'s signature.
    """
    op = node if isinstance(node, Op) else lower(node)
    if not optimize:
        return op
    pctx = pctx or PassContext(backend, trace=trace, cse_table=cse_table)
    op = PassManager(default_passes(pctx.descriptor)).run(op, pctx)
    if report is not None:
        report["pass_timings_s"] = list(pctx.timings)
        report["fusion_decisions"] = list(pctx.decisions)
        report["snapshots"] = list(pctx.snapshots)
        report["gate"] = dict(pctx.counters)
    return op


def explain_pipeline(node: Transformer, backend=None, *,
                     optimize: bool = True) -> str:
    """Render the IR before/after each pass (``pipeline.explain()``)."""
    op = lower(node)
    if backend is None or not optimize:
        return "== lowered IR ==\n" + pretty(op, _safe_annotate(op, backend))
    pctx = PassContext(backend, keep_snapshots=True)
    compile_pipeline(op, backend, pctx=pctx)
    out = []
    prev_key = None
    for name, snap in pctx.snapshots:
        if prev_key is not None and snap.key() == prev_key:
            out.append(f"== after {name}: (unchanged)")
            continue
        prev_key = snap.key()
        head = "lowered IR" if name == "lower" else f"after {name}"
        out.append(f"== {head} ==\n" + pretty(snap, _safe_annotate(snap,
                                                                   backend)))
    for d in pctx.decisions:
        out.append(f"-- fusion gate [{d['pattern']}]: "
                   f"{'fused' if d['accepted'] else 'kept unfused'} "
                   f"(kernel_native={d['kernel_native']}, {d['source']})")
    return "\n".join(out)


def _safe_annotate(op: Op, backend):
    try:
        return annotate(op, backend)
    except SchemaError:
        return None
