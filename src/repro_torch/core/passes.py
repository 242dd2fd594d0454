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
  fusion              — cost-gated lowering onto the CUDA kernel paths:
                        ``cutoff(retrieve)`` -> FusedTopKRetrieve
                        (kernels/topk), ``cutoff(fat_retrieve)`` ->
                        FusedFatRetrieve (kernels/fused_scoring),
                        ``cutoff(dense_retrieve)`` -> FusedDenseRetrieve
                        (kernels/dense_scoring, kernels/pq_scoring) and
                        ``retrieve >> cutoff(dense_rerank)`` ->
                        FusedDenseRerank (kernels/dense_scoring), each
                        accepted only when the op-stream cost model
                        (:func:`repro_torch.analysis.op_cost.estimate_callable`)
                        prices the fused form strictly cheaper and the
                        kernel serves its k; otherwise the unfused path is
                        kept.  ``AutotunePass`` (``descriptor.autotune``)
                        measures the candidates inside an uncertainty band
                        and tunes the IVF knobs; a persisted
                        ``TuningProfile`` replays the decisions
  schema_check        — re-infer/validate schemas on the final graph

``compile_pipeline`` is the single optimization entry point (the executor
and ``Experiment`` go through it); ``explain_pipeline`` renders the
IR before/after each pass for ``pipeline.explain()``.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import stages as S
from repro_torch.core.descriptor import BackendDescriptor, as_descriptor
from repro_torch.core.ir import Op, Schema, SchemaError, leaf, lower, pretty
from repro_torch.core.transformer import Transformer
from repro_torch.obs.metrics import CounterMap, MetricsRegistry
from repro_torch.obs.tracing import tracer_for

#: query-term width of the gate's probes, for estimates and measurements
#: alike (only cost *ratios* decide, and they are monotone in the query
#: width); doubles as the tuning profile's bucket key
GATE_MAXQ = 8
#: a PQ tile other than the default is taken only when its kernel call is
#: faster by more than this fraction, so that no tile is switched on timing
#: noise (a tile changes no result)
PQ_BLOCK_KEEP_WITHIN = 0.05


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
        #: spans are recorded by the process-global tracer only when the
        #: descriptor opted in; otherwise they reach a recording profiler
        self.tracer = tracer_for(self.descriptor)
        #: fusion-gate decisions and how many fused (``report["gate"]``)
        self.gate = CounterMap(
            self.metrics.counter(
                "compile_fusion_total", "fusion-gate decisions per compile",
                ("counter",)),
            ("gate_decisions", "fused"))
        #: the acceptance counters of the warm-reuse property: a compile
        #: served entirely from a persisted TuningProfile shows zero
        #: gate_estimates (candidate runs under the cost counter) and zero
        #: probe_measurements (``report["tuning"]``)
        self.counters = CounterMap(
            self.metrics.counter(
                "compile_tuning_total",
                "fusion-gate and autotune work per compile", ("counter",)),
            ("gate_estimates", "probe_measurements",
             "profile_hits", "profile_misses"))


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
# cost-gated fusion / kernel lowering
# ---------------------------------------------------------------------------

def _probe_queries(backend, n: int):
    """Concrete synthetic (terms, weights) probe batch [n, GATE_MAXQ] —
    deterministic (the reference's draws), so probe timings are comparable
    across candidates."""
    rng = np.random.default_rng(0)
    terms = rng.integers(0, backend.index.vocab,
                         (n, GATE_MAXQ)).astype(np.int32)
    weights = np.ones((n, GATE_MAXQ), np.float32)
    dev = backend.device
    return (torch.as_tensor(terms, device=dev),
            torch.as_tensor(weights, device=dev))


def _probe_qvecs(backend, n: int):
    rng = np.random.default_rng(0)
    qv = rng.standard_normal((n, backend.dense.dim)).astype(np.float32)
    qv /= np.maximum(np.linalg.norm(qv, axis=-1, keepdims=True), 1e-6)
    return torch.as_tensor(qv, device=backend.device)


def _estimate(backend, desc: BackendDescriptor, key, build, args,
              counters=None) -> dict:
    """Cost estimate of one candidate program on a concrete one-query probe
    (``analysis.op_cost.estimate_callable``), cached on the backend by
    content key: estimates are pure functions of the backend, the static
    params and the descriptor's peaks.  The cache is scoped by the
    descriptor's host/peak digest, so an estimate priced under one set of
    peaks, or for another device, never answers for another.  A candidate
    that raises is cached as ``{"error": text}``."""
    scope = backend.__dict__.setdefault("_cost_estimates", {})
    cache = scope.setdefault(desc.peak_digest, {})
    if key in cache:
        return cache[key]
    from repro_torch.analysis.op_cost import estimate_callable
    if counters is not None:
        counters["gate_estimates"] += 1
    try:
        est = estimate_callable(
            build(), *args(),
            peaks=(desc.peak_flops_per_s, desc.peak_bytes_per_s))
    except Exception as e:          # never fuse blind: recorded, not hidden
        est = {"error": f"{type(e).__name__}: {e}"}
    cache[key] = est
    return est


def _backend_gate_digest(backend) -> str:
    """Content digest keying this backend's tuning-profile entries (lazy
    import: plan imports this module at load time)."""
    from repro_torch.core.plan import backend_digest
    return backend_digest(backend)


def _timed(fn, args, repeats: int):
    """(least seconds over ``repeats`` calls, the first call's output) of
    ``fn(*args)``: one warm-up call first, which also absorbs a kernel's
    first-use build.  On the card each call is timed by CUDA events after
    a synchronise; on the CPU by ``time.perf_counter``."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               torch.device("cpu"))
    with torch.no_grad():
        out = fn(*args)
        best = float("inf")
        for _ in range(max(repeats, 1)):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                fn(*args)
                best = min(best, time.perf_counter() - t0)
    return best, out


def _measure_callable(fn, static_args, batched_args, repeats: int) -> float:
    """Seconds of one candidate on a concrete probe batch: the candidates
    are the port's batched functions, so ``fn(*static_args,
    *batched_args)`` runs the whole batch (no vmap), directly, never
    through the engine and its program cache."""
    return _timed(fn, (*static_args, *batched_args), repeats)[0]


class FusionPass(Pass):
    """Lower ``cutoff(retrieve)`` / ``cutoff(fat_retrieve)`` /
    ``cutoff(dense_retrieve)`` chains — and the two-stage
    ``retrieve >> cutoff(dense_rerank)`` pattern — onto the CUDA kernel
    paths, gated by the op-stream cost model: the fused candidate must
    price *strictly* cheaper than the unfused chain it replaces, else the
    unfused path is kept.  A k the kernel does not serve is rejected before
    any estimate (``"source": "kernel_limit"``: the kernels raise outside
    their k), and a candidate whose estimate raises keeps the unfused form
    (``"source": "estimate_failed"``, with the error).  Every decision
    (either way) is recorded in ``PassContext.decisions`` and, when the
    descriptor carries a :class:`~repro_torch.core.descriptor.TuningProfile`,
    persisted so the next compile against the same backend replays it with
    zero estimates.  Enablement and kernel-native limits come from the
    backend descriptor, received at pass construction."""
    name = "fusion"

    def __init__(self, descriptor: BackendDescriptor):
        self.descriptor = descriptor

    def run(self, op: Op, pctx: PassContext) -> Op:
        out = self._walk(op, pctx)
        if self.descriptor.profile is not None:
            self.descriptor.profile.save()    # no-op unless dirty
        return out

    def _walk(self, op: Op, pctx: PassContext) -> Op:
        op = _rebuild(op, [self._walk(i, pctx) for i in op.inputs])
        if op.kind == "then":
            return self._fuse_dense_rerank_pairs(op, pctx)
        if op.kind == "linear":
            return self._tune_mixed_linear(op, pctx)
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
        from repro_torch.index import retrieve as RT
        mp = be.max_postings
        model = inner.params.get("model")
        probe = lambda n: ((be.index,), _probe_queries(be, n))
        args = lambda: (be.index, *_probe_queries(be, 1))
        if inner.kind == "dense_retrieve":
            need = "pq_topk" if (inner.params.get("pq")
                                 and inner.params.get("nprobe")) \
                else "dense_topk"
            if desc.supports(need):
                return self._fuse_dense_retrieve(op, inner, K, k_in, pctx)
        elif inner.kind == "retrieve" and desc.supports("fused_topk"):
            fused = leaf(S.FusedTopKRetrieve(model=model, k=K))
            if self._gate(pctx, "topk",
                          kernel_native=desc.kernel_native("topk", K),
                          args=args,
                          unfused=("topk_unfused", model, k_in, mp),
                          fused=("topk_fused", model, K, mp),
                          build_unfused=lambda: (
                              lambda ix, t, w: RT.retrieve_topk(
                                  ix, t, w, model=model, k=k_in,
                                  max_postings=mp)),
                          build_fused=lambda: (
                              lambda ix, t, w: RT.retrieve_topk_fused(
                                  ix, t, w, model=model, k=K,
                                  max_postings=mp)),
                          probe=probe):
                pctx.trace.append(("fuse_topk", op, fused))
                return fused
        elif inner.kind == "fat_retrieve" and desc.supports("fused_scoring"):
            from repro_torch.kernels.fused_scoring.ops import models_supported
            feats = tuple(inner.params["features"])
            if not models_supported((model,) + feats):
                return op
            fused = leaf(S.FusedFatRetrieve(model=model, features=feats, k=K))
            if self._gate(pctx, "fat",
                          kernel_native=desc.kernel_native("fat", K),
                          args=args,
                          unfused=("fat_unfused", model, feats, k_in, mp),
                          fused=("fat_fused", model, feats, K, mp),
                          build_unfused=lambda: (
                              lambda ix, t, w: RT.retrieve_fat(
                                  ix, t, w, rank_model=model,
                                  feature_models=feats, k=k_in,
                                  max_postings=mp)),
                          build_fused=lambda: (
                              lambda ix, t, w: RT.retrieve_fat_fused(
                                  ix, t, w, rank_model=model,
                                  feature_models=feats, k=K,
                                  max_postings=mp)),
                          probe=probe):
                pctx.trace.append(("fuse_fat", op, fused))
                return fused
        return op

    # -- mixed-k linear fusion: measured-only (AutotunePass) ----------------
    def _tune_mixed_linear(self, op: Op, pctx: PassContext) -> Op:
        """Hook for the AutotunePass's mixed-k ``linear()`` fusion.  The
        static pass never takes it (uniform-k is the equivalence-rule
        boundary; mixed-k changes the per-model truncation depths, so it is
        only acceptable when *measured* faster)."""
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
            refine = be.pq_refine
            r = DN._pq_shortlist_depth(k_in, refine, npb * pqi.max_list_len)
            fused = leaf(S.FusedDenseRetrieve(k=K, nprobe=nprobe, pq=True,
                                              pq_shortlist=r))
            if self._gate(pctx, "pq_topk",
                          kernel_native=desc.kernel_native("pq_topk", r),
                          args=lambda: (pqi, _probe_qvecs(be, 1)),
                          unfused=("pq_topk_unfused", k_in, nprobe, refine),
                          fused=("pq_topk_fused", K, nprobe, refine, r),
                          build_unfused=lambda: (
                              lambda ix, q: DN.ivfpq_retrieve_topk(
                                  ix, q, k=k_in, nprobe=npb, refine=refine)),
                          build_fused=lambda: (
                              lambda ix, q: DN.ivfpq_retrieve_topk_fused(
                                  ix, q, k=K, nprobe=npb, refine=refine,
                                  shortlist=r)),
                          probe=lambda n: ((pqi,), (_probe_qvecs(be, n),))):
                pctx.trace.append(("fuse_pq_topk", op, fused))
                return self._tune_dense_knobs(fused, pctx)
            return op
        fused = leaf(S.FusedDenseRetrieve(k=K, nprobe=nprobe))
        if nprobe:
            npb = min(nprobe, be.ivf.n_lists)
            state = be.ivf
            build_u = lambda: (lambda ivf, q: DN.ivf_retrieve_topk(
                ivf, q, k=k_in, nprobe=npb))
            build_f = lambda: (lambda ivf, q: DN.ivf_retrieve_topk_fused(
                ivf, q, k=K, nprobe=npb))
        else:
            state = be.dense
            build_u = lambda: (lambda dn, q: DN.dense_retrieve_exact(
                dn, q, k=k_in))
            build_f = lambda: (lambda dn, q: DN.dense_retrieve_exact_fused(
                dn, q, k=K))
        if self._gate(pctx, "dense_topk",
                      kernel_native=desc.kernel_native("dense_topk", K),
                      args=lambda: (state, _probe_qvecs(be, 1)),
                      unfused=("dense_topk_unfused", k_in, nprobe),
                      fused=("dense_topk_fused", K, nprobe),
                      build_unfused=build_u, build_fused=build_f,
                      probe=lambda n: ((state,), (_probe_qvecs(be, n),))):
            pctx.trace.append(("fuse_dense_topk", op, fused))
            return self._tune_dense_knobs(fused, pctx) if nprobe else fused
        return op

    def _tune_dense_knobs(self, op: Op, pctx: PassContext) -> Op:
        """Hook for the AutotunePass's IVF knob search (``nprobe``, the PQ
        kernel's tile).  The static pass keeps the configured knobs: a
        different ``nprobe`` changes which lists are scanned, so it is only
        acceptable when *measured* both faster and within the descriptor's
        result-overlap band."""
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
        from repro_torch.index import retrieve as RT
        be = pctx.backend
        K = b.params["k"]
        k_in = a.params.get("k") or be.default_k
        if K > k_in:
            return None
        K = min(K, be.index.n_docs)
        k_in = min(k_in, be.index.n_docs)
        model = a.params["model"]
        alpha = b.inputs[0].params["alpha"]
        mp = be.max_postings
        fused = leaf(S.FusedDenseRerank(model=model, k_in=k_in, k=K,
                                        alpha=alpha))
        if self._gate(pctx, "dense_rerank",
                      kernel_native=self.descriptor.kernel_native(
                          "dense_rerank", K),
                      args=lambda: (be.index, be.dense.emb,
                                    *_probe_queries(be, 1),
                                    _probe_qvecs(be, 1)),
                      unfused=("dense_rerank_unfused", model, k_in, K,
                               alpha, mp),
                      fused=("dense_rerank_fused", model, k_in, K,
                             alpha, mp),
                      build_unfused=lambda: (
                          lambda ix, emb, t, w, q: RT.retrieve_dense_rerank(
                              ix, emb, t, w, q, model=model, k_in=k_in, k=K,
                              alpha=alpha, max_postings=mp)),
                      build_fused=lambda: (
                          lambda ix, emb, t, w, q:
                          RT.retrieve_dense_rerank_fused(
                              ix, emb, t, w, q, model=model, k_in=k_in, k=K,
                              alpha=alpha, max_postings=mp)),
                      probe=lambda n: (
                          (be.index, be.dense.emb),
                          (*_probe_queries(be, n), _probe_qvecs(be, n)))):
            pctx.trace.append(("fuse_dense_rerank", Op("then", {}, (a, b)),
                               fused))
            return fused
        return None

    def _gate(self, pctx, pattern, *, unfused, fused, build_unfused,
              build_fused, args, kernel_native: bool = True,
              probe=None, require_measured: bool = False) -> bool:
        """One gate decision.  Resolution order: a k the kernel does not
        serve (rejected, nothing estimated) -> persisted TuningProfile hit
        (zero estimates, zero probes) -> cost estimates of both candidates
        on ``args()`` -> the subclass ``_decide`` policy (base: estimate-only
        strict-less-than; AutotunePass: probe-measure inside the
        uncertainty band).  Fresh decisions are recorded back into the
        profile."""
        be = pctx.backend
        desc = self.descriptor
        pctx.gate["gate_decisions"] += 1
        if not kernel_native:
            pctx.decisions.append({
                "pattern": pattern, "accepted": False,
                "kernel_native": False, "source": "kernel_limit",
                "unfused_key": unfused, "fused_key": fused})
            return False
        prof = desc.profile
        opk = (pattern, fused, unfused)
        bd = None
        if prof is not None:
            bd = _backend_gate_digest(be)
            hit = prof.lookup(bd, opk, GATE_MAXQ)
            if hit is not None:
                pctx.counters["profile_hits"] += 1
                d = dict(hit)
                d["source"] = "profile"
                pctx.decisions.append(d)
                pctx.gate["fused"] += bool(d["accepted"])
                return bool(d["accepted"])
            pctx.counters["profile_misses"] += 1
        est_u = _estimate(be, desc, unfused, build_unfused, args,
                          counters=pctx.counters)
        est_f = _estimate(be, desc, fused, build_fused, args,
                          counters=pctx.counters)
        d = self._decide(pctx, desc, est_u, est_f, build_unfused,
                         build_fused, probe, require_measured)
        ok_u, ok_f = "error" not in est_u, "error" not in est_f
        d.update({
            "pattern": pattern, "kernel_native": kernel_native,
            "unfused_key": unfused, "fused_key": fused,
            "unfused_proxy_s": est_u["time_proxy_s"] if ok_u else None,
            "fused_proxy_s": est_f["time_proxy_s"] if ok_f else None,
            "unfused_flops": est_u["flops_per_chip"] if ok_u else None,
            "unfused_bytes": est_u["bytes_per_chip"] if ok_u else None,
            "fused_flops": est_f["flops_per_chip"] if ok_f else None,
            "fused_bytes": est_f["bytes_per_chip"] if ok_f else None,
        })
        pctx.decisions.append(d)
        pctx.gate["fused"] += bool(d["accepted"])
        if prof is not None:
            prof.record(bd, opk, GATE_MAXQ, d)
        return d["accepted"]

    def _decide(self, pctx, desc, est_u, est_f, build_unfused, build_fused,
                probe, require_measured: bool = False) -> dict:
        """Static policy: accept iff the fused estimate prices *strictly*
        cheaper.  A candidate whose estimate raised keeps the unfused form
        (``"estimate_failed"``, the error recorded).  Semantics-affecting
        candidates (``require_measured``) are never taken on estimates
        alone, so the static gate rejects them."""
        errors = [e["error"] for e in (est_u, est_f) if "error" in e]
        d = {"accepted": False, "source": "estimate",
             "unfused_measured_s": None, "fused_measured_s": None}
        if errors:
            d.update(source="estimate_failed", error="; ".join(errors))
        elif not require_measured:
            d["accepted"] = est_f["time_proxy_s"] < est_u["time_proxy_s"]
        return d


class AutotunePass(FusionPass):
    """Measurement-driven fusion gate (opt-in: ``descriptor.autotune``).

    Two extensions over the static gate.  (1) When the estimated margin
    between the candidates, ``|fused - unfused| / unfused`` over the proxy
    times, is within ``descriptor.autotune_band`` — the regime where the
    static roofline is least trustworthy — both lowerings are measured on
    a small concrete probe batch (CUDA events on the card) and the
    *measured* winner is recorded.  (2) Mixed-k ``linear()`` combinations,
    which the equivalence rewriter must skip (per-model truncation depths
    differ), are lowered to a single MultiRetrieve when — and only when —
    measured faster.  Either way the decision lands in the TuningProfile
    exactly like the static gate's, so the next compile replays it with
    zero probes."""
    name = "autotune"

    def _decide(self, pctx, desc, est_u, est_f, build_unfused, build_fused,
                probe, require_measured: bool = False) -> dict:
        d = super()._decide(pctx, desc, est_u, est_f, build_unfused,
                            build_fused, probe, require_measured)
        measure = require_measured
        if not measure and d["source"] == "estimate":
            pu, pf = est_u["time_proxy_s"], est_f["time_proxy_s"]
            measure = pu > 0 and abs(pf - pu) / pu <= desc.autotune_band
        if not measure or probe is None:
            return d
        try:
            static_args, batched_args = probe(desc.probe_queries)
            m_u = _measure_callable(build_unfused(), static_args,
                                    batched_args, desc.probe_repeats)
            m_f = _measure_callable(build_fused(), static_args,
                                    batched_args, desc.probe_repeats)
        except Exception as e:   # probe failure: the estimate's decision
            d["probe_error"] = f"{type(e).__name__}: {e}"
            return d
        pctx.counters["probe_measurements"] += 2
        d.update({"accepted": bool(m_f < m_u), "source": "measured",
                  "unfused_measured_s": m_u, "fused_measured_s": m_f})
        return d

    # -- IVF knob search: nprobe, and the PQ kernel's tile on the card ------
    def _tune_dense_knobs(self, op: Op, pctx: PassContext) -> Op:
        """Measured ``nprobe`` search around the configured value, on an
        already accepted fused dense stage.  Speed alone would always shrink
        ``nprobe`` (fewer lists scanned is strictly less work) and silently
        trash recall, so a candidate is eligible only if its top-K overlap
        against the *widest* candidate stays within the descriptor's
        ``autotune_band``; the fastest eligible candidate wins.  For PQ on
        the card the PQ-scoring kernel's tile is probed next
        (:meth:`_tune_pq_block`); the plain version the CPU runs has no
        tiles."""
        be = pctx.backend
        params = dict(op.params)
        nprobe = params.get("nprobe")
        if not nprobe:
            return op
        from repro_torch.index import dense as DN
        pq = bool(params.get("pq"))
        K = params["k"]
        if pq:
            index = be.ivfpq
            refine = be.pq_refine
            sl = params.get("pq_shortlist")
            fn_for = lambda c: (lambda ix, q: DN.ivfpq_retrieve_topk_fused(
                ix, q, k=K, nprobe=c, refine=refine, shortlist=sl))
        else:
            index = be.ivf
            refine = None
            fn_for = lambda c: (lambda ix, q: DN.ivf_retrieve_topk_fused(
                ix, q, k=K, nprobe=c))
        npb = min(int(nprobe), index.n_lists)
        cands = sorted({max(1, npb // 2), npb,
                        min(2 * npb, index.n_lists)})
        chosen = self._probe_knob(
            pctx, pattern="nprobe_tune", knob="nprobe", configured=npb,
            cands=cands, index=index, fn_for=fn_for,
            extra_key=(pq, K, refine))
        if chosen is not None and chosen != params["nprobe"]:
            params["nprobe"] = chosen
            op = leaf(S.FusedDenseRetrieve(**params))
        if pq and index.codes.is_cuda:
            op = self._tune_pq_block(op, pctx, index, refine)
        return op

    def _tune_pq_block(self, op: Op, pctx: PassContext, index,
                       refine: int) -> Op:
        """The PQ-scoring kernel's tile (``pq_block``, rows a tile) on the
        card, probed on the kernel alone: the stage's ADC inputs (codes,
        tables and bases of a chunk's worth of probe queries) are built
        once, and each candidate tile's kernel call is timed by CUDA
        events.  The default tile (the largest that fits) is kept unless
        another beats it by more than ``PQ_BLOCK_KEEP_WITHIN``; every tile
        gives the same result."""
        from repro_torch.index import dense as DN
        from repro_torch.kernels.pq_scoring.ops import plan, streaming_pq_topk
        params = dict(op.params)
        K = params["k"]
        npb = min(int(params["nprobe"]), index.n_lists)
        sl = params.get("pq_shortlist")
        n_rows = npb * index.max_list_len
        # the default tile is the largest that fits the segment and the
        # shared memory, so the candidates are it, its half and quarter
        tile = plan(n_rows, index.m, index.codebook.n_codes)[2]
        blocks = sorted({plan(n_rows, index.m, index.codebook.n_codes, b)[2]
                         for b in (tile // 4, tile // 2, tile)})
        adc = {}

        def blk_for(c):
            def f(ix, q):
                if not adc:
                    codes, table, base, _, r = DN._pq_candidates(
                        ix, q, k=K, nprobe=npb, refine=refine, shortlist=sl)
                    adc.update(args=(codes, table, base), r=r)
                vals, rows = streaming_pq_topk(*adc["args"], k=adc["r"],
                                               block=c)
                return rows, vals
            return f
        chosen = self._probe_knob(
            pctx, pattern="pq_block_tune", knob="pq_block",
            configured=params.get("pq_block") or tile, cands=blocks,
            index=index, fn_for=blk_for,
            extra_key=(params["nprobe"], K, refine),
            n_queries=pctx.backend.query_chunk,
            keep_within=PQ_BLOCK_KEEP_WITHIN)
        if chosen is not None and chosen != tile:
            params["pq_block"] = chosen
            op = leaf(S.FusedDenseRetrieve(**params))
        return op

    def _probe_knob(self, pctx, *, pattern, knob, configured, cands,
                    index, fn_for, extra_key, n_queries: int | None = None,
                    keep_within: float = 0.0):
        """Measure each knob candidate on the concrete probe batch
        (``n_queries`` probe queries, default ``probe_queries``); return
        the fastest whose top-K doc overlap vs the widest candidate is >=
        1 - autotune_band, or the configured value where it is eligible and
        within ``keep_within`` (a fraction) of the fastest (None = keep the
        configured value).  Decisions are persisted in the TuningProfile and
        replayed like gate decisions."""
        desc = self.descriptor
        be = pctx.backend
        prof = desc.profile
        opk = (pattern, knob, tuple(cands), extra_key)
        bd = None
        if prof is not None:
            bd = _backend_gate_digest(be)
            hit = prof.lookup(bd, opk, GATE_MAXQ)
            if hit is not None:
                pctx.counters["profile_hits"] += 1
                d = dict(hit)
                d["source"] = "profile"
                pctx.decisions.append(d)
                return d.get("chosen")
            pctx.counters["profile_misses"] += 1
        if len(cands) < 2:
            return None
        try:
            qvecs = _probe_qvecs(be, n_queries or desc.probe_queries)
            times, docs = {}, {}
            for c in cands:
                times[c], out = _timed(fn_for(c), (index, qvecs),
                                       desc.probe_repeats)
                docs[c] = out[0].cpu().numpy()
        except Exception as e:     # probe failure: keep the configured knob
            pctx.decisions.append({
                "pattern": pattern, "knob": knob, "configured": configured,
                "candidates": list(cands), "chosen": None, "accepted": False,
                "source": "probe_failed", "kernel_native": True,
                "error": f"{type(e).__name__}: {e}"})
            return None
        pctx.counters["probe_measurements"] += len(cands)
        ref = docs[cands[-1]]

        def overlap(a):
            tot = 0.0
            for i in range(ref.shape[0]):
                want = {int(x) for x in ref[i] if x >= 0}
                got = {int(x) for x in a[i] if x >= 0}
                tot += len(want & got) / max(len(want), 1)
            return tot / max(ref.shape[0], 1)

        ovl = {c: overlap(docs[c]) for c in cands}
        floor = 1.0 - desc.autotune_band
        eligible = [c for c in cands if ovl[c] >= floor]
        chosen = min(eligible, key=lambda c: times[c]) if eligible \
            else cands[-1]
        if keep_within and configured in eligible and \
                times[configured] <= times[chosen] * (1.0 + keep_within):
            chosen = configured
        d = {"pattern": pattern, "knob": knob, "configured": configured,
             "candidates": list(cands), "chosen": chosen,
             "accepted": bool(chosen != configured), "source": "measured",
             "measured_knob_s": {str(c): times[c] for c in cands},
             "overlap_at_k": {str(c): ovl[c] for c in cands},
             "kernel_native": True,
             "unfused_proxy_s": None, "fused_proxy_s": None,
             "unfused_measured_s": None, "fused_measured_s": None}
        pctx.decisions.append(d)
        if prof is not None:
            prof.record(bd, opk, GATE_MAXQ, d)
        return chosen

    def _tune_mixed_linear(self, op: Op, pctx: PassContext) -> Op:
        """Σ wᵢ·Retrieve(mᵢ, kᵢ) with *differing* kᵢ -> MultiRetrieve at
        max(kᵢ) when measured faster.  ``retrieve_multi`` combines the full
        score vectors before the final top-k (no per-model truncation), so
        the fused program is identical whatever the children's ks — but it
        is NOT equivalent to the truncating unfused sum, hence
        measured-only."""
        desc = self.descriptor
        be = pctx.backend
        if not desc.supports("multi_model"):
            return op
        ks, models = [], []
        for c in op.inputs:
            if c.kind != "retrieve":
                return op
            ks.append(min(c.params["k"] or be.default_k, be.index.n_docs))
            models.append(c.params["model"])
        if len(models) < 2 or len(set(ks)) == 1:
            return op
        from repro_torch.index import retrieve as RT
        mtuple = tuple(models)
        weights = tuple(op.params["weights"])
        kmax = max(ks)
        mp = be.max_postings
        mw = torch.tensor(weights, dtype=torch.float32, device=be.device)

        def build_fused():
            def f(ix, t, w):
                return RT.retrieve_multi(ix, t, w, mw, models=mtuple,
                                         k=kmax, max_postings=mp)
            return f

        def build_unfused():
            def f(ix, t, w):
                return tuple(
                    RT.retrieve_topk(ix, t, w, model=m, k=kc,
                                     max_postings=mp)
                    for m, kc in zip(mtuple, ks))
            return f

        fused = leaf(S.MultiRetrieve(models=mtuple, weights=weights, k=kmax))
        if self._gate(pctx, "multi_mixed", kernel_native=True,
                      args=lambda: (be.index, *_probe_queries(be, 1)),
                      unfused=("multi_mixed_unfused", mtuple, tuple(ks), mp),
                      fused=("multi_mixed_fused", mtuple, weights, kmax, mp),
                      build_unfused=build_unfused, build_fused=build_fused,
                      probe=lambda n: ((be.index,), _probe_queries(be, n)),
                      require_measured=True):
            pctx.trace.append(("tune_multi_mixed", op, fused))
            return fused
        return op


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def default_passes(descriptor: BackendDescriptor) -> list[Pass]:
    """The standard pass pipeline, parameterised by the backend
    descriptor; ``descriptor.autotune`` selects the measurement-driven
    fusion gate."""
    fusion_cls = AutotunePass if descriptor.autotune else FusionPass
    return [CanonicalizePass(), SchemaPass("schema_inference"),
            RewritePass(descriptor), CSEPass(), fusion_cls(descriptor),
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
    timings, the fusion gate's decisions, its decision counts (``gate``)
    and its tuning work (``tuning``: estimates, probe measurements and
    profile hits and misses); ``pctx`` supplies a context of one's own
    (``explain`` keeps its IR snapshots) and then carries the trace and
    CSE table itself — ``trace=`` and ``cse_table=`` keep
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
        report["gate"] = dict(pctx.gate)
        report["tuning"] = dict(pctx.counters)
    return op


def explain_pipeline(node: Transformer, backend=None, *,
                     optimize: bool = True) -> str:
    """Render the IR before/after each pass (``pipeline.explain()``), then
    each gate decision: predicted (and, where probed, measured) fused vs
    unfused seconds and its source, and each tuned knob."""
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
        fmt = lambda v: "n/a" if v is None else f"{v:.4e}s"
        if d.get("knob"):
            out.append(
                f"-- autotune knob [{d['pattern']}]: "
                f"{d['knob']}={d['chosen']} "
                f"(configured {d['configured']}, "
                f"candidates {d['candidates']}, "
                f"{d.get('source', 'measured')})")
            continue
        line = (f"-- fusion gate [{d['pattern']}]: "
                f"{'fused' if d['accepted'] else 'kept unfused'} "
                f"(predicted fused {fmt(d.get('fused_proxy_s'))} vs "
                f"unfused {fmt(d.get('unfused_proxy_s'))}")
        if d.get("fused_measured_s") is not None:
            line += (f"; measured fused {fmt(d['fused_measured_s'])} vs "
                     f"unfused {fmt(d['unfused_measured_s'])}")
        line += f", kernel_native={d['kernel_native']}, {d['source']}"
        if d.get("error"):
            line += f": {d['error']}"
        out.append(line + ")")
    return "\n".join(out)


def _safe_annotate(op: Op, backend):
    try:
        return annotate(op, backend)
    except SchemaError:
        return None
