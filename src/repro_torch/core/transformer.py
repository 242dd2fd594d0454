"""Transformers + operators: the declarative pipeline algebra (paper §3).

A :class:`Transformer` is a *declarative node*: composing transformers with
the eight overloaded operators (Table 2) builds an expression DAG — nothing
executes until ``transform()`` / ``Experiment`` triggers compilation.  The
DAG is normalised on construction (associative ops flattened to variadic
nodes) so the rewriter's pattern matching is canonical.

    pipe = (Retrieve(bm25) % 10) >> (Extract("QL") ** Extract("TF_IDF")) >> ltr
    R = pipe(Q, backend=backend)          # compile (+optimise) then execute

Operator -> node mapping:
    >> Then     + Linear     * Scale      ** FeatureUnion
    |  Union    & Intersect  % Cutoff     ^ Concat
"""
from __future__ import annotations

import itertools
from typing import Sequence

_UID = itertools.count()


def canon_param_items(params: dict) -> tuple:
    """Canonical hashable view of a params dict — the single definition the
    Transformer algebra and the typed IR (core/ir.py) both key on, so a
    lowered op and the node it was lowered from always agree."""
    items = []
    for k, v in sorted(params.items()):
        if isinstance(v, (list, tuple)):
            v = tuple(v)
        elif not isinstance(v, (int, float, str, bool, type(None))):
            v = ("obj", id(v))
        items.append((k, v))
    return tuple(items)


class Transformer:
    kind: str = "abstract"
    #: stateful nodes (learned rerankers) include a version in their key
    stateful: bool = False
    #: primary output stream: "R" for result-producing stages, "Q" for
    #: query-rewrite (Q -> Q) stages.  Rank-cutoff rewrites consult this —
    #: a % K must only ever attach to an R-producing expression.
    out_kind: str = "R"
    #: whether execute() reads the incoming result list R.  A cutoff may
    #: hop over a Q -> Q stage only if that stage never looks at R.
    reads_results: bool = True

    def __init__(self, children: Sequence["Transformer"] = (), **params):
        self.children = tuple(children)
        self.params = dict(params)
        self.uid = next(_UID)
        self.version = 0

    # -- structural identity (for rewriting + plan/result caching) ---------
    def key(self) -> tuple:
        state = (self.uid, self.version) if self.stateful else ()
        return (self.kind, canon_param_items(self.params), state,
                tuple(c.key() for c in self.children))

    def __repr__(self):
        inner = ", ".join([repr(c) for c in self.children] +
                          [f"{k}={v!r}" for k, v in self.params.items()
                           if not hasattr(v, "shape") and k != "index"])
        return f"{type(self).__name__}({inner})"

    # -- execution ----------------------------------------------------------
    def transform(self, Q, R=None, *, backend=None, optimize: bool = True,
                  ctx=None):
        from repro_torch.core.compiler import run_pipeline
        return run_pipeline(self, Q, R, backend=backend, optimize=optimize,
                            ctx=ctx)

    def __call__(self, Q, R=None, **kw):
        return self.transform(Q, R, **kw)

    def explain(self, backend=None, *, optimize: bool = True) -> str:
        """Render the typed IR of this pipeline before/after each compiler
        pass (schema annotations included once a backend is given)."""
        from repro_torch.core.passes import explain_pipeline
        return explain_pipeline(self, backend, optimize=optimize)

    def execute(self, ctx, Q, R):  # overridden by concrete nodes
        raise NotImplementedError(self.kind)

    # -- training protocol (paper eq. 9) -------------------------------------
    def fit(self, Q_train, qrels_train, Q_valid=None, qrels_valid=None, *,
            backend=None):
        """Depth-first: fit every stateful stage, feeding it the output of
        its upstream prefix (other transformers applied as needed)."""
        from repro_torch.core.compiler import fit_pipeline
        fit_pipeline(self, Q_train, qrels_train, Q_valid, qrels_valid,
                     backend=backend)
        return self

    def _fit_local(self, ctx, Q, R, qrels, Q_valid, R_valid, qrels_valid):
        pass  # stateless by default

    # -- operators ------------------------------------------------------------
    def __rshift__(self, other):
        return Then.of(self, _coerce(other))

    def __add__(self, other):
        return Linear.of((1.0, self), (1.0, _coerce(other)))

    def __radd__(self, other):
        if other == 0:   # support sum()
            return self
        return _coerce(other) + self

    def __mul__(self, alpha):
        return Scale.of(float(alpha), self)

    __rmul__ = __mul__

    def __pow__(self, other):
        return FeatureUnion.of(self, _coerce(other))

    def __or__(self, other):
        return SetOp(children=[self, _coerce(other)], op="union")

    def __and__(self, other):
        return SetOp(children=[self, _coerce(other)], op="intersect")

    def __mod__(self, k: int):
        return Cutoff(children=[self], k=int(k))

    def __xor__(self, other):
        return Concat(children=[self, _coerce(other)])


def _coerce(x) -> "Transformer":
    if isinstance(x, Transformer):
        return x
    if callable(x):
        return Generic(fn=x)
    raise TypeError(f"cannot use {x!r} as a transformer")


# ---------------------------------------------------------------------------
# combinator nodes (flattening constructors give canonical variadic forms)
# ---------------------------------------------------------------------------

class Then(Transformer):
    """Composition (>>): feed output of stage i to stage i+1."""
    kind = "then"

    @staticmethod
    def of(*stages: Transformer) -> "Then":
        flat: list[Transformer] = []
        for s in stages:
            flat.extend(s.children if isinstance(s, Then) else [s])
        return Then(children=flat)


class Linear(Transformer):
    """Weighted linear combination (+ / *): CombSUM over the union of the
    children's documents (missing scores contribute 0)."""
    kind = "linear"

    @staticmethod
    def of(*weighted: tuple[float, Transformer]) -> "Linear":
        ws, cs = [], []
        for w, t in weighted:
            if isinstance(t, Linear):
                for wi, ci in zip(t.params["weights"], t.children):
                    ws.append(w * wi)
                    cs.append(ci)
            elif isinstance(t, Scale):
                ws.append(w * t.params["alpha"])
                cs.append(t.children[0])
            else:
                ws.append(w)
                cs.append(t)
        return Linear(children=cs, weights=tuple(ws))


class Scale(Transformer):
    kind = "scale"

    @staticmethod
    def of(alpha: float, t: Transformer) -> Transformer:
        if isinstance(t, Scale):
            return Scale.of(alpha * t.params["alpha"], t.children[0])
        if isinstance(t, Linear):
            return Linear.of(*[(alpha * w, c) for w, c in
                               zip(t.params["weights"], t.children)])
        return Scale(children=[t], alpha=float(alpha))


class FeatureUnion(Transformer):
    """** : combine children's scores as feature columns (paper: R1 ⋈ R2
    with [f1, f2] -> f), aligned on the first child's candidate set."""
    kind = "feature_union"

    @staticmethod
    def of(*ts: Transformer) -> "FeatureUnion":
        flat: list[Transformer] = []
        for t in ts:
            flat.extend(t.children if isinstance(t, FeatureUnion) else [t])
        return FeatureUnion(children=flat)


class SetOp(Transformer):
    kind = "setop"


class Cutoff(Transformer):
    kind = "cutoff"


class Concat(Transformer):
    kind = "concat"


class Generic(Transformer):
    """Any callable (Q, R) -> (Q, R) as a transformer — paper §3.2 last ¶."""
    kind = "generic"

    def execute(self, ctx, Q, R):
        return self.params["fn"](Q, R)
