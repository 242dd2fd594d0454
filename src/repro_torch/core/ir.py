"""Typed dataflow IR for declarative retrieval pipelines (paper §4).

The operator algebra (``core/transformer.py``) is a *surface syntax*: users
compose ``Transformer`` nodes with the eight operators and nothing carries
types, static shapes, or a stable identity the optimiser / planner / engine
all agree on.  This module is the single representation they share:

* :class:`Op` — one dataflow node: ``kind`` + static ``params`` + ``inputs``
  (operand ops) + an optional ``ref`` back to the executable stage object.
  Ops are *structurally immutable*: rewrites build new ops (``with_inputs``)
  instead of mutating, so schema/key caches stay sound and CSE can share
  instances freely.
* :class:`Schema` — the type of an op's output stream: ``Q`` (query
  rewrite, the R stream passes through), ``R`` (ranked results), ``F``
  (ranked results carrying feature columns), or ``A`` (answer-bearing
  results: ranked results plus generated token columns), plus the *static*
  result depth ``k`` and feature width where they are known at compile time.
* ``lower`` / ``raise_ir`` — convert a ``Transformer`` tree to IR and back.
  The round trip preserves ``key()`` exactly: ``Op.key()`` is computed with
  the same canonicalisation as ``Transformer.key()``
  (:func:`repro_torch.core.transformer.canon_param_items`), so result-memo
  entries, plan-trie nodes and engine jit-cache entries written against one
  representation are valid against the other.
* ``pretty`` — human-readable rendering, used by ``pipeline.explain()``.

The pass manager that operates on this IR lives in ``core/passes.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.transformer import (Concat, Cutoff, FeatureUnion,
                                          Linear, Scale, SetOp, Then,
                                          Transformer, canon_param_items)


class SchemaError(TypeError):
    """A pipeline violates the IR typing rules (e.g. a rank cutoff applied
    to a pure query-rewrite expression)."""


@dataclasses.dataclass(frozen=True)
class Schema:
    """Static type of an op's output stream.

    ``out``  — "Q" (no result stream produced; R passes through), "R"
               (ranked results), "F" (results + feature columns), "A"
               (answer-bearing results: R plus generated token columns —
               terminal; no ranking stage may consume it).
    ``k``    — static result depth, or None where unknown at compile time.
    ``width``— static feature-column count, or None where unknown.
    ``reads_results`` — whether executing the op observes the incoming R
               (the cutoff-hop soundness bit: a % K may hop a Q -> Q stage
               only if that stage never looks at R).
    """
    out: str = "R"
    k: int | None = None
    width: int | None = None
    reads_results: bool = True

    def annotate(self) -> str:
        bits = [self.out]
        if self.k is not None:
            bits.append(f"k={self.k}")
        if self.width:
            bits.append(f"w={self.width}")
        if self.reads_results:
            bits.append("readsR")
        return "[" + ", ".join(bits) + "]"


#: combinator kinds executed structurally by the compiler (inputs + params
#: fully define them); every other kind is a leaf stage executed via ``ref``
#: (retrieve / fat_retrieve / dense_retrieve / dense_rerank / ... plus the
#: fused_* kinds the cost-gated fusion pass lowers chains onto)
COMBINATOR_KINDS = frozenset({
    "then", "linear", "scale", "cutoff", "setop", "concat", "feature_union",
})

_COMBINATOR_TYPES = {
    "then": Then, "linear": Linear, "scale": Scale, "cutoff": Cutoff,
    "setop": SetOp, "concat": Concat, "feature_union": FeatureUnion,
}


class Op:
    """One typed-IR node.  Treat as immutable once constructed."""

    __slots__ = ("kind", "params", "inputs", "ref", "_key", "_stateful")

    def __init__(self, kind: str, params: dict | None = None,
                 inputs: Sequence["Op"] = (), ref: Transformer | None = None):
        self.kind = kind
        self.params = dict(params or {})
        self.inputs = tuple(inputs)
        self.ref = ref
        self._key = None
        self._stateful = None
        if kind not in COMBINATOR_KINDS and ref is None:
            raise ValueError(f"leaf op {kind!r} needs an executable ref")

    # -- identity -----------------------------------------------------------
    def _state(self) -> tuple:
        r = self.ref
        if r is not None and r.stateful:
            return (r.uid, r.version)
        return ()

    def stateful_subtree(self) -> bool:
        """Whether any op in this subtree wraps a stateful stage (whose key
        embeds a live version marker)."""
        if self._stateful is None:
            self._stateful = (self.ref is not None and self.ref.stateful) \
                or any(i.stateful_subtree() for i in self.inputs)
        return self._stateful

    def key(self) -> tuple:
        """Stable content key, bit-identical to the key of the raised
        ``Transformer`` tree.  Subtrees containing a stateful leaf embed a
        live (uid, version) marker, so their keys are recomputed on every
        call (fit() bumps the version — a cached key anywhere on the path
        would serve pre-training memo entries); fully stateless keys are
        cached."""
        if self._key is not None:
            return self._key
        k = (self.kind, canon_param_items(self.params), self._state(),
             tuple(i.key() for i in self.inputs))
        if not self.stateful_subtree():
            self._key = k
        return k

    def with_inputs(self, inputs: Sequence["Op"]) -> "Op":
        return Op(self.kind, self.params, inputs, ref=self.ref)

    def with_params(self, **params) -> "Op":
        return Op(self.kind, {**self.params, **params}, self.inputs,
                  ref=self.ref)

    @property
    def is_leaf(self) -> bool:
        return self.kind not in COMBINATOR_KINDS

    def label(self) -> str:
        if self.ref is not None:
            return type(self.ref).__name__
        return self.kind

    def __repr__(self):
        inner = ", ".join(
            [f"{k}={v!r}" for k, v in self.params.items()
             if not hasattr(v, "shape") and k != "index"])
        tail = f" x{len(self.inputs)}" if self.inputs else ""
        return f"Op({self.kind}{'(' + inner + ')' if inner else ''}{tail})"


# ---------------------------------------------------------------------------
# lowering / raising
# ---------------------------------------------------------------------------

def lower(node: Transformer) -> Op:
    """Transformer tree -> IR graph.  Every op keeps a ``ref`` to the node
    it was lowered from: leaves execute through it, and an unchanged subtree
    raises back to the identical object (key/state preserved for free)."""
    return Op(node.kind, node.params,
              tuple(lower(c) for c in node.children), ref=node)


def leaf(stage: Transformer) -> Op:
    """Wrap a freshly built leaf stage (rewrite/fusion product) as an op."""
    assert not stage.children, "leaf() is for childless stages"
    return Op(stage.kind, stage.params, (), ref=stage)


def raise_ir(op: Op) -> Transformer:
    """IR graph -> Transformer tree (inverse of :func:`lower`).

    Leaves return their ``ref`` (the executable payload *is* the node);
    combinators are rebuilt from the registry unless the op still matches
    its ref's children, in which case the original node is returned — so
    ``raise_ir(lower(t))`` is ``t`` and trivially preserves ``key()``.
    """
    if op.is_leaf:
        return op.ref
    kids = [raise_ir(i) for i in op.inputs]
    r = op.ref
    if (r is not None and len(kids) == len(r.children)
            and all(a is b for a, b in zip(kids, r.children))
            and canon_param_items(r.params) == canon_param_items(op.params)):
        return r
    return _COMBINATOR_TYPES[op.kind](children=kids, **op.params)


def chain(op: Op) -> list[Op]:
    """A pipeline as its linear chain of top-level stages (the planner's
    trie rows).  Nested combinators stay atomic entries."""
    return list(op.inputs) if op.kind == "then" else [op]


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def pretty(op: Op, schemas: dict[int, Schema] | None = None,
           indent: int = 0) -> str:
    """Indented tree rendering; ``schemas`` (id(op) -> Schema, as produced
    by the schema-inference pass) adds type annotations."""
    pad = "  " * indent
    inner = ", ".join(f"{k}={v!r}" for k, v in sorted(op.params.items())
                      if not hasattr(v, "shape"))
    line = f"{pad}{op.label()}({inner})" if inner else f"{pad}{op.label()}"
    if schemas is not None and id(op) in schemas:
        line += f"  {schemas[id(op)].annotate()}"
    lines = [line]
    for i in op.inputs:
        lines.append(pretty(i, schemas, indent + 1))
    return "\n".join(lines)
