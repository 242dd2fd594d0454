"""Experiment planner: trie-based shared-prefix scheduling + artifact cache.

The paper's ``Experiment`` promises that pipelines sharing a common prefix
execute that prefix once.  This module makes the promise *structural*
instead of accidental: the planner compiles every pipeline through the IR
pass manager (``core/passes.py``, with one CSE table spanning all
pipelines), flattens the resulting IR into its chain of top-level stage
ops, inserts the chains into a **prefix trie** keyed by the ops' stable
content keys, and schedules a depth-first traversal in which every trie
node — i.e. every distinct shared sub-pipeline — executes **exactly once**
per query set.

Per trie node the planner records wall-clock for a cold pass (first calls,
kernel builds) and a steady-state pass, so an Experiment's MRT decomposes
into ``compile`` / ``execute`` / ``shared-amortised`` components.  On the
card a recorded (or persisted) stage ends with the backend's barrier (the
engine's ``barrier``, a ``torch.cuda.synchronize()``), so its wall clock
covers its device work, not only its enqueueing; an unrecorded pass stays
asynchronous.

Stage outputs can additionally be spilled to an on-disk
:class:`ArtifactCache` keyed by ``(prefix key, query-set digest, backend
digest)`` — all content-derived, so a cache directory is valid across
processes and devices.  Stages whose structural key embeds process-local
state (``("obj", id)`` params or stateful uid/version markers) are never
persisted.
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import os
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.core import ir
from repro_torch.core.compiler import (Context, TorchBackend, _execute,
                                       derive_token)
from repro_torch.core.passes import compile_pipeline
from repro_torch.core.transformer import Transformer
from repro_torch.obs.tracing import tracer_for


# ---------------------------------------------------------------------------
# canonical chains + persistent keys
# ---------------------------------------------------------------------------

def stage_chain(node: Transformer | ir.Op) -> list:
    """A (compiled) pipeline as its linear chain of top-level stages.
    Nested combinators stay atomic trie entries; sharing inside them is
    handled by the content-addressed memo.  The planner operates on IR ops;
    ``Transformer`` trees are accepted too."""
    if isinstance(node, Transformer):
        node = ir.lower(node)
    return ir.chain(node)


def _key_is_persistent(key) -> bool:
    kind, items, state, children = key
    if state:                       # stateful: (uid, version), process-local
        return False
    for _, v in items:
        if isinstance(v, tuple) and len(v) == 2 and v[0] == "obj":
            return False            # param keyed by object identity
    return all(_key_is_persistent(c) for c in children)


def persistent_key(node) -> str | None:
    """Cross-process digest of a stage's structural key (IR op or
    Transformer), or None if the key references process-local state and
    must not be written to disk."""
    key = node.key()
    if not _key_is_persistent(key):
        return None
    return hashlib.sha256(repr(key).encode()).hexdigest()


def chain_prefix_digests(chain: Sequence, *, scope: str = "") -> list[str]:
    """Cumulative digests of a stage chain's prefixes: ``out[i]`` covers
    stages ``0..i``, chained over the *full* structural key, so
    process-local stages (object-identity params, stateful version markers)
    participate too.  Only valid in-process while the caller pins the ops;
    anything written to disk must go through :func:`persistent_key`
    instead.  A stateful stage's ``fit()`` bumps its version marker, which
    changes every digest from that stage onward."""
    out: list[str] = []
    acc = hashlib.sha256(scope.encode()).hexdigest()
    for stage in chain:
        acc = hashlib.sha256(
            (acc + repr(stage.key())).encode()).hexdigest()
        out.append(acc)
    return out


def _digest_into(h, obj) -> None:
    """Feed ``obj`` into the hash ``h``: a tensor or array by its dtype,
    shape and bytes (a card tensor's bytes are read on the host, so equal
    bytes on either device give one digest), a dataclass field by field,
    a dict in key order, a sequence in order, anything else by ``repr``."""
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        h.update(f"{obj.dtype}{obj.shape}".encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _digest_into(h, getattr(obj, f.name))
    elif isinstance(obj, dict):
        for k in sorted(obj):
            h.update(repr(k).encode())
            _digest_into(h, obj[k])
    elif isinstance(obj, (tuple, list)):
        h.update(b"(")
        for x in obj:
            _digest_into(h, x)
        h.update(b")")
    else:
        h.update(repr(obj).encode())


def _defaults(builder) -> dict:
    """A builder's keyword defaults (dims, seeds, iterations), so a change
    to one moves the digest of the state it builds."""
    params = inspect.signature(builder).parameters
    return {n: p.default for n, p in params.items()
            if p.default is not inspect.Parameter.empty}


def backend_digest(backend: TorchBackend) -> str:
    """Content digest of the backend's result-affecting state: the index
    (arrays and statics) plus the execution config stages resolve at run
    time (``default_k`` for ``Retrieve(k=None)``, the dense state for the
    dense stages and ``embed_queries``).  The dense embeddings, query
    projection, IVF and IVF-PQ indexes the backend builds itself are pure
    functions of the index, the backend's config and the builders'
    defaults, so those digest them (and nothing is built to be digested);
    a supplied one is digested by its contents.  Cached — all of it is immutable once the
    backend is built.  At Robust04 scale the index is 1.29 GB, read from
    the card once."""
    dig = getattr(backend, "_content_digest", None)
    if dig is None:
        from repro_torch.index import dense as D
        ext = backend._external
        h = hashlib.sha256(b"torch-backend")
        _digest_into(h, backend.index)
        _digest_into(h, {
            "default_k": backend.default_k,
            "dense": (backend._dense if ext["dense"]
                      else _defaults(D.build_dense_index)),
            "ivf": (backend._ivf if ext["ivf"]
                    else (backend.ivf_lists, _defaults(D.build_ivf_index))),
            "ivfpq": (backend._ivfpq if ext["ivfpq"]
                      else (backend.pq_m, _defaults(D.build_ivfpq_index))),
            "pq_refine": backend.pq_refine})
        dig = h.hexdigest()
        backend._content_digest = dig
    return dig


# ---------------------------------------------------------------------------
# on-disk artifact cache
# ---------------------------------------------------------------------------

class ArtifactCache:
    """Stage-output store: one ``.npz`` per (prefix, query set, backend)
    key, holding the stage's (Q, R) output tensors as host arrays."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0

    def _file(self, key: str) -> Path:
        return self.path / f"{key}.npz"

    def load(self, key: str, device=None):
        """The (Q, R) stored under ``key`` as tensors on ``device``
        (``None`` = the card), or None on a miss."""
        f = self._file(key)
        if not f.exists():
            self.misses += 1
            return None
        dev = resolve_device(device)
        try:
            with np.load(f) as z:
                meta = json.loads(z["__meta__"].item())
                out = []
                for part in ("Q", "R"):
                    if meta[part] is None:
                        out.append(None)
                    else:
                        out.append({k: torch.as_tensor(z[f"{part}.{k}"],
                                                       device=dev)
                                    for k in meta[part]})
        except Exception:
            # corrupt / truncated / foreign file: a cache must degrade to
            # recompute, never take the experiment down
            f.unlink(missing_ok=True)
            self.misses += 1
            return None
        self.hits += 1
        return tuple(out)

    def store(self, key: str, Q, R) -> None:
        arrays, meta = {}, {}
        for part, d in (("Q", Q), ("R", R)):
            meta[part] = None if d is None else sorted(d)
            if d is not None:
                for k, v in d.items():
                    arrays[f"{part}.{k}"] = v.detach().cpu().numpy()
        # per-writer tmp name (concurrent processes may store the same key),
        # .npz suffix so savez keeps the name; then atomic publish
        tmp = self.path / f"{key}.{os.getpid()}.tmp.npz"
        np.savez(tmp, __meta__=json.dumps(meta), **arrays)
        tmp.replace(self._file(key))


# ---------------------------------------------------------------------------
# the plan trie
# ---------------------------------------------------------------------------

class PlanNode:
    """One trie node = one stage execution (an IR op), shared by every
    pipeline whose chain passes through this prefix."""

    __slots__ = ("stage", "parent", "children", "pipelines", "persist",
                 "cold_s", "warm_s", "cache_hit")

    def __init__(self, stage: "ir.Op | None", parent: "PlanNode | None"):
        self.stage = stage
        self.parent = parent
        self.children: dict = {}        # stage.key() -> PlanNode
        self.pipelines: list[int] = []  # pipeline indices sharing this prefix
        self.persist: str | None = None # cross-process prefix digest
        self.cold_s: float | None = None
        self.warm_s: float | None = None
        self.cache_hit = False

    @property
    def n_shared(self) -> int:
        return len(self.pipelines)

    @property
    def depth(self) -> int:
        d, n = 0, self
        while n.parent is not None:
            d, n = d + 1, n.parent
        return d

    def label(self) -> str:
        return self.stage.label() if self.stage is not None else "<root>"


class ExperimentPlan:
    """Shared-prefix execution plan over a set of pipelines.

    ``execute`` runs every trie node exactly once per call (depth-first, so
    intermediate results die as soon as the last sibling consumed them) and
    returns the per-pipeline final results in input order.
    """

    def __init__(self, pipelines: Sequence[Transformer], backend: TorchBackend,
                 *, optimize: bool = True):
        self.backend = backend
        self.pipelines = list(pipelines)
        # the compile passes and the trie, rebuilt on every Experiment call
        with tracer_for(backend.descriptor).span(
                "plan.build", "plan", n_pipelines=len(self.pipelines)):
            self._build(optimize)

    def _build(self, optimize: bool) -> None:
        backend = self.backend
        #: per-pipeline rewrite traces [(rule, before_op, after_op), ...]
        self.traces: list[list] = [[] for _ in self.pipelines]
        #: one CSE interning table across all pipelines: shared prefixes
        #: compile to literally shared IR ops, which is what the trie keys on
        cse_table: dict = {}
        self.ops = [compile_pipeline(p, backend, optimize=optimize,
                                     trace=self.traces[i],
                                     cse_table=cse_table)
                    for i, p in enumerate(self.pipelines)]
        # publish any fresh autotune/gate decisions now, so a second
        # Experiment (or another process) compiles this plan profile-warm
        prof = backend.descriptor.profile
        if prof is not None:
            prof.save()
        self.chains = [ir.chain(op) for op in self.ops]
        self.root = PlanNode(None, None)
        self.root.persist = "root"
        self._leaves: list[PlanNode] = []
        for i, chain in enumerate(self.chains):
            cur = self.root
            cur.pipelines.append(i)
            for stage in chain:
                nxt = cur.children.get(stage.key())
                if nxt is None:
                    nxt = PlanNode(stage, cur)
                    pk = persistent_key(stage)
                    if pk is not None and cur.persist is not None:
                        nxt.persist = hashlib.sha256(
                            (cur.persist + pk).encode()).hexdigest()
                    cur.children[stage.key()] = nxt
                nxt.pipelines.append(i)
                cur = nxt
            self._leaves.append(cur)

    # -- structure ----------------------------------------------------------
    def nodes(self) -> list[PlanNode]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n.stage is not None:
                out.append(n)
            stack.extend(n.children.values())
        return out

    @property
    def n_stage_executions(self) -> int:
        """Stages the plan will execute (vs sum(len(chain)) without sharing)."""
        return len(self.nodes())

    @property
    def n_stage_requests(self) -> int:
        return sum(len(c) for c in self.chains)

    # -- execution ----------------------------------------------------------
    def execute(self, Q, *, ctx: Context | None = None,
                cache: ArtifactCache | None = None,
                record: str | None = "cold") -> list:
        ctx = ctx or Context(self.backend)
        tracer = tracer_for(getattr(self.backend, "descriptor", None))
        device = self.backend.device
        qtok = ctx.source_token(Q, None)
        idx_dig = backend_digest(self.backend) if cache is not None else None
        results: list = [None] * len(self._leaves)
        leaf_index: dict[int, list[int]] = {}
        for i, leaf in enumerate(self._leaves):   # duplicates share one leaf
            leaf_index.setdefault(id(leaf), []).append(i)

        def run_stage(child: PlanNode, Qi, Ri, toki):
            ck = loaded = None
            if cache is not None and child.persist is not None:
                ck = hashlib.sha256(
                    f"{child.persist}:{qtok}:{idx_dig}".encode()).hexdigest()
                loaded = cache.load(ck, device)
            t0 = time.perf_counter()
            if loaded is not None:
                Qo, Ro = loaded
                toko = derive_token(child.stage.key(), toki)
                # seed the memo so non-plan users of this ctx share too
                ctx.memo[(child.stage.key(), toki)] = (Qo, Ro, toko)
                child.cache_hit = True
            else:
                Qo, Ro, toko = _execute(child.stage, ctx, Qi, Ri, toki)
                # barrier only at stage boundaries the caller needs timed
                # (or persisted); untimed runs stay asynchronous
                if record is not None or ck is not None:
                    self.backend.barrier((Qo, Ro))
                child.cache_hit = False
                if ck is not None:
                    cache.store(ck, Qo, Ro)
            dt = time.perf_counter() - t0
            if record == "warm":
                child.warm_s = dt
            elif record == "cold":
                child.cold_s = dt
            return Qo, Ro, toko

        def visit(node: PlanNode, Qi, Ri, toki) -> None:
            for i in leaf_index.get(id(node), ()):
                results[i] = Ri if Ri is not None else Qi
            for child in node.children.values():
                # span covers the child's whole subtree, so the exported
                # trace nests exactly like the trie (children inside their
                # shared prefix); cache_hit lands on the span after run
                with tracer.span("plan.stage", "plan",
                                 stage=child.stage.label(),
                                 depth=child.depth,
                                 n_pipelines=child.n_shared) as sp:
                    out = run_stage(child, Qi, Ri, toki)
                    sp.set(cache_hit=child.cache_hit)
                    visit(child, *out)

        try:
            with tracer.span("plan.execute", "plan",
                             n_stage_executions=self.n_stage_executions,
                             n_stage_requests=self.n_stage_requests):
                visit(self.root, Q, None, qtok)
        finally:
            # visit calls itself through its own closure cell: a reference
            # cycle that would hold ctx, its memo and the backend (on the
            # card, the engine's captured graphs) until a collection pass
            visit = None
        return results

    # -- timing attribution --------------------------------------------------
    def pipeline_times(self, i: int) -> dict:
        """Decomposed wall-clock for pipeline ``i``: steady execution,
        compile (cold - steady), and the sharing-amortised steady time in
        which each stage's cost is split across the pipelines using it."""
        steady = compile_ = amortised = 0.0
        node = self._leaves[i]
        while node is not None and node.stage is not None:
            warm = node.warm_s if node.warm_s is not None else (node.cold_s or 0.0)
            cold = node.cold_s if node.cold_s is not None else warm
            steady += warm
            compile_ += max(0.0, cold - warm)
            amortised += warm / max(node.n_shared, 1)
            node = node.parent
        return {"steady_s": steady, "compile_s": compile_,
                "amortised_s": amortised}

    def stage_stats(self) -> list[dict]:
        """Per-trie-node report (one row per *executed* stage).  A stage
        that no pass timed (``execute(record=None)``, as an Experiment
        without ``measure_time`` runs) has ``cold_ms`` and ``steady_ms``
        None."""
        rows = []
        for n in sorted(self.nodes(), key=lambda n: (n.depth, n.label())):
            warm = n.warm_s if n.warm_s is not None else n.cold_s
            row = {"stage": n.label(), "depth": n.depth,
                   "n_pipelines": n.n_shared, "cache_hit": n.cache_hit,
                   "cold_ms": None if n.cold_s is None else 1000 * n.cold_s,
                   "steady_ms": None if warm is None else 1000 * warm}
            if n.cold_s is not None and n.warm_s is not None:
                row["compile_ms"] = 1000 * max(0.0, n.cold_s - n.warm_s)
            rows.append(row)
        return rows
