"""Shape-bucketed query execution engine on one device (the port of
``src/repro/core/engine.py``).

The backend runs every stage's batched function through this engine, built
from the reference's mechanisms, on one card:

* **Bucket ladder** — query batches are padded up to a small fixed ladder
  of chunk sizes, and each ``(stage key, bucket, trailing shapes)`` is an
  entry of a bounded program cache, counted as a compile when it is
  created.  A stage therefore meets at most ``len(ladder)`` shapes per
  signature, whatever the sizes of the query sets it is given.  The
  bucketed stages run eagerly on the bucket shape.
* **Pinned programs as CUDA graphs** — a fixed-shape program (the generate
  stage's greedy decode, the decode pool's prefill and step) is captured
  once per ``(key, "pinned", argument signature)`` as a
  ``torch.cuda.CUDAGraph`` over static input buffers, and every later call
  copies its arguments in and replays it: one launch from the host for the
  whole program, where eager execution issues one per operation.  On the
  CPU a pinned program runs eagerly and its entry is counted the same way.
* **No host synchronisation** — the engine never waits for the device
  itself; the planner calls :meth:`barrier` only at the stage boundaries it
  times (``ExperimentPlan.execute(record=...)``).

A chunk cache makes stage-to-stage handoff cheap: when stage ``i+1``
consumes a tensor stage ``i`` produced, the engine reuses the per-chunk
padded pieces instead of slicing and padding the concatenated result again.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.common import (LRU, resolve_device, select_ladder_bucket,
                                tree_flatten, tree_map)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import NOOP_TRACER


def _key_label(key) -> str:
    """Short printable form of a program-cache key for trace events."""
    s = str(key)
    return s if len(s) <= 96 else s[:93] + "..."


def default_bucket_ladder(n_devices: int = 1, *, base: int = 8,
                          steps: Sequence[int] = (1, 2, 4)) -> tuple[int, ...]:
    """Geometric bucket ladder, every bucket a multiple of the device
    count: ``(8, 16, 32)`` on one card.  The largest bucket is the
    steady-state chunk; a small query set pads only up to the smallest
    covering bucket."""
    quantum = max(int(n_devices), base)
    ladder = []
    for s in steps:
        b = s * quantum
        b = -(-b // n_devices) * n_devices      # round up to a device multiple
        if b not in ladder:
            ladder.append(b)
    return tuple(sorted(ladder))


def merge_shard_topk(parts, *, k: int):
    """Cross-shard top-k merge of per-shard ``(docids, scores)`` results
    (each ``[nq, k_s]``, global doc ids, invalid entries ``-1``/``-inf``),
    on the host.  The stable descending sort keeps the first-seen entry
    among score ties; shards are contiguous ascending doc-id ranges in
    shard order, so ties resolve to the lowest global doc id, the
    single-index rule."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    docs = np.concatenate([host(d) for d, _ in parts], axis=1)
    vals = np.concatenate([host(v) for _, v in parts], axis=1)
    if docs.shape[1] < k:
        raise ValueError(f"merge width {docs.shape[1]} < k={k}")
    sel = np.argsort(-vals, axis=1, kind="stable")[:, :k]
    rows = np.arange(docs.shape[0])[:, None]
    return docs[rows, sel], vals[rows, sel]


@dataclasses.dataclass(frozen=True)
class StageProgram:
    """The engine's unit of execution: a batched function plus the key that
    names its program-cache entry.

    The key must fully determine ``fn``'s behaviour: two programs with one
    key may share one cache entry (and, for a pinned program, one captured
    graph).  A stage's ``key()`` embeds its static params and version
    marker but not the backend's tensors, which ``fn`` closes over, so
    ``TorchBackend.map_query_chunks`` scopes it by the backend's uid.
    ``key=None`` marks an anonymous program that runs uncached."""
    key: Any
    fn: Callable


def _leaf_sig(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, nn.Module):
        # read in place by the program: the entry holds the module, so its
        # id cannot be taken by another while the entry lives
        return ("module", id(x))
    return ("value", repr(x))


def _donated_leaves(args, donate_argnums) -> list[bool]:
    """Per flattened leaf of ``args``: whether it lies in a donated
    argument."""
    return [j in donate_argnums for j, a in enumerate(args)
            for _ in tree_flatten(a)[0]]


def _check_donated(entry, args) -> None:
    """Raise unless every donated tensor of ``args`` is the buffer the
    entry adopted: a program's entry owns its donated buffers, so two
    callers that donate different caches need two entries (two keys)."""
    new, _ = tree_flatten(args)
    for x, ptr, d in zip(new, entry.donated_ptrs, entry.donated_mask):
        if d and isinstance(x, torch.Tensor) and x.data_ptr() != ptr:
            raise ValueError(
                f"pinned program {_key_label(entry.key)}: a donated argument "
                f"is not the buffer its entry adopted; a caller that donates "
                f"another buffer (another KV cache) needs a key of its own")


class _PinnedGraph:
    """One captured CUDA graph of a pinned program.

    Each tensor argument gets a static buffer that the graph reads; a call
    copies its arguments into them (an argument that already is its buffer
    is not copied), replays the graph and returns its outputs.  Modules
    (the LM's weights) are read in place.  A donated argument, which the
    program updates in place and returns (the KV cache), is adopted as its
    own buffer at capture: the caller threads the returned tensors into the
    next call, of this program or of another that donates the same cache,
    and nothing is copied.  A call whose donated argument is another buffer
    raises (:func:`_check_donated`): copying it in would write one caller's
    cache over another's.  Every other output is cloned, since the next
    replay overwrites it."""

    def __init__(self, key, fn, args, donate_argnums, device):
        self.key = key
        donated = set(donate_argnums)
        self.static = tuple(
            a if j in donated else tree_map(_clone, a)
            for j, a in enumerate(args))
        self.donated = {id(x) for j in donated
                        for x in tree_flatten(args[j])[0]}
        self.donated_mask = _donated_leaves(args, donated)
        self.donated_ptrs = [x.data_ptr() if isinstance(x, torch.Tensor)
                             else None for x in tree_flatten(args)[0]]
        # a warm-up run on a side stream makes every lazy handle and
        # workspace before capture; it writes into copies of the donated
        # buffers, so the caller's are not touched before the first replay
        scratch = tuple(tree_map(_clone, a) if j in donated else a
                        for j, a in enumerate(self.static))
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad():
            with torch.cuda.stream(side):
                fn(*scratch)
            torch.cuda.current_stream(device).wait_stream(side)
            del scratch
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = fn(*self.static)

    def __call__(self, args):
        _check_donated(self, args)
        new, _ = tree_flatten(args)
        old, _ = tree_flatten(self.static)
        for x, buf in zip(new, old):
            # the signature matched, so the other leaves are the captured
            # ones: the same modules and values
            if isinstance(buf, torch.Tensor) and \
                    x.data_ptr() != buf.data_ptr():
                buf.copy_(x)
        self.graph.replay()
        return tree_map(lambda y: y if id(y) in self.donated else y.clone(),
                        self.out)


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


class _Eager:
    """A pinned program's entry on the CPU: the program of its first call,
    run eagerly, holding its modules and owning its donated buffers as a
    captured graph does."""

    def __init__(self, key, fn, args, donate_argnums):
        self.key = key
        self.fn = fn
        leaves, _ = tree_flatten(args)
        self.modules = [x for x in leaves if isinstance(x, nn.Module)]
        self.donated_mask = _donated_leaves(args, set(donate_argnums))
        self.donated_ptrs = [x.data_ptr() if isinstance(x, torch.Tensor)
                             else None for x in leaves]

    def __call__(self, args):
        _check_donated(self, args)
        with torch.no_grad():
            return self.fn(*args)


class ShardedQueryEngine:
    """Executes batched stage functions over the query axis: padded to
    bucketed shapes, cached by program key, on one device.  The name is the
    reference's, so the serving layer and its statistics read the same;
    it serves one device, where the reference shards across a mesh.

    The program cache requires that a stage function's behaviour is fully
    determined by its ``key`` (plus the backend the engine serves).
    ``Transformer.key()`` provides exactly this for pipeline stages."""

    def __init__(self, device=None, *, ladder: Sequence[int] | None = None,
                 max_jit_entries: int | None = 512,
                 max_chunk_entries: int | None = 64,
                 registry: MetricsRegistry | None = None):
        self.device = resolve_device(device)
        self.n_devices = 1
        self.ladder = (tuple(sorted(int(b) for b in ladder)) if ladder
                       else default_bucket_ladder(self.n_devices))
        #: (stage key, bucket, trailing signature) -> the program (a
        #: captured graph for a pinned program on the card).  LRU-bounded:
        #: a long-lived server meets unboundedly many stage keys, and each
        #: resident graph holds its memory pool.  An evicted entry is made
        #: anew on next use, and counted again.
        self._jit_cache: LRU = LRU(max_jit_entries)
        #: (stage key, trailing signature) -> buckets made; the ladder
        #: bounds each by len(self.ladder) while the stage stays resident
        self.compiles: LRU = LRU(None if max_jit_entries is None
                                 else 4 * max_jit_entries)
        #: id(full tensor) -> (weakref, chunk plan, [padded pieces]); an
        #: entry also dies with its source tensor through the weakref
        self._chunk_cache: LRU = LRU(max_chunk_entries)
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._m_dispatches = self.metrics.counter(
            "engine_dispatches_total", "chunk/pinned program dispatches")
        self._m_compiles = self.metrics.counter(
            "engine_compiles_total", "program-cache entries made by cause",
            ("cause",))
        for c in ("cold_rung", "ladder_miss", "pinned"):
            self._m_compiles.touch((c,))
        self._m_chunk = self.metrics.counter(
            "engine_chunk_cache_total", "validated chunk-cache lookups",
            ("result",))
        for r in ("hit", "miss"):
            self._m_chunk.touch((r,))
        # the gauge and the chunk cache's callbacks hold the caches, never
        # the engine: an engine in a reference cycle would keep its
        # captured graphs and their memory pools until a collection pass
        self.metrics.gauge(
            "engine_jit_cache_entries",
            "resident programs").set_fn(self._jit_cache.__len__)
        self.tracer = NOOP_TRACER
        self.recorder = None
        #: bucket -> EWMA of measured batch service seconds, fed back by the
        #: serving layer after each executed micro-batch
        self._service_ewma: dict[int, float] = {}
        self._service_alpha = 0.2

    # -- observability ------------------------------------------------------
    def attach_observability(self, tracer=None, recorder=None) -> None:
        """Point the engine's compile/dispatch events at a tracer and/or
        flight recorder (several servers sharing one engine share the last
        attachment)."""
        if tracer is not None:
            self.tracer = tracer
        if recorder is not None:
            self.recorder = recorder

    @property
    def n_compiles_total(self) -> int:
        return int(sum(self._m_compiles.series().values()))

    @property
    def n_dispatches(self) -> int:
        return int(self._m_dispatches.value())

    @property
    def n_chunk_cache_hits(self) -> int:
        return int(self._m_chunk.value(("hit",)))

    @property
    def n_chunk_cache_misses(self) -> int:
        return int(self._m_chunk.value(("miss",)))

    def compiles_by_cause(self) -> dict[str, int]:
        """Program-cache entries made, by cause."""
        return {c[0]: int(n) for c, n in self._m_compiles.series().items()}

    def _note_compile(self, cause: str, key, bucket) -> None:
        """Count one program-cache entry and emit its cause-tagged event:
        ``cold_rung`` (first rung for a never-seen stage/signature),
        ``ladder_miss`` (another rung for a known stage, or a re-make after
        LRU eviction), ``pinned`` (a fixed-shape program: a CUDA graph
        capture on the card)."""
        self._m_compiles.inc(1, (cause,))
        self.tracer.event("engine.jit_compile", "engine", cause=cause,
                          bucket=bucket, key=_key_label(key))
        if self.recorder is not None:
            self.recorder.record("recompile", cause=cause, bucket=bucket,
                                 key=_key_label(key))

    # -- chunk planning -----------------------------------------------------
    def chunk_plan(self, nq: int) -> tuple[tuple[int, int, int], ...]:
        """Split ``nq`` queries into ``(start, n, bucket)`` chunks: full
        chunks of the largest bucket plus one tail padded to the smallest
        covering ladder bucket."""
        if nq <= 0:
            raise ValueError("empty query batch")
        mx = self.ladder[-1]
        plan, s = [], 0
        while nq - s > mx:
            plan.append((s, mx, mx))
            s += mx
        rem = nq - s
        plan.append((s, rem, self.select_bucket(rem)))
        return tuple(plan)

    # -- chunk extraction / caching ----------------------------------------
    def _remember(self, full, plan, pieces) -> None:
        # a piece that IS the full tensor (one exact-fit chunk) would make
        # the entry self-referential and immortal: nothing to cache there
        if any(p is full for p in pieces):
            return
        key, cache = id(full), weakref.ref(self._chunk_cache)

        def forget(_, k=key):
            c = cache()
            if c is not None:
                c.pop(k, None)

        try:
            ref = weakref.ref(full, forget)
        except TypeError:
            return                                # non-weakrefable leaf
        self._chunk_cache.put(key, (ref, plan, pieces))

    def _pieces(self, arr, plan):
        """Per-chunk pieces of ``arr``, padded with zero rows to their
        buckets.  Tensors the engine itself produced hit the chunk cache
        and skip the slice and the pad."""
        ent = self._chunk_cache.get(id(arr))
        if ent is not None and ent[0]() is arr and ent[1] == plan:
            self._m_chunk.inc(1, ("hit",))
            return ent[2]
        self._m_chunk.inc(1, ("miss",))
        pieces = []
        for start, n, bucket in plan:
            piece = arr[start:start + n]
            if n < bucket:
                piece = torch.cat(
                    [piece, piece.new_zeros((bucket - n,) + piece.shape[1:])])
            pieces.append(piece)
        self._remember(arr, plan, pieces)
        return pieces

    # -- the program cache --------------------------------------------------
    def _enter(self, key, bucket: int, sig) -> None:
        jk = (key, bucket, sig)
        if self._jit_cache.get(jk) is None:
            self._jit_cache.put(jk, True)
            ck = (key, sig)
            prior = self.compiles.get(ck, 0) or 0
            self.compiles.put(ck, prior + 1)
            self._note_compile("cold_rung" if prior == 0 else "ladder_miss",
                               key, bucket)

    def max_compiles_per_stage(self) -> int:
        return max(self.compiles.values(), default=0)

    def total_compiles(self) -> int:
        """Program-cache entries made across all stages and buckets,
        monotone even when per-stage counter entries age out: the serving
        layer snapshots it at warm-up to assert zero steady-state
        recompilation."""
        return self.n_compiles_total

    # -- execution ----------------------------------------------------------
    @staticmethod
    def _args_of(Q, extra) -> tuple:
        return ((Q["terms"], Q["weights"]) if Q is not None else ()) + extra

    def select_bucket(self, n: int) -> int:
        """Smallest ladder bucket covering an ``n``-query micro-batch: the
        engine's padding rule and the serving scheduler's batch-closure
        rule are one function (``common.select_ladder_bucket``)."""
        return select_ladder_bucket(self.ladder, n)

    # -- service-time feedback ----------------------------------------------
    def note_service_time(self, bucket: int, seconds: float) -> None:
        """Record one measured micro-batch service time for ``bucket``
        (EWMA), fed by the serving layer after each executed batch."""
        prev = self._service_ewma.get(bucket)
        a = self._service_alpha
        self._service_ewma[bucket] = (seconds if prev is None
                                      else (1.0 - a) * prev + a * seconds)

    def service_time_estimate(self, bucket: int | None = None) -> float | None:
        """EWMA service seconds for ``bucket`` (falling back to the nearest
        observed rung), or the worst observed rung when ``bucket`` is None.
        None until the first observation."""
        if not self._service_ewma:
            return None
        if bucket is None:
            return max(self._service_ewma.values())
        if bucket in self._service_ewma:
            return self._service_ewma[bucket]
        near = min(self._service_ewma,
                   key=lambda b: (abs(b - bucket), b))
        return self._service_ewma[near]

    def run(self, program: StageProgram, Q, *extra):
        """Execute one stage program over the query axis:
        ``program.fn(terms, weights, *extra)`` (or ``fn(*extra)`` when Q is
        None) on padded chunks of the ladder's shapes, ``program.key``
        naming the cache entry.  Returns the concatenated outputs, trimmed
        to the real rows.  A batch that fits the largest bucket is one
        :meth:`submit_chunk`; a bigger one is chunk-planned."""
        args = self._args_of(Q, extra)
        nq = int(args[0].shape[0])
        if 0 < nq <= self.ladder[-1]:
            return self.submit_chunk(program, Q, *extra)
        return self._run_plan(program, args, self.chunk_plan(nq))

    def submit_chunk(self, program: StageProgram, Q, *extra,
                     bucket: int | None = None):
        """Serving entry point: run ONE micro-batch (``n`` <= the largest
        bucket) as a single padded chunk.  ``bucket`` pins the ladder rung
        (defaults to :meth:`select_bucket`)."""
        args = self._args_of(Q, extra)
        nq = int(args[0].shape[0])
        if bucket is None:
            bucket = self.select_bucket(nq)
        elif bucket not in self.ladder or nq > bucket:
            raise ValueError(f"bucket {bucket} not a ladder rung covering "
                             f"{nq} queries (ladder {self.ladder})")
        return self._run_plan(program, args, ((0, nq, bucket),))

    def run_pinned(self, program: StageProgram, *args,
                   donate_argnums: tuple = ()):
        """Execute a *pinned-shape* program (the generate stage's greedy
        decode, the decode pool's prefill and step): no bucket padding, the
        caller guarantees every shape is drawn from a finite, warmed set.
        The entry is keyed ``(key, "pinned", argument signature)`` in the
        same LRU and counted by the same compile counters as the bucketed
        entries.  Tensors enter the signature by shape and dtype, modules
        (the weights, read in place) by identity, any other argument by
        value.

        On the card the entry is a captured CUDA graph (see
        :class:`_PinnedGraph`); ``donate_argnums`` names the arguments the
        program updates in place and returns (the KV cache).  A program
        that cannot be captured raises: there is no eager fallback on a
        CUDA tensor.  On the CPU the program runs eagerly."""
        leaves, _ = tree_flatten(args)
        sig = tuple(_leaf_sig(x) for x in leaves)
        self._m_dispatches.inc()
        if program.key is None:
            return program.fn(*args)
        jk = (program.key, "pinned", sig)
        ent = self._jit_cache.get(jk)
        if ent is None:
            on_card = any(isinstance(x, torch.Tensor) and x.is_cuda
                          for x in leaves)
            if on_card:
                try:
                    ent = _PinnedGraph(program.key, program.fn, args,
                                       donate_argnums, self.device)
                except Exception as e:
                    raise RuntimeError(
                        f"pinned program {_key_label(program.key)} could not "
                        f"be captured as a CUDA graph: {e}") from e
            else:
                ent = _Eager(program.key, program.fn, args, donate_argnums)
            self._jit_cache.put(jk, ent)
            ck = (program.key, "pinned")
            self.compiles.put(ck, (self.compiles.get(ck, 0) or 0) + 1)
            self._note_compile("pinned", program.key, None)
        return ent(args)

    def run_pinned_chunks(self, program: StageProgram, rows: torch.Tensor,
                          *consts):
        """``run_pinned(program, *consts, chunk, n)`` over the chunk plan
        of ``rows`` (each chunk padded with zero rows to its bucket; ``n``
        its count of real rows, a 0-d int64 tensor on the device), the
        outputs concatenated and trimmed: a pinned program per ladder rung,
        as the generate stage runs its greedy decode."""
        plan = self.chunk_plan(int(rows.shape[0]))
        outs = [self.run_pinned(program, *consts, piece, torch.full(
            (), n, dtype=torch.long, device=piece.device))
            for piece, (_, n, _) in zip(self._pieces(rows, plan), plan)]
        return self._materialize(outs, plan)

    def _run_plan(self, program: StageProgram, args, plan):
        key, fn = program.key, program.fn
        sig = tuple((tuple(a.shape[1:]), str(a.dtype)) for a in args)
        pieces = [self._pieces(a, plan) for a in args]
        outs = []
        for i, (start, n, bucket) in enumerate(plan):
            # keyless calls stay out of the program cache
            if key is not None:
                self._enter(key, bucket, sig)
            with self.tracer.span("engine.dispatch", "engine", bucket=bucket,
                                  n=n, key=_key_label(key)):
                outs.append(fn(*[p[i] for p in pieces]))
            self._m_dispatches.inc()
        full = self._materialize(outs, plan)
        self._remember_outputs(full, outs, plan)
        return full

    def map_queries(self, fn, Q, *extra, key=None):
        """Compatibility wrapper over :meth:`run`."""
        return self.run(StageProgram(key=key, fn=fn), Q, *extra)

    def run_doc_sharded(self, programs: Sequence[StageProgram], Q, *extra,
                        k: int):
        """Doc-axis sharded top-k: run one StageProgram per document shard
        (each closing over its contiguous shard and emitting *global* doc
        ids, e.g. built over ``index.dense.shard_dense_index``), then merge
        the per-shard ``(docids, scores)`` across shards on the host with
        :func:`merge_shard_topk`.  The shards' programs are enqueued one
        after another with no wait; the barrier before the merge is the one
        synchronisation point."""
        parts = [self.run(p, Q, *extra) for p in programs]
        self.barrier(parts)
        return merge_shard_topk(parts, k=k)

    def _materialize(self, outs, plan):
        _, n_tail, b_tail = plan[-1]
        if len(outs) == 1:
            if n_tail == b_tail:
                return outs[0]
            return tree_map(lambda x: x[:n_tail], outs[0])

        def cat(*xs):
            xs = list(xs)
            if n_tail != b_tail:
                xs[-1] = xs[-1][:n_tail]
            return torch.cat(xs, 0)

        return tree_map(cat, *outs)

    def _remember_outputs(self, full, outs, plan) -> None:
        """Seed the chunk cache so the next stage consuming ``full`` reuses
        the padded chunk outputs instead of slicing again."""
        flat_full, _ = tree_flatten(full)
        flat_outs = [tree_flatten(o)[0] for o in outs]
        for li, leaf in enumerate(flat_full):
            self._remember(leaf, plan, [fo[li] for fo in flat_outs])

    # -- barriers / reporting ----------------------------------------------
    def barrier(self, tree):
        """Wait until every tensor in ``tree`` is computed (a synchronize
        of the engine's device on the card).  The engine itself never
        waits: this is for the planner's timed stage boundaries and for
        benchmark harnesses."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return tree

    def cache_info(self) -> dict:
        """Sizes, bounds and hit counters of the engine's two bounded
        caches (``jit``: the program cache; ``chunk``: the validated
        chunk-cache counters)."""
        jit = self._jit_cache.info()
        chunk = self._chunk_cache.info()
        chunk["hits"] = self.n_chunk_cache_hits
        chunk["misses"] = self.n_chunk_cache_misses
        return {"jit": jit, "chunk": chunk}

    def stats(self) -> dict:
        return {
            "devices": self.n_devices,
            "ladder": list(self.ladder),
            "dispatches": self.n_dispatches,
            "compiled_variants": self.n_compiles_total,
            "compiles_by_cause": self.compiles_by_cause(),
            "max_compiles_per_stage": self.max_compiles_per_stage(),
            "chunk_cache_hits": self.n_chunk_cache_hits,
            "chunk_cache_misses": self.n_chunk_cache_misses,
            "cache_info": self.cache_info(),
            "service_ms_ewma": {b: round(1000.0 * s, 3)
                                for b, s in sorted(self._service_ewma.items())},
        }
