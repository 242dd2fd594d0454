"""PipelineServer: compiled pipelines as a long-lived online service (the
port of ``src/repro/serve/server.py``).

The offline stack executes a *batch* of queries through a compiled
pipeline; serving inverts the shape: queries arrive one at a time and the
server re-creates the batch axis continuously —

    submit() -> bounded queue -> deadline-aware micro-batch scheduler
             -> bucket ladder -> stage-keyed result cache
             -> per-stage execution -> result

* Each pipeline is compiled ONCE (pass manager, fusion gate) when it is
  attached; serving executes the compiled IR chains, so steady-state
  traffic never touches the compiler.
* Micro-batches pack into the engine's existing bucket ladder and reuse
  its program cache: after :meth:`warmup` every (pipeline stage, bucket)
  entry exists, every decode program is captured as a CUDA graph on the
  card, and serving makes no new entry.
* **Multi-tenancy**: :meth:`add_pipeline` multiplexes several compiled
  pipelines over ONE engine, ONE scheduler, and ONE shared
  :class:`~repro_torch.serve.cache.StageResultCache`.  Pipelines sharing a
  structural prefix share cache entries (the chained prefix digests make
  that sound), so tenant B resumes from state tenant A computed —
  cross-pipeline hits are surfaced per tenant in :meth:`stats`.
* **Deadline awareness**: the scheduler packs batches EDF, sheds requests
  whose deadline its service-time EWMA says cannot be met *before* they
  occupy a ladder slot, and serves priority lanes by weighted fair
  queueing.  The server feeds measured batch service times back to the
  scheduler (and the engine) after every executed batch.
* **RAG serving**: a pipeline ending in a ``generate`` stage splits at the
  answer boundary — the retrieval prefix rides the micro-batch/bucket
  machinery above, then the request's assembled prompt enters a per-tenant
  continuous-batching decode pool (:class:`~repro_torch.serve.batching
  .ContinuousBatcher` slots over one KV cache).  The
  scheduler's decode queue admits new prompts *between* decode steps
  (iteration-level scheduling), so one long answer never blocks admission,
  and :meth:`step` interleaves one retrieval batch with one decode step —
  batches mix retrieval-resume and mid-decode requests.  Prefill and
  decode-step programs are pinned programs of the engine, so
  ``recompiles_since_warmup`` covers the decode path too.
* Policy lives in one frozen :class:`~repro_torch.serve.config.ServeConfig`.

Requests and results are host numpy rows, as the stage cache keeps them;
each micro-batch is moved to the backend's device for execution.  The
server owns no thread until :meth:`start`; tests and replay drive it
synchronously with :meth:`pump`.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any

import numpy as np

from repro_torch.common import tree_map
from repro_torch.core import ir
from repro_torch.obs import NOOP_TRACER, FlightRecorder, MetricsRegistry, Tracer
from repro_torch.core.compiler import Context, _execute
from repro_torch.core.passes import compile_pipeline
from repro_torch.core.plan import chain_prefix_digests
from repro_torch.serve.batching import ContinuousBatcher
from repro_torch.serve.batching import Request as _DecodeRequest
from repro_torch.serve.cache import StageResultCache, query_digest
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.request import RequestTrace, ServeRequest
from repro_torch.serve.scheduler import MicroBatchScheduler
from repro_torch.serve.trace import TraceLog

#: bucket ladder used when the backend has no engine attached
#: (REPRO_ENGINE=sequential): the sequential path chunks by itself, so
#: these rungs only shape the scheduler's batching decisions
_FALLBACK_LADDER = (1, 2, 4, 8, 16)

#: sentinel distinguishing "caller said nothing" (inherit the server
#: default) from an explicit ``timeout_ms=None`` ("no deadline")
_UNSET = object()


@dataclasses.dataclass
class _Tenant:
    """One served pipeline: its compiled chain plus cache-key material.
    ``generate`` is the chain's trailing :class:`~repro_torch.core.stages
    .Generate` stage instance when the pipeline ends in one (the tenant
    then serves retrieval through the micro-batcher and decode through
    its pool), else None."""
    name: str
    op: Any                       # compiled IR root
    chain: list                   # ir.chain(op)
    stateful: bool                # any stage with a version marker?
    prefixes: list                # chained stage digests (shared scope)
    compile_report: dict
    generate: Any = None          # trailing Generate stage ref, if any


class PipelineServer:
    """Serve single queries (or small bursts) through compiled pipelines.

    >>> cfg = ServeConfig.default(max_wait_ms=4.0).with_deadlines(250.0)
    >>> server = PipelineServer(Retrieve("BM25") % 10, backend, cfg)
    >>> server.add_pipeline(other_pipe, name="background")
    >>> server.warmup(Q_sample)
    >>> req = server.submit_one(q_row)  # non-blocking
    >>> server.pump()                   # or server.start() for a thread
    >>> R = req.wait(timeout=5.0)
    """

    def __init__(self, pipeline, backend, config: ServeConfig | None = None,
                 *, cache: StageResultCache | None = None,
                 name: str = "default"):
        self.config = config if config is not None else ServeConfig()
        self.backend = backend
        self.engine = backend.engine
        self._digest_scope = f"serve:be{backend.uid}:"
        self._tenants: dict[str, _Tenant] = {}
        self._default_tenant = name
        ladder = (self.engine.ladder if self.engine is not None
                  else _FALLBACK_LADDER)
        cfg = self.config
        # one registry per server: every counter stats() reports lives
        # here; tracer/recorder are the opt-in layers (ServeConfig
        # .with_observability) and default to shared no-ops
        self.metrics = MetricsRegistry()
        self.tracer = (Tracer(enabled=True, capacity=cfg.obs_trace_events)
                       if cfg.obs_tracing else NOOP_TRACER)
        self.recorder = (FlightRecorder(cfg.obs_recorder_events)
                         if cfg.obs_recorder else None)
        self.scheduler = MicroBatchScheduler(
            ladder=ladder, max_queue=cfg.max_queue,
            max_wait_ms=cfg.max_wait_ms, max_batch=cfg.max_batch,
            lanes=cfg.lanes, default_lane=cfg.default_lane,
            adaptive_wait=cfg.adaptive_wait, shed=cfg.shed,
            service_ewma_alpha=cfg.service_ewma_alpha,
            registry=self.metrics, tracer=self.tracer,
            recorder=self.recorder)
        self.cache = cache if cache is not None \
            else StageResultCache(cfg.cache_entries, registry=self.metrics)
        self.cache_stages = cfg.cache_stages
        self.default_timeout_ms = cfg.default_timeout_ms
        self.trace_stages = cfg.trace_stages
        self.log = TraceLog(cfg.trace_capacity, registry=self.metrics)
        if self.engine is not None and (cfg.obs_tracing or cfg.obs_recorder):
            self.engine.attach_observability(tracer=self.tracer,
                                             recorder=self.recorder)
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._warm_compiles: int | None = None
        #: tenant name -> decode pool (generate-stage tenants only)
        self._pools: dict[str, ContinuousBatcher] = {}
        #: rid -> in-flight ServeRequest currently decoding in some pool
        self._decoding: dict[int, ServeRequest] = {}
        self._thread: threading.Thread | None = None
        self._stop = False
        self.last_error: BaseException | None = None
        self.add_pipeline(pipeline, name=name)

    # -- tenancy ------------------------------------------------------------
    def add_pipeline(self, pipeline, *, name: str | None = None,
                     optimize: bool | None = None) -> str:
        """Attach another pipeline to this server (compiled now, once).
        All pipelines share the engine, the scheduler, and the stage cache
        — identical structural prefixes share cache entries across
        tenants.  Returns the tenant name (``submit(..., pipeline=name)``
        routes to it).  Call :meth:`warmup` again after attaching so the
        new chain's (stage, bucket) variants are compiled before traffic
        hits them."""
        if name is None:
            name = f"pipe{len(self._tenants)}"
        if name in self._tenants:
            raise ValueError(f"pipeline name {name!r} already attached "
                             f"(attached: {sorted(self._tenants)})")
        report: dict = {}
        op = compile_pipeline(
            pipeline, self.backend,
            optimize=self.config.optimize if optimize is None else optimize,
            report=report)
        chain = ir.chain(op)
        gen = self._generate_ref(chain[-1]) if chain[-1].kind == "generate" \
            else None
        self._tenants[name] = _Tenant(
            name=name, op=op, chain=chain,
            stateful=op.stateful_subtree(),
            prefixes=chain_prefix_digests(chain, scope=self._digest_scope),
            compile_report=report, generate=gen)
        if gen is not None:
            # per-tenant decode pool over one KV cache; prefill and
            # decode-step programs are pinned in the engine, so warmup
            # captures them and steady state never makes another
            cfg_lm, params_lm = self.backend.lm(gen.params["model"])
            self._pools[name] = ContinuousBatcher(
                cfg_lm, params_lm, slots=self.config.decode_slots,
                max_len=(gen.params["max_prompt_len"]
                         + gen.params["max_new_tokens"] + 1),
                engine=self.engine,
                key=(self.backend.uid, chain[-1].key()))
        self.log.register_tenant(name)
        self._warm_compiles = None      # new chain: warm-up snapshot stale
        return name

    @staticmethod
    def _generate_ref(op):
        """The Generate stage instance behind a compiled ``generate`` op
        (rebuilt from the op's params if a rewrite dropped the ref)."""
        if op.ref is not None:
            return op.ref
        from repro_torch.core.stages import Generate
        return Generate(**op.params)

    def pipelines(self) -> list[str]:
        return list(self._tenants)

    def _tenant(self, name: str | None) -> _Tenant:
        if name is None:
            name = self._default_tenant
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(f"unknown pipeline {name!r}; attached: "
                           f"{sorted(self._tenants)}") from None

    # back-compat accessors: the default tenant's compiled pipeline
    @property
    def op(self):
        return self._tenant(None).op

    @property
    def chain(self):
        return self._tenant(None).chain

    @property
    def compile_report(self) -> dict:
        """Compile report of the default pipeline: pass timings, gate
        decisions, tuning counters (``['tuning']['profile_hits']`` > 0 with
        zero gate_estimates/probe_measurements = a profile-warm restart)."""
        return self._tenant(None).compile_report

    # -- key management -----------------------------------------------------
    def _prefix_digests(self, tenant: _Tenant) -> list:
        """Chained stage digests; recomputed per batch when the chain holds
        a stateful stage (fit() bumps its version marker — the recompute is
        what invalidates the online cache)."""
        if tenant.stateful:
            tenant.prefixes = chain_prefix_digests(tenant.chain,
                                                   scope=self._digest_scope)
        return tenant.prefixes

    # -- submission ---------------------------------------------------------
    def _next_rid(self) -> int:
        with self._rid_lock:
            self._rid += 1
            return self._rid

    def _make_requests(self, Q, timeout_ms, lane, pipeline) -> list:
        tenant = self._tenant(pipeline)
        lane = self.config.default_lane if lane is None else lane
        Q = StageResultCache.to_host(Q)
        nq = int(Q["qid"].shape[0])
        if nq <= 0:
            raise ValueError("empty query batch")
        if timeout_ms is _UNSET:
            timeout_ms = self.default_timeout_ms
        now = time.monotonic()
        deadline = None if timeout_ms is None else now + timeout_ms / 1000.0
        reqs = []
        for j in range(nq):
            row = StageResultCache.row(Q, j)
            rid = self._next_rid()
            req = ServeRequest(
                rid=rid, Q=row, deadline=deadline, lane=lane,
                tenant=tenant.name,
                trace=RequestTrace(rid=rid, t_arrival=now,
                                   chain_len=len(tenant.chain),
                                   lane=lane, tenant=tenant.name))
            req.qdigest = query_digest(row)
            reqs.append(req)
        # atomic: a burst admits whole or not at all (partial admission
        # would execute requests the caller holds no handles to)
        self.scheduler.submit_many(reqs)
        return reqs

    def submit_one(self, Q, *, timeout_ms=_UNSET, lane: str | None = None,
                   pipeline: str | None = None) -> ServeRequest:
        """Enqueue exactly one query (an nq==1 Q relation) and return its
        :class:`ServeRequest`.  ``timeout_ms`` omitted = inherit the
        server's ``default_timeout_ms``; an explicit ``None`` = no
        deadline.  ``lane`` routes into a WFQ priority lane; ``pipeline``
        names the tenant (default: the constructor pipeline).  Raises
        :class:`~repro_torch.serve.request.ServerOverloaded` when admission
        control rejects, and its subclass
        :class:`~repro_torch.serve.request.DeadlineUnmeetable` when
        shed-before-execute rejects the deadline at the door."""
        nq = int(Q["qid"].shape[0])
        if nq != 1:
            raise ValueError(f"submit_one takes exactly one query row, got "
                             f"nq={nq}; use submit() for bursts")
        return self._make_requests(Q, timeout_ms, lane, pipeline)[0]

    def submit(self, Q, *, timeout_ms=_UNSET, lane: str | None = None,
               pipeline: str | None = None) -> list:
        """Enqueue the queries in ``Q`` (an nq>=1 Q relation).  Always
        returns a plain list of :class:`ServeRequest` — one per row
        (:meth:`submit_one` is the single-request API).  See
        :meth:`submit_one` for ``timeout_ms`` / ``lane`` / ``pipeline``
        semantics and the overload exceptions."""
        return self._make_requests(Q, timeout_ms, lane, pipeline)

    def submit_wait(self, Q, *, timeout: float = 60.0, timeout_ms=_UNSET,
                    lane: str | None = None, pipeline: str | None = None):
        """Synchronous convenience: submit + pump + wait.  ``timeout_ms``
        is the per-request deadline (forwarded to :meth:`submit`, so the
        synchronous path can express deadlines too); ``timeout`` bounds
        the local wait for results.  Returns one result for an nq==1
        submission, else a list of results."""
        reqs = self._make_requests(Q, timeout_ms, lane, pipeline)
        self.pump()
        outs = [r.wait(timeout) for r in reqs]
        return outs[0] if len(outs) == 1 else outs

    # -- serving loop -------------------------------------------------------
    def _decode_busy(self) -> bool:
        return bool(self._decoding) or self.scheduler.decode_pending() > 0

    def step(self, *, block: bool = False, timeout: float | None = None,
             drain: bool = False) -> int:
        """Close and execute at most one micro-batch, then advance every
        decode pool by one iteration (admit freed slots, one ragged decode
        step); returns the number of requests retired (served + shed;
        0 = no batch closed and no decode finished).  Never blocks while
        decodes are in flight — a blocked wait for retrieval arrivals must
        not stall token production."""
        if block and self._decode_busy():
            block = False
        batch = self.scheduler.next_batch(block=block, timeout=timeout,
                                          drain=drain)
        n = 0
        if batch is not None:
            self._execute_batch(batch)
            n += len(batch.requests) + len(batch.shed)
        n += self._decode_pump()
        return n

    def pump(self) -> int:
        """Drain the queue synchronously (replay/test mode): retrieval
        batches and decode iterations until nothing is queued, waiting for
        a slot, or mid-decode."""
        total = 0
        while True:
            n = self.step(drain=True)
            total += n
            if n == 0 and not self._decode_busy():
                return total

    def start(self) -> "PipelineServer":
        """Spawn the serving thread (continuous mode)."""
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="pipeline-server")
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop = True
            self._thread.join()
            self._thread = None
        self.pump()                      # never strand queued requests

    def _loop(self) -> None:
        while not self._stop:
            try:
                self.step(block=True, timeout=0.02)
            except BaseException as e:             # keep the loop alive
                self.last_error = e

    # -- warm-up ------------------------------------------------------------
    def warmup(self, Q_sample) -> dict:
        """Make every (pipeline stage, bucket) program entry by replaying a
        sample query at each ladder rung through every attached pipeline,
        then snapshot the engine's compile counter:
        ``stats()['recompiles_since_warmup']`` must stay 0 in steady
        state.  Cache writes are skipped (the tiled duplicates would only
        pollute the LRU)."""
        row = StageResultCache.row(StageResultCache.to_host(Q_sample), 0)
        t0 = time.monotonic()
        for tenant in self._tenants.values():
            pool = self._pools.get(tenant.name)
            # a generate tenant serves its chain split at the answer
            # boundary, so warm exactly what serving runs: the retrieval
            # prefix + prompt assembly at every rung, then the pool's
            # prefill and decode-step programs once — their shapes are
            # fixed (static prompt length, full-pool decode arrays), so
            # one compile each covers every future mix of slots
            chain = (tenant.chain if pool is None else tenant.chain[:-1])
            for bucket in self.scheduler.ladder:
                Qb = tree_map(
                    lambda x: np.tile(x, (bucket,) + (1,) * (x.ndim - 1)),
                    row)
                ctx = Context(self.backend)
                Q, R, tok = self._device(Qb), None, None
                for stage in chain:
                    Q, R, tok = _execute(stage, ctx, Q, R, tok)
                if pool is not None:
                    tenant.generate.assemble(ctx, Q, R)
                self._barrier()
            if pool is not None:
                P = tenant.generate.params["max_prompt_len"]
                pool.prefill_request(_DecodeRequest(
                    rid=-1, prompt=np.zeros(P, np.int32), max_new_tokens=2))
                pool.step_active()
                pool.reset()
        if self.engine is not None:
            self._warm_compiles = self.engine.total_compiles()
        out = {"warmup_s": round(time.monotonic() - t0, 3),
               "buckets": list(self.scheduler.ladder),
               "pipelines": list(self._tenants),
               "compiles": (None if self.engine is None
                            else self.engine.total_compiles())}
        # persist any autotune decisions taken at compile time, so the next
        # server process starts profile-warm (zero estimates / probes)
        prof = self.backend.descriptor.profile
        if prof is not None:
            prof.save()
            out["tuning_profile"] = prof.info()
        if self.compile_report:
            out["tuning"] = self.compile_report.get("tuning")
        return out

    # -- batch execution ----------------------------------------------------
    def _device(self, tree):
        """A host nest as tensors on the backend's device."""
        return StageResultCache.to_device(tree, self.backend.device)

    def _barrier(self) -> None:
        """Wait for the backend's device (a synchronize on the card)."""
        self.backend.barrier()

    def _execute_batch(self, batch) -> None:
        now = batch.t_closed
        for req in batch.shed:          # shed pre-execution by the scheduler
            req.trace.t_scheduled = now
            req.trace.queue_wait_ms = 1000.0 * (now - req.t_enqueued)
            req.trace.batch_reason = batch.reason
            self._finish(req, None, timed_out=True)
        live = []
        for req in batch.requests:
            req.trace.t_scheduled = now
            req.trace.queue_wait_ms = 1000.0 * (now - req.t_enqueued)
            req.trace.batch_size = len(batch.requests)
            req.trace.batch_reason = batch.reason
            if req.expired(now):        # expired while queued (no EWMA yet)
                self._finish(req, None, timed_out=True)
            else:
                live.append(req)
        if not live:
            return
        self.log.record_batch(len(live))
        t_exec0 = time.monotonic()
        # deepest cached prefix per request, then group by (tenant, resume
        # depth) so each group executes its remaining suffix as one
        # micro-batch of its own pipeline
        groups: dict[tuple, list] = {}
        cached: dict[int, tuple] = {}
        max_bucket = 0
        for req in live:
            tenant = self._tenants[req.tenant]
            depth, val, writer = self.cache.lookup_deepest(
                self._prefix_digests(tenant), req.qdigest,
                reader=tenant.name)
            req.trace.cache_hit_depth = depth
            req.trace.cross_prefix_hit = (depth > 0 and writer is not None
                                          and writer != tenant.name)
            cached[req.rid] = val
            groups.setdefault((req.tenant, depth), []).append(req)
        for tname, depth in sorted(groups, key=lambda g: (g[0], -g[1])):
            grp = groups[(tname, depth)]
            try:
                bucket = self._run_group(self._tenants[tname], grp, depth,
                                         [cached[r.rid] for r in grp])
                max_bucket = max(max_bucket, bucket)
            except BaseException as e:
                self.last_error = e
                for req in grp:
                    req.error = e
                    self._finish(req, None)
        # service-time feedback: the per-bucket/per-slot EWMAs of these are
        # the scheduler's S in every shed decision and its deadline cap on
        # batch packing; the engine keeps its own per-bucket view
        dt = time.monotonic() - t_exec0
        self.scheduler.note_service_time(dt, len(live))
        if self.engine is not None and max_bucket:
            self.engine.note_service_time(max_bucket, dt)

    def _run_group(self, tenant: _Tenant, reqs, depth: int,
                   cached_vals) -> int:
        """Execute one (tenant, resume-depth) group as a padded micro-batch;
        returns the ladder bucket it padded to (0 = pure cache replay)."""
        chain, prefixes = tenant.chain, self._prefix_digests(tenant)
        L = len(chain)
        qids = [r.qid for r in reqs]
        if depth >= L:                       # full-pipeline cache hits
            for req, (Qc, Rc) in zip(reqs, cached_vals):
                Qr, Rr = StageResultCache.restamp_qids(Qc, Rc, [req.qid])
                # row(…, 0) copies: the served result must never alias the
                # live cache entry (same invariant as the miss path)
                self._finish(req, StageResultCache.row(
                    Rr if Rr is not None else Qr, 0))
            return 0
        if depth == 0:
            Q = StageResultCache.stack_rows([r.Q for r in reqs])
            R = None
        else:                                # resume mid-chain
            Q = StageResultCache.stack_rows([v[0] for v in cached_vals])
            R_rows = [v[1] for v in cached_vals]
            R = (None if R_rows[0] is None
                 else StageResultCache.stack_rows(R_rows))
            Q, R = StageResultCache.restamp_qids(Q, R, qids)
        n = len(reqs)
        bucket = (self.engine.select_bucket(n) if self.engine is not None
                  else self.scheduler.select_bucket(n))
        for req in reqs:
            req.trace.bucket = bucket
        # pad up to the bucket BEFORE execution: every stage then sees
        # exactly the ladder shapes warm-up compiled (no per-size variants
        # anywhere, eager pre-steps included); padded rows are dropped when
        # results are sliced per request below
        Q = self._device(StageResultCache.pad_rows(Q, bucket - n))
        R = self._device(StageResultCache.pad_rows(R, bucket - n))
        ctx = Context(self.backend)
        tok = ctx.source_token(Q, R)
        stage_times = []
        # a generate tenant runs only its retrieval prefix here; the final
        # stage is decode, which the request rides iteration-level in the
        # tenant's pool (handoff below) instead of run-to-completion
        L_here = L - 1 if tenant.generate is not None else L
        for i in range(depth, L_here):
            stage = chain[i]
            t0 = time.monotonic() if self.trace_stages else 0.0
            Q, R, tok = _execute(stage, ctx, Q, R, tok)
            if self.trace_stages:
                self._barrier()
                ms = 1000.0 * (time.monotonic() - t0)
                label = stage.label()
                stage_times.append((label, round(ms, 3)))
                self.log.record_stage(label, ms)
            if self.cache_stages and self.cache.enabled and i < L - 1:
                # one device->host copy per stage, rows sliced from the
                # host copy (not one small device slice per row)
                Qh = StageResultCache.to_host(Q)
                Rh = None if R is None else StageResultCache.to_host(R)
                for j, req in enumerate(reqs):
                    self.cache.store(prefixes[i], req.qdigest,
                                     StageResultCache.row(Qh, j),
                                     None if Rh is None
                                     else StageResultCache.row(Rh, j),
                                     writer=tenant.name)
        if tenant.generate is not None:
            # answer boundary: assemble each live row's prompt (batched at
            # the same bucket shape warm-up compiled) and queue it for a
            # decode slot — these requests retire from _decode_pump, and
            # the batch they just rode mixed with pure-retrieval tenants
            gen = tenant.generate
            prompts = gen.assemble(ctx, Q, R).cpu().numpy()
            Qh = StageResultCache.to_host(Q)
            Rh = StageResultCache.to_host(R)
            for j, req in enumerate(reqs):
                req.trace.stage_ms = tuple(stage_times)
                req._prompt = prompts[j]
                req._Q_row = StageResultCache.row(Qh, j)
                req._R_row = StageResultCache.row(Rh, j)
                self.scheduler.decode_submit(req)
            return bucket
        Qh = StageResultCache.to_host(Q)
        Rh = None if R is None else StageResultCache.to_host(R)
        result = Rh if Rh is not None else Qh
        for j, req in enumerate(reqs):
            req.trace.stage_ms = tuple(stage_times)
            if self.cache.enabled:
                self.cache.store(
                    prefixes[L - 1], req.qdigest,
                    StageResultCache.row(Qh, j),
                    None if Rh is None else StageResultCache.row(Rh, j),
                    writer=tenant.name)
            self._finish(req, StageResultCache.row(result, j))
        return bucket

    def _decode_pump(self) -> int:
        """One iteration of every decode pool: admit queued prompts into
        freed KV-cache slots (EDF order — this between-steps admission is
        what makes decode scheduling iteration-level), one ragged decode
        step per active pool, then retire finished answers.  Returns the
        number of requests retired."""
        retired = 0
        free = sum(p.free_slots() for p in self._pools.values())
        if free and self.scheduler.decode_pending():
            now = time.monotonic()
            for req in self.scheduler.decode_take(free):
                if req.expired(now):
                    self._finish(req, None, timed_out=True)
                    retired += 1
                    continue
                pool = self._pools[req.tenant]
                if pool.free_slots() == 0:
                    # the freed slot was another tenant's pool: wait on
                    self.scheduler.decode_submit(req)
                    continue
                tenant = self._tenants[req.tenant]
                pool.prefill_request(_DecodeRequest(
                    rid=req.rid, prompt=req._prompt,
                    max_new_tokens=tenant.generate.params["max_new_tokens"]))
                # the prefill produced the first answer token
                req.trace.ttft_ms = 1000.0 * (time.monotonic()
                                              - req.trace.t_arrival)
                self._decoding[req.rid] = req
        for pool in self._pools.values():
            if pool.active_slots() == 0:
                continue
            for dreq in pool.step_active():
                req = self._decoding.pop(dreq.rid)
                tenant = self._tenants[req.tenant]
                tokens = np.asarray(dreq.generated, np.int32)[None, :]
                row = dict(req._R_row)
                row["tokens"] = tokens
                req.trace.n_tokens = int(tokens.shape[1])
                if self.cache.enabled:
                    self.cache.store(
                        self._prefix_digests(tenant)[-1], req.qdigest,
                        req._Q_row, row, writer=tenant.name)
                # row(…, 0) copies: the served result must never alias the
                # live cache entry (same invariant as the retrieval path)
                self._finish(req, StageResultCache.row(row, 0))
                retired += 1
        return retired

    def _finish(self, req, result, *, timed_out: bool = False) -> None:
        t = time.monotonic()
        tr = req.trace
        tr.t_done = t
        tr.timed_out = timed_out
        tr.errored = req.error is not None
        tr.latency_ms = 1000.0 * (t - tr.t_arrival)
        tr.service_ms = 1000.0 * (t - tr.t_scheduled) if tr.t_scheduled else 0.0
        tr.late = (not timed_out and not tr.errored
                   and req.deadline is not None and t > req.deadline)
        req.result = result
        if timed_out and self.recorder is not None and not tr.shed:
            # shed drops are recorded by the scheduler at decision time
            # (with the S(n) inputs); this covers expiry in queue/decode
            self.recorder.record("deadline_drop", rid=tr.rid,
                                 tenant=tr.tenant, lane=tr.lane,
                                 queue_wait_ms=round(tr.queue_wait_ms, 3))
        if self.tracer.enabled:
            self._emit_request_spans(tr)
        self.log.record(tr)
        req.done.set()

    def _emit_request_spans(self, tr) -> None:
        """Retrospective per-request lifecycle spans, emitted at finish
        from the ``RequestTrace`` timestamps.  Spans link by explicit
        parent id (nesting is data, not wall-clock containment), so a
        request admitted on the caller thread and executed on the serving
        thread still exports as one nested tree; each request gets its
        own synthetic Perfetto track (``tid = rid``)."""
        tracer, rel, tid = self.tracer, self.tracer.rel, tr.rid
        outcome = ("errors" if tr.errored else "shed" if tr.shed
                   else "timed_out" if tr.timed_out
                   else "late" if tr.late else "served")
        root = tracer.add_span(
            "serve.request", rel(tr.t_arrival), rel(tr.t_done), cat="serve",
            tid=tid, rid=tr.rid, tenant=tr.tenant, lane=tr.lane,
            outcome=outcome, latency_ms=round(tr.latency_ms, 3))
        if not tr.t_scheduled:
            return
        tracer.add_span("serve.queue", rel(tr.t_arrival),
                        rel(tr.t_scheduled), cat="serve", parent=root,
                        tid=tid, queue_wait_ms=round(tr.queue_wait_ms, 3))
        # decode start = first generated token; before it, the request
        # was riding its retrieval micro-batch
        t_dec0 = (tr.t_arrival + tr.ttft_ms / 1000.0 if tr.ttft_ms else None)
        batch = tracer.add_span(
            "serve.batch", rel(tr.t_scheduled),
            rel(t_dec0 if t_dec0 is not None else tr.t_done), cat="serve",
            parent=root, tid=tid, reason=tr.batch_reason,
            batch_size=tr.batch_size, bucket=tr.bucket,
            cache_hit_depth=tr.cache_hit_depth,
            cross_prefix_hit=tr.cross_prefix_hit)
        t = tr.t_scheduled            # stage stamps are durations only:
        for label, ms in tr.stage_ms:  # lay them end-to-end from close
            tracer.add_span(f"serve.stage:{label}", rel(t),
                            rel(t + ms / 1000.0), cat="serve",
                            parent=batch, tid=tid, ms=ms)
            t += ms / 1000.0
        if t_dec0 is not None:
            tracer.add_span("serve.decode", rel(t_dec0), rel(tr.t_done),
                            cat="serve", parent=root, tid=tid,
                            n_tokens=tr.n_tokens,
                            ttft_ms=round(tr.ttft_ms, 3))

    # -- observability ------------------------------------------------------
    def trace_export(self, path: str | None = None) -> dict:
        """Chrome trace-event JSON of every retained span (request
        lifecycles, scheduler batch closes, engine dispatches and
        cause-tagged program-cache entries and graph captures).  Load the written file in Perfetto
        (https://ui.perfetto.dev) to see per-request tracks with nested
        queue/batch/stage/decode children.  Requires
        ``ServeConfig.with_observability()``; disabled tracing exports an
        empty event list."""
        out = self.tracer.export_chrome()
        if path is not None:
            with open(path, "w") as f:
                json.dump(out, f)
        return out

    def flight_record(self, last: int | None = None) -> list:
        """The flight recorder's ring — the last N scheduler/engine
        decisions (admissions, sheds with their service-model inputs,
        deadline drops, recompiles), oldest first.  Empty when the
        recorder is disabled."""
        return [] if self.recorder is None else self.recorder.dump(last)

    def metrics_snapshot(self) -> dict:
        """Structured dump of the metrics behind :meth:`stats`
        (name -> {kind, series}): the server's own registry merged with
        the shared engine's (the engine serves every server on its
        backend, so it keeps a registry of its own)."""
        out = (self.engine.metrics.snapshot()
               if self.engine is not None else {})
        out.update(self.metrics.snapshot())
        return out

    def metrics_text(self) -> str:
        """Prometheus text exposition of :meth:`metrics_snapshot`."""
        parts = [self.metrics.render_text()]
        if self.engine is not None:
            parts.append(self.engine.metrics.render_text())
        return "".join(parts)

    # -- reporting ----------------------------------------------------------
    def stats(self) -> dict:
        default = self._tenant(None)
        # NOTE: log.summary() supplies "pipelines" — the per-tenant counter
        # dict, keyed by every attached pipeline name
        out = {
            "pipeline": default.op.label(),
            "chain_len": len(default.chain),
            "config": self.config.as_dict(),
            "scheduler": self.scheduler.stats(),
            **self.log.summary(),
            "stage_cache": self.cache.info(),
        }
        out["cross_pipeline_hits"] = self.cache.cross_pipeline_hits
        if self._pools:
            out["decode_pools"] = {
                name: {"slots": p.slots,
                       "active": p.active_slots(),
                       "queued": self.scheduler.decode_pending(),
                       "decode_steps": p.n_decode_steps,
                       "max_len": p.max_len}
                for name, p in self._pools.items()}
        if self.engine is not None:
            out["engine"] = self.engine.stats()
            total = self.engine.total_compiles()
            out["recompiles_since_warmup"] = (
                None if self._warm_compiles is None
                else total - self._warm_compiles)
        else:
            out["engine"] = None
            out["recompiles_since_warmup"] = None
        out["tuning"] = default.compile_report.get("tuning")
        prof = self.backend.descriptor.profile
        out["tuning_profile"] = None if prof is None else prof.info()
        return out


class MultiPipelineServer(PipelineServer):
    """Several named pipelines multiplexed over one engine, one scheduler,
    and one shared stage cache from construction:

    >>> server = MultiPipelineServer(
    ...     {"interactive": bm25 >> rerank % 10, "batch": bm25 % 100},
    ...     backend, ServeConfig.default().with_lanes(
    ...         ("interactive", 4.0), ("background", 1.0)))
    >>> server.warmup(Q)
    >>> server.submit_one(row, pipeline="batch", lane="background")

    The first entry is the default tenant (``submit`` with no ``pipeline=``
    routes there).  Equivalent to ``PipelineServer`` + ``add_pipeline``
    per extra entry.
    """

    def __init__(self, pipelines: dict, backend,
                 config: ServeConfig | None = None, *,
                 cache: StageResultCache | None = None):
        if not pipelines:
            raise ValueError("MultiPipelineServer needs at least one "
                             "pipeline")
        items = list(pipelines.items())
        first_name, first = items[0]
        super().__init__(first, backend, config, cache=cache,
                         name=first_name)
        for tname, pipe in items[1:]:
            self.add_pipeline(pipe, name=tname)
