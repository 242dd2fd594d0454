"""The Experiment abstraction (paper §3.4).

``Experiment(pipelines, topics, qrels, metrics)`` applies each pipeline to a
common query set and evaluates the results side-by-side.  By default the
pipelines are compiled into an :class:`~repro_torch.core.plan.ExperimentPlan`
— a shared-prefix trie that executes every common sub-pipeline exactly once
and attributes per-stage wall-clock, so MRT (mean response time, the
RQ1/RQ2 tables) decomposes into compile / steady-state / shared-amortised
components.  ``plan=False`` keeps the sequential path (one
``run_pipeline`` per pipeline over a shared memo, or a fresh one each with
``share_cache=False``).

Timing semantics: with ``measure_time=True`` the plan runs twice — a cold
pass (kernel builds and first-call costs happen here) and a steady-state
pass with a fresh memo — and ``mrt_ms`` reports the steady pass: the sum of
each stage's wall clock on the pipeline's path per query, every stage
ended by the backend's barrier (``torch.cuda.synchronize()`` on a CUDA
backend).  ``compile_ms`` is the cold pass's excess, ``mrt_shared_ms``
splits each stage over the pipelines sharing it.  The sequential path's ``mrt_ms`` is one
synchronised run of the whole pipeline after a warm-up run, per query.
Without ``measure_time`` the plan runs once, asynchronously, with no
barrier between stages, and its ``stage_table`` holds no times
(``cold_ms`` and ``steady_ms`` are None).

Spans (``repro_torch.obs.tracing``): ``experiment.call`` around the whole
call, ``experiment.wait`` around the planned path's wait for the device to
finish the results, and ``experiment.measures`` around each pipeline's
evaluation; in the process-global tracer where the backend's descriptor
opts in, and in a recording ``torch.profiler`` always.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Sequence

from repro_torch.core import measures as M
from repro_torch.core.compiler import Context, TorchBackend, run_pipeline
from repro_torch.core.passes import compile_pipeline
from repro_torch.core.plan import ArtifactCache, ExperimentPlan
from repro_torch.core.transformer import Transformer
from repro_torch.obs.tracing import tracer_for


def Experiment(pipelines: Sequence[Transformer], topics, qrels,
               metrics: Sequence[str] = ("map", "ndcg_cut_10"),
               *, backend: TorchBackend, names: Sequence[str] | None = None,
               optimize: bool = True, measure_time: bool = False,
               share_cache: bool = True, plan: bool = True,
               artifact_cache: ArtifactCache | str | Path | None = None) -> dict:
    """Returns {"table": [row dicts], "results": [R per pipeline]}; planned
    runs also carry "plan" (the ExperimentPlan) and "stage_table"
    (per-stage sharing attribution, and timing with ``measure_time``:
    otherwise its ``cold_ms`` and ``steady_ms`` are None)."""
    names = list(names) if names else [repr(p)[:60] for p in pipelines]
    if isinstance(artifact_cache, (str, Path)):
        artifact_cache = ArtifactCache(artifact_cache)
    tracer = tracer_for(backend.descriptor)
    with tracer.span("experiment.call", "experiment",
                     n_pipelines=len(names), planned=plan):
        if plan:
            return _experiment_planned(pipelines, topics, qrels, metrics,
                                       backend, names, optimize,
                                       measure_time, artifact_cache, tracer)
        return _experiment_sequential(pipelines, topics, qrels, metrics,
                                      backend, names, optimize, measure_time,
                                      share_cache, tracer)


def _measures(tracer, name, R, qrels, metrics) -> dict:
    """The evaluation row of one pipeline's results."""
    with tracer.span("experiment.measures", "experiment", pipeline=name):
        return {"name": name, **M.compute_measures(R, qrels, list(metrics))}


def _experiment_planned(pipelines, topics, qrels, metrics, backend, names,
                        optimize, measure_time, cache, tracer) -> dict:
    eplan = ExperimentPlan(pipelines, backend, optimize=optimize)
    # stages end in a barrier only where they are timed (or persisted)
    results = eplan.execute(topics, ctx=Context(backend), cache=cache,
                            record="cold" if measure_time else None)
    if measure_time:
        if cache is not None and cache.hits:
            # artifacts served from disk mean the cold pass ran nothing —
            # pay the first calls in an unrecorded pass so the timed steady
            # pass below holds none of them
            eplan.execute(topics, ctx=Context(backend), record=None)
        # steady-state pass: fresh memo, first-call costs paid.  No artifact
        # cache here — MRT must measure execution, not disk reads.
        results = eplan.execute(topics, ctx=Context(backend), record="warm")
    # the evaluation copies the results to the host, which waits for the
    # device anyway: wait here, so that experiment.measures times the
    # evaluation alone
    with tracer.span("experiment.wait", "experiment"):
        backend.barrier(results)
    nq = int(topics["qid"].shape[0])
    rows = []
    for i, (name, R) in enumerate(zip(names, results)):
        row = _measures(tracer, name, R, qrels, metrics)
        if measure_time:
            t = eplan.pipeline_times(i)
            row["mrt_ms"] = 1000.0 * t["steady_s"] / nq
            row["compile_ms"] = 1000.0 * t["compile_s"]
            row["mrt_shared_ms"] = 1000.0 * t["amortised_s"] / nq
        rows.append(row)
    return {"table": rows, "results": results, "plan": eplan,
            "stage_table": eplan.stage_stats()}


def _experiment_sequential(pipelines, topics, qrels, metrics, backend, names,
                           optimize, measure_time, share_cache,
                           tracer) -> dict:
    """The pre-planner path (``plan=False``)."""
    sync = backend.barrier
    shared = Context(backend)
    rows, results = [], []
    for name, pipe in zip(names, pipelines):
        node = compile_pipeline(pipe, backend) if optimize else pipe
        if measure_time:
            # warm-up with a throwaway memo so the timed region below
            # measures steady-state retrieval, not first-call costs
            run_pipeline(node, topics, backend=backend, optimize=False,
                         ctx=Context(backend))
            sync()
        t0 = time.perf_counter()
        R = run_pipeline(node, topics, backend=backend, optimize=False,
                         ctx=shared if share_cache else Context(backend))
        sync()
        elapsed = time.perf_counter() - t0
        row = _measures(tracer, name, R, qrels, metrics)
        if measure_time:
            row["mrt_ms"] = 1000.0 * elapsed / int(R["qid"].shape[0])
        rows.append(row)
        results.append(R)
    return {"table": rows, "results": results}


def format_table(rows: list[dict]) -> str:
    if not rows:
        return "(empty)"
    cols = list(rows[0].keys())
    widths = {c: max(len(c), *(len(_fmt(r.get(c))) for r in rows)) for c in cols}
    lines = ["  ".join(c.ljust(widths[c]) for c in cols)]
    for r in rows:
        lines.append("  ".join(_fmt(r.get(c)).ljust(widths[c]) for c in cols))
    return "\n".join(lines)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)
