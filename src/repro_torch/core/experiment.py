"""The Experiment abstraction (paper §3.4).

``Experiment(pipelines, topics, qrels, metrics)`` applies each pipeline to a
common query set and evaluates the results side-by-side.  The port runs the
sequential path (one ``run_pipeline`` per pipeline over a shared memo); the
shared-prefix planner (``core/plan.py`` in the JAX package) is not ported
yet, so ``plan=True`` raises.

Timing semantics: with ``measure_time=True`` each pipeline runs once to warm
up (kernel builds and first-call costs happen there), then once timed;
``mrt_ms`` is the timed run's wall-clock per query, bracketed by
``torch.cuda.synchronize()`` on a CUDA backend so it covers the device
work, not just its enqueueing.
"""
from __future__ import annotations

import time
from typing import Sequence

import torch

from repro_torch.core import measures as M
from repro_torch.core.compiler import Context, TorchBackend, run_pipeline
from repro_torch.core.passes import compile_pipeline
from repro_torch.core.transformer import Transformer


def Experiment(pipelines: Sequence[Transformer], topics, qrels,
               metrics: Sequence[str] = ("map", "ndcg_cut_10"),
               *, backend: TorchBackend, names: Sequence[str] | None = None,
               optimize: bool = True, measure_time: bool = False,
               plan: bool = False) -> dict:
    """Returns {"table": [row dicts], "results": [R per pipeline]}."""
    if plan:
        raise NotImplementedError(
            "the Experiment planner (core/plan.py: ExperimentPlan) is not "
            "ported yet; use plan=False")
    names = list(names) if names else [repr(p)[:60] for p in pipelines]
    sync = (torch.cuda.synchronize if backend.device.type == "cuda"
            else (lambda: None))
    ctx = Context(backend)          # one memo shared by the pipelines
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
                         ctx=ctx)
        sync()
        elapsed = time.perf_counter() - t0
        row = {"name": name, **M.compute_measures(R, qrels, list(metrics))}
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
