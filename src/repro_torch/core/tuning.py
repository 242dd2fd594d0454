"""Experiment variants the paper sketches in §3.4: grid search with
stage-output caching, and k-fold cross-validation.

"Due to the compositional nature of a retrieval pipeline, the grid search
would be able to cache the outcomes of earlier stages, such that later
retrieval components could be varied without re-execution of all pipeline
stages."  — implemented literally: all candidate pipelines share one
``Context`` memo, so common prefixes (hash-consed by structural key)
execute once across the whole grid.
"""
from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import measures as M
from repro_torch.core.compiler import Context, TorchBackend, run_pipeline
from repro_torch.core.passes import compile_pipeline
from repro_torch.core.transformer import Transformer


def GridSearch(build: Callable[..., Transformer], grid: dict[str, Sequence],
               topics, qrels, *, metric: str = "map", backend: TorchBackend,
               optimize: bool = True) -> dict:
    """Evaluate ``build(**params)`` over the cartesian grid; returns
    {"best_params", "best_score", "table"}.  Shared-prefix stage caching
    happens automatically via the common Context.
    """
    ctx = Context(backend)
    names = list(grid)
    rows = []
    best = (None, -np.inf)
    for values in itertools.product(*grid.values()):
        params = dict(zip(names, values))
        pipe = build(**params)
        node = compile_pipeline(pipe, backend) if optimize else pipe
        R = run_pipeline(node, topics, backend=backend, optimize=False,
                         ctx=ctx)
        score = M.compute_measures(R, qrels, [metric])[metric]
        rows.append({**params, metric: score})
        if score > best[1]:
            best = (params, score)
    return {"best_params": best[0], "best_score": best[1], "table": rows}


def kfold_splits(qids: np.ndarray, k: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(qids))
    folds = np.array_split(order, k)
    for i in range(k):
        test = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        yield train, test


def _subset(Q, idx):
    """The rows ``idx`` of every tensor of Q, indexed on its own device."""
    idx = np.asarray(idx)
    return {k: v[torch.as_tensor(idx, device=v.device)] for k, v in Q.items()}


def _subset_qrels(qrels, Q):
    qids = set(int(q) for q in Q["qid"].cpu().numpy())
    return {q: g for q, g in qrels.items() if q in qids}


def CrossValidate(build: Callable[..., Transformer], topics, qrels, *,
                  k: int = 5, metrics: Sequence[str] = ("map",),
                  backend: TorchBackend, fit: bool = True,
                  seed: int = 0) -> dict:
    """k-fold CV: for each fold, ``build()`` a fresh pipeline, fit it on the
    train queries (if it has stateful stages), evaluate on the held-out
    fold; returns per-fold and mean metrics."""
    qids = topics["qid"].cpu().numpy()
    folds = []
    for train_idx, test_idx in kfold_splits(qids, k, seed):
        pipe = build()
        Qtr, Qte = _subset(topics, train_idx), _subset(topics, test_idx)
        if fit:
            pipe.fit(Qtr, _subset_qrels(qrels, Qtr), backend=backend)
        R = pipe.transform(Qte, backend=backend)
        folds.append(M.compute_measures(R, _subset_qrels(qrels, Qte),
                                        list(metrics)))
    mean = {m: float(np.mean([f[m] for f in folds])) for m in metrics}
    return {"folds": folds, "mean": mean}
