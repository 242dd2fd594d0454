"""The IR data model (paper §3.1): queries Q, result lists R, qrels RA.

Q and R are relations realised as dicts of tensors on one explicit device:

  Q:  {"qid" [NQ], "terms" [NQ, MAXQ] (-1 padded), "weights" [NQ, MAXQ]}
  R:  {"qid" [NQ], "docids" [NQ, K] (-1 padded), "scores" [NQ, K],
       optional "features" [NQ, K, F]}

Primary keys: q.id for Q; (q.id, d.id) for R — mirrored from the paper's
object-relational model.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common import resolve_device

MAXQ = 48   # padded query length (original + expansion terms)

Queries = dict[str, Any]
Results = dict[str, Any]


def make_queries(terms: np.ndarray, weights: np.ndarray | None = None,
                 qids: np.ndarray | None = None, maxq: int = MAXQ,
                 device=None) -> Queries:
    """Q on ``device`` (``None`` = the card; raises without one)."""
    dev = resolve_device(device)
    terms = np.asarray(terms, np.int32)
    nq, L = terms.shape
    if L < maxq:
        terms = np.pad(terms, ((0, 0), (0, maxq - L)), constant_values=-1)
        if weights is not None:
            weights = np.pad(np.asarray(weights, np.float32),
                             ((0, 0), (0, maxq - L)))
    if weights is None:
        weights = (terms >= 0).astype(np.float32)
    if qids is None:
        qids = np.arange(nq, dtype=np.int32)
    return {"qid": torch.as_tensor(np.asarray(qids, np.int32), device=dev),
            "terms": torch.as_tensor(terms, device=dev),
            "weights": torch.as_tensor(np.asarray(weights, np.float32),
                                       device=dev)}


def empty_results(nq: int, k: int, device=None) -> Results:
    dev = resolve_device(device)
    return {"qid": torch.arange(nq, dtype=torch.int32, device=dev),
            "docids": torch.full((nq, k), -1, dtype=torch.int32, device=dev),
            "scores": torch.full((nq, k), -torch.inf, dtype=torch.float32,
                                 device=dev)}
