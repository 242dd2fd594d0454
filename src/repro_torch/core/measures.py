"""IR evaluation measures (trec_eval semantics) — metric math in torch.

The (qid, docid) -> grade join happens host-side (as trec_eval does); the
measure computations are vectorised fp32 torch over the dense [NQ, K] grade
matrix, on the CPU.  Supported: map, ndcg_cut_K, P_K, recip_rank,
recall_K, num_rel_ret.
"""
from __future__ import annotations

import re

import numpy as np
import torch


def label_matrix(R, qrels: dict[int, dict[int, int]]) -> tuple[np.ndarray, np.ndarray]:
    """Returns (grades [NQ, K], n_rel [NQ])."""
    qids = R["qid"].cpu().numpy()
    docids = R["docids"].cpu().numpy()
    grades = np.zeros(docids.shape, np.float32)
    n_rel = np.zeros(len(qids), np.float32)
    for i, q in enumerate(qids):
        g = qrels.get(int(q), {})
        n_rel[i] = sum(1 for v in g.values() if v > 0)
        if g:
            row = docids[i]
            grades[i] = [g.get(int(d), 0) if d >= 0 else 0 for d in row]
    return grades, n_rel


def average_precision(grades, n_rel):
    rel = (grades > 0).to(torch.float32)
    cum = torch.cumsum(rel, dim=1)
    ranks = torch.arange(1, grades.shape[1] + 1, dtype=torch.float32)
    prec = cum / ranks
    ap = torch.sum(prec * rel, dim=1) / n_rel.clamp(min=1.0)
    return torch.where(n_rel > 0, ap, 0.0)


def ndcg_at(grades, n_rel, k: int):
    g = grades[:, :k]
    discounts = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float32))
    discounts = discounts[:g.shape[1]]
    dcg = torch.sum((2.0 ** g - 1.0) * discounts, dim=1)
    ideal = torch.sort(grades, dim=1, descending=True).values[:, :k]
    idcg = torch.sum((2.0 ** ideal - 1.0) * discounts, dim=1)
    return torch.where(idcg > 0, dcg / idcg.clamp(min=1e-9), 0.0)


def precision_at(grades, n_rel, k: int):
    return torch.mean((grades[:, :k] > 0).to(torch.float32), dim=1)


def recip_rank(grades, n_rel):
    rel = grades > 0
    first = torch.argmax(rel.to(torch.int8), dim=1)
    has = torch.any(rel, dim=1)
    return torch.where(has, 1.0 / (first + 1.0), 0.0)


def recall_at(grades, n_rel, k: int):
    hits = torch.sum((grades[:, :k] > 0).to(torch.float32), dim=1)
    return torch.where(n_rel > 0, hits / n_rel.clamp(min=1.0), 0.0)


def compute_measures(R, qrels, metrics: list[str]) -> dict[str, float]:
    grades_np, n_rel_np = label_matrix(R, qrels)
    grades, n_rel = torch.from_numpy(grades_np), torch.from_numpy(n_rel_np)
    out = {}
    for m in metrics:
        if m == "map":
            v = average_precision(grades, n_rel)
        elif m == "recip_rank":
            v = recip_rank(grades, n_rel)
        elif m == "num_rel_ret":
            v = torch.sum(grades > 0, dim=1).to(torch.float32)
        elif (mm := re.fullmatch(r"ndcg_cut_(\d+)", m)):
            v = ndcg_at(grades, n_rel, int(mm.group(1)))
        elif (mm := re.fullmatch(r"P_(\d+)", m)):
            v = precision_at(grades, n_rel, int(mm.group(1)))
        elif (mm := re.fullmatch(r"recall_(\d+)", m)):
            v = recall_at(grades, n_rel, int(mm.group(1)))
        else:
            raise ValueError(f"unknown metric {m}")
        out[m] = float(torch.mean(v))
    return out
