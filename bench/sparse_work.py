"""The least work of a sparse retrieval pipeline over a set of queries,
priced whatever implements it (``sparse.mfu.*`` read it): each distinct
query term's postings (doc id and tf, 8 bytes each) read once, the results
written once (doc id and score, 4 bytes each, and 4 bytes a feature), the
first-stage model's operations a posting and each feature model's a
(candidate, query term) pair."""
from __future__ import annotations

import numpy as np

import roofline


def least_time(view, tree, terms) -> float:
    """Seconds: the larger of the work's bytes at the HBM rate and its
    operations at the fp32 peak.  ``terms``: [n, L] term ids (-1 pads) of
    the queries run together."""
    terms = np.asarray(terms)
    real = terms[terms >= 0]
    postings = int(view.work["df"][np.unique(real)].sum())
    n = terms.shape[0]
    retr = tree.stages("Retrieve")[0]
    k_in = int(retr.param(1, "k") or view.cell.config["index"]["default_k"])
    cut = [node.k for node in tree.walk() if node.op == "cutoff"]
    k_out = min([k_in] + cut)
    feats = [node.param(0, "model") for node in tree.stages("Extract")]
    per_query_terms = real.size / max(n, 1)
    ops = postings * roofline.MODEL_OPS[retr.param(0, "model", "BM25")] + \
        n * k_in * per_query_terms * sum(roofline.MODEL_OPS[m] for m in feats)
    nbytes = postings * 8 + n * k_out * (8 + 4 * len(feats))
    return roofline.least_time(float(ops), float(nbytes), roofline.FP32_FLOPS)
