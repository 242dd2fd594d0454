"""Plain torch version of the fused-scoring kernel."""
from __future__ import annotations

import torch

from repro_torch.index import scoring


def fused_scoring_ref(tf, dl, df, cf, *, models, n_docs, avg_dl, total_terms):
    stats = {"n_docs": float(n_docs), "avg_doclen": float(avg_dl),
             "total_terms": float(total_terms)}
    out = scoring.score_all(list(models), tf, dl, df, cf, stats)
    return torch.where((tf > 0)[..., None], out, 0.0).to(torch.float32)
