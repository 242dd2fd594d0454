"""Plain torch version of the PQ-scoring kernel: ADC scores, then the
``lax.top_k`` rule.  The m table lookups are added in subspace order
``s = 0..m-1`` and ``base`` last, the order the kernel repeats, so the two
agree bit for bit."""
from __future__ import annotations

import torch

from repro_torch.common import topk


def adc_scores(codes: torch.Tensor, table: torch.Tensor,
               base: torch.Tensor | None = None) -> torch.Tensor:
    """codes [NQ, N, m] uint8, table [NQ, m, n_codes] -> scores [NQ, N]
    ``table[0, c_0] + ... + table[m-1, c_{m-1}] (+ base)``."""
    table = table.to(torch.float32)
    lookups = torch.gather(table, 2, codes.long().transpose(1, 2))  # [NQ, m, N]
    scores = lookups[:, 0]
    for s in range(1, lookups.shape[1]):
        scores = scores + lookups[:, s]
    return scores if base is None else scores + base


def pq_topk_ref(codes, table, base=None, *, k: int):
    """-> (values [NQ, k] f32 descending, indices [NQ, k] int32), ties to
    the lowest index."""
    vals, idxs = topk(adc_scores(codes, table, base), k)
    return vals, idxs.to(torch.int32)
