"""Plain torch version of the dense-scoring kernel: scores ``emb @ q +
base`` (the expression of ``src/repro/kernels/dense_scoring/ref.py``), then
the ``lax.top_k`` rule."""
from __future__ import annotations

import torch

from repro_torch.common import topk


def dense_scores(emb: torch.Tensor, qvec: torch.Tensor,
                 base: torch.Tensor | None = None) -> torch.Tensor:
    """emb [N, dim] (shared by the queries) or [NQ, N, dim], qvec [NQ, dim],
    base [NQ, N] or None -> scores [NQ, N] f32."""
    emb, q = emb.to(torch.float32), qvec.to(torch.float32)
    if emb.dim() == 2:
        scores = torch.matmul(q, emb.T)
    else:
        scores = torch.matmul(emb, q[..., None])[..., 0]
    return scores if base is None else scores + base


def dense_topk_ref(emb, qvec, base=None, *, k: int):
    """-> (values [NQ, k] f32 descending, indices [NQ, k] int32), ties to
    the lowest index."""
    vals, idxs = topk(dense_scores(emb, qvec, base), k)
    return vals, idxs.to(torch.int32)
