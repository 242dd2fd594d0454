"""Plain torch version of the top-k kernel: the ``lax.top_k`` rule."""
from __future__ import annotations

import torch

from repro_torch.common import topk


def streaming_topk_ref(scores: torch.Tensor, *, k: int):
    """scores [..., N] -> (values [..., k] f32 descending, indices int32),
    ties to the lowest index."""
    vals, idxs = topk(scores.to(torch.float32), k)
    return vals, idxs.to(torch.int32)
