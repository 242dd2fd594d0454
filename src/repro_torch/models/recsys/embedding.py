"""Sparse embedding substrate for recsys (the port of
``src/repro/models/recsys/embedding.py``).

All categorical fields of a model share one concatenated table, so a batch
does a *single* gather (``index_select``) whatever the field count.
``embedding_bag`` is the multi-hot EmbeddingBag: the reference's
``segment_sum`` is ``index_add`` here and its ``segment_max`` a
``scatter_reduce("amax")`` over a ``-inf`` fill, so an empty segment comes
out as the reference's does (zeros for sum and mean, ``-inf`` for max).

Criteo-style vocabularies are provided for the DCN-v2 / AutoInt configs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import round_up

# Criteo-Kaggle per-field vocabulary sizes (DLRM convention), 26 fields.
CRITEO_VOCABS = [
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
    15, 286181, 105, 142572,
]


class FieldTable:
    """Concatenated per-field embedding table with precomputed offsets."""

    def __init__(self, vocabs: list[int], embed_dim: int, *,
                 pad_rows_to: int = 1):
        self.vocabs = list(vocabs)
        self.embed_dim = embed_dim
        self.offsets = np.concatenate(
            [[0], np.cumsum(vocabs)[:-1]]).astype(np.int64)
        self.total_rows = round_up(int(sum(vocabs)), pad_rows_to)

    def shape(self) -> tuple[int, int]:
        return (self.total_rows, self.embed_dim)

    def lookup(self, table: torch.Tensor, cat: torch.Tensor) -> torch.Tensor:
        """cat [B, F] per-field ids -> [B, F, D] in one gather.  The
        offsets are added in the ids' dtype, as the reference adds them
        (Criteo's 33,762,577 rows fit int32)."""
        return take(table, cat + torch.as_tensor(
            self.offsets, device=cat.device).to(cat.dtype))


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: the rows of ``ids`` (any shape)."""
    return table.index_select(0, ids.reshape(-1)).reshape(
        *ids.shape, table.shape[1])


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  segment_ids: torch.Tensor, num_segments: int, *,
                  combiner: str = "sum",
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-hot EmbeddingBag: gather rows then segment-reduce.

    indices/segment_ids: [nnz]; returns [num_segments, D].
    """
    rows = table.index_select(0, indices)
    if weights is not None:
        rows = rows * weights[:, None]
    seg = segment_ids.long()
    shape = (num_segments, rows.shape[1])
    if combiner == "max":
        return torch.full(shape, -torch.inf, dtype=rows.dtype,
                          device=rows.device).scatter_reduce(
            0, seg[:, None].expand_as(rows), rows, "amax",
            include_self=False)
    summed = rows.new_zeros(shape).index_add(0, seg, rows)
    if combiner == "sum":
        return summed
    if combiner == "mean":
        counts = torch.zeros(num_segments, dtype=torch.float32,
                             device=rows.device).index_add(
            0, seg, torch.ones(seg.shape, dtype=torch.float32,
                               device=rows.device))
        return summed / torch.clamp_min(counts, 1.0)[:, None]
    raise ValueError(combiner)


def mlp_tower(dims: list[int]) -> list[dict]:
    """The shapes of a ReLU tower over ``dims``: one {"w", "b"} a layer."""
    return [{"w": (a, b), "b": (b,)} for a, b in zip(dims[:-1], dims[1:])]


def mlp_tower_apply(layers, x: torch.Tensor, *,
                    final_act: bool = False) -> torch.Tensor:
    for i, p in enumerate(layers):
        x = x @ p.w + p.b
        if final_act or i < len(layers) - 1:
            x = torch.relu(x)
    return x


def bce_loss(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy from logits (fp32), the reference's formula."""
    logit = logit.float()
    label = label.float()
    return torch.mean(torch.maximum(logit, torch.zeros_like(logit)) -
                      logit * label + torch.log1p(torch.exp(-logit.abs())))
