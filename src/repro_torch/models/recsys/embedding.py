"""Sparse embedding substrate for recsys (the port of
``src/repro/models/recsys/embedding.py``).

All categorical fields of a model share one concatenated table, so a batch
does a *single* gather (``index_select``) whatever the field count.
``embedding_bag`` is the multi-hot EmbeddingBag: the reference's
``segment_sum`` is ``index_add`` here and its ``segment_max`` a
``scatter_reduce("amax")`` over a ``-inf`` fill, so an empty segment comes
out as the reference's does (zeros for sum and mean, ``-inf`` for max).

On a mesh of cards (the parameters' ``.mesh``, ``param_tree.py``) a
recsys model runs on the rank's rows of the batch, cut over the axes of
``BATCH`` (a retrieval's candidates over those of ``CANDIDATES``; the
tests and the launch layer cut them by :func:`shard_batch`), with
``batch["rows"]`` the whole batch's row count, as the LMs' training pass
takes it.  The reference lets GSPMD lay these computations out; here
they are explicit, through ``repro_torch/collectives.py``, and
differentiable: :func:`lookup` from a table whose rows are cut over
``model`` (``TABLE_ROWS``), :func:`mlp_tower_sharded` column-parallel
over ``model`` (``MLP``) and :func:`linear_out` row-parallel after it,
and :func:`bce_loss` over the whole batch, its sum and count reduced over
the batch's axes (never a mean of the ranks' means).

Criteo-style vocabularies are provided for the DCN-v2 / AutoInt configs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import collectives as C
from repro_torch import sharding as sh
from repro_torch.common import round_up
from repro_torch.models.layers import gather_at_use
from repro_torch.sharding import Ax

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

    def logical(self) -> Ax:
        return Ax(sh.TABLE_ROWS, None)

    def lookup(self, table: torch.Tensor, cat: torch.Tensor, spec=None,
               mesh=None, rows=()) -> torch.Tensor:
        """cat [B, F] per-field ids -> [B, F, D] in one gather.  The
        offsets are added in the ids' dtype, as the reference adds them
        (Criteo's 33,762,577 rows fit int32).  On ``mesh`` ``table`` is
        the rank's shard by ``spec`` (:func:`lookup`)."""
        return lookup(table, spec, cat + torch.as_tensor(
            self.offsets, device=cat.device).to(cat.dtype), mesh, rows)


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: the rows of ``ids`` (any shape)."""
    return table.index_select(0, ids.reshape(-1)).reshape(
        *ids.shape, table.shape[1])


def lookup(table: torch.Tensor, spec, ids: torch.Tensor, mesh=None,
           rows=()) -> torch.Tensor:
    """``take(table, ids)`` from the rank's shard of a table [rows, D] cut
    by ``spec``.  Where its rows are cut over mesh axes, each rank looks up
    the ids in its own row range, zeros elsewhere, and the ranks of those
    axes sum their parts: by an all-reduce where they hold the same ids
    (``rows``, the axes that cut the ids' leading dim, leave those axes
    free), else the ids are all-gathered over them first and the sums
    reduce-scattered back.  Differentiable; without a mesh, or with the
    rows whole on every rank, a plain ``take``."""
    axes = () if mesh is None else mesh.axes(sh.spec_axes(spec, 0))
    if not axes:
        return take(table, ids)
    n = table.shape[0]
    gathered = bool(set(axes) & set(rows))
    if gathered:
        ids = C.all_gather(ids, mesh, axes, 0)
    local = ids.long() - sh.shard_index(mesh, axes, mesh.coords) * n
    mine = (local >= 0) & (local < n)
    part = torch.where(mine[..., None], take(table, local.clamp(0, n - 1)),
                       0.0)
    if gathered:
        return C.reduce_scatter(part, mesh, axes, 0)
    return C.all_reduce(part, mesh, axes)


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


def mlp_tower_logical(dims: list[int]) -> list[dict]:
    return [{"w": Ax(None, sh.MLP), "b": Ax(sh.MLP)}
            for _ in range(len(dims) - 1)]


def mlp_tower_sharded(layers, x: torch.Tensor, mesh=None, rows=(), *,
                      final_act: bool = False):
    """A ReLU tower (the reference's ``mlp_tower_apply``) on the rank's
    shards: each layer runs column-parallel over the axes that cut its
    columns, its output's columns left cut (the next layer all-gathers
    them first); a layer whose columns are cut over axes that also cut
    the rows (``rows``) is gathered at use.  Without ``mesh`` the plain
    tower.  Returns (x, the axes its columns are cut over)."""
    cols = ()
    for i, p in enumerate(layers):
        w, b = p.w, p.b
        if mesh is not None:
            x = C.all_gather(x, mesh, cols, -1)
            cols = mesh.axes(sh.spec_axes(p.shard_specs["w"], 1))
            if set(cols) & set(rows):
                w = gather_at_use(w, p.shard_specs["w"], mesh)
                b = gather_at_use(b, p.shard_specs["b"], mesh)
                cols = ()
        x = x @ w + b
        if final_act or i < len(layers) - 1:
            x = torch.relu(x)
    return x, cols


def linear_out(p, x: torch.Tensor, cols=(), mesh=None) -> torch.Tensor:
    """``x @ p.w + p.b`` for x whose columns are cut over ``cols``:
    row-parallel, one all-reduce, where the rows of ``p.w`` are cut over
    ``cols`` alone; else x and the weights are gathered whole first.
    Without ``mesh`` the plain product."""
    if mesh is None:
        return x @ p.w + p.b
    spec_w = p.shard_specs["w"]
    if cols and mesh.axes(sh.spec_axes(spec_w, 0)) == tuple(cols) and \
            not sh.spec_axes(spec_w, 1) and not sh.spec_axes(
                p.shard_specs["b"], 0):
        return C.all_reduce(x @ p.w, mesh, cols) + p.b
    x = C.all_gather(x, mesh, cols, -1)
    return x @ gather_at_use(p.w, spec_w, mesh) + \
        gather_at_use(p.b, p.shard_specs["b"], mesh)


def bce_loss(logit: torch.Tensor, label: torch.Tensor, mesh=None, rows=(),
             n: int | None = None) -> torch.Tensor:
    """Binary cross-entropy from logits (fp32), the reference's formula.
    On ``mesh`` the logits are the rank's rows, cut over ``rows``, of a
    batch of ``n``: the sum is all-reduced over ``rows`` and divided by
    ``n``, the same on every rank."""
    logit = logit.float()
    label = label.float()
    terms = torch.maximum(logit, torch.zeros_like(logit)) - \
        logit * label + torch.log1p(torch.exp(-logit.abs()))
    if mesh is None:
        return torch.mean(terms)
    return C.all_reduce(terms.sum(), mesh, rows) / n


# ---------------------------------------------------------------------------
# a recsys batch on a mesh
# ---------------------------------------------------------------------------

def row_spec(mesh, shape, logical=sh.BATCH) -> sh.P:
    """The spec of a tensor of ``shape`` whose leading dim is ``logical``
    (the others whole) under the ``tp`` profile."""
    return sh.resolve_spec((logical,) + (None,) * (len(shape) - 1), shape,
                           mesh, sh.tp_profile(mesh))


def batch_axes(mesh, batch: dict, key: str, logical=sh.BATCH
               ) -> tuple[str, ...]:
    """The mesh axes (of size above 1) that cut the rows of the batch on
    ``mesh`` by ``logical``: its tensor ``key`` holds the rank's rows and
    ``batch["rows"]`` the whole count."""
    rows = batch.get("rows")
    if rows is None:
        raise ValueError("a pass on a mesh needs batch['rows'], the whole "
                         "batch's row count")
    axes = mesh.axes(sh.spec_axes(row_spec(mesh, (int(rows),), logical), 0))
    if batch[key].shape[0] * math.prod(mesh.shape[a] for a in axes) != rows:
        raise ValueError(f"{batch[key].shape[0]} rows a rank over {axes} "
                         f"are not the batch's {rows}")
    return axes


def shard_batch(mesh, batch: dict, logical=sh.BATCH, n_micro: int = 1
                ) -> dict:
    """The rank's share of a whole batch (tensors [B, ...]) for a step of
    ``n_micro`` micro-batches (``sharding.batch_share``), its rows by
    :func:`row_spec` of a micro-batch, with ``"rows"``: B."""
    B = next(iter(batch.values())).shape[0]
    return sh.batch_share(batch, row_spec(mesh, (B // n_micro,), logical),
                          mesh, n_micro)


def row_offset(mesh, rows, n_local: int) -> int:
    """The global index of the rank's first row, its rows cut over
    ``rows`` ``n_local`` a rank."""
    return sh.shard_index(mesh, rows, mesh.coords) * n_local if rows else 0


def roll_rows(x: torch.Tensor, mesh, rows) -> torch.Tensor:
    """``jnp.roll(x, 1, axis=0)`` over the whole batch, of which ``x`` is
    the rank's rows: its first row is the previous rank's last row (the
    last rank's on rank 0).  Differentiable."""
    if mesh is None or not rows:
        return torch.roll(x, 1, dims=0)
    last = C.all_gather(x[-1:], mesh, rows, 0)
    i = sh.shard_index(mesh, rows, mesh.coords)
    return torch.cat([last[(i - 1) % last.shape[0]][None], x[:-1]])
