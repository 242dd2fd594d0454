"""DCN-v2 (arXiv:2008.13535): cross network v2 + deep tower, stacked (the
port of ``src/repro/models/recsys/dcn.py``).

x_{l+1} = x_0 ⊙ (x_l W_l + b_l) + x_l  with full-rank W (paper default).
13 dense features (log-transformed), 26 Criteo sparse fields, dim-16 embeds.

On a mesh (``embedding.py``): the table's rows over ``model`` where they
divide (Criteo's 33,762,577 do not: replicated), the cross layers
replicated on the rank's rows, the MLP tower column-parallel over
``model`` and ``out`` row-parallel after it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import sharding as sh
from repro_torch.models import param_tree as P
from repro_torch.models.recsys import embedding as E
from repro_torch.sharding import Ax


@dataclasses.dataclass(frozen=True, kw_only=True)
class DCNConfig:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp: tuple[int, ...] = (1024, 1024, 512)
    vocabs: tuple[int, ...] = tuple(E.CRITEO_VOCABS)
    dtype: Any = torch.float32

    @property
    def d_input(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim

    def table(self) -> E.FieldTable:
        return E.FieldTable(list(self.vocabs), self.embed_dim)


def param_shapes(cfg: DCNConfig) -> dict:
    d = cfg.d_input
    return {
        "table": cfg.table().shape(),
        "cross": [{"w": (d, d), "b": (d,)}
                  for _ in range(cfg.n_cross_layers)],
        "mlp": E.mlp_tower([d, *cfg.mlp]),
        "out": {"w": (cfg.mlp[-1], 1), "b": (1,)},
    }


def param_logical(cfg: DCNConfig) -> dict:
    """The reference's logical axes of every leaf."""
    return {
        "table": cfg.table().logical(),
        "cross": [{"w": Ax(None, None), "b": Ax(None)}
                  for _ in range(cfg.n_cross_layers)],
        "mlp": E.mlp_tower_logical([cfg.d_input, *cfg.mlp]),
        "out": {"w": Ax(sh.MLP, None), "b": Ax(None)},
    }


class DCN(P.ParamTree):
    """DCN-v2's parameters (``table``, ``cross.i.{w,b}``, ``mlp.i.{w,b}``,
    ``out.{w,b}``) on ``device`` (``None`` = the card, or the mesh's),
    zero-filled; with ``mesh``, the rank's shards."""

    def __init__(self, cfg: DCNConfig, device=None, mesh=None):
        super().__init__(param_shapes(cfg), cfg.dtype,
                         P.device_of(device, mesh), mesh,
                         param_logical(cfg))


def init_params(cfg: DCNConfig, generator: torch.Generator,
                device=None, mesh=None) -> DCN:
    return P.init_normal(DCN(cfg, device, mesh), generator,
                         {"table": cfg.embed_dim ** -0.5})


def from_arrays(cfg: DCNConfig, tree, device=None, mesh=None) -> DCN:
    return P.load_arrays(DCN(cfg, device, mesh), tree)


to_arrays = P.to_arrays


def _logit(cfg: DCNConfig, params: DCN, batch, mesh, rows) -> torch.Tensor:
    """The logits of the batch's rows (on ``mesh``: the rank's, cut over
    ``rows``)."""
    spec = params.shard_specs["table"] if mesh is not None else None
    emb = cfg.table().lookup(params.table, batch["cat"], spec, mesh,
                             rows)                          # [B, F, D]
    B = emb.shape[0]
    x0 = torch.cat([torch.log1p(batch["dense"].abs()).to(cfg.dtype),
                    emb.reshape(B, -1)], dim=-1)
    x = x0
    for p in params.cross:
        x = x0 * (x @ p.w + p.b) + x
    h, cols = E.mlp_tower_sharded(params.mlp, x, mesh, rows, final_act=True)
    return E.linear_out(params.out, h, cols, mesh)[:, 0]


def forward(cfg: DCNConfig, params: DCN, batch, *, mesh=None
            ) -> torch.Tensor:
    """batch: {dense [B, n_dense] f32, cat [B, n_sparse] i32} -> logit [B].
    On the parameters' mesh the batch is the rank's rows and
    ``batch["rows"]`` the whole count (``embedding.shard_batch``)."""
    mesh = P.mesh_of(params, mesh)
    rows = () if mesh is None else E.batch_axes(mesh, batch, "cat")
    return _logit(cfg, params, batch, mesh, rows)


def loss_fn(cfg: DCNConfig, params: DCN, batch, *, mesh=None):
    mesh = P.mesh_of(params, mesh)
    rows = () if mesh is None else E.batch_axes(mesh, batch, "cat")
    logit = _logit(cfg, params, batch, mesh, rows)
    loss = E.bce_loss(logit, batch["label"], mesh, rows, batch.get("rows"))
    return loss, {"bce": loss}


def retrieval_score(cfg: DCNConfig, params: DCN, batch, *, mesh=None
                    ) -> torch.Tensor:
    """Score ONE query context against n_candidates item ids — vectorised.

    batch: {dense [1, n_dense], cat [1, n_sparse], candidates [C] i32}.
    The candidate id replaces the last categorical field; all other features
    broadcast.  Returns scores [C].  On the parameters' mesh the
    candidates are the rank's, cut by ``CANDIDATES``, and
    ``batch["rows"]`` their whole count; the scores are the rank's.
    """
    mesh = P.mesh_of(params, mesh)
    C = batch["candidates"].shape[0]
    cand = batch["candidates"] % cfg.vocabs[-1]     # hash into the item field
    cat = batch["cat"].expand(C, cfg.n_sparse).clone()
    cat[:, -1] = cand
    dense = batch["dense"].expand(C, cfg.n_dense)
    rows = () if mesh is None else E.batch_axes(mesh, batch, "candidates",
                                                sh.CANDIDATES)
    return _logit(cfg, params, {"dense": dense, "cat": cat}, mesh, rows)
