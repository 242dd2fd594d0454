"""DCN-v2 (arXiv:2008.13535): cross network v2 + deep tower, stacked (the
port of ``src/repro/models/recsys/dcn.py``).

x_{l+1} = x_0 ⊙ (x_l W_l + b_l) + x_l  with full-rank W (paper default).
13 dense features (log-transformed), 26 Criteo sparse fields, dim-16 embeds.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.common import resolve_device
from repro_torch.models import param_tree as P
from repro_torch.models.recsys import embedding as E


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


class DCN(P.ParamTree):
    """DCN-v2's parameters (``table``, ``cross.i.{w,b}``, ``mlp.i.{w,b}``,
    ``out.{w,b}``) on ``device`` (``None`` = the card), zero-filled."""

    def __init__(self, cfg: DCNConfig, device=None):
        d = cfg.d_input
        super().__init__({
            "table": cfg.table().shape(),
            "cross": [{"w": (d, d), "b": (d,)}
                      for _ in range(cfg.n_cross_layers)],
            "mlp": E.mlp_tower([d, *cfg.mlp]),
            "out": {"w": (cfg.mlp[-1], 1), "b": (1,)},
        }, cfg.dtype, resolve_device(device))


def init_params(cfg: DCNConfig, generator: torch.Generator,
                device=None) -> DCN:
    return P.init_normal(DCN(cfg, device), generator,
                         {"table": cfg.embed_dim ** -0.5})


def from_arrays(cfg: DCNConfig, tree, device=None) -> DCN:
    return P.load_arrays(DCN(cfg, device), tree)


to_arrays = P.to_arrays


def forward(cfg: DCNConfig, params: DCN, batch) -> torch.Tensor:
    """batch: {dense [B, n_dense] f32, cat [B, n_sparse] i32} -> logit [B]."""
    emb = cfg.table().lookup(params.table, batch["cat"])     # [B, F, D]
    B = emb.shape[0]
    x0 = torch.cat([torch.log1p(batch["dense"].abs()).to(cfg.dtype),
                    emb.reshape(B, -1)], dim=-1)
    x = x0
    for p in params.cross:
        x = x0 * (x @ p.w + p.b) + x
    h = E.mlp_tower_apply(params.mlp, x, final_act=True)
    return (h @ params.out.w + params.out.b)[:, 0]


def loss_fn(cfg: DCNConfig, params: DCN, batch):
    logit = forward(cfg, params, batch)
    loss = E.bce_loss(logit, batch["label"])
    return loss, {"bce": loss}


def retrieval_score(cfg: DCNConfig, params: DCN, batch) -> torch.Tensor:
    """Score ONE query context against n_candidates item ids — vectorised.

    batch: {dense [1, n_dense], cat [1, n_sparse], candidates [C] i32}.
    The candidate id replaces the last categorical field; all other features
    broadcast.  Returns scores [C].
    """
    C = batch["candidates"].shape[0]
    cand = batch["candidates"] % cfg.vocabs[-1]     # hash into the item field
    cat = batch["cat"].expand(C, cfg.n_sparse).clone()
    cat[:, -1] = cand
    dense = batch["dense"].expand(C, cfg.n_dense)
    return forward(cfg, params, {"dense": dense, "cat": cat})
