"""AutoInt (arXiv:1810.11921): multi-head self-attention feature
interaction (the port of ``src/repro/models/recsys/autoint.py``).

39 sparse fields (26 Criteo categorical + 13 bucketised dense), dim-16
embeddings, 3 interacting layers with 2 heads of d_attn=32, residual
connections, final flatten -> logit.

On a mesh (``embedding.py``): the table's rows over ``model`` where they
divide (the full table's 33,775,577 do not: replicated), every other
leaf replicated, so the rank's rows run as pure data parallelism.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import sharding as sh
from repro_torch.models import param_tree as P
from repro_torch.models.recsys import embedding as E
from repro_torch.sharding import Ax

#: 26 Criteo categorical vocabs + 13 bucketised-dense vocabs (1000 buckets).
AUTOINT_VOCABS = tuple(E.CRITEO_VOCABS) + (1000,) * 13


@dataclasses.dataclass(frozen=True, kw_only=True)
class AutoIntConfig:
    name: str = "autoint"
    n_sparse: int = 39
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    vocabs: tuple[int, ...] = AUTOINT_VOCABS
    dtype: Any = torch.float32

    def table(self) -> E.FieldTable:
        return E.FieldTable(list(self.vocabs), self.embed_dim)


def param_shapes(cfg: AutoIntConfig) -> dict:
    H, A = cfg.n_heads, cfg.d_attn
    d_out = H * A
    layers = []
    d_in = cfg.embed_dim
    for _ in range(cfg.n_attn_layers):
        layers.append({"wq": (d_in, H, A), "wk": (d_in, H, A),
                       "wv": (d_in, H, A), "w_res": (d_in, d_out)})
        d_in = d_out
    return {"table": cfg.table().shape(), "layers": layers,
            "out": {"w": (cfg.n_sparse * d_out, 1), "b": (1,)}}


def param_logical(cfg: AutoIntConfig) -> dict:
    """The reference's logical axes of every leaf."""
    layer = {"wq": Ax(None, None, None), "wk": Ax(None, None, None),
             "wv": Ax(None, None, None), "w_res": Ax(None, None)}
    return {"table": cfg.table().logical(),
            "layers": [dict(layer) for _ in range(cfg.n_attn_layers)],
            "out": {"w": Ax(None, None), "b": Ax(None)}}


class AutoInt(P.ParamTree):
    """AutoInt's parameters (``table``, ``layers.i.{wq,wk,wv,w_res}``,
    ``out.{w,b}``) on ``device`` (``None`` = the card, or the mesh's),
    zero-filled; with ``mesh``, the rank's shards."""

    def __init__(self, cfg: AutoIntConfig, device=None, mesh=None):
        super().__init__(param_shapes(cfg), cfg.dtype,
                         P.device_of(device, mesh), mesh,
                         param_logical(cfg))


def init_params(cfg: AutoIntConfig, generator: torch.Generator,
                device=None, mesh=None) -> AutoInt:
    return P.init_normal(AutoInt(cfg, device, mesh), generator,
                         {"table": cfg.embed_dim ** -0.5})


def from_arrays(cfg: AutoIntConfig, tree, device=None,
                mesh=None) -> AutoInt:
    return P.load_arrays(AutoInt(cfg, device, mesh), tree)


to_arrays = P.to_arrays


def _interact(p, x: torch.Tensor) -> torch.Tensor:
    """x [B, F, d_in] -> [B, F, H*d_attn] self-attention over fields: the
    scores in fp32, probabilities cast to v's dtype before the product.
    A head at a time (the reference's einsums, a head's slice each), so
    that one head's projections and [B, F, F] scores live at once: over a
    million candidates each [B, F, H, d_attn] tensor is 10 GB."""
    heads = []
    for h in range(p.wq.shape[1]):
        q, k = x @ p.wq[:, h], x @ p.wk[:, h]                 # [B, F, A]
        scores = (q @ k.transpose(1, 2)).float()               # [B, F, F]
        del q, k
        v = x @ p.wv[:, h]
        heads.append(torch.softmax(scores, dim=-1).to(v.dtype) @ v)
        del scores, v
    out = torch.cat(heads, dim=-1)                             # [B, F, H*A]
    del heads
    return torch.relu(out + x @ p.w_res)


def _logit(cfg: AutoIntConfig, params: AutoInt, cat, mesh,
           rows) -> torch.Tensor:
    """The logits of the rows of ``cat`` (on ``mesh``: the rank's, cut
    over ``rows``)."""
    spec = params.shard_specs["table"] if mesh is not None else None
    x = cfg.table().lookup(params.table, cat, spec, mesh, rows)  # [B, F, D]
    for p in params.layers:
        x = _interact(p, x)
    B = x.shape[0]
    return (x.reshape(B, -1) @ params.out.w + params.out.b)[:, 0]


def forward(cfg: AutoIntConfig, params: AutoInt, batch, *, mesh=None
            ) -> torch.Tensor:
    """batch: {cat [B, n_sparse] i32} -> logit [B].  On the parameters'
    mesh the batch is the rank's rows and ``batch["rows"]`` the whole
    count (``embedding.shard_batch``)."""
    mesh = P.mesh_of(params, mesh)
    rows = () if mesh is None else E.batch_axes(mesh, batch, "cat")
    return _logit(cfg, params, batch["cat"], mesh, rows)


def loss_fn(cfg: AutoIntConfig, params: AutoInt, batch, *, mesh=None):
    mesh = P.mesh_of(params, mesh)
    rows = () if mesh is None else E.batch_axes(mesh, batch, "cat")
    logit = _logit(cfg, params, batch["cat"], mesh, rows)
    loss = E.bce_loss(logit, batch["label"], mesh, rows, batch.get("rows"))
    return loss, {"bce": loss}


def retrieval_score(cfg: AutoIntConfig, params: AutoInt, batch, *,
                    mesh=None) -> torch.Tensor:
    """On the parameters' mesh the candidates are the rank's, cut by
    ``CANDIDATES``, and ``batch["rows"]`` their whole count."""
    mesh = P.mesh_of(params, mesh)
    C = batch["candidates"].shape[0]
    cand = batch["candidates"] % cfg.vocabs[-1]     # hash into the item field
    cat = batch["cat"].expand(C, cfg.n_sparse).clone()
    cat[:, -1] = cand
    rows = () if mesh is None else E.batch_axes(mesh, batch, "candidates",
                                                sh.CANDIDATES)
    return _logit(cfg, params, cat, mesh, rows)
