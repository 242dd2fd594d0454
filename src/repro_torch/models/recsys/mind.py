"""MIND (arXiv:1904.08030): multi-interest retrieval with capsule routing
(the port of ``src/repro/models/recsys/mind.py``).

Behaviour-to-Interest (B2I) dynamic routing extracts ``n_interests`` capsules
from the user history; training uses label-aware attention + sampled-softmax
(in-batch negatives); serving scores candidates against the max interest.
The reference's ``lax.scan`` over the routing iterations is a Python loop.

On a mesh (``embedding.py``): the item table's rows over ``model`` where
they divide (the full 100,000 do), ``s`` and ``b_init`` replicated.  The
in-batch softmax scores each of the rank's rows against every target of
the whole batch (all-gathered over the batch's axes, differentiably),
each row's label its index in the whole batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import collectives as C
from repro_torch import sharding as sh
from repro_torch.models import param_tree as P
from repro_torch.models.recsys import embedding as E
from repro_torch.sharding import Ax


@dataclasses.dataclass(frozen=True, kw_only=True)
class MINDConfig:
    name: str = "mind"
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50
    item_vocab: int = 100000
    label_pow: float = 2.0       # label-aware attention sharpening
    dtype: Any = torch.float32


def param_shapes(cfg: MINDConfig) -> dict:
    return {"item_table": (cfg.item_vocab, cfg.embed_dim),
            "s": (cfg.embed_dim, cfg.embed_dim),
            "b_init": (cfg.n_interests,)}


def param_logical(cfg: MINDConfig) -> dict:
    """The reference's logical axes of every leaf."""
    return {"item_table": Ax(sh.TABLE_ROWS, None),
            "s": Ax(None, None), "b_init": Ax(None)}


class MIND(P.ParamTree):
    """MIND's parameters on ``device`` (``None`` = the card, or the
    mesh's), zero-filled (with ``mesh``, the rank's shards):
    ``item_table``, the shared bilinear ``s`` of B2I routing, and the
    routing logits' initial values ``b_init`` (in the reference's tree, so
    trained; 1-D, so not decayed)."""

    def __init__(self, cfg: MINDConfig, device=None, mesh=None):
        super().__init__(param_shapes(cfg), cfg.dtype,
                         P.device_of(device, mesh), mesh,
                         param_logical(cfg))


def init_params(cfg: MINDConfig, generator: torch.Generator,
                device=None, mesh=None) -> MIND:
    return P.init_normal(MIND(cfg, device, mesh), generator,
                         {"item_table": cfg.embed_dim ** -0.5,
                          "b_init": 1.0})


def from_arrays(cfg: MINDConfig, tree, device=None, mesh=None) -> MIND:
    return P.load_arrays(MIND(cfg, device, mesh), tree)


to_arrays = P.to_arrays


def _squash(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n2 = torch.sum(x.float().square(), dim=dim, keepdim=True)
    return x * (n2 / (1.0 + n2) * torch.rsqrt(n2 + 1e-9)).to(x.dtype)


def _items(params: MIND, ids, mesh=None, rows=()) -> torch.Tensor:
    """The item table's rows of ``ids`` (``embedding.lookup``)."""
    spec = params.shard_specs["item_table"] if mesh is not None else None
    return E.lookup(params.item_table, spec, ids, mesh, rows)


def interests(cfg: MINDConfig, params: MIND, hist_items, hist_mask,
              mesh=None, rows=()) -> torch.Tensor:
    """B2I dynamic routing: [B,T] history -> [B,K,D] interest capsules (the
    last iteration's); on ``mesh`` of the rank's rows, cut over
    ``rows``."""
    e = _items(params, hist_items, mesh, rows)                   # [B,T,D]
    mask = hist_mask.float()
    low = torch.einsum("btd,de->bte", e, params.s)               # shared
    B, T, _ = low.shape
    b = params.b_init[None, :, None].float().expand(
        B, cfg.n_interests, T)
    caps = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b, dim=1)                              # over K
        w = w * mask[:, None, :]
        caps = _squash(torch.einsum("bkt,bte->bke", w.to(low.dtype), low))
        b = b + torch.einsum("bke,bte->bkt", caps, low).float()
    return caps                                                  # [B,K,D]


def user_vector(cfg: MINDConfig, params: MIND, hist_items, hist_mask,
                target_items, mesh=None, rows=()):
    """Label-aware attention pooled user vector for training. [B,D]"""
    caps = interests(cfg, params, hist_items, hist_mask, mesh,
                     rows)                                       # [B,K,D]
    t = _items(params, target_items, mesh, rows)                 # [B,D]
    logits = torch.einsum("bkd,bd->bk", caps, t).float()
    att = torch.softmax(cfg.label_pow * logits, dim=-1)
    return torch.einsum("bk,bkd->bd", att.to(caps.dtype), caps), caps


def loss_fn(cfg: MINDConfig, params: MIND, batch, *, mesh=None):
    """Sampled-softmax with in-batch negatives over target items.  On the
    parameters' mesh the batch is the rank's rows and ``batch["rows"]``
    the whole count (``embedding.shard_batch``): each row is scored
    against the whole batch's targets, and the loss is the whole
    batch's."""
    mesh = P.mesh_of(params, mesh)
    rows = () if mesh is None else E.batch_axes(mesh, batch, "hist_items")
    u, _ = user_vector(cfg, params, batch["hist_items"], batch["hist_mask"],
                       batch["target_item"], mesh, rows)
    t = _items(params, batch["target_item"], mesh, rows)         # [B,D]
    if mesh is not None:
        t = C.all_gather(t, mesh, rows, 0)
    scores = torch.einsum("bd,cd->bc", u, t).float()             # in-batch
    labels = torch.arange(scores.shape[0], device=scores.device)
    if mesh is not None:
        labels = labels + E.row_offset(mesh, rows, scores.shape[0])
    logp = torch.log_softmax(scores, dim=-1)
    del scores
    gold = logp.gather(-1, labels[:, None])
    if mesh is None:
        loss = -torch.mean(gold)
    else:
        loss = -C.all_reduce(gold.sum(), mesh, rows) / batch["rows"]
    return loss, {"sampled_softmax": loss}


def forward(cfg: MINDConfig, params: MIND, batch, *, mesh=None
            ) -> torch.Tensor:
    """Serving forward: score target item(s) against max interest. [B]
    (on the parameters' mesh, of the rank's rows: ``batch["rows"]`` the
    whole count)."""
    mesh = P.mesh_of(params, mesh)
    rows = () if mesh is None else E.batch_axes(mesh, batch, "hist_items")
    caps = interests(cfg, params, batch["hist_items"], batch["hist_mask"],
                     mesh, rows)
    t = _items(params, batch["target_item"], mesh, rows)
    return torch.einsum("bkd,bd->bk", caps, t).amax(dim=-1)


def retrieval_score(cfg: MINDConfig, params: MIND, batch, *, mesh=None
                    ) -> torch.Tensor:
    """1 user's interests vs C candidates: batched dot + max, never a loop.
    On the parameters' mesh the candidates are the rank's, cut by
    ``CANDIDATES``, and ``batch["rows"]`` their whole count; the user's
    history is whole on every rank."""
    mesh = P.mesh_of(params, mesh)
    rows = () if mesh is None else E.batch_axes(mesh, batch, "candidates",
                                                sh.CANDIDATES)
    caps = interests(cfg, params, batch["hist_items"], batch["hist_mask"],
                     mesh)
    cand = _items(params, batch["candidates"], mesh, rows)       # [C,D]
    return torch.einsum("kd,cd->kc", caps[0], cand).amax(dim=0)  # [C]
