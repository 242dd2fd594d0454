"""MIND (arXiv:1904.08030): multi-interest retrieval with capsule routing
(the port of ``src/repro/models/recsys/mind.py``).

Behaviour-to-Interest (B2I) dynamic routing extracts ``n_interests`` capsules
from the user history; training uses label-aware attention + sampled-softmax
(in-batch negatives); serving scores candidates against the max interest.
The reference's ``lax.scan`` over the routing iterations is a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.common import resolve_device
from repro_torch.models import param_tree as P
from repro_torch.models.recsys import embedding as E


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


class MIND(P.ParamTree):
    """MIND's parameters on ``device`` (``None`` = the card), zero-filled:
    ``item_table``, the shared bilinear ``s`` of B2I routing, and the
    routing logits' initial values ``b_init`` (in the reference's tree, so
    trained; 1-D, so not decayed)."""

    def __init__(self, cfg: MINDConfig, device=None):
        super().__init__({
            "item_table": (cfg.item_vocab, cfg.embed_dim),
            "s": (cfg.embed_dim, cfg.embed_dim),
            "b_init": (cfg.n_interests,),
        }, cfg.dtype, resolve_device(device))


def init_params(cfg: MINDConfig, generator: torch.Generator,
                device=None) -> MIND:
    return P.init_normal(MIND(cfg, device), generator,
                         {"item_table": cfg.embed_dim ** -0.5,
                          "b_init": 1.0})


def from_arrays(cfg: MINDConfig, tree, device=None) -> MIND:
    return P.load_arrays(MIND(cfg, device), tree)


to_arrays = P.to_arrays


def _squash(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n2 = torch.sum(x.float().square(), dim=dim, keepdim=True)
    return x * (n2 / (1.0 + n2) * torch.rsqrt(n2 + 1e-9)).to(x.dtype)


def interests(cfg: MINDConfig, params: MIND, hist_items,
              hist_mask) -> torch.Tensor:
    """B2I dynamic routing: [B,T] history -> [B,K,D] interest capsules (the
    last iteration's)."""
    e = E.take(params.item_table, hist_items)                    # [B,T,D]
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
                target_items):
    """Label-aware attention pooled user vector for training. [B,D]"""
    caps = interests(cfg, params, hist_items, hist_mask)         # [B,K,D]
    t = E.take(params.item_table, target_items)                  # [B,D]
    logits = torch.einsum("bkd,bd->bk", caps, t).float()
    att = torch.softmax(cfg.label_pow * logits, dim=-1)
    return torch.einsum("bk,bkd->bd", att.to(caps.dtype), caps), caps


def loss_fn(cfg: MINDConfig, params: MIND, batch):
    """Sampled-softmax with in-batch negatives over target items."""
    u, _ = user_vector(cfg, params, batch["hist_items"], batch["hist_mask"],
                       batch["target_item"])
    t = E.take(params.item_table, batch["target_item"])          # [B,D]
    scores = torch.einsum("bd,cd->bc", u, t).float()             # in-batch
    labels = torch.arange(scores.shape[0], device=scores.device)
    logp = torch.log_softmax(scores, dim=-1)
    del scores
    loss = -torch.mean(logp.gather(-1, labels[:, None]))
    return loss, {"sampled_softmax": loss}


def forward(cfg: MINDConfig, params: MIND, batch) -> torch.Tensor:
    """Serving forward: score target item(s) against max interest. [B]"""
    caps = interests(cfg, params, batch["hist_items"], batch["hist_mask"])
    t = E.take(params.item_table, batch["target_item"])
    return torch.einsum("bkd,bd->bk", caps, t).amax(dim=-1)


def retrieval_score(cfg: MINDConfig, params: MIND, batch) -> torch.Tensor:
    """1 user's interests vs C candidates: batched dot + max, never a loop."""
    caps = interests(cfg, params, batch["hist_items"], batch["hist_mask"])
    cand = E.take(params.item_table, batch["candidates"])        # [C,D]
    return torch.einsum("kd,cd->kc", caps[0], cand).amax(dim=0)  # [C]
