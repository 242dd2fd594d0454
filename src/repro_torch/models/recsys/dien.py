"""DIEN (arXiv:1809.03672): interest evolution via GRU + AUGRU (the port of
``src/repro/models/recsys/dien.py``).

Interest extractor GRU over the behaviour sequence (+ auxiliary next-item
loss), target-attention scores, and an attention-update-gate GRU (AUGRU)
whose final state feeds the prediction MLP.  The reference's
``lax.scan`` over the sequence is a Python loop over T here, stacking the
hidden states.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.common import resolve_device
from repro_torch.models import param_tree as P
from repro_torch.models.recsys import embedding as E

#: candidates :func:`retrieval_score` scores a forward: at the published
#: widths one forward over 1,000,000 candidates would hold their
#: [C, 100, 108] fp32 interest states, 43.2 GB, twice
RETRIEVAL_CHUNK = 65536


@dataclasses.dataclass(frozen=True, kw_only=True)
class DIENConfig:
    name: str = "dien"
    embed_dim: int = 18          # per feature; item+cate concat = 36
    seq_len: int = 100
    gru_dim: int = 108
    mlp: tuple[int, ...] = (200, 80)
    item_vocab: int = 63001
    cate_vocab: int = 801
    use_aux_loss: bool = True
    aux_weight: float = 1.0
    dtype: Any = torch.float32

    @property
    def d_behav(self) -> int:
        return 2 * self.embed_dim


def _gru(d_in: int, d_h: int) -> dict:
    return {"wx": (d_in, 3 * d_h), "wh": (d_h, 3 * d_h), "b": (3 * d_h,)}


class DIEN(P.ParamTree):
    """DIEN's parameters (``item_table``, ``cate_table``, ``gru1`` and
    ``augru`` {wx, wh, b}, ``att_w``, ``mlp.i.{w,b}``, ``out.{w,b}``) on
    ``device`` (``None`` = the card), zero-filled."""

    def __init__(self, cfg: DIENConfig, device=None):
        d_b, d_h = cfg.d_behav, cfg.gru_dim
        d_final = d_h + 2 * d_b  # [augru_state, target_emb, sum_pooled_hist]
        super().__init__({
            "item_table": (cfg.item_vocab, cfg.embed_dim),
            "cate_table": (cfg.cate_vocab, cfg.embed_dim),
            "gru1": _gru(d_b, d_h),
            "augru": _gru(d_h, d_h),
            "att_w": (d_h, d_b),
            "mlp": E.mlp_tower([d_final, *cfg.mlp]),
            "out": {"w": (cfg.mlp[-1], 1), "b": (1,)},
        }, cfg.dtype, resolve_device(device))


def init_params(cfg: DIENConfig, generator: torch.Generator,
                device=None) -> DIEN:
    scale = cfg.embed_dim ** -0.5
    return P.init_normal(DIEN(cfg, device), generator,
                         {"item_table": scale, "cate_table": scale})


def from_arrays(cfg: DIENConfig, tree, device=None) -> DIEN:
    return P.load_arrays(DIEN(cfg, device), tree)


to_arrays = P.to_arrays


def _gru_gates(p, x_t, h):
    z = x_t @ p.wx + h @ p.wh + p.b
    d_h = h.shape[-1]
    u = torch.sigmoid(z[..., :d_h])             # update
    r = torch.sigmoid(z[..., d_h:2 * d_h])      # reset
    # candidate uses reset-gated hidden: recompute its slice with r*h
    c_in = x_t @ p.wx[:, 2 * d_h:] + (r * h) @ p.wh[:, 2 * d_h:] + \
        p.b[2 * d_h:]
    return u, torch.tanh(c_in)


def gru_scan(p, xs: torch.Tensor, h0: torch.Tensor,
             att: torch.Tensor | None = None):
    """xs [B, T, d]; optional att [B, T] turns this into AUGRU.
    Returns (h_last [B, d_h], h_seq [B, T, d_h]).  The steps take their
    inputs by ``unbind``, whose backward stacks the T gradients once (an
    index a step would add each into a zero tensor of the whole input)."""
    h, seq = h0, []
    atts = att.unbind(1) if att is not None else (None,) * xs.shape[1]
    for x_t, a_t in zip(xs.unbind(1), atts):
        u, c = _gru_gates(p, x_t, h)
        if a_t is not None:
            u = a_t[:, None] * u                 # attention-scaled update gate
        h = (1.0 - u) * h + u * c
        seq.append(h)
    return h, torch.stack(seq, dim=1)


def _behaviour_embed(params: DIEN, items, cates) -> torch.Tensor:
    return torch.cat([E.take(params.item_table, items),
                      E.take(params.cate_table, cates)], dim=-1)


def forward(cfg: DIENConfig, params: DIEN, batch, *, with_aux=False):
    """batch: hist_items/hist_cates [B,T] i32, hist_mask [B,T] f32,
    target_item/target_cate [B] i32 -> logit [B] (+aux loss)."""
    hist = _behaviour_embed(params, batch["hist_items"], batch["hist_cates"])
    target = _behaviour_embed(params, batch["target_item"],
                              batch["target_cate"])
    mask = batch["hist_mask"].float()
    B = hist.shape[0]
    h0 = hist.new_zeros(B, cfg.gru_dim)
    _, h_seq = gru_scan(params.gru1, hist, h0)               # [B, T, H]

    # target attention over interest states (bilinear)
    att_logits = torch.einsum("bth,hd,bd->bt", h_seq, params.att_w, target)
    att_logits = torch.where(mask > 0, att_logits.float(), -1e30)
    att = torch.softmax(att_logits, dim=-1).to(hist.dtype)

    h_final, _ = gru_scan(params.augru, h_seq, h0, att=att)

    pooled = torch.sum(hist * mask[..., None].to(hist.dtype), dim=1) / \
        torch.clamp_min(mask.sum(1), 1.0)[:, None].to(hist.dtype)
    feats = torch.cat([h_final, target, pooled], dim=-1)
    h = E.mlp_tower_apply(params.mlp, feats, final_act=True)
    logit = (h @ params.out.w + params.out.b)[:, 0]

    if not with_aux:
        return logit
    # auxiliary loss: h_t should predict behaviour t+1 (in-batch negatives)
    proj = h_seq[:, :-1] @ params.att_w
    pos = torch.einsum("bth,bth->bt", proj, hist[:, 1:])
    neg_hist = torch.roll(hist[:, 1:], 1, dims=0)           # other users'
    neg = torch.einsum("bth,bth->bt", proj, neg_hist)
    m = mask[:, 1:]
    aux = -(F.logsigmoid(pos) + F.logsigmoid(-neg)).float()
    aux = torch.sum(aux * m) / torch.clamp_min(torch.sum(m), 1.0)
    return logit, aux


def loss_fn(cfg: DIENConfig, params: DIEN, batch):
    if cfg.use_aux_loss:
        logit, aux = forward(cfg, params, batch, with_aux=True)
    else:
        logit = forward(cfg, params, batch)
        aux = logit.new_zeros((), dtype=torch.float32)
    bce = E.bce_loss(logit, batch["label"])
    loss = bce + cfg.aux_weight * aux
    return loss, {"bce": bce, "aux": aux}


def retrieval_score(cfg: DIENConfig, params: DIEN, batch) -> torch.Tensor:
    """1 user history vs C candidate items (category derived by hash),
    RETRIEVAL_CHUNK candidates a forward.  Each candidate's score depends
    on its own row alone, so chunks change no value."""
    cands = batch["candidates"]
    out = []
    for s in range(0, cands.shape[0], RETRIEVAL_CHUNK):
        c = cands[s:s + RETRIEVAL_CHUNK]

        def rep(x):
            return x.expand(c.shape[0], *x.shape[1:])
        out.append(forward(cfg, params, {
            "hist_items": rep(batch["hist_items"]),
            "hist_cates": rep(batch["hist_cates"]),
            "hist_mask": rep(batch["hist_mask"]),
            "target_item": c,
            "target_cate": c % cfg.cate_vocab}))
    return torch.cat(out)
