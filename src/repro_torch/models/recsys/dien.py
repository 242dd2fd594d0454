"""DIEN (arXiv:1809.03672): interest evolution via GRU + AUGRU (the port of
``src/repro/models/recsys/dien.py``).

Interest extractor GRU over the behaviour sequence (+ auxiliary next-item
loss), target-attention scores, and an attention-update-gate GRU (AUGRU)
whose final state feeds the prediction MLP.  The reference's
``lax.scan`` over the sequence is a Python loop over T here, stacking the
hidden states.

On a mesh (``embedding.py``): the item and category tables' rows over
``model`` where they divide (the full 63,001 and 801 do not: replicated),
the GRUs replicated on the rank's rows, the MLP tower column-parallel
over ``model``; the aux loss's negatives are the reference's roll over
the whole batch (``embedding.roll_rows``), its sum and count reduced over
the batch's axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import collectives as C
from repro_torch import sharding as sh
from repro_torch.models import param_tree as P
from repro_torch.models.recsys import embedding as E
from repro_torch.sharding import Ax

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


def param_shapes(cfg: DIENConfig) -> dict:
    d_b, d_h = cfg.d_behav, cfg.gru_dim
    d_final = d_h + 2 * d_b  # [augru_state, target_emb, sum_pooled_hist]
    return {
        "item_table": (cfg.item_vocab, cfg.embed_dim),
        "cate_table": (cfg.cate_vocab, cfg.embed_dim),
        "gru1": _gru(d_b, d_h),
        "augru": _gru(d_h, d_h),
        "att_w": (d_h, d_b),
        "mlp": E.mlp_tower([d_final, *cfg.mlp]),
        "out": {"w": (cfg.mlp[-1], 1), "b": (1,)},
    }


def param_logical(cfg: DIENConfig) -> dict:
    """The reference's logical axes of every leaf."""
    gru = {"wx": Ax(None, None), "wh": Ax(None, None), "b": Ax(None)}
    return {
        "item_table": Ax(sh.TABLE_ROWS, None),
        "cate_table": Ax(sh.TABLE_ROWS, None),
        "gru1": dict(gru), "augru": dict(gru),
        "att_w": Ax(None, None),
        "mlp": E.mlp_tower_logical([cfg.gru_dim + 2 * cfg.d_behav,
                                    *cfg.mlp]),
        "out": {"w": Ax(None, None), "b": Ax(None)},
    }


class DIEN(P.ParamTree):
    """DIEN's parameters (``item_table``, ``cate_table``, ``gru1`` and
    ``augru`` {wx, wh, b}, ``att_w``, ``mlp.i.{w,b}``, ``out.{w,b}``) on
    ``device`` (``None`` = the card, or the mesh's), zero-filled; with
    ``mesh``, the rank's shards."""

    def __init__(self, cfg: DIENConfig, device=None, mesh=None):
        super().__init__(param_shapes(cfg), cfg.dtype,
                         P.device_of(device, mesh), mesh,
                         param_logical(cfg))


def init_params(cfg: DIENConfig, generator: torch.Generator,
                device=None, mesh=None) -> DIEN:
    scale = cfg.embed_dim ** -0.5
    return P.init_normal(DIEN(cfg, device, mesh), generator,
                         {"item_table": scale, "cate_table": scale})


def from_arrays(cfg: DIENConfig, tree, device=None, mesh=None) -> DIEN:
    return P.load_arrays(DIEN(cfg, device, mesh), tree)


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


def _behaviour_embed(params: DIEN, items, cates, mesh=None,
                     rows=()) -> torch.Tensor:
    specs = params.shard_specs if mesh is not None else {}
    return torch.cat([
        E.lookup(params.item_table, specs.get("item_table"), items, mesh,
                 rows),
        E.lookup(params.cate_table, specs.get("cate_table"), cates, mesh,
                 rows)], dim=-1)


def forward(cfg: DIENConfig, params: DIEN, batch, *, mesh=None,
            with_aux=False):
    """batch: hist_items/hist_cates [B,T] i32, hist_mask [B,T] f32,
    target_item/target_cate [B] i32 -> logit [B] (+aux loss).  On the
    parameters' mesh the batch is the rank's rows and ``batch["rows"]``
    the whole count (``embedding.shard_batch``); the aux loss is the whole
    batch's."""
    mesh = P.mesh_of(params, mesh)
    rows = () if mesh is None else E.batch_axes(mesh, batch, "hist_items")
    return _forward(cfg, params, batch, mesh, rows, with_aux)


def _forward(cfg: DIENConfig, params: DIEN, batch, mesh, rows, with_aux):
    """:func:`forward` of the batch's rows (on ``mesh``: the rank's, cut
    over ``rows``)."""
    hist = _behaviour_embed(params, batch["hist_items"], batch["hist_cates"],
                            mesh, rows)
    target = _behaviour_embed(params, batch["target_item"],
                              batch["target_cate"], mesh, rows)
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
    h, cols = E.mlp_tower_sharded(params.mlp, feats, mesh, rows,
                                  final_act=True)
    logit = E.linear_out(params.out, h, cols, mesh)[:, 0]

    if not with_aux:
        return logit
    # auxiliary loss: h_t should predict behaviour t+1 (in-batch negatives)
    proj = h_seq[:, :-1] @ params.att_w
    pos = torch.einsum("bth,bth->bt", proj, hist[:, 1:])
    neg_hist = E.roll_rows(hist[:, 1:], mesh, rows)         # other users'
    neg = torch.einsum("bth,bth->bt", proj, neg_hist)
    m = mask[:, 1:]
    aux = -(F.logsigmoid(pos) + F.logsigmoid(-neg)).float()
    if mesh is None:
        return logit, torch.sum(aux * m) / torch.clamp_min(torch.sum(m), 1.0)
    total = C.all_reduce(torch.sum(aux * m), mesh, rows)
    count = C.all_reduce(torch.sum(m), mesh, rows)
    return logit, total / torch.clamp_min(count, 1.0)


def loss_fn(cfg: DIENConfig, params: DIEN, batch, *, mesh=None):
    mesh = P.mesh_of(params, mesh)
    rows = () if mesh is None else E.batch_axes(mesh, batch, "hist_items")
    if cfg.use_aux_loss:
        logit, aux = _forward(cfg, params, batch, mesh, rows, True)
    else:
        logit = _forward(cfg, params, batch, mesh, rows, False)
        aux = logit.new_zeros((), dtype=torch.float32)
    bce = E.bce_loss(logit, batch["label"], mesh, rows, batch.get("rows"))
    loss = bce + cfg.aux_weight * aux
    return loss, {"bce": bce, "aux": aux}


def retrieval_score(cfg: DIENConfig, params: DIEN, batch, *,
                    mesh=None) -> torch.Tensor:
    """1 user history vs C candidate items (category derived by hash),
    RETRIEVAL_CHUNK candidates a forward.  Each candidate's score depends
    on its own row alone, so chunks change no value.  On the parameters'
    mesh the candidates are the rank's, cut by ``CANDIDATES``, and
    ``batch["rows"]`` their whole count."""
    mesh = P.mesh_of(params, mesh)
    cands = batch["candidates"]
    rows = () if mesh is None else E.batch_axes(mesh, batch, "candidates",
                                                sh.CANDIDATES)
    out = []
    for s in range(0, cands.shape[0], RETRIEVAL_CHUNK):
        c = cands[s:s + RETRIEVAL_CHUNK]

        def rep(x):
            return x.expand(c.shape[0], *x.shape[1:])
        out.append(_forward(cfg, params, {
            "hist_items": rep(batch["hist_items"]),
            "hist_cates": rep(batch["hist_cates"]),
            "hist_mask": rep(batch["hist_mask"]),
            "target_item": c,
            "target_cate": c % cfg.cate_vocab}, mesh, rows, False))
    return torch.cat(out)
