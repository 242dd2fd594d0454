"""Graph attention network (GAT) via segment ops — the SpMM/SDDMM regime
(the port of ``src/repro/models/gnn.py``).

Message passing from first principles: SDDMM-style edge scores ->
segment-softmax over incoming edges (``scatter_reduce("amax")`` over a
``-inf`` fill, then ``index_add``) -> scatter-sum aggregation
(``index_add``), where the reference calls ``jax.ops.segment_max`` and
``segment_sum``.  Gathers are ``index_select``, whose backward is an
``index_add``.  The aggregation of the alpha-weighted source rows runs
``MESSAGE_CHUNK`` edges at a time, forward and backward
(:class:`_Aggregate`), so the ``[E, H, F]`` gathered messages never exist
whole: at ogb_products' first layer one such tensor is 15.8 GB, and
autograd through the plain gather keeps one and builds three more in the
backward, more than the card holds.

Covers all four gat-cora shape cells:
  full_graph_sm / ogb_products — full-batch node classification
  minibatch_lg                 — sampled subgraphs from :mod:`repro_torch.models.sampler`
  molecule                     — batched small graphs packed disjointly + readout
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.common import resolve_device
from repro_torch.models import param_tree as P
from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True, kw_only=True)
class GATConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 8           # per-head hidden dim
    n_heads: int = 8
    d_feat: int = 1433
    n_classes: int = 7
    negative_slope: float = 0.2
    readout: str | None = None  # None (node-level) | "mean" (graph-level)
    dtype: Any = torch.float32


class GAT(P.ParamTree):
    """GAT's parameters (``layers.i.{w, a_src, a_dst, bias}``) on
    ``device`` (``None`` = the card), zero-filled."""

    def __init__(self, cfg: GATConfig, device=None):
        layers = []
        d_in = cfg.d_feat
        for i in range(cfg.n_layers):
            last = i == cfg.n_layers - 1
            h = 1 if last else cfg.n_heads
            f = cfg.n_classes if last else cfg.d_hidden
            layers.append({"w": (d_in, h, f), "a_src": (h, f),
                           "a_dst": (h, f), "bias": (h, f)})
            d_in = h * f
        super().__init__({"layers": layers}, cfg.dtype,
                         resolve_device(device))


@torch.no_grad()
def init_params(cfg: GATConfig, generator: torch.Generator,
                device=None) -> GAT:
    """The reference's draw: ``dense_init`` (truncated normal, fan-in the
    first axis) for ``w``, ``a_src`` and ``a_dst``; ``bias`` zero."""
    gat = GAT(cfg, device)
    for lay in gat.layers:
        for p in (lay.w, lay.a_src, lay.a_dst):
            p.copy_(dense_init(generator, tuple(p.shape), cfg.dtype))
    return gat


def from_arrays(cfg: GATConfig, tree, device=None) -> GAT:
    return P.load_arrays(GAT(cfg, device), tree)


to_arrays = P.to_arrays


#: edges whose messages :class:`_Aggregate` gathers at once ([E, 8, 8]
#: fp32: 1 GiB)
MESSAGE_CHUNK = 1 << 22


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_zeros((n, *x.shape[1:])).index_add(0, ids, x)


class _Aggregate(torch.autograd.Function):
    """agg [N, H, F] = segment_sum(h[src] * alpha[..., None], dst): the
    reference's SpMM, MESSAGE_CHUNK edges at a time.  The backward
    gathers again what it needs, a chunk at a time: grad_h =
    segment_sum(grad[dst] * alpha[..., None], src) and grad_alpha =
    sum_F(grad[dst] * h[src])."""

    @staticmethod
    def forward(ctx, h, alpha, src, dst, n_nodes: int):
        ctx.save_for_backward(h, alpha, src, dst)
        agg = h.new_zeros((n_nodes, *h.shape[1:]))
        for s in range(0, src.shape[0], MESSAGE_CHUNK):
            e = slice(s, s + MESSAGE_CHUNK)
            agg.index_add_(0, dst[e],
                           h.index_select(0, src[e]) * alpha[e, :, None])
        return agg

    @staticmethod
    def backward(ctx, grad):
        h, alpha, src, dst = ctx.saved_tensors
        grad_h, grad_alpha = torch.zeros_like(h), torch.empty_like(alpha)
        for s in range(0, src.shape[0], MESSAGE_CHUNK):
            e = slice(s, s + MESSAGE_CHUNK)
            g = grad.index_select(0, dst[e])
            grad_h.index_add_(0, src[e], g * alpha[e, :, None])
            grad_alpha[e] = torch.sum(g * h.index_select(0, src[e]), dim=-1)
        return grad_h, grad_alpha, None, None, None


def gat_layer(p, x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              n_nodes: int, *, negative_slope: float = 0.2,
              final: bool = False) -> torch.Tensor:
    """x [N, d_in]; src/dst [E] int. Returns [N, H*F] (or [N, F] if final)."""
    src, dst = src.long(), dst.long()
    h = torch.einsum("nd,dhf->nhf", x, p.w)                # [N, H, F]
    s_src = torch.sum(h * p.a_src, dim=-1)                 # [N, H]
    s_dst = torch.sum(h * p.a_dst, dim=-1)
    e = s_src.index_select(0, src) + s_dst.index_select(0, dst)  # SDDMM
    e = F.leaky_relu(e, negative_slope).float()
    # segment softmax over incoming edges of each dst node; a node with no
    # incoming edge keeps the fill, -inf, which becomes 0 as in the reference
    e_max = torch.full((n_nodes, e.shape[1]), -torch.inf, device=e.device) \
        .scatter_reduce(0, dst[:, None].expand_as(e), e, "amax",
                        include_self=False)
    e_max = torch.where(torch.isfinite(e_max), e_max, 0.0)
    alpha = torch.exp(e - e_max.index_select(0, dst))
    denom = _segment_sum(alpha, dst, n_nodes)
    alpha = alpha / torch.clamp_min(denom.index_select(0, dst), 1e-9)
    # SpMM: aggregate alpha-weighted source features
    agg = _Aggregate.apply(h, alpha.to(h.dtype), src, dst, n_nodes) + p.bias
    if final:
        return torch.mean(agg, dim=1)                      # average heads
    return F.elu(agg).reshape(n_nodes, -1)                 # concat heads


def forward(cfg: GATConfig, params: GAT, graph) -> torch.Tensor:
    """graph: {x [N,d], src [E], dst [E], (graph_ids [N], node_counts [G])}."""
    x, src, dst = graph["x"], graph["src"], graph["dst"]
    n_nodes = x.shape[0]
    for i, p in enumerate(params.layers):
        x = gat_layer(p, x, src, dst, n_nodes,
                      negative_slope=cfg.negative_slope,
                      final=i == cfg.n_layers - 1)
    if cfg.readout == "mean":
        counts = graph["node_counts"]
        summed = _segment_sum(x, graph["graph_ids"].long(), counts.shape[0])
        return summed / torch.clamp_min(counts[:, None], 1).to(x.dtype)
    return x  # [N, n_classes] logits


def loss_fn(cfg: GATConfig, params: GAT, batch):
    """Masked node (or graph) classification cross-entropy."""
    logits = forward(cfg, params, batch).float()
    labels = batch["labels"].long()
    mask = batch.get("label_mask")
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    if mask is not None:
        m = mask.float()
        loss = torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    else:
        loss = torch.mean(nll)
    return loss, {"ce": loss}
