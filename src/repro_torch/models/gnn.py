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

On a mesh of cards (the parameters' ``.mesh``; every leaf replicated,
as the reference lays GAT out) the graph is cut as :func:`shard_graph`
cuts it: nodes over the axes of ``NODES`` and edges over those of
``EDGES``, both the data axes (``model`` replicates).  A rank's edges
reach nodes of every shard, so each layer all-gathers the node scores
and features; the segment max is an all-reduce ``max`` of the ranks'
partial maxima (detached: the softmax does not depend on it), the
softmax sums an all-reduce, and the aggregation's partial sums are
reduce-scattered back to the node shards; a graph-level readout sums
over graph ids across the shards.  Differentiable
(``repro_torch/collectives.py``).

Covers all four gat-cora shape cells:
  full_graph_sm / ogb_products — full-batch node classification
  minibatch_lg                 — sampled subgraphs from :mod:`repro_torch.models.sampler`
  molecule                     — batched small graphs packed disjointly + readout
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import collectives as C
from repro_torch import sharding as sh
from repro_torch.models import param_tree as P
from repro_torch.models.layers import dense_init
from repro_torch.sharding import Ax


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


def param_shapes(cfg: GATConfig) -> dict:
    layers = []
    d_in = cfg.d_feat
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        h = 1 if last else cfg.n_heads
        f = cfg.n_classes if last else cfg.d_hidden
        layers.append({"w": (d_in, h, f), "a_src": (h, f),
                       "a_dst": (h, f), "bias": (h, f)})
        d_in = h * f
    return {"layers": layers}


def param_logical(cfg: GATConfig) -> dict:
    """The reference's logical axes of every leaf: all replicated."""
    layer = {"w": Ax(None, None, None), "a_src": Ax(None, None),
             "a_dst": Ax(None, None), "bias": Ax(None, None)}
    return {"layers": [dict(layer) for _ in range(cfg.n_layers)]}


class GAT(P.ParamTree):
    """GAT's parameters (``layers.i.{w, a_src, a_dst, bias}``) on
    ``device`` (``None`` = the card, or the mesh's), zero-filled; with
    ``mesh``, the rank's (whole) copies."""

    def __init__(self, cfg: GATConfig, device=None, mesh=None):
        super().__init__(param_shapes(cfg), cfg.dtype,
                         P.device_of(device, mesh), mesh,
                         param_logical(cfg))


@torch.no_grad()
def init_params(cfg: GATConfig, generator: torch.Generator,
                device=None, mesh=None) -> GAT:
    """The reference's draw: ``dense_init`` (truncated normal, fan-in the
    first axis) for ``w``, ``a_src`` and ``a_dst``; ``bias`` zero."""
    gat = GAT(cfg, device, mesh)
    for name, _ in gat.named_parameters():
        if not name.endswith("bias"):
            P.put(gat, name, dense_init(generator, P.whole_shape(gat, name),
                                        cfg.dtype))
    return gat


def from_arrays(cfg: GATConfig, tree, device=None, mesh=None) -> GAT:
    return P.load_arrays(GAT(cfg, device, mesh), tree)


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
              final: bool = False, mesh=None, axes=()) -> torch.Tensor:
    """x [N, d_in]; src/dst [E] int. Returns [N, H*F] (or [N, F] if final).
    On ``mesh`` with ``axes``: x is the rank's block of the nodes and
    src/dst its block of the edges, both cut over ``axes``, of a graph of
    ``n_nodes``; returns the rank's block of the nodes."""
    src, dst = src.long(), dst.long()
    h = torch.einsum("nd,dhf->nhf", x, p.w)                # [N, H, F]
    s_src = torch.sum(h * p.a_src, dim=-1)                 # [N, H]
    s_dst = torch.sum(h * p.a_dst, dim=-1)
    if axes:                    # the rank's edges reach every node shard
        s_src = C.all_gather(s_src, mesh, axes, 0)
        s_dst = C.all_gather(s_dst, mesh, axes, 0)
    e = s_src.index_select(0, src) + s_dst.index_select(0, dst)  # SDDMM
    e = F.leaky_relu(e, negative_slope).float()
    # segment softmax over incoming edges of each dst node; a node with no
    # incoming edge keeps the fill, -inf, which becomes 0 as in the reference
    e_max = torch.full((n_nodes, e.shape[1]), -torch.inf, device=e.device) \
        .scatter_reduce(0, dst[:, None].expand_as(e),
                        e.detach() if axes else e, "amax",
                        include_self=False)
    if axes:
        e_max = C.all_reduce(e_max, mesh, axes, "max")
    e_max = torch.where(torch.isfinite(e_max), e_max, 0.0)
    alpha = torch.exp(e - e_max.index_select(0, dst))
    denom = _segment_sum(alpha, dst, n_nodes)
    if axes:
        denom = C.all_reduce(denom, mesh, axes)
    alpha = alpha / torch.clamp_min(denom.index_select(0, dst), 1e-9)
    # SpMM: aggregate alpha-weighted source features
    h_all = C.all_gather(h, mesh, axes, 0) if axes else h
    agg = _Aggregate.apply(h_all, alpha.to(h.dtype), src, dst, n_nodes)
    if axes:
        agg = C.reduce_scatter(agg, mesh, axes, 0)
    agg = agg + p.bias
    if final:
        return torch.mean(agg, dim=1)                      # average heads
    return F.elu(agg).reshape(agg.shape[0], -1)            # concat heads


def _node_axes(mesh, n_nodes: int) -> tuple[str, ...]:
    """The axes (of size above 1) that cut a graph of ``n_nodes`` nodes."""
    spec = sh.resolve_spec((sh.NODES,), (n_nodes,), mesh, sh.tp_profile(mesh))
    return mesh.axes(sh.spec_axes(spec, 0))


def shard_graph(mesh, graph: dict) -> dict:
    """The rank's part of a whole graph on ``mesh``: ``x`` (with a
    graph-level cell's ``graph_ids``, or a node-level cell's ``labels``
    and ``label_mask``) cut over the axes of ``NODES``, ``src`` and
    ``dst`` over those of ``EDGES``, the rest whole; ``"n_nodes"`` the
    whole node count.  Both counts must divide alike (the launch layer
    pads a graph to 128 x the mesh's size first)."""
    N, E_ = graph["x"].shape[0], graph["src"].shape[0]
    axes = _node_axes(mesh, N)
    edge_spec = sh.resolve_spec((sh.EDGES,), (E_,), mesh,
                                sh.tp_profile(mesh))
    if mesh.axes(sh.spec_axes(edge_spec, 0)) != axes:
        raise ValueError(f"{N} nodes and {E_} edges cut over different axes "
                         f"of {mesh}: pad the graph first")
    node_keys = {"x", "graph_ids"} if "graph_ids" in graph else \
        {"x", "labels", "label_mask"}
    n = math.prod(mesh.shape[a] for a in axes)
    i = sh.shard_index(mesh, axes, mesh.coords)
    out = {}
    for k, v in graph.items():
        if k in node_keys or k in ("src", "dst"):
            b = v.shape[0] // n
            v = v[i * b:(i + 1) * b]
        out[k] = v
    out["n_nodes"] = N
    return out


def forward(cfg: GATConfig, params: GAT, graph, *, mesh=None
            ) -> torch.Tensor:
    """graph: {x [N,d], src [E], dst [E], (graph_ids [N], node_counts [G])}.
    On the parameters' mesh the graph is the rank's part
    (:func:`shard_graph`) and the logits the rank's nodes' (a
    graph-level readout's whole, on every rank)."""
    mesh = P.mesh_of(params, mesh)
    x, src, dst = graph["x"], graph["src"], graph["dst"]
    n_nodes, axes = x.shape[0], ()
    if mesh is not None:
        n_nodes = int(graph["n_nodes"])
        axes = _node_axes(mesh, n_nodes)
    for i, p in enumerate(params.layers):
        x = gat_layer(p, x, src, dst, n_nodes,
                      negative_slope=cfg.negative_slope,
                      final=i == cfg.n_layers - 1, mesh=mesh, axes=axes)
    if cfg.readout == "mean":
        counts = graph["node_counts"]
        summed = _segment_sum(x, graph["graph_ids"].long(), counts.shape[0])
        if axes:
            summed = C.all_reduce(summed, mesh, axes)
        return summed / torch.clamp_min(counts[:, None], 1).to(x.dtype)
    return x  # [N, n_classes] logits


def loss_fn(cfg: GATConfig, params: GAT, batch, *, mesh=None):
    """Masked node (or graph) classification cross-entropy; on the
    parameters' mesh the whole graph's, summed and counted across the
    node shards."""
    mesh = P.mesh_of(params, mesh)
    logits = forward(cfg, params, batch, mesh=mesh).float()
    labels = batch["labels"].long()
    mask = batch.get("label_mask")
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    m = torch.ones_like(nll) if mask is None else mask.float()
    axes = () if mesh is None or cfg.readout == "mean" else \
        _node_axes(mesh, int(batch["n_nodes"]))
    if axes:
        loss = C.all_reduce(torch.sum(nll * m), mesh, axes) / \
            torch.clamp_min(C.all_reduce(torch.sum(m), mesh, axes), 1.0)
    elif mask is not None:
        loss = torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    else:
        loss = torch.mean(nll)
    return loss, {"ce": loss}
