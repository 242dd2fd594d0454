"""Mixture-of-Experts FFN with capacity-bounded top-k routing (the port of
``src/repro/models/moe.py``).

Two dispatch strategies, selected by ``MoEConfig.dispatch``:

* ``"scatter"`` — each assignment's position inside its expert comes from a
  cumsum over the one-hot expert assignment, token-major; the kept tokens'
  rows are gathered into an ``[E, C, d]`` buffer, the expert FFNs run as
  batched matrix products over ``E``, and each assignment's output row is
  gathered back and weighted by its gate.
* ``"einsum"`` — GShard-style one-hot einsum dispatch over token groups of
  ``group_size``.

Covers Llama-4-Scout (16 routed top-1 + 1 shared expert, sigmoid router)
and OLMoE (64 routed top-8, softmax, normalised gates).  The expert products
are plain batched matrix products, as in the JAX package, which computes
them as einsums outside any Pallas kernel.  Routing ties go to the lowest
expert (``common.topk``, the ``lax.top_k`` rule).  Nothing here reads a
value back to the host and no shape depends on the data, so a prefill or a
decode step that runs it can be captured as a CUDA graph.  Capacity is per
call: a token's output depends on the other tokens of its batch, though
not on the rows that pad a batch to its bucket (``moe_apply``'s
``n_rows``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import collectives as C
from repro_torch import sharding as sh
from repro_torch.common import DEFAULT_DTYPE, cdiv, resolve_device, round_up, \
    topk
from repro_torch.models.layers import MLP, dense_init, gather_at_use, \
    mlp_apply, mlp_apply_sharded, mlp_init


@dataclasses.dataclass(frozen=True, kw_only=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # shared (always-on) experts
    d_ff_shared: int = 0
    router_act: str = "softmax"  # or "sigmoid" (llama4)
    normalize_gates: bool = True
    capacity_factor: float = 1.25
    dispatch: str = "scatter"    # or "einsum"
    group_size: int = 1024       # einsum dispatch group
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3


class MoE(nn.Module):
    """The MoE layer's parameters: ``router`` [d_model, E] in fp32, the
    experts ``w_gate``/``w_up`` [E, d_model, d_ff] and ``w_down`` [E, d_ff,
    d_model], and with ``n_shared`` the shared expert ``shared`` (an
    :class:`~repro_torch.models.layers.MLP`); on ``device`` (``None`` = the
    card)."""

    def __init__(self, d_model: int, cfg: MoEConfig, dtype=DEFAULT_DTYPE,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        E, f = cfg.n_experts, cfg.d_ff_expert

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.router = param(d_model, E, dt=torch.float32)
        self.w_gate = param(E, d_model, f)
        self.w_up = param(E, d_model, f)
        self.w_down = param(E, f, d_model)
        self.shared = (MLP(d_model, cfg.d_ff_shared or f, dtype, device)
                       if cfg.n_shared else None)


def moe_init(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=DEFAULT_DTYPE) -> MoE:
    """A :class:`MoE` on the generator's device with the JAX package's
    ``moe_init`` distribution: ``dense_init`` of each [E, ...] tensor,
    whose fan-in is its first axis, E.  The experts are drawn one at a
    time, so the fp32 temporary is one expert's matrix, not all E."""
    p = MoE(d_model, cfg, dtype, generator.device)
    std = cfg.n_experts ** -0.5
    with torch.no_grad():
        p.router.copy_(dense_init(generator, tuple(p.router.shape),
                                  torch.float32))
        for name in ("w_gate", "w_up", "w_down"):
            w = getattr(p, name)
            for e in range(cfg.n_experts):
                w[e].copy_(dense_init(generator, tuple(w.shape[1:]), dtype,
                                      scale=std))
        if cfg.n_shared:
            p.shared = mlp_init(generator, d_model,
                                cfg.d_ff_shared or cfg.d_ff_expert, dtype)
    return p


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """bool [..., n]; an index outside [0, n) gives a row of False (as
    ``jax.nn.one_hot`` gives zeros)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _routing(xt: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
             expert_idx: torch.Tensor | None = None):
    """Returns (gates [N, k] in xt's dtype, expert_idx [N, k] int64,
    metrics {"moe_aux", "moe_z": 0-d fp32 tensors; "expert_idx"; and
    "expert_load" [E] int64, the assignments each expert is given, kept or
    not}).  ``expert_idx`` routes to the given experts in place of the
    router's top-k, each gated by the router's score there."""
    logits = xt.to(torch.float32) @ router
    if cfg.router_act == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    if expert_idx is None:
        gates, expert_idx = topk(scores, cfg.top_k)
    else:
        gates = scores.gather(-1, expert_idx)
    if cfg.normalize_gates and cfg.top_k > 1:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)

    # Switch-style load-balance loss + router z-loss
    probs = (scores if cfg.router_act == "softmax"
             else torch.softmax(logits, dim=-1))
    load = _one_hot(expert_idx, cfg.n_experts).sum((0, 1))
    density = load.to(torch.float32) / xt.shape[0]
    density_prob = probs.mean(0)
    aux = cfg.n_experts * torch.sum(density / cfg.top_k * density_prob)
    z = torch.logsumexp(logits, dim=-1).square().mean()
    metrics = {"moe_aux": aux * cfg.aux_loss_weight,
               "moe_z": z * cfg.router_z_weight,
               "expert_idx": expert_idx, "expert_load": load}
    return gates.to(xt.dtype), expert_idx, metrics


def _expert_ffn(p: MoE, buf: torch.Tensor, w=None) -> torch.Tensor:
    """buf [E, C, d] -> [E, C, d] via each expert's SwiGLU (the weights
    ``w`` = (w_gate, w_up, w_down) in place of ``p``'s when given)."""
    w_gate, w_up, w_down = w or (p.w_gate, p.w_up, p.w_down)
    h = F.silu(torch.bmm(buf, w_gate), inplace=True)
    h.mul_(torch.bmm(buf, w_up))
    return torch.bmm(h, w_down)


def _slots(cfg: MoEConfig, n, multiple: int):
    """An expert's slots for ``n`` (capacity factor x k x tokens, a float,
    or a 0-d float64 tensor on the device): max(1, round_up(cdiv(int(n),
    E), multiple)); an int, or a 0-d int64 tensor, read nowhere on the
    host."""
    E = cfg.n_experts
    if isinstance(n, torch.Tensor):
        c = -(-n.floor().long() // E)
        return torch.clamp_min(-(-c // multiple) * multiple, 1)
    return max(1, round_up(cdiv(int(n), E), multiple))


def scatter_capacity(cfg: MoEConfig, rows, seq: int = 1):
    """Slots an expert takes in a scatter call of ``rows`` rows of ``seq``
    tokens, the product in the reference's order; ``rows`` an int, or a
    0-d integer tensor on the device (then a 0-d tensor)."""
    if isinstance(rows, torch.Tensor):
        rows = rows.double()
    return _slots(cfg, cfg.capacity_factor * cfg.top_k * rows * seq, 8)


def scatter_slots(expert_idx: torch.Tensor, n_experts: int, capacity: int,
                  limit=None):
    """Each assignment's place in the reference's order: (flat_e [N*k],
    slot [N*k], keep [N*k] bool).  Positions within an expert count its
    assignments token-major over the flattened [N * k] assignments; those
    at or past ``limit`` (a 0-d tensor, at most ``capacity``; None: the
    capacity) are dropped (``keep`` False, ``slot`` = capacity).  Kept
    (expert, slot) pairs are unique."""
    flat_e = expert_idx.reshape(-1)
    # the scan runs along the last axis, [E, N*k]: a CUDA scan along the
    # first axis of [N*k, E] walks each of the E columns serially
    pos = torch.cumsum(_one_hot(flat_e, n_experts).T, 1, dtype=torch.int32)
    mypos = pos.gather(0, flat_e[None, :])[0].long() - 1
    keep = mypos < (capacity if limit is None else limit)
    return flat_e, torch.where(keep, mypos, capacity), keep


def _scatter_buffer(xt, flat_e, slot, keep, n_experts: int,
                    capacity: int) -> torch.Tensor:
    """The experts' input [E, C, d]: each kept assignment's token row at
    its (expert, slot), zeros elsewhere."""
    N, d = xt.shape
    E, C = n_experts, capacity
    # the token each buffer row [E * C] takes: a kept assignment's token,
    # else N (a zero row); dropped assignments write to a sink past the end
    dest = torch.where(keep, flat_e * C + slot, E * C)
    src = torch.full((E * C + 1,), N, dtype=torch.long, device=xt.device)
    src.scatter_(0, dest, torch.arange(flat_e.numel(), device=xt.device) //
                 (flat_e.numel() // N))
    return torch.cat([xt, xt.new_zeros(1, d)])[src[:-1]].view(E, C, d)


def _scatter_combine(y, flat_e, slot, keep, gates) -> torch.Tensor:
    """The experts' output y [E, C, d] back to tokens [N, d]: each kept
    assignment's row times its gate, summed over a token's k."""
    E, C, d = y.shape
    at = torch.where(keep, flat_e * C + slot, 0)
    out_tok = torch.where(keep[:, None],
                          y.view(E * C, d)[at] * gates.reshape(-1, 1), 0)
    return out_tok.view(gates.shape[0], gates.shape[1], d).sum(1)


def _dispatch_scatter(p: MoE, xt, gates, expert_idx, cfg: MoEConfig,
                      capacity: int, limit):
    flat_e, slot, keep = scatter_slots(expert_idx, cfg.n_experts, capacity,
                                       limit)
    buf = _scatter_buffer(xt, flat_e, slot, keep, cfg.n_experts, capacity)
    return (_scatter_combine(_expert_ffn(p, buf), flat_e, slot, keep, gates),
            keep)


def _dispatch_einsum(p: MoE, xt, gates, expert_idx, cfg: MoEConfig,
                     n_real):
    N, d = xt.shape
    k, E = cfg.top_k, cfg.n_experts
    g = min(cfg.group_size, N)
    n_groups = cdiv(N, g)
    pad = n_groups * g - N
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
        gates = F.pad(gates, (0, 0, 0, pad))
        expert_idx = F.pad(expert_idx, (0, 0, 0, pad))
    C = _slots(cfg, cfg.capacity_factor * k * g, 4)
    # a group of the real tokens alone, where they fill less than g
    limit = C if n_real is None else _slots(
        cfg, cfg.capacity_factor * k * torch.clamp_max(n_real, g).double(),
        4)
    xg = xt.reshape(n_groups, g, d)
    eg = expert_idx.reshape(n_groups, g, k)
    wg = gates.reshape(n_groups, g, k)
    onehot = _one_hot(eg, E).to(torch.int32)                 # [G, g, k, E]
    # scanned along the last axis, as in scatter_slots
    pos = torch.cumsum(onehot.reshape(n_groups, g * k, E).transpose(1, 2),
                       2).transpose(1, 2).reshape(n_groups, g, k, E) * \
        onehot - 1
    keep = (pos < limit) & (pos >= 0)
    dis = (_one_hot(torch.where(keep, pos, C), C) &
           keep[..., None]).to(xt.dtype)                      # [G,g,k,E,C]
    dispatch = (dis * onehot[..., None].to(xt.dtype)).sum(2)  # [G, g, E, C]
    combine = (dis * (onehot.to(xt.dtype) * wg[..., None])[..., None]).sum(2)
    buf = torch.einsum("Ggec,Ggd->Gecd", dispatch, xg)
    # every group's [E, C, d] buffer through the experts at once
    y = _expert_ffn(p, buf.transpose(0, 1).reshape(E, n_groups * C, d))
    y = y.reshape(E, n_groups, C, d).transpose(0, 1)           # [G, E, C, d]
    out = torch.einsum("Ggec,Gecd->Ggd", combine, y).reshape(-1, d)
    return out[:N], keep.any(-1).reshape(-1)[:N * k]


def moe_apply(p: MoE, x: torch.Tensor, cfg: MoEConfig, *, n_rows=None,
              expert_idx: torch.Tensor | None = None):
    """x [B, S, d] -> (out [B, S, d], metrics): :func:`_routing`'s and
    "dropped", the assignments past their expert's capacity (a 0-d int64
    tensor; both over all B rows).

    ``n_rows`` (a 0-d integer tensor on x's device; None: B) counts the
    rows that hold real tokens, the first ones, where the rest pad a
    bucket: capacity then counts the real rows' tokens, as a call on them
    alone does, and the buffers keep the shapes of all B rows.  Positions
    are token-major, so a pad row never takes a real token's slot, and the
    real rows' outputs equal those of the call on them alone.
    ``expert_idx`` [B * S, k] pins the routing (see :func:`_routing`)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    gates, expert_idx, metrics = _routing(xt, p.router, cfg, expert_idx)
    if cfg.dispatch == "scatter":
        limit = None if n_rows is None else scatter_capacity(cfg, n_rows, S)
        out, keep = _dispatch_scatter(p, xt, gates, expert_idx, cfg,
                                      scatter_capacity(cfg, B, S), limit)
    elif cfg.dispatch == "einsum":
        out, keep = _dispatch_einsum(p, xt, gates, expert_idx, cfg,
                                     None if n_rows is None else n_rows * S)
    else:
        raise ValueError(f"unknown MoE dispatch {cfg.dispatch!r}")
    metrics["dropped"] = (~keep).sum()
    if cfg.n_shared:
        out = out + mlp_apply(p.shared, x).reshape(B * S, d)
    return out.reshape(B, S, d), metrics


def moe_apply_sharded(p: MoE, x: torch.Tensor, cfg: MoEConfig, mesh,
                      token_axes=(), *,
                      expert_idx: torch.Tensor | None = None):
    """:func:`moe_apply` (scatter dispatch) on a mesh, with the experts
    sharded over the axes of their EXPERTS dim (expert parallelism).  x
    [B_l, S, d] is the rank's rows (sharded over ``token_axes``).  The
    rows are gathered, so every rank routes all B x S tokens as the
    unsharded layer does: the same choices, positions and capacity drops,
    and the same metrics.  Each rank runs its own experts over their
    slots, combines their outputs for its rows and all-reduces the sums
    over the expert axes (for all rows where those axes also shard the
    tokens); weight shards on other dims are gathered at use.
    ``expert_idx`` [B * S, k], the whole batch's, pins the routing as in
    :func:`moe_apply`.  Under autograd the gathered rows' gradient is
    reduce-scattered back to the ranks that own them (the all-gather's
    backward), so the terms that every rank computes whole (the routing,
    ``moe_aux`` and ``moe_z``) reach each row once a rank, as the loss's
    share of 1/(the ranks) asks (``train/train_step.py``)."""
    if cfg.dispatch != "scatter":
        raise NotImplementedError(f"dispatch {cfg.dispatch!r} on a mesh: "
                                  f"the mesh path dispatches by scatter")
    specs = p.shard_specs
    B_l, S, d = x.shape
    xa = C.all_gather(x, mesh, token_axes, 0)
    B = xa.shape[0]
    xt = xa.reshape(B * S, d)
    router = gather_at_use(p.router, specs["router"], mesh)
    gates, expert_idx, metrics = _routing(xt, router, cfg, expert_idx)
    ax = {sh.spec_axes(specs[n], 0) for n in ("w_gate", "w_up", "w_down")}
    ax = ax.pop() if len(ax) == 1 else ()
    w = tuple(gather_at_use(getattr(p, n), specs[n], mesh,
                            (0,) if ax else ())
              for n in ("w_gate", "w_up", "w_down"))
    E_l = w[0].shape[0]
    e0 = sh.shard_index(mesh, ax, mesh.coords) * E_l
    capacity = scatter_capacity(cfg, B, S)
    flat_e, slot, keep = scatter_slots(expert_idx, cfg.n_experts, capacity)
    local_e = flat_e - e0
    mine = keep & (local_e >= 0) & (local_e < E_l)
    buf = _scatter_buffer(xt, local_e, slot, mine, E_l, capacity)
    y = _expert_ffn(p, buf, w)
    # the rows whose outputs this rank sums: its own, unless ranks along
    # the expert axes hold other rows
    k = cfg.top_k
    own = not (set(mesh.axes(ax)) & set(mesh.axes(token_axes)))
    r0 = sh.shard_index(mesh, token_axes, mesh.coords) * B_l if own else 0
    n = B_l if own else B
    a = slice(r0 * S * k, (r0 + n) * S * k)
    out = _scatter_combine(y, local_e[a], slot[a], mine[a],
                           gates[r0 * S:(r0 + n) * S])
    out = C.all_reduce(out, mesh, ax)
    if not own:
        lo = sh.shard_index(mesh, token_axes, mesh.coords) * B_l * S
        out = out[lo:lo + B_l * S]
    metrics["dropped"] = (~keep).sum()
    if cfg.n_shared:
        out = out + mlp_apply_sharded(p.shared, x, mesh,
                                      token_axes).reshape(B_l * S, d)
    return out.reshape(B_l, S, d), metrics
