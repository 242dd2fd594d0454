"""Hand-written AdamW with its schedules (the port of
``src/repro/train/optimizer.py``).

Parameters are a tree: an ``nn.Module`` (its named parameters) or nested
dicts of tensors.  The state is parallel to it, keyed by the parameters'
dotted names:

  {"m": {name: fp32 tensor}, "v": {name: fp32 tensor}, "step": 0-d int32}

Moments are fp32 whatever the parameters' dtype, and :func:`update`
computes each new parameter in fp32 before casting it back, in place.

Weight decay takes the leaves of two axes or more, counted in the JAX
package's tree.  That tree stacks an LM's layers on a leading L axis, so a
layer's leaf there has one axis more than the port's per-layer tensor:
the LM declares the parameter prefixes it stacks
(``TransformerLM.stacked_prefixes``).  Everything else, lists and dict
trees included, counts its own axes: the model zoo's trees are Python
lists of unstacked leaves there (``cross[i]``, ``mlp[i]``,
``layers[i]``), so their 1-D biases are not decayed.

On a mesh (a module whose parameters are a rank's shards: ``mesh`` and
``shard_specs``, as ``TransformerLM`` has them) the moments are ZeRO-1, as
the reference's ``zero1_sharding_tree`` lays them out: each leaf's
moments follow ``sharding.zero1_spec`` of its spec in the reference's
stacked tree (:func:`mesh_layout`), so where a parameter leaves ``data``
free its moments are cut over ``data`` on the first free dim that it
divides.  That dim is the stacked layer axis where it divides (the ``tp``
LMs): a rank then holds the moments of its own layers only, whole, and
none of the others'.  :func:`update` sums each leaf's gradient over the
ranks that hold the leaf alike (a reduce-scatter over ``data`` onto the
moments' slice, an all-reduce over the other axes the spec leaves free),
takes the global norm with each replicated copy counted once, updates the
rank's slice of the moments and of the parameter, and all-gathers the
parameter over ``data``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from repro_torch import collectives as C
from repro_torch import sharding as sh


@dataclasses.dataclass(frozen=True, kw_only=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # "cosine" | "linear" | "constant"


def _children(tree: Any):
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, (list, tuple)):
        return enumerate(tree)
    return None


def named_leaves(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """The tensors of a tree by dotted name: an ``nn.Module``'s named
    parameters, or the leaves of nested dicts and lists."""
    if isinstance(tree, nn.Module):
        return {prefix + n: p for n, p in tree.named_parameters()}
    children = _children(tree)
    if children is None:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in children:
        out.update(named_leaves(v, f"{prefix}{k}."))
    return out


def stacked_leaves(tree: Any, prefix: str = "") -> set[str]:
    """The names of the leaves that the JAX package stacks on a leading L
    axis: a module's parameters under its ``stacked_prefixes``."""
    if isinstance(tree, nn.Module):
        stacked = getattr(tree, "stacked_prefixes", ())
        return {prefix + n for n, _ in tree.named_parameters()
                if n.startswith(stacked)}
    out: set[str] = set()
    for k, v in _children(tree) or ():
        out |= stacked_leaves(v, f"{prefix}{k}.")
    return out


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), fp32: a
    linear warm-up, then cosine, linear or constant to ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = torch.ones_like(frac)
    return cfg.lr * warm * decay


@dataclasses.dataclass(frozen=True)
class MeshLeaf:
    """A parameter's place in the reference's tree on a mesh: its ``key``
    there (the dotted name without its layer index), its ``layer`` in the
    stack (None for a leaf that is not stacked), the whole leaf's
    ``shape`` and ``spec`` (stacked: the L dim first, never sharded) and
    its moments' spec ``mspec``, ``zero1_spec`` of ``spec``."""
    key: str
    layer: int | None
    shape: tuple[int, ...]
    spec: sh.P
    mspec: sh.P

    def zero_dim(self) -> int | None:
        """The dim to which ZeRO-1 adds ``data`` (None: none)."""
        for i, e in enumerate(self.mspec):
            if e == "data" and not sh.spec_axes(self.spec, i):
                return i
        return None

    def free(self, mesh) -> tuple[str, ...]:
        """The mesh axes over which the moments' slice is replicated."""
        used = {a for i in range(len(self.mspec))
                for a in sh.spec_axes(self.mspec, i)}
        return mesh.axes(tuple(a for a in mesh.axis_names if a not in used))


def mesh_layout(params: Any) -> dict[str, MeshLeaf] | None:
    """Each parameter's :class:`MeshLeaf` by dotted name, for a module
    whose parameters are a rank's shards (``params.mesh``, and each owner
    module's ``shard_specs``); None for any other tree."""
    mesh = getattr(params, "mesh", None)
    if mesh is None:
        return None
    prefixes = tuple(getattr(params, "stacked_prefixes", ()))
    named = {}
    for name, p in params.named_parameters():
        owner, _, leaf = name.rpartition(".")
        spec = params.get_submodule(owner).shard_specs[leaf]
        whole = tuple(n * math.prod(mesh.shape[a]
                                    for a in sh.spec_axes(spec, i))
                      for i, n in enumerate(p.shape))
        parts = name.split(".")
        at = next((i for i, q in enumerate(parts) if q.isdigit()), None) \
            if name.startswith(prefixes) and prefixes else None
        if at is None:
            named[name] = (name, None, whole, spec)
        else:
            named[name] = (".".join(parts[:at] + parts[at + 1:]),
                           int(parts[at]), whole, spec)
    layers: dict[str, int] = {}
    for key, layer, _, _ in named.values():
        if layer is not None:
            layers[key] = layers.get(key, 0) + 1
    out = {}
    for name, (key, layer, whole, spec) in named.items():
        if layer is not None:
            spec = sh.P(None, *spec)
            whole = (layers[key], *whole)
        out[name] = MeshLeaf(key, layer, whole, spec,
                             sh.zero1_spec(spec, whole, mesh))
    return out


def _held(lf: MeshLeaf, mesh) -> bool:
    """Whether this rank holds moments of ``lf``'s layer."""
    if lf.layer is None:
        return True
    block = sh.local_slices(lf.mspec, lf.shape, mesh, mesh.coords)[0]
    return block.start <= lf.layer < block.stop


def init(params: Any) -> dict[str, Any]:
    leaves = named_leaves(params)
    device = next(iter(leaves.values())).device
    layout = mesh_layout(params)

    def zeros():
        if layout is None:
            return {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in leaves.items()}
        mesh = params.mesh
        out = {}
        for n, p in leaves.items():
            lf = layout[n]
            if _held(lf, mesh):
                shape = sh.local_shape(lf.mspec, lf.shape, mesh)
                out[n] = torch.zeros(shape[lf.layer is not None:],
                                     dtype=torch.float32, device=p.device)
        return out

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for x in named_leaves(tree).values()))


def _adamw(cfg: AdamWConfig, g, m, v, p32, decay: bool, lr, c1, c2):
    """One element-wise AdamW step of fp32 ``p32`` with gradient ``g``
    (clipped already): ``m`` and ``v`` in place; returns the new p32."""
    m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g.square())
    u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
    if cfg.weight_decay and decay:
        u = u + cfg.weight_decay * p32
    return p32 - lr * u


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Any, state: dict[str, Any], params: Any):
    """One AdamW step: the parameters of ``params`` and the moments of
    ``state`` are updated in place.  ``grads`` is a tree like ``params``
    (or a dict by dotted name); on a mesh each is the rank's unreduced
    gradient of its shard (see the module's docstring).  Returns (params,
    new state, metrics {"grad_norm", "lr"})."""
    leaves, grads = named_leaves(params), named_leaves(grads)
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    c1 = 1.0 - cfg.b1 ** step.to(torch.float32)
    c2 = 1.0 - cfg.b2 ** step.to(torch.float32)
    layout = mesh_layout(params)
    if layout is not None:
        gnorm = _update_mesh(cfg, grads, state, params, layout, lr, c1, c2)
    else:
        stacked = stacked_leaves(params)
        gnorm = global_norm(grads)
        scale = _clip(cfg, gnorm)
        for name, p in leaves.items():
            new = _adamw(cfg, grads[name].float() * scale, state["m"][name],
                         state["v"][name], p.float(),
                         p.dim() + (name in stacked) >= 2, lr, c1, c2)
            p.copy_(new)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics


def _clip(cfg: AdamWConfig, gnorm):
    return (torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
            if cfg.grad_clip else 1.0)


def _stack(tensors: list, stacked: bool) -> torch.Tensor:
    return torch.stack(tensors) if stacked else tensors[0]


def _update_mesh(cfg, grads, state, params, layout, lr, c1, c2):
    """:func:`update` on ``params.mesh`` (ZeRO-1); returns the global
    gradient norm.  A key's layers are stacked, as the reference's leaf
    is, so a moment cut along L updates the rank's layers alone."""
    mesh = params.mesh
    leaves = named_leaves(params)
    groups: dict[str, list] = {}
    for name, lf in layout.items():
        groups.setdefault(lf.key, []).append(name)
    reduced, sq = {}, torch.zeros((), dtype=torch.float32,
                                  device=next(iter(leaves.values())).device)
    for key, names in groups.items():
        names.sort(key=lambda n: layout[n].layer or 0)
        lf = layout[names[0]]
        stacked = lf.layer is not None
        g = _stack([grads[n].float() for n in names], stacked)
        dim = lf.zero_dim()
        if dim is not None:
            g = C.reduce_scatter(g, mesh, "data", dim)
        free = lf.free(mesh)
        g = C.all_reduce(g, mesh, free)
        reduced[key] = g
        sq += g.square().sum() / math.prod(mesh.shape[a] for a in free)
    gnorm = torch.sqrt(C.all_reduce(sq, mesh, mesh.axis_names))
    scale = _clip(cfg, gnorm)
    for key, names in groups.items():
        lf = layout[names[0]]
        stacked = lf.layer is not None
        held = [n for n in names if n in state["m"]]
        m = _stack([state["m"][n] for n in held], stacked)
        v = _stack([state["v"][n] for n in held], stacked)
        p = _stack([leaves[n].detach() for n in names], stacked)
        dim = lf.zero_dim()
        if dim is not None:
            n = p.shape[dim] // mesh.shape["data"]
            p = p.narrow(dim, mesh.coords["data"] * n, n)
        new = _adamw(cfg, reduced.pop(key) * scale, m, v, p.float(),
                     len(lf.shape) >= 2, lr, c1, c2).to(p.dtype)
        if dim is not None:
            new = C.all_gather(new, mesh, "data", dim)
        for i, name in enumerate(held):
            if stacked:
                state["m"][name].copy_(m[i])
                state["v"][name].copy_(v[i])
        for i, name in enumerate(names):
            leaves[name].copy_(new[i] if stacked else new)
    return gnorm
