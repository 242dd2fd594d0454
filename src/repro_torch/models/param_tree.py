"""The model zoo's parameter trees, in the JAX package's layout.

The JAX package keeps a recsys or GNN model's weights as nested dicts and
lists of arrays (DCN-v2: ``{"table", "cross": [{"w", "b"}, ...], "mlp":
[...], "out": {"w", "b"}}``).  :class:`ParamTree` holds such a tree as an
``nn.Module``: a dict is a module whose attributes are its keys, a list an
``nn.ModuleList``, an array an ``nn.Parameter``, so ``named_parameters()``
gives the tree's paths as dotted names (``cross.0.w``).  Nothing is
stacked on a layer axis, so the optimizer decays exactly the leaves of two
axes or more, as the reference does on these trees.  Parameters are made
with ``requires_grad=False``, as the LMs' are; the trainer switches them
on.  :func:`load_arrays` and :func:`to_arrays` carry a tree of numpy
arrays across, both ways.

On a mesh (``launch/mesh.py``) a tree holds the rank's shards: each leaf
is cut by its spec, the reference's ``pspec_tree`` of the model's
``param_logical`` under the ``tp`` profile (:func:`param_specs`), each
owner module keeps its parameters' specs in ``shard_specs`` and the tree
keeps the mesh as ``.mesh``, as ``TransformerLM`` does, so that the
optimizer lays its moments out ZeRO-1 (``optimizer.mesh_layout``) and
the checkpoints save and restore the tree by :func:`state_specs`.  A
leaf is drawn or read whole and cut to the rank's shard (:func:`put`), so
every rank's shards are slices of the one-card tree.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch import sharding as sh
from repro_torch.common import resolve_device
from repro_torch.models.layers import gather_at_use


class ParamTree(nn.Module):
    """A tree of zero-filled parameters from a tree of shapes (dicts,
    lists and tuples of ints), all of ``dtype`` on ``device``.  With
    ``mesh``, the rank's shards by the specs of ``logical`` (the parallel
    nest of ``sharding.Ax`` leaves) under the ``tp`` profile, or by
    ``specs`` (a parallel nest of specs) when given."""

    def __init__(self, shapes: dict, dtype: torch.dtype,
                 device: torch.device, mesh=None, logical=None,
                 specs=None):
        super().__init__()
        if mesh is not None and specs is None:
            specs = sh.pspec_tree(shapes, logical, mesh, sh.tp_profile(mesh))
        self.mesh = mesh
        for key, node in shapes.items():
            spec = None if specs is None else specs[key]
            if isinstance(node, dict):
                self.add_module(key, ParamTree(node, dtype, device, mesh,
                                               specs=spec))
            elif isinstance(node, list):
                self.add_module(key, nn.ModuleList(
                    ParamTree(n, dtype, device, mesh, specs=s)
                    for n, s in zip(node, spec or [None] * len(node))))
            else:
                shape = node if mesh is None else \
                    sh.local_shape(spec, node, mesh)
                self.register_parameter(key, nn.Parameter(
                    torch.zeros(shape, dtype=dtype, device=device),
                    requires_grad=False))
                if mesh is not None:
                    self.__dict__.setdefault("shard_specs", {})[key] = spec


def device_of(device, mesh) -> torch.device:
    """``device``, or the mesh's when it is None and the mesh has one
    (``None`` without either: the card)."""
    if device is None and mesh is not None and mesh.device is not None:
        device = mesh.device
    return resolve_device(device)


def mesh_of(params, mesh):
    """The mesh a pass runs on: the one the parameters' shards were cut
    for (``mesh`` None or the same)."""
    held = getattr(params, "mesh", None)
    if mesh is not None and mesh is not held:
        raise ValueError(f"the parameters are sharded for {held}, not for "
                         f"{mesh}")
    return held


def param_specs(module, cfg, mesh) -> dict:
    """The spec of every leaf of ``module.param_shapes(cfg)`` on ``mesh``
    (a zoo model module: its ``param_logical`` under the ``tp`` profile,
    as the reference's ``launch/steps.py`` lays the zoo out)."""
    return sh.pspec_tree(module.param_shapes(cfg), module.param_logical(cfg),
                         mesh, sh.tp_profile(mesh))


def state_specs(module, cfg, mesh) -> dict:
    """The reference's shardings of a zoo train state on ``mesh`` (its
    ``_abstract_state``): the parameters by :func:`param_specs`, the
    moments by ``zero1_sharding_tree`` of them, the step replicated."""
    pspecs = param_specs(module, cfg, mesh)
    moments = sh.zero1_sharding_tree(module.param_shapes(cfg), pspecs, mesh)
    return {"params": pspecs,
            "opt": {"m": moments, "v": moments, "step": sh.P()}}


def leaf_spec(tree: nn.Module, name: str):
    """The spec of parameter ``name`` (a dotted name) of a tree on a
    mesh."""
    owner, _, leaf = name.rpartition(".")
    return tree.get_submodule(owner).shard_specs[leaf]


def whole_shape(tree: nn.Module, name: str) -> tuple[int, ...]:
    """The shape of the whole leaf of parameter ``name``."""
    p = tree.get_parameter(name)
    mesh = tree.mesh
    if mesh is None:
        return tuple(p.shape)
    spec = leaf_spec(tree, name)
    return tuple(n * math.prod(mesh.shape[a] for a in sh.spec_axes(spec, i))
                 for i, n in enumerate(p.shape))


@torch.no_grad()
def put(tree: nn.Module, name: str, full: torch.Tensor) -> None:
    """Copy ``full``, the whole leaf of parameter ``name``, into ``tree``:
    whole, or on a mesh the rank's slice of it."""
    p = tree.get_parameter(name)
    mesh = tree.mesh
    if mesh is not None:
        full = full[sh.local_slices(leaf_spec(tree, name), full.shape, mesh,
                                    mesh.coords)]
    p.copy_(full)


def normal(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    """N(0, 1) x ``scale`` in fp32, drawn on the generator's device."""
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device) * scale


@torch.no_grad()
def init_normal(tree: nn.Module, generator: torch.Generator,
                scales: dict[str, float] | None = None) -> nn.Module:
    """The reference's draw for the recsys models: each leaf of two axes or
    more N(0, 1) x fan_in^-0.5 (its first axis), a leaf named in
    ``scales`` N(0, 1) x that scale; the other 1-D leaves (the biases) stay
    zero.  Each leaf is drawn whole (:func:`put`)."""
    scales = scales or {}
    for name, _ in tree.named_parameters():
        shape = whole_shape(tree, name)
        if name in scales:
            scale = scales[name]
        elif len(shape) >= 2:
            scale = shape[0] ** -0.5
        else:
            continue
        put(tree, name, normal(generator, shape, scale))
    return tree


@torch.no_grad()
def load_arrays(tree: nn.Module, arrays) -> nn.Module:
    """Copies ``arrays`` (the JAX tree: dicts and lists of array-likes)
    into ``tree``'s parameters, each cast to its parameter's dtype (on a
    mesh, the rank's slice of each)."""
    for name, _ in tree.named_parameters():
        node = arrays
        for part in name.split("."):
            node = node[int(part)] if isinstance(node, (list, tuple)) \
                else node[part]
        a = np.array(node, np.float32)
        want = whole_shape(tree, name)
        if a.shape != want:
            raise ValueError(f"{name}: array of shape {a.shape} for a "
                             f"parameter of shape {want}")
        put(tree, name, torch.from_numpy(a))
    return tree


def to_arrays(tree: nn.Module):
    """The JAX tree of ``tree``'s parameters as float32 numpy arrays (the
    inverse of :func:`load_arrays`); on a mesh each leaf is gathered whole
    from the ranks' shards, so every rank calls it."""
    if isinstance(tree, nn.ModuleList):
        return [to_arrays(m) for m in tree]
    out = {}
    for n, p in tree.named_parameters(recurse=False):
        p = p.detach()
        if tree.mesh is not None:
            p = gather_at_use(p, tree.shard_specs[n], tree.mesh)
        out[n] = p.float().cpu().numpy()
    out.update({n: to_arrays(m) for n, m in tree.named_children()})
    return out
