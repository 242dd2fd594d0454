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
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


class ParamTree(nn.Module):
    """A tree of zero-filled parameters from a tree of shapes (dicts,
    lists and tuples of ints), all of ``dtype`` on ``device``."""

    def __init__(self, shapes: dict, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        for key, node in shapes.items():
            if isinstance(node, dict):
                self.add_module(key, ParamTree(node, dtype, device))
            elif isinstance(node, list):
                self.add_module(key, nn.ModuleList(
                    ParamTree(n, dtype, device) for n in node))
            else:
                self.register_parameter(key, nn.Parameter(
                    torch.zeros(node, dtype=dtype, device=device),
                    requires_grad=False))


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
    zero."""
    scales = scales or {}
    for name, p in tree.named_parameters():
        if name in scales:
            scale = scales[name]
        elif p.dim() >= 2:
            scale = p.shape[0] ** -0.5
        else:
            continue
        p.copy_(normal(generator, p.shape, scale))
    return tree


@torch.no_grad()
def load_arrays(tree: nn.Module, arrays) -> nn.Module:
    """Copies ``arrays`` (the JAX tree: dicts and lists of array-likes)
    into ``tree``'s parameters, each cast to its parameter's dtype."""
    for name, p in tree.named_parameters():
        node = arrays
        for part in name.split("."):
            node = node[int(part)] if isinstance(node, (list, tuple)) \
                else node[part]
        a = np.array(node, np.float32)
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: array of shape {a.shape} for a "
                             f"parameter of shape {tuple(p.shape)}")
        p.copy_(torch.from_numpy(a))
    return tree


def to_arrays(tree: nn.Module):
    """The JAX tree of ``tree``'s parameters as float32 numpy arrays (the
    inverse of :func:`load_arrays`)."""
    if isinstance(tree, nn.ModuleList):
        return [to_arrays(m) for m in tree]
    out = {n: p.detach().float().cpu().numpy()
           for n, p in tree.named_parameters(recurse=False)}
    out.update({n: to_arrays(m) for n, m in tree.named_children()})
    return out
