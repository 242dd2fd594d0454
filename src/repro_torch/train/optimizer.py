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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn


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


def init(params: Any) -> dict[str, Any]:
    leaves = named_leaves(params)
    device = next(iter(leaves.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in leaves.items()}

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for x in named_leaves(tree).values()))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Any, state: dict[str, Any], params: Any):
    """One AdamW step: the parameters of ``params`` and the moments of
    ``state`` are updated in place.  ``grads`` is a tree like ``params``
    (or a dict by dotted name).  Returns (params, new state, metrics
    {"grad_norm", "lr"})."""
    leaves, grads = named_leaves(params), named_leaves(grads)
    stacked = stacked_leaves(params)
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
             if cfg.grad_clip else 1.0)
    lr = schedule_lr(cfg, step)
    c1 = 1.0 - cfg.b1 ** step.to(torch.float32)
    c2 = 1.0 - cfg.b2 ** step.to(torch.float32)
    for name, p in leaves.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g.square())
        u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        p32 = p.float()
        if cfg.weight_decay and p.dim() + (name in stacked) >= 2:
            u = u + cfg.weight_decay * p32
        p.copy_(p32 - lr * u)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
