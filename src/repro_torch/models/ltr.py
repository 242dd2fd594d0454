"""The learning-to-rank model of the ``LTRRerank`` stage: a one-hidden-layer
tanh MLP over a candidate's feature columns, trained on the pairwise
logistic loss over the pairs of a query's candidates (the port of the model
and loss inside ``LTRRerank`` in ``src/repro/core/stages.py``).

Its parameters keep the JAX stage's ``state`` names (``w1`` [F, H], ``b1``
[H], ``w2`` [H, 1]); :func:`ltr_state_from_arrays` carries a JAX state
across, so both packages score with one function.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.common import resolve_device


class LTRModel(nn.Module):
    """``score(feats) = tanh(feats @ w1 + b1) @ w2`` over feats [..., F]."""

    def __init__(self, n_features: int, hidden: int, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.w1 = nn.Parameter(torch.zeros((n_features, hidden),
                                           dtype=torch.float32, device=dev))
        self.b1 = nn.Parameter(torch.zeros((hidden,), dtype=torch.float32,
                                           device=dev))
        self.w2 = nn.Parameter(torch.zeros((hidden, 1), dtype=torch.float32,
                                           device=dev))

    @property
    def device(self) -> torch.device:
        return self.w1.device

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(feats @ self.w1 + self.b1)
        return (h @ self.w2)[..., 0]


def init_state(n_features: int, hidden: int,
               generator: torch.Generator) -> LTRModel:
    """A fresh draw on the generator's device: standard normal weights
    scaled by 1/sqrt(fan-in) and a zero bias, the JAX stage's
    distribution."""
    m = LTRModel(n_features, hidden, device=generator.device)
    with torch.no_grad():
        for p in (m.w1, m.w2):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device)
                    / math.sqrt(p.shape[0]))
    return m


def ltr_state_from_arrays(tree: dict, device=None) -> LTRModel:
    """The model whose parameters are ``tree`` (the JAX stage's ``state``:
    ``w1``, ``b1``, ``w2`` as numpy or array-like leaves), in float32 on
    ``device`` (``None`` = the card)."""
    w1 = np.asarray(tree["w1"], np.float32)
    m = LTRModel(w1.shape[0], w1.shape[1], device=device)
    with torch.no_grad():
        for name in ("w1", "b1", "w2"):
            getattr(m, name).copy_(torch.from_numpy(
                np.array(tree[name], np.float32)))
    return m


def pairwise_loss(scores: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Mean pairwise logistic loss ``log(1 + exp(-(s_i - s_j)))`` over the
    pairs (i, j) of a query's valid candidates with label_i > label_j;
    scores / labels / valid [NQ, K].  ``torch.logaddexp`` is the
    reference's ``jnp.logaddexp`` (``softplus`` thresholds, and so is
    another function)."""
    ds = scores[:, :, None] - scores[:, None, :]
    dl = labels[:, :, None] - labels[:, None, :]
    pair = (dl > 0) & valid[:, :, None] & valid[:, None, :]
    losses = torch.logaddexp(torch.zeros((), device=ds.device), -ds) * pair
    return losses.sum() / pair.sum().clamp(min=1)
