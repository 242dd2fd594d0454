"""Gradient compression for slow interconnects (the port of
``src/repro/train/compression.py``).

Two standard schemes, both with error feedback (the residual is carried so
compression error doesn't bias the optimizer — Karimireddy et al.):

* int8 quantisation — per-tensor scale, 4x over fp32 (2x over bf16)
* top-k sparsification — keep the largest |g| entries (indices+values),
  ties to the lowest index (the ``lax.top_k`` rule, ``common.topk``)

Gradients are nested dicts of tensors.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.common import topk


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def quantize_int8(g: torch.Tensor):
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor):
    return q.to(torch.float32) * scale


def topk_sparsify(g: torch.Tensor, k_frac: float = 0.01):
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * k_frac))
    _, idx = topk(flat.abs(), k)
    return flat[idx], idx, tuple(g.shape)


def topk_densify(vals, idx, shape):
    flat = torch.zeros(math.prod(shape), dtype=vals.dtype, device=vals.device)
    flat[idx] = vals
    return flat.reshape(shape)


class ErrorFeedback:
    """Carry compression residuals across steps: g_t' = g_t + e_{t-1};
    e_t = g_t' - decompress(compress(g_t'))."""

    def __init__(self, scheme: str = "int8", k_frac: float = 0.01):
        assert scheme in ("int8", "topk")
        self.scheme = scheme
        self.k_frac = k_frac

    def init(self, grads: Any) -> Any:
        return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)

    def compress_decompress(self, grads: Any, residual: Any):
        """Returns (decompressed grads as seen after the wire, new
        residual); the wire format is materialised, so the traffic would be
        the compressed payload."""

        def one(g, e):
            gf = g.to(torch.float32) + e
            if self.scheme == "int8":
                out = dequantize_int8(*quantize_int8(gf))
            else:
                out = topk_densify(*topk_sparsify(gf, self.k_frac))
            return out, gf - out

        pairs = _map(one, grads, residual)
        return _map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs)

    def wire_bytes(self, grads: Any) -> tuple[int, int]:
        """(compressed, uncompressed fp32) bytes per step."""
        leaves = _leaves(grads)
        total = sum(x.numel() for x in leaves)
        if self.scheme == "int8":
            comp = total + 4 * len(leaves)
        else:
            comp = int(total * self.k_frac) * 8
        return comp, total * 4
