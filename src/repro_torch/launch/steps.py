"""The model-FLOP formulas of every family and the recsys input table (the
first part of the port of ``src/repro/launch/steps.py``).

``chip_smoke.py`` reads them to make the zoo's batches at a shape cell and
to price a step against the card's fp32 rate.  The reference's
``StepBundle`` and ``build_bundle`` (a jittable step with its abstract
inputs and shardings) wait for the rest of ``launch/*`` (ROADMAP §1 item
4).
"""
from __future__ import annotations

import torch

#: an input's (shape, dtype)
Spec = tuple[tuple[int, ...], torch.dtype]


def _lm_model_flops(cfg, tokens: int, kind: str) -> float:
    n = cfg.params_active
    return (6.0 if kind == "train" else 2.0) * n * tokens


def _gnn_flops(cfg, n_nodes: int, n_edges: int) -> float:
    # dense projections + edge messages, fwd+bwd (×3 of fwd)
    f = 0.0
    d_in = cfg.d_feat
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        h = 1 if last else cfg.n_heads
        fdim = cfg.n_classes if last else cfg.d_hidden
        f += 2.0 * n_nodes * d_in * h * fdim      # X @ W
        f += 4.0 * n_edges * h * fdim             # messages + weighting
        d_in = h * fdim
    return 3.0 * f


def _recsys_inputs(arch_id: str, cfg, B: int) -> dict[str, Spec]:
    """The inputs of a recsys arch's batch of ``B`` rows: name -> (shape,
    dtype)."""
    i32, f32 = torch.int32, torch.float32
    if arch_id == "dcn-v2":
        return {"dense": ((B, cfg.n_dense), f32),
                "cat": ((B, cfg.n_sparse), i32),
                "label": ((B,), i32)}
    if arch_id == "autoint":
        return {"cat": ((B, cfg.n_sparse), i32),
                "label": ((B,), i32)}
    if arch_id == "dien":
        return {"hist_items": ((B, cfg.seq_len), i32),
                "hist_cates": ((B, cfg.seq_len), i32),
                "hist_mask": ((B, cfg.seq_len), f32),
                "target_item": ((B,), i32),
                "target_cate": ((B,), i32),
                "label": ((B,), i32)}
    if arch_id == "mind":
        return {"hist_items": ((B, cfg.seq_len), i32),
                "hist_mask": ((B, cfg.seq_len), f32),
                "target_item": ((B,), i32)}
    raise ValueError(arch_id)


def _recsys_flops(arch_id: str, cfg, B: int, kind: str) -> float:
    mult = 3.0 if kind == "train" else 1.0
    if arch_id == "dcn-v2":
        d = cfg.d_input
        f = cfg.n_cross_layers * 2 * d * d + 2 * d * cfg.mlp[0] + \
            2 * cfg.mlp[0] * cfg.mlp[1] + 2 * cfg.mlp[1] * cfg.mlp[2]
        return mult * B * f
    if arch_id == "autoint":
        F, dh = cfg.n_sparse, cfg.n_heads * cfg.d_attn
        f = cfg.n_attn_layers * (3 * 2 * F * cfg.embed_dim * dh +
                                 2 * 2 * F * F * dh)
        return mult * B * f
    if arch_id == "dien":
        h = cfg.gru_dim
        f = cfg.seq_len * 2 * 3 * ((cfg.d_behav + h) * h +   # GRU-1
                                   (h + h) * h)              # AUGRU
        return mult * B * f
    if arch_id == "mind":
        if kind == "retrieval":   # interests computed once; per-candidate dot
            return 2.0 * B * cfg.n_interests * cfg.embed_dim
        f = cfg.capsule_iters * 4 * cfg.seq_len * cfg.embed_dim * \
            cfg.n_interests + 2 * cfg.seq_len * cfg.embed_dim ** 2
        return mult * B * f
    raise ValueError(arch_id)
