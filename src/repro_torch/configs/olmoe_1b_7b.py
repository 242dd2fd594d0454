"""olmoe-1b-7b [arXiv:2409.02060]: 16L d=2048 16H (kv=16) d_ff=1024,
MoE 64e top-8, vocab=50304 (the numbers of
``src/repro/configs/olmoe_1b_7b.py``).  16 heads divide 16 -> TP attention +
EP experts."""
from __future__ import annotations

import numpy as np

from repro_torch.configs import shapes
from repro_torch.configs.registry import ArchDef, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer_lm import LMConfig


def model_cfg(shape: str | None = None) -> LMConfig:
    return LMConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_q=16, n_kv=16,
        d_head=128, d_ff=1024, vocab=50304, rope_theta=1e4,
        moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024,
                      router_act="softmax", normalize_gates=True,
                      dispatch="scatter"),
        sharding_profile="tp",
    )


def reduced():
    cfg = LMConfig(
        name="olmoe-smoke", n_layers=2, d_model=64, n_q=4, n_kv=4, d_head=16,
        d_ff=64, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
    )

    def batch():
        rng = np.random.default_rng(4)
        t = rng.integers(0, cfg.vocab, (2, 32), dtype=np.int32)
        return {"tokens": t, "targets": t}

    return cfg, batch


register(ArchDef(
    arch_id="olmoe-1b-7b", family="lm", shapes=shapes.LM_SHAPES,
    model_cfg=model_cfg, reduced=reduced, train_microbatches=4,
))
