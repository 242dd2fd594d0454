"""internlm2-1.8b [arXiv:2403.17297]: 24L d=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 — GQA (the numbers of
``src/repro/configs/internlm2_1_8b.py``).  16 q-heads divide 16 -> TP
profile."""
from __future__ import annotations

import numpy as np

from repro_torch.configs import shapes
from repro_torch.configs.registry import ArchDef, register
from repro_torch.models.transformer_lm import LMConfig


def model_cfg(shape: str | None = None) -> LMConfig:
    return LMConfig(
        name="internlm2-1.8b", n_layers=24, d_model=2048, n_q=16, n_kv=8,
        d_head=128, d_ff=8192, vocab=92544, rope_theta=1e6,
        sharding_profile="tp",
    )


def reduced():
    cfg = LMConfig(
        name="internlm2-smoke", n_layers=2, d_model=64, n_q=4, n_kv=2,
        d_head=16, d_ff=128, vocab=512,
    )

    def batch():
        rng = np.random.default_rng(2)
        t = rng.integers(0, cfg.vocab, (2, 32), dtype=np.int32)
        return {"tokens": t, "targets": t}

    return cfg, batch


register(ArchDef(
    arch_id="internlm2-1.8b", family="lm", shapes=shapes.LM_SHAPES,
    model_cfg=model_cfg, reduced=reduced, train_microbatches=4,
))
