"""glm4-9b [hf:THUDM/glm-4-9b]: 40L d=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — RoPE, GQA (the numbers of ``src/repro/configs/glm4_9b.py``).
32 q-heads divide 16 -> TP profile, ``seq_parallel`` as the reference sets
it."""
from __future__ import annotations

import numpy as np

from repro_torch.configs import shapes
from repro_torch.configs.registry import ArchDef, register
from repro_torch.models.transformer_lm import LMConfig


def model_cfg(shape: str | None = None) -> LMConfig:
    return LMConfig(
        name="glm4-9b", n_layers=40, d_model=4096, n_q=32, n_kv=2,
        d_head=128, d_ff=13696, vocab=151552, rope_theta=1e6,
        sharding_profile="tp", seq_parallel=True,
    )


def reduced():
    cfg = LMConfig(
        name="glm4-smoke", n_layers=2, d_model=64, n_q=8, n_kv=2, d_head=16,
        d_ff=160, vocab=512,
    )

    def batch():
        rng = np.random.default_rng(1)
        t = rng.integers(0, cfg.vocab, (2, 32), dtype=np.int32)
        return {"tokens": t, "targets": t}

    return cfg, batch


register(ArchDef(
    arch_id="glm4-9b", family="lm", shapes=shapes.LM_SHAPES,
    model_cfg=model_cfg, reduced=reduced, train_microbatches=8,
))
