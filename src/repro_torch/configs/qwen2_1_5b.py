"""qwen2-1.5b [arXiv:2407.10671]: 28L d=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA with QKV bias, tied embeddings (the numbers of
``src/repro/configs/qwen2_1_5b.py``).  12 query heads don't divide the
16-way model axis -> FSDP (ZeRO-3) profile."""
from __future__ import annotations

import numpy as np

from repro_torch.configs import shapes
from repro_torch.configs.registry import ArchDef, register
from repro_torch.models.transformer_lm import LMConfig


def model_cfg(shape: str | None = None) -> LMConfig:
    return LMConfig(
        name="qwen2-1.5b", n_layers=28, d_model=1536, n_q=12, n_kv=2,
        d_head=128, d_ff=8960, vocab=151936, qkv_bias=True,
        tie_embeddings=True, rope_theta=1e6,
        sharding_profile="fsdp",
    )


def reduced():
    cfg = LMConfig(
        name="qwen2-smoke", n_layers=2, d_model=64, n_q=4, n_kv=2, d_head=16,
        d_ff=128, vocab=512, qkv_bias=True, tie_embeddings=True,
    )

    def batch():
        rng = np.random.default_rng(0)
        t = rng.integers(0, cfg.vocab, (2, 32), dtype=np.int32)
        return {"tokens": t, "targets": t}

    return cfg, batch


register(ArchDef(
    arch_id="qwen2-1.5b", family="lm", shapes=shapes.LM_SHAPES,
    model_cfg=model_cfg, reduced=reduced, train_microbatches=4,
))
