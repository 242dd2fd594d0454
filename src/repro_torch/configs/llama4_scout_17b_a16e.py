"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E]: 48L d=5120
40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1 + 1 shared expert,
chunked local attention (8192) on 3/4 layers (the numbers of
``src/repro/configs/llama4_scout_17b_a16e.py``).  40 heads don't divide
16 -> FSDP attention + expert parallelism over 'model'."""
from __future__ import annotations

import numpy as np

from repro_torch.configs import shapes
from repro_torch.configs.registry import ArchDef, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer_lm import LMConfig


def model_cfg(shape: str | None = None) -> LMConfig:
    return LMConfig(
        name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_q=40,
        n_kv=8, d_head=128, d_ff=8192, vocab=202048, rope_theta=5e5,
        attn_chunk=8192, attn_chunk_every=4,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1,
                      d_ff_shared=8192, router_act="sigmoid",
                      normalize_gates=False, dispatch="scatter"),
        sharding_profile="fsdp",
    )


def reduced():
    cfg = LMConfig(
        name="llama4-smoke", n_layers=2, d_model=64, n_q=4, n_kv=2, d_head=16,
        d_ff=128, vocab=512, attn_chunk=16, attn_chunk_every=2,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=64, n_shared=1,
                      d_ff_shared=64, router_act="sigmoid",
                      normalize_gates=False),
    )

    def batch():
        rng = np.random.default_rng(3)
        t = rng.integers(0, cfg.vocab, (2, 32), dtype=np.int32)
        return {"tokens": t, "targets": t}

    return cfg, batch


register(ArchDef(
    arch_id="llama4-scout-17b-a16e", family="lm", shapes=shapes.LM_SHAPES,
    model_cfg=model_cfg, reduced=reduced, train_microbatches=8,
))
