"""mind [arXiv:1904.08030]: embed_dim=64, 4 interests, 3 capsule routing
iterations, multi-interest retrieval.
The numbers of ``src/repro/configs/mind.py``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import shapes
from repro_torch.configs.registry import ArchDef, register
from repro_torch.models.recsys.mind import MINDConfig


def model_cfg(shape: str | None = None) -> MINDConfig:
    return MINDConfig()


def reduced():
    cfg = MINDConfig(item_vocab=500, seq_len=10)

    def batch():
        rng = np.random.default_rng(8)
        return {
            "hist_items": rng.integers(0, 500, (8, 10), dtype=np.int32),
            "hist_mask": (rng.random((8, 10)) < 0.9).astype(np.float32),
            "target_item": rng.integers(0, 500, 8, dtype=np.int32),
        }

    return cfg, batch


register(ArchDef(
    arch_id="mind", family="recsys", shapes=shapes.RECSYS_SHAPES,
    model_cfg=model_cfg, reduced=reduced,
))
