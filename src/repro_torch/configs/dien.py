"""dien [arXiv:1809.03672]: embed_dim=18, seq_len=100, GRU 108, MLP 200-80,
AUGRU interest evolution (Amazon-Electronics-sized vocabularies).
The numbers of ``src/repro/configs/dien.py``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import shapes
from repro_torch.configs.registry import ArchDef, register
from repro_torch.models.recsys.dien import DIENConfig


def model_cfg(shape: str | None = None) -> DIENConfig:
    return DIENConfig()


def reduced():
    cfg = DIENConfig(item_vocab=200, cate_vocab=20, seq_len=12, mlp=(32, 16))

    def batch():
        rng = np.random.default_rng(7)
        return {
            "hist_items": rng.integers(0, 200, (8, 12), dtype=np.int32),
            "hist_cates": rng.integers(0, 20, (8, 12), dtype=np.int32),
            "hist_mask": (rng.random((8, 12)) < 0.8).astype(np.float32),
            "target_item": rng.integers(0, 200, 8, dtype=np.int32),
            "target_cate": rng.integers(0, 20, 8, dtype=np.int32),
            "label": rng.integers(0, 2, 8, dtype=np.int32),
        }

    return cfg, batch


register(ArchDef(
    arch_id="dien", family="recsys", shapes=shapes.RECSYS_SHAPES,
    model_cfg=model_cfg, reduced=reduced,
))
