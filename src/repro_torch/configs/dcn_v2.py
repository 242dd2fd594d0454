"""dcn-v2 [arXiv:2008.13535]: 13 dense + 26 sparse (Criteo vocabs), dim-16
embeds, 3 cross layers, MLP 1024-1024-512.
The numbers of ``src/repro/configs/dcn_v2.py``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import shapes
from repro_torch.configs.registry import ArchDef, register
from repro_torch.models.recsys.dcn import DCNConfig


def model_cfg(shape: str | None = None) -> DCNConfig:
    return DCNConfig()


def reduced():
    cfg = DCNConfig(vocabs=(50,) * 26, mlp=(64, 64, 32))

    def batch():
        rng = np.random.default_rng(6)
        return {
            "dense": rng.standard_normal((16, 13), dtype=np.float32),
            "cat": rng.integers(0, 50, (16, 26), dtype=np.int32),
            "label": rng.integers(0, 2, 16, dtype=np.int32),
        }

    return cfg, batch


register(ArchDef(
    arch_id="dcn-v2", family="recsys", shapes=shapes.RECSYS_SHAPES,
    model_cfg=model_cfg, reduced=reduced,
))
