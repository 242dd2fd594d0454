"""autoint [arXiv:1810.11921]: 39 sparse fields, dim-16 embeds, 3 self-attn
interacting layers, 2 heads, d_attn=32.
The numbers of ``src/repro/configs/autoint.py``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import shapes
from repro_torch.configs.registry import ArchDef, register
from repro_torch.models.recsys.autoint import AutoIntConfig


def model_cfg(shape: str | None = None) -> AutoIntConfig:
    return AutoIntConfig()


def reduced():
    cfg = AutoIntConfig(vocabs=(50,) * 39)

    def batch():
        rng = np.random.default_rng(9)
        return {
            "cat": rng.integers(0, 50, (16, 39), dtype=np.int32),
            "label": rng.integers(0, 2, 16, dtype=np.int32),
        }

    return cfg, batch


register(ArchDef(
    arch_id="autoint", family="recsys", shapes=shapes.RECSYS_SHAPES,
    model_cfg=model_cfg, reduced=reduced,
))
