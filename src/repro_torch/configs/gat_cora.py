"""gat-cora [arXiv:1710.10903]: 2-layer GAT, 8 hidden per head, 8 heads,
attention aggregator.  Feature/class dims follow the dataset of each shape
cell (Cora / Reddit / ogbn-products / molhiv-like molecules).
The numbers of ``src/repro/configs/gat_cora.py``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import shapes
from repro_torch.configs.registry import ArchDef, register
from repro_torch.models.gnn import GATConfig


def model_cfg(shape: str | None = None) -> GATConfig:
    cell = shapes.GNN_SHAPES.get(shape or "full_graph_sm",
                                 shapes.GNN_SHAPES["full_graph_sm"])
    return GATConfig(
        name="gat-cora", n_layers=2, d_hidden=8, n_heads=8,
        d_feat=cell["d_feat"], n_classes=cell["n_classes"],
        readout=cell.get("readout"),
    )


def reduced():
    cfg = GATConfig(name="gat-smoke", n_layers=2, d_hidden=8, n_heads=4,
                    d_feat=16, n_classes=5)

    def batch():
        rng = np.random.default_rng(5)
        return {
            "x": rng.standard_normal((64, 16), dtype=np.float32),
            "src": rng.integers(0, 64, 256, dtype=np.int32),
            "dst": rng.integers(0, 64, 256, dtype=np.int32),
            "labels": rng.integers(0, 5, 64, dtype=np.int32),
            "label_mask": np.ones(64, bool),
        }

    return cfg, batch


register(ArchDef(
    arch_id="gat-cora", family="gnn", shapes=shapes.GNN_SHAPES,
    model_cfg=model_cfg, reduced=reduced,
))
