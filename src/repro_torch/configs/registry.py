"""Architecture registry: ``--arch <id>`` resolution for all 10 archs of
the JAX package (the port of ``src/repro/configs/registry.py``): the five
LMs, gat-cora and the four recsys models."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

from repro_torch.common import Registry

ARCHS = Registry("architecture")


@dataclasses.dataclass(frozen=True, kw_only=True)
class ArchDef:
    """One selectable architecture with its shape cells.

    ``model_cfg(shape_name)`` may specialise the config per shape (the GNN
    cells carry their own feature/class counts); ``reduced()`` returns a
    small same-family config + a host-side batch factory for smoke tests.
    ``module`` is the model module of the family (a recsys arch's own).
    ``train_microbatches`` is the gradient accumulation of its train cells
    (``launch/steps.py``).
    """

    arch_id: str
    family: str                                   # "lm" | "gnn" | "recsys"
    shapes: dict[str, dict]
    model_cfg: Callable[[str], Any]
    reduced: Callable[[], tuple[Any, Callable[[], dict]]]
    train_microbatches: int = 1                   # grad-accum for train cells

    @property
    def module(self):
        mod = {
            "lm": "repro_torch.models.transformer_lm",
            "gnn": "repro_torch.models.gnn",
        }.get(self.family)
        if mod is None:  # recsys: per-arch module (dcn-v2 -> dcn, ...)
            mod = f"repro_torch.models.recsys.{self.arch_id.split('-')[0]}"
        return importlib.import_module(mod)


def register(arch: ArchDef) -> ArchDef:
    ARCHS.register(arch.arch_id, arch)
    return arch


def get_arch(arch_id: str) -> ArchDef:
    _ensure_loaded()
    return ARCHS[arch_id]


def all_arch_ids() -> list[str]:
    _ensure_loaded()
    return ARCHS.names()


_LOADED = False

_CONFIG_MODULES = [
    "repro_torch.configs.qwen2_1_5b",
    "repro_torch.configs.glm4_9b",
    "repro_torch.configs.internlm2_1_8b",
    "repro_torch.configs.llama4_scout_17b_a16e",
    "repro_torch.configs.olmoe_1b_7b",
    "repro_torch.configs.gat_cora",
    "repro_torch.configs.dcn_v2",
    "repro_torch.configs.dien",
    "repro_torch.configs.mind",
    "repro_torch.configs.autoint",
]


def _ensure_loaded():
    global _LOADED
    if not _LOADED:
        for m in _CONFIG_MODULES:
            importlib.import_module(m)
        _LOADED = True
