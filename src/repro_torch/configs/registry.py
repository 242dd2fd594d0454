"""Architecture registry: ``--arch <id>`` resolution (the port of
``src/repro/configs/registry.py``).

The port registers the five LM archs of the JAX package.  The recsys and
GNN archs (gat-cora, dcn-v2, dien, mind, autoint) wait for the model zoo
(ROADMAP §1 item 3): :func:`get_arch` raises for them, naming it.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

from repro_torch.common import Registry

ARCHS = Registry("architecture")

#: the JAX package's archs the port has no model for yet
UNPORTED = {"gat-cora": "gnn", "dcn-v2": "recsys", "dien": "recsys",
            "mind": "recsys", "autoint": "recsys"}


@dataclasses.dataclass(frozen=True, kw_only=True)
class ArchDef:
    """One selectable architecture with its shape cells.

    ``model_cfg(shape_name)`` may specialise the config per shape;
    ``reduced()`` returns a small same-family config + a host-side batch
    factory for smoke tests.
    """

    arch_id: str
    shapes: dict[str, dict]
    model_cfg: Callable[[str], Any]
    reduced: Callable[[], tuple[Any, Callable[[], dict]]]


def register(arch: ArchDef) -> ArchDef:
    ARCHS.register(arch.arch_id, arch)
    return arch


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"{arch_id}: the {UNPORTED[arch_id]} archs are not ported yet "
            f"(ROADMAP §1 item 3, the model zoo)")
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
]


def _ensure_loaded():
    global _LOADED
    if not _LOADED:
        for m in _CONFIG_MODULES:
            importlib.import_module(m)
        _LOADED = True
