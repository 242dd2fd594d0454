"""Shared utilities: device policy, the LMs' default dtype, the card's stamp,
registries, integer helpers and the top-k rule every ranking on the sparse
path follows."""
from __future__ import annotations

import subprocess
from typing import Any

import torch

#: default parameter / activation dtype of the LMs; fp32 is kept for the
#: softmax and the normalisation statistics
DEFAULT_DTYPE = torch.bfloat16


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.  ``None`` means the card: it
    raises when CUDA is absent instead of carrying on quietly on the CPU
    (callers that want the CPU ask for it, as the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def card() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` reports
    them: the stamp every time measured on the card carries."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


class Registry:
    """Minimal name → factory registry (weighting models, ...)."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, Any] = {}

    def register(self, name: str, obj: Any = None):
        if obj is not None:
            self._entries[name] = obj
            return obj

        def deco(fn):
            self._entries[name] = fn
            return fn

        return deco

    def __getitem__(self, name: str) -> Any:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} {name!r}; known: {sorted(self._entries)}")
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


#: the integer type of each float type's bits
_BITS = {torch.float16: torch.int16, torch.bfloat16: torch.int16,
         torch.float32: torch.int32, torch.float64: torch.int64}


def order_key(x: torch.Tensor) -> torch.Tensor:
    """``x``'s floats as integers in the ``lax.top_k`` order: a larger
    float gets a larger integer, and -0.0 lies just below +0.0 (a float
    comparison ties them).  The kernels' ``order_key`` is the same map."""
    bits = _BITS.get(x.dtype)
    if bits is None:
        return x
    i = x.view(bits)
    # a negative float's magnitude bits flipped: the larger its magnitude,
    # the lower its integer
    return i ^ ((i >> (8 * x.element_size() - 1)) &
                torch.iinfo(bits).max)


def topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last axis with the ``lax.top_k`` rule: values
    sorted descending, -0.0 below +0.0, ties going to the lowest index.
    ``torch.topk`` promises no tie order on CUDA, so this is a stable
    descending sort of ``order_key(x)`` — the plain version of the top-k
    kernels and the rule of every other top-k on the sparse path.  Returns
    (values, int64 indices)."""
    _, idx = torch.sort(order_key(x), dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return x.gather(-1, idx), idx
