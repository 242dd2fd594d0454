"""Shared utilities: device policy, the LMs' default dtype, the card's stamp,
registries, the bounded LRU and the bucket-ladder rule the engine and the
serving scheduler share, integer helpers and the top-k rule every ranking
on the sparse path follows."""
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


def on_card(device):
    """A context in which ``device`` is the current CUDA device (nothing
    for another device type): an operation that names no device, each
    stream it takes, and a kernel's C entry (its attributes, descriptors
    and launch) then belong to that card, whichever card the caller has
    made current."""
    import contextlib
    device = torch.device(device)
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def card() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` reports
    them: the stamp every time measured on the card carries."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


class Registry:
    """Minimal name → factory registry (weighting models, archs, ...)."""

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

    def names(self) -> list[str]:
        return sorted(self._entries)


# ---------------------------------------------------------------------------
# bounded LRU mapping (engine jit/chunk caches, serve-layer stage cache)
# ---------------------------------------------------------------------------


class LRU:
    """Bounded insertion/access-ordered mapping with eviction + hit counters.

    ``maxsize=None`` disables the bound (plain dict semantics).  A long-lived
    server touches arbitrarily many (stage, bucket, signature) cache keys, so
    every cache on that path must be bounded or it leaks; the counters feed
    ``cache_info()``-style accessors.

    Thread-safe: the serving layer explicitly supports one cache shared by
    several running servers, and both ``get`` (pop + re-insert) and ``put``
    (insert + evict-oldest) are compound — two racing evictions would pop
    the same oldest key and the loser would KeyError without the lock.
    The lock is reentrant because weakref death callbacks (the engine's
    chunk cache evicts entries when their source array dies) may fire from
    GC triggered *inside* a locked method on the same thread.
    """

    def __init__(self, maxsize: int | None = None):
        import threading
        self.maxsize = maxsize
        self._d: dict = {}
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, default=None):
        with self._lock:
            try:
                v = self._d.pop(key)
            except KeyError:
                self.misses += 1
                return default
            self._d[key] = v      # re-insert = move to most-recent
            self.hits += 1
            return v

    def put(self, key, value) -> None:
        with self._lock:
            self._d.pop(key, None)
            self._d[key] = value
            if self.maxsize is not None:
                while len(self._d) > self.maxsize:
                    self._d.pop(next(iter(self._d)), None)
                    self.evictions += 1

    def pop(self, key, default=None):
        with self._lock:
            return self._d.pop(key, default)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, key) -> bool:   # no LRU touch, no counter bump
        with self._lock:
            return key in self._d

    def values(self) -> list:
        """Snapshot copy — a live dict view would raise if another thread
        inserts mid-iteration (stats readers race the serving thread)."""
        with self._lock:
            return list(self._d.values())

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def info(self) -> dict:
        with self._lock:
            return {"size": len(self._d), "maxsize": self.maxsize,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


# ---------------------------------------------------------------------------
# bucket ladder policy (shared by the engine and the serving scheduler)
# ---------------------------------------------------------------------------


def select_ladder_bucket(ladder, n: int, *, clamp: bool = False) -> int:
    """Smallest rung of a sorted bucket ``ladder`` covering an ``n``-query
    micro-batch.  This is THE ladder policy — the engine's padding rule and
    the serving scheduler's batch-closure rule are the same function, so
    the two can never drift.  ``clamp=True`` returns the largest rung for
    oversized ``n`` (schedulers report a bucket for any batch they could
    close); ``clamp=False`` raises (the engine chunk-plans big batches
    instead of silently truncating them)."""
    if n <= 0:
        raise ValueError("empty query batch")
    for b in ladder:
        if b >= n:
            return int(b)
    if clamp:
        return int(ladder[-1])
    raise ValueError(
        f"micro-batch of {n} exceeds largest bucket {ladder[-1]}; "
        f"split it (run() chunk-plans big batches automatically)")


# ---------------------------------------------------------------------------
# nests of tensors (the pytrees the engine and the serving layer move)
# ---------------------------------------------------------------------------


def tree_flatten(tree) -> tuple[list, Any]:
    """(leaves, structure) of a nest of dicts, tuples and lists; ``None``
    is an empty node, anything else a leaf.  :func:`tree_unflatten` with
    the structure rebuilds the nest from new leaves."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys, leaves, subs = list(tree), [], []
        for k in keys:
            lv, s = tree_flatten(tree[k])
            leaves += lv
            subs.append((len(lv), s))
        return leaves, ("dict", keys, subs)
    if isinstance(tree, (tuple, list)):
        leaves, subs = [], []
        for x in tree:
            lv, s = tree_flatten(x)
            leaves += lv
            subs.append((len(lv), s))
        return leaves, (type(tree), None, subs)
    return [tree], "leaf"


def tree_unflatten(struct, leaves: list):
    if struct is None:
        return None
    if struct == "leaf":
        return leaves[0]
    kind, keys, subs = struct
    parts, i = [], 0
    for n, s in subs:
        parts.append(tree_unflatten(s, leaves[i:i + n]))
        i += n
    if kind == "dict":
        return dict(zip(keys, parts))
    return kind(parts)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, nests of the same structure), in a nest of that structure."""
    leaves, struct = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(struct, [fn(*xs) for xs in zip(leaves, *others)])


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
