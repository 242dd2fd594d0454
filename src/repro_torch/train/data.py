"""Deterministic sharded data pipeline (``src/repro/train/data.py``,
numpy only, copied).

Determinism contract (required by StepGuard replay): batch ``t`` depends only
on (seed, step t, host shard) — a restored run re-reads exactly the batches
it would have seen.  Per-family synthetic generators with double-buffered
host prefetch.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np


def lm_batch_fn(vocab: int, batch: int, seq: int):
    def make(step: int, shard: int = 0, n_shards: int = 1) -> dict[str, np.ndarray]:
        b = batch // n_shards
        rng = np.random.default_rng((step * 1_000_003 + shard) & 0x7FFFFFFF)
        # zipf-ish tokens: realistic id skew for embedding-gather benches
        toks = (rng.zipf(1.3, (b, seq + 1)) - 1) % vocab
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return make


def recsys_batch_fn(make_inputs: Callable[[int, np.random.Generator], dict]):
    def make(step: int, shard: int = 0, n_shards: int = 1):
        rng = np.random.default_rng((step * 999_983 + shard) & 0x7FFFFFFF)
        return make_inputs(step, rng)
    return make


class DataPipeline:
    """Deterministic, replayable, prefetched iterator."""

    def __init__(self, batch_fn: Callable[..., dict], *, shard: int = 0,
                 n_shards: int = 1, prefetch: int = 2):
        self.batch_fn = batch_fn
        self.shard = shard
        self.n_shards = n_shards
        self.prefetch = prefetch

    def iter_from(self, step: int) -> Iterator[dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            s = step
            while not stop.is_set():
                b = self.batch_fn(s, self.shard, self.n_shards)
                q.put((s, b))
                s += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                _, b = q.get()
                yield b
        finally:
            stop.set()
            try:
                q.get_nowait()
            except queue.Empty:
                pass
