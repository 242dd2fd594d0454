"""Stage-keyed result cache for online traffic.

The experiment planner's trie shares pipeline *prefixes* across pipelines
within one batch execution; this cache shares them across *requests over
time*: every (pipeline prefix, source query) pair the server has executed
maps to the (Q, R) state flowing out of that prefix, so a repeated or
near-duplicate query resumes from the deepest cached prefix instead of
re-running the whole chain (cf. MacAvaney & Macdonald on precomputation
dominating pipeline cost).

Keys reuse the planner's machinery (`plan.chain_prefix_digests` chains the
stages' structural content keys; the query digest hashes the source row's
terms/weights).  ``qid`` is deliberately excluded from the digest — two
users issuing the same query share entries — and is re-stamped from the
requesting row when a cached value is served.

Values are nq==1 row slices of the stage-output nests, held as **host
numpy** arrays, as in the JAX package (the port of
``src/repro/serve/cache.py``): one device-to-host copy per stage output,
then row plumbing (slice one request out of a batch, re-stack rows into the
next batch) in plain numpy, not one small device operation per row.  The
store is LRU-bounded (``repro_torch.common.LRU``), so a long-lived
server's memory is capped regardless of traffic diversity.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.common import LRU, tree_map
from repro_torch.obs.metrics import MetricsRegistry


def query_digest(Q_row) -> str:
    """Content digest of a single query row's terms+weights (qid excluded:
    identical queries from different callers must share cache entries)."""
    h = hashlib.sha256()
    for name in ("terms", "weights"):
        a = np.asarray(Q_row[name])
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _restamp_qid(part, qid_arr):
    if part is None:
        return None
    out = dict(part)
    out["qid"] = qid_arr
    return out


class StageResultCache:
    """(prefix digest, query digest) -> (Q row, R row, writer) after that
    prefix.

    One cache instance may back several pipelines (one multi-tenant
    server, or several servers over a shared backend): two pipelines whose
    leading stages carry identical structural keys chain to identical
    prefix digests, so tenant B's request resumes from state tenant A
    computed.  ``writer`` records which pipeline stored each entry — a hit
    whose writer differs from the requester is a *cross-pipeline* prefix
    hit, surfaced per tenant in ``server.stats()``.
    """

    def __init__(self, maxsize: int | None = 4096,
                 registry: MetricsRegistry | None = None):
        self.lru = LRU(maxsize)
        self.enabled = maxsize is None or maxsize > 0
        self.metrics = registry if registry is not None else MetricsRegistry()
        # request-level counters: ONE hit or miss per lookup_deepest call
        # (the raw LRU counters would count every probed depth of the
        # chain, making 'hit rate' uninterpretable per request); kept as
        # registry series, surfaced as attributes for the legacy readers
        self._lookups = self.metrics.counter(
            "stage_cache_lookups_total",
            "request-level stage-cache lookups", ("result",))
        for r in ("hit", "miss", "cross_pipeline_hit"):
            self._lookups.touch((r,))

    @property
    def hits(self) -> int:
        return int(self._lookups.value(("hit",)))

    @property
    def misses(self) -> int:
        return int(self._lookups.value(("miss",)))

    @property
    def cross_pipeline_hits(self) -> int:
        """Hits served from an entry a *different* pipeline wrote (the
        online realisation of cross-pipeline prefix reuse)."""
        return int(self._lookups.value(("cross_pipeline_hit",)))

    # -- lookup -------------------------------------------------------------
    def lookup_deepest(self, prefix_digests, qdigest: str,
                       reader: str = ""):
        """Deepest cached prefix for this query: returns
        ``(depth, (Q_row, R_row), writer)`` where ``depth`` stages are
        already computed (0 = nothing cached, value/writer None).  Scans
        deep-to-shallow so a full-pipeline hit wins outright.  ``reader``
        names the requesting pipeline for cross-pipeline accounting."""
        if not self.enabled:
            return 0, None, None
        for depth in range(len(prefix_digests), 0, -1):
            key = (prefix_digests[depth - 1], qdigest)
            if key not in self.lru:      # counter-free probe
                continue
            val = self.lru.get(key)      # refreshes recency
            if val is not None:          # (may have raced an eviction)
                self._lookups.inc(labels=("hit",))
                Q_row, R_row, writer = val
                if writer != reader:
                    self._lookups.inc(labels=("cross_pipeline_hit",))
                return depth, (Q_row, R_row), writer
        self._lookups.inc(labels=("miss",))
        return 0, None, None

    def store(self, prefix_digest: str, qdigest: str, Q_row, R_row,
              writer: str = "") -> None:
        if self.enabled:
            self.lru.put((prefix_digest, qdigest), (Q_row, R_row, writer))

    # -- row plumbing (host-side numpy on purpose — see module docstring) ----
    @staticmethod
    def to_host(tree):
        """One device->host copy for each tensor of a batched nest; slice
        rows out of THIS, never out of the device tensors."""
        return tree_map(lambda x: x.detach().cpu().numpy()
                        if isinstance(x, torch.Tensor) else np.asarray(x),
                        tree)

    @staticmethod
    def row(tree, j: int):
        """Slice request ``j``'s nq==1 row out of a (host) batched nest.
        Copied, not a view: a view would pin the entire (padded) batch
        buffer for as long as the cache entry lives, and would alias the
        caller's result with the cache (an in-place mutation of a returned
        result must never rewrite what later hits serve)."""
        return tree_map(lambda x: np.asarray(x)[j:j + 1].copy(), tree)

    @staticmethod
    def stack_rows(rows):
        """Rebatch nq==1 host rows (inverse of :meth:`row`)."""
        if len(rows) == 1:
            return rows[0]
        return tree_map(lambda *xs: np.concatenate(xs, 0), *rows)

    @staticmethod
    def pad_rows(tree, pad: int):
        """Pad a host batch with ``pad`` copies of its last row, up to a
        ladder bucket.  Serving pads BEFORE stage execution so every stage
        only ever sees ladder-sized batches, the shapes warm-up made."""
        if pad <= 0 or tree is None:
            return tree
        return tree_map(
            lambda x: np.concatenate(
                [x, np.repeat(np.asarray(x)[-1:], pad, 0)], 0), tree)

    @staticmethod
    def to_device(tree, device):
        """A host nest as tensors on ``device`` (the stages' input)."""
        return tree_map(lambda x: torch.as_tensor(x, device=device), tree)

    @staticmethod
    def restamp_qids(Q, R, qids):
        """Overwrite the qid columns with the requesting rows' qids (cached
        entries carry the original submitter's qid)."""
        qid_arr = np.asarray(qids, np.int32)
        return _restamp_qid(Q, qid_arr), _restamp_qid(R, qid_arr)

    def info(self) -> dict:
        out = self.lru.info()
        out["hits"] = self.hits          # request-level, not per-depth
        out["misses"] = self.misses
        out["cross_pipeline_hits"] = self.cross_pipeline_hits
        return out
