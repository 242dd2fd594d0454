"""Trace aggregation for the serving layer: latency percentiles, batch and
cache-depth histograms, per-stage running means.

The server keeps a bounded ring of recent :class:`RequestTrace` records
(percentiles are computed over the ring) plus running counters that never
reset — so ``stats()`` is O(ring) and a week-old server doesn't hold a
week of traces.

The counters live in a :class:`~repro_torch.obs.metrics.MetricsRegistry`
(``serve_requests_total{tenant,outcome}``, ``serve_batch_size``,
``serve_cache_hit_depth_total{tenant,depth}``, ...): ``summary()`` keeps
its legacy dict shape but is a *view* over registry series, so the same
numbers are available as a Prometheus exposition via the server.
"""
from __future__ import annotations

import math
from collections import deque

from repro_torch.obs.metrics import MetricsRegistry


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a sequence; 0.0 when
    empty.  Deliberately simple/deterministic — bench JSON comparisons
    diff across hosts, so no interpolation scheme to disagree over.
    (True ceil, not round(x + .5): banker's rounding returns one rank too
    high on exact-integer ties, e.g. the median of two values.)"""
    xs = sorted(values)
    if not xs:
        return 0.0
    return _rank(xs, q)


def _rank(sorted_xs, q: float) -> float:
    rank = max(0, min(len(sorted_xs) - 1,
                      math.ceil(q / 100.0 * len(sorted_xs)) - 1))
    return float(sorted_xs[rank])


def latency_summary(latencies_ms) -> dict:
    """p50/p95/p99/max over one *single* sort — this runs under the
    trace-log lock, so a per-percentile re-sort was pure lock-hold time."""
    xs = sorted(latencies_ms)
    if not xs:
        return {"n": 0, "mean_ms": 0.0, "p50_ms": 0.0, "p95_ms": 0.0,
                "p99_ms": 0.0, "max_ms": 0.0}
    return {
        "n": len(xs),
        "mean_ms": round(sum(xs) / len(xs), 3),
        "p50_ms": round(_rank(xs, 50), 3),
        "p95_ms": round(_rank(xs, 95), 3),
        "p99_ms": round(_rank(xs, 99), 3),
        "max_ms": round(xs[-1], 3),
    }


#: per-tenant request outcomes tracked in ``serve_requests_total``
_OUTCOMES = ("served", "timed_out", "shed", "errors", "late")

#: batch sizes are small integers; powers of two to 1024 cover any pool
_BATCH_BUCKETS = tuple(float(2 ** i) for i in range(11))


class TraceLog:
    """Bounded trace ring + registry-backed scalar aggregates.

    Locked throughout: the serving thread records while monitoring threads
    call ``summary()`` — an unguarded deque/dict would raise
    "mutated during iteration" under continuous traffic.  The whole
    summary (ring scan *and* percentile reduction) builds under the lock,
    so a concurrent ``record()`` can never tear it."""

    def __init__(self, capacity: int = 2048,
                 registry: MetricsRegistry | None = None):
        import threading
        self._lock = threading.Lock()
        self.ring: deque = deque(maxlen=capacity)
        self.metrics = registry if registry is not None else MetricsRegistry()
        m = self.metrics
        self._requests = m.counter(
            "serve_requests_total", "request outcomes by tenant",
            ("tenant", "outcome"))
        self._batches = m.counter("serve_batches_total", "closed batches")
        self._batch_size = m.histogram(
            "serve_batch_size", "requests per closed batch",
            buckets=_BATCH_BUCKETS)
        self._hit_depth = m.counter(
            "serve_cache_hit_depth_total",
            "stage-cache hit depth (0 = no prefix reused)",
            ("tenant", "depth"))
        self._cross_hits = m.counter(
            "serve_cross_prefix_hits_total",
            "stage-cache hits on a prefix another pipeline populated",
            ("tenant",))
        self._lane_served = m.counter(
            "serve_lane_served_total", "completed requests per WFQ lane",
            ("lane",))
        self._stage_ms = m.histogram(
            "serve_stage_ms", "per-stage execution time", ("stage",))
        self._decoded = m.counter(
            "serve_decode_requests_total",
            "completed requests that decoded tokens")
        self._tokens = m.counter(
            "serve_decode_tokens_total", "tokens decoded")
        #: tenant (pipeline) name registration order; populated even for a
        #: single-pipeline server (one "default" entry)
        self._tenant_names: list[str] = []

    # -- registry-backed views (legacy attribute surface) --------------------
    @property
    def n_served(self) -> int:
        return self._outcome_total("served")

    @property
    def n_timed_out(self) -> int:
        return self._outcome_total("timed_out")

    @property
    def n_shed(self) -> int:
        return self._outcome_total("shed")

    @property
    def n_errors(self) -> int:
        return self._outcome_total("errors")

    @property
    def n_late(self) -> int:
        return self._outcome_total("late")

    @property
    def n_batches(self) -> int:
        return int(self._batches.value())

    @property
    def n_decoded(self) -> int:
        return int(self._decoded.value())

    @property
    def n_tokens_total(self) -> int:
        return int(self._tokens.value())

    def _outcome_total(self, outcome: str) -> int:
        return int(sum(v for (tenant, o), v in self._requests.series().items()
                       if o == outcome))

    # -- recording ----------------------------------------------------------
    def record_batch(self, size: int) -> None:
        with self._lock:
            self._batches.inc()
            self._batch_size.observe(float(size))

    def record_stage(self, label: str, ms: float) -> None:
        with self._lock:
            self._stage_ms.observe(ms, (label,))

    def register_tenant(self, name: str) -> None:
        """Pre-create a pipeline's counter series so ``summary()`` lists
        every attached tenant, traffic or not."""
        with self._lock:
            self._tenant(name)

    def _tenant(self, name: str) -> str:
        if name not in self._tenant_names:
            self._tenant_names.append(name)
            for o in _OUTCOMES:
                self._requests.touch((name, o))
            self._cross_hits.touch((name,))
        return name

    def record(self, trace) -> None:
        with self._lock:
            self.ring.append(trace)
            ten = self._tenant(trace.tenant or "default")
            if trace.timed_out:
                self._requests.inc(labels=(ten, "timed_out"))
                if trace.shed:
                    self._requests.inc(labels=(ten, "shed"))
                return
            if trace.errored:
                self._requests.inc(labels=(ten, "errors"))
                return
            self._requests.inc(labels=(ten, "served"))
            if trace.lane:
                self._lane_served.inc(labels=(trace.lane,))
            if trace.late:
                self._requests.inc(labels=(ten, "late"))
            self._hit_depth.inc(labels=(ten, str(trace.cache_hit_depth)))
            if trace.cross_prefix_hit:
                self._cross_hits.inc(labels=(ten,))
            if trace.n_tokens:
                self._decoded.inc()
                self._tokens.inc(trace.n_tokens)

    # -- reporting ----------------------------------------------------------
    def summary(self) -> dict:
        with self._lock:
            req = self._requests.series()
            totals = {o: 0 for o in _OUTCOMES}
            depths: dict[int, int] = {}
            per_tenant_depths: dict[str, dict[int, int]] = {}
            for (tenant, o), v in req.items():
                totals[o] += int(v)
            for (tenant, d), v in self._hit_depth.series().items():
                d = int(d)
                depths[d] = depths.get(d, 0) + int(v)
                per_tenant_depths.setdefault(tenant, {})[d] = int(v)
            cross = self._cross_hits.series()
            bs = self._batch_size.stats()
            out = {
                "served": totals["served"],
                "timed_out": totals["timed_out"],
                "shed": totals["shed"],
                "errors": totals["errors"],
                "late": totals["late"],
                "batches": int(self._batches.value()),
                "mean_batch_size": round(bs["mean"], 2),
                "max_batch_size": int(bs["max"] or 0),
                "cache_hit_depths": dict(sorted(depths.items())),
                "lane_served": {
                    lane: int(v) for (lane,), v in
                    sorted(self._lane_served.series().items())},
                "pipelines": {
                    name: {
                        **{o: int(req.get((name, o), 0)) for o in _OUTCOMES},
                        "cache_hit_depths": dict(sorted(
                            per_tenant_depths.get(name, {}).items())),
                        "cross_pipeline_prefix_hits":
                            int(cross.get((name,), 0)),
                    }
                    for name in sorted(self._tenant_names)},
            }
            stage = self._stage_ms.series()
            if stage:
                out["stage_mean_ms"] = {
                    label: round(h["sum"] / h["count"], 3)
                    for (label,), h in stage.items() if h["count"]}
            done = [t for t in self.ring
                    if not (t.timed_out or t.errored)]
            out["latency_ms"] = latency_summary([t.latency_ms for t in done])
            out["queue_wait_ms"] = latency_summary(
                [t.queue_wait_ms for t in done])
            decoded = [t for t in done if t.n_tokens]
            n_decoded = int(self._decoded.value())
            if decoded or n_decoded:
                # per-token latency excludes the first token (TTFT owns the
                # prompt prefill + retrieval); a 1-token decode has no steps
                out["decode"] = {
                    "requests": n_decoded,
                    "tokens": int(self._tokens.value()),
                    "ttft_ms": latency_summary(
                        [t.ttft_ms for t in decoded]),
                    "per_token_ms": latency_summary(
                        [(t.latency_ms - t.ttft_ms) / max(t.n_tokens - 1, 1)
                         for t in decoded]),
                }
            return out
