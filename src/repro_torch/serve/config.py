"""ServeConfig: the serving layer's frozen front-door configuration.

``PipelineServer`` used to take ten loose constructor kwargs (``max_queue``,
``max_wait_ms``, ``max_batch``, ``cache_entries``, ...); this module
consolidates them into one frozen dataclass — the serving counterpart of
the compiler's :class:`~repro_torch.core.descriptor.BackendDescriptor` — so a
deployment's serving policy is a single inspectable value that can be
shared across servers, logged, and diffed:

* **batching**     — micro-batch closure (``max_batch``, ``max_wait_ms``,
                     arrival-rate-adaptive wait),
* **admission**    — queue bound + deadline policy (default timeout,
                     EDF shed-before-execute, service-time EWMA smoothing),
* **lanes**        — weighted-fair-queueing priority lanes,
* **caching**      — the stage-result cache bound and per-stage writes,
* **decode**       — the generate stage's decode-slot pool size,
* **tracing**      — per-stage timing and the trace-ring capacity.

Construction mirrors the descriptor idiom: ``ServeConfig.default()`` plus
chained ``with_*()`` builders returning new frozen values.  The config is
the only constructor surface — the pre-config loose-kwarg shim was removed
after its deprecation cycle, so unknown kwargs fail as a plain
``TypeError`` from the signature itself.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Frozen serving policy for a :class:`~repro_torch.serve.server.PipelineServer`.

    ``lanes`` is a tuple of ``(name, weight)`` pairs — the scheduler serves
    lanes in weighted-fair order so a low-weight background tenant cannot
    starve interactive traffic; ``default_lane`` is where ``submit`` routes
    when the caller names none.  ``shed`` enables shed-before-execute: a
    request whose deadline cannot survive the estimated queue wait plus one
    batch service time (an EWMA with ``service_ewma_alpha``) is rejected at
    submit / dropped at batch close *before* it occupies a ladder slot.
    ``adaptive_wait`` shrinks the batch-close wait below ``max_wait_ms``
    when the observed arrival rate says the batch cannot fill in time.
    """

    # -- compilation --------------------------------------------------------
    optimize: bool = True
    # -- admission / queue --------------------------------------------------
    max_queue: int = 1024
    default_timeout_ms: float | None = None
    # -- batching -----------------------------------------------------------
    max_wait_ms: float = 5.0
    max_batch: int | None = None
    adaptive_wait: bool = False
    # -- deadline policy ----------------------------------------------------
    shed: bool = True
    service_ewma_alpha: float = 0.2
    # -- priority lanes (WFQ) -----------------------------------------------
    lanes: tuple = (("default", 1.0),)
    default_lane: str = "default"
    # -- stage-result cache -------------------------------------------------
    cache_entries: int | None = 4096
    cache_stages: bool = True
    # -- decode (generate-stage serving) --------------------------------------
    #: KV-cache slots per generate tenant's decode pool: the iteration-level
    #: scheduler admits up to this many concurrent decodes; each slot is one
    #: row of the block-allocated cache
    decode_slots: int = 8
    # -- tracing ------------------------------------------------------------
    trace_stages: bool = False
    trace_capacity: int = 2048
    # -- observability (span tracing + flight recorder; metrics are
    # -- always-on registry counters and have no switch) ---------------------
    #: span tracing of the serve lifecycle (admit -> queue -> batch ->
    #: stages -> decode -> reply), exportable as Chrome trace-event JSON
    obs_tracing: bool = False
    #: flight recorder: bounded ring of scheduler/engine decision events
    obs_recorder: bool = False
    obs_trace_events: int = 65536
    obs_recorder_events: int = 1024

    def __post_init__(self):
        if not self.lanes:
            raise ValueError("ServeConfig.lanes must name at least one lane")
        names = [n for n, _ in self.lanes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate lane names in {names}")
        if any(w <= 0 for _, w in self.lanes):
            raise ValueError("lane weights must be positive")
        if self.default_lane not in names:
            raise ValueError(f"default_lane {self.default_lane!r} not in "
                             f"lanes {names}")
        if not 0.0 < self.service_ewma_alpha <= 1.0:
            raise ValueError("service_ewma_alpha must be in (0, 1]")
        if self.decode_slots < 1:
            raise ValueError("decode_slots must be >= 1")

    # -- construction -------------------------------------------------------
    @classmethod
    def default(cls, **overrides) -> "ServeConfig":
        return cls(**overrides)

    def replace(self, **changes) -> "ServeConfig":
        return dataclasses.replace(self, **changes)

    def with_batching(self, *, max_batch: int | None = ...,
                      max_wait_ms: float | None = None,
                      adaptive_wait: bool | None = None) -> "ServeConfig":
        kw: dict = {}
        if max_batch is not ...:
            kw["max_batch"] = max_batch
        if max_wait_ms is not None:
            kw["max_wait_ms"] = float(max_wait_ms)
        if adaptive_wait is not None:
            kw["adaptive_wait"] = bool(adaptive_wait)
        return self.replace(**kw)

    def with_queue(self, max_queue: int) -> "ServeConfig":
        return self.replace(max_queue=int(max_queue))

    def with_deadlines(self, default_timeout_ms: float | None = ...,
                       *, shed: bool | None = None,
                       service_ewma_alpha: float | None = None
                       ) -> "ServeConfig":
        kw: dict = {}
        if default_timeout_ms is not ...:
            kw["default_timeout_ms"] = default_timeout_ms
        if shed is not None:
            kw["shed"] = bool(shed)
        if service_ewma_alpha is not None:
            kw["service_ewma_alpha"] = float(service_ewma_alpha)
        return self.replace(**kw)

    def with_lanes(self, *lanes, default: str | None = None) -> "ServeConfig":
        """Lanes as ``(name, weight)`` pairs; the default lane is ``default``
        (or the first lane)."""
        spec = tuple((str(n), float(w)) for n, w in lanes)
        return self.replace(lanes=spec,
                            default_lane=default if default is not None
                            else spec[0][0])

    def with_cache(self, entries: int | None = ...,
                   *, cache_stages: bool | None = None) -> "ServeConfig":
        kw: dict = {}
        if entries is not ...:
            kw["cache_entries"] = entries
        if cache_stages is not None:
            kw["cache_stages"] = bool(cache_stages)
        return self.replace(**kw)

    def with_decode(self, slots: int) -> "ServeConfig":
        """Decode-pool size for generate-stage tenants (KV-cache slots the
        iteration-level scheduler fills between decode steps)."""
        return self.replace(decode_slots=int(slots))

    def with_tracing(self, stages: bool | None = None,
                     *, capacity: int | None = None) -> "ServeConfig":
        kw: dict = {}
        if stages is not None:
            kw["trace_stages"] = bool(stages)
        if capacity is not None:
            kw["trace_capacity"] = int(capacity)
        return self.replace(**kw)

    def with_observability(self, enabled: bool = True, *,
                           tracing: bool | None = None,
                           recorder: bool | None = None,
                           trace_events: int | None = None,
                           recorder_events: int | None = None
                           ) -> "ServeConfig":
        """Opt in to span tracing and/or the flight recorder.

        ``with_observability()`` turns both on; ``tracing=``/``recorder=``
        override the master switch per layer (e.g. recorder-only for an
        overload post-mortem without per-request span cost).  Metrics are
        not gated here — the registry is always on (an increment is a dict
        lookup); these switches govern the layers that allocate per-event
        records.
        """
        kw: dict = {
            "obs_tracing": bool(enabled if tracing is None else tracing),
            "obs_recorder": bool(enabled if recorder is None else recorder),
        }
        if trace_events is not None:
            kw["obs_trace_events"] = int(trace_events)
        if recorder_events is not None:
            kw["obs_recorder_events"] = int(recorder_events)
        return self.replace(**kw)

    # -- queries ------------------------------------------------------------
    def lane_weights(self) -> dict[str, float]:
        return {n: float(w) for n, w in self.lanes}

    def as_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["lanes"] = [list(p) for p in self.lanes]
        return out
