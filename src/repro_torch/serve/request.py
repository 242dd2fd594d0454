"""Serving request objects: one submitted query + its lifecycle/trace.

A :class:`ServeRequest` is what ``PipelineServer.submit`` hands back: a
single-query slice of the Q relation plus a completion event the caller
waits on.  Every request carries a :class:`RequestTrace` — the structured
per-request accounting (queue wait, batch size, bucket, cache hit depth,
per-stage wall-clock) that ``server.stats()`` aggregates.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any


class ServerOverloaded(RuntimeError):
    """Admission control rejected the request: the bounded request queue is
    full.  Callers shed load (retry later / fail the caller) instead of the
    server growing an unbounded backlog."""


class DeadlineUnmeetable(ServerOverloaded):
    """Shed at the door: the scheduler's service-time model says this
    request's deadline cannot survive the estimated queue wait plus one
    batch service time, so admitting it would only burn a ladder slot on
    an answer nobody will accept.  Subclasses :class:`ServerOverloaded`
    because the remedy is the same — the caller sheds load."""


class RequestTimeout(TimeoutError):
    """The request's deadline expired before the server produced a result
    (the scheduler drops expired requests instead of wasting a batch slot
    on work nobody is waiting for)."""


@dataclasses.dataclass
class RequestTrace:
    """Structured per-request accounting, filled in as the request moves
    queue -> scheduler -> bucketed execution -> completion."""
    rid: int
    t_arrival: float = 0.0          # monotonic, set at submit
    t_scheduled: float = 0.0        # when its micro-batch closed
    t_done: float = 0.0             # result ready (or dropped)
    queue_wait_ms: float = 0.0
    service_ms: float = 0.0         # batch close -> result ready
    latency_ms: float = 0.0         # submit -> result ready
    batch_size: int = 0             # requests in its micro-batch
    bucket: int = 0                 # ladder rung the batch padded to
    cache_hit_depth: int = 0        # pipeline stages skipped via the cache
    chain_len: int = 0
    batch_reason: str = ""          # "full" | "deadline" | "drain"
    timed_out: bool = False
    shed: bool = False              # dropped pre-execution by the scheduler
    errored: bool = False           # execution raised; see request.error
    late: bool = False              # completed, but past its deadline
    lane: str = ""                  # WFQ lane it was served from
    tenant: str = ""                # pipeline (tenant) it executed under
    cross_prefix_hit: bool = False  # cache hit written by another pipeline
    stage_ms: tuple = ()            # ((stage label, ms), ...) of its batch
    # -- decode (generate-stage requests only; zero otherwise) --------------
    ttft_ms: float = 0.0            # submit -> first generated token
    n_tokens: int = 0               # tokens decoded for this request

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServeRequest:
    """One in-flight query.  ``Q`` is an nq==1 slice of the Q relation
    (``{"qid", "terms", "weights"}``); ``result`` is the matching nq==1
    result slice once ``done`` is set."""
    rid: int
    Q: Any
    deadline: float | None          # absolute monotonic deadline, or None
    trace: RequestTrace
    t_enqueued: float = 0.0         # set by the scheduler on admission
    qdigest: str = ""               # content digest of terms/weights
    lane: str = "default"           # WFQ lane this request queues in
    tenant: str = "default"         # which of the server's pipelines runs it
    result: Any = None
    error: BaseException | None = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)

    @property
    def qid(self) -> int:
        import numpy as np
        return int(np.asarray(self.Q["qid"]).reshape(-1)[0])

    def expired(self, now: float | None = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) > self.deadline

    def wait(self, timeout: float | None = None):
        """Block until the result is ready and return it.  Raises
        :class:`RequestTimeout` if the server dropped the request at its
        deadline, or ``TimeoutError`` if ``timeout`` elapses first."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still pending after "
                               f"{timeout}s")
        if self.error is not None:
            raise self.error
        if self.trace.timed_out:
            raise RequestTimeout(
                f"request {self.rid} "
                + ("shed pre-execution (deadline cannot survive the "
                   "estimated queue wait + one batch service time)"
                   if self.trace.shed else
                   "expired in queue (deadline passed before execution)"))
        return self.result
