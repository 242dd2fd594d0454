"""Deadline-aware continuous micro-batching scheduler over the engine's
bucket ladder: EDF packing, shed-before-execute, weighted-fair lanes.

The closure policy is the standard continuous-batching trade (cf.
vLLM-style LM serving, here over retrieval pipelines):

* **heavy load** — the queue reaches ``max_batch`` (the largest ladder
  bucket by default) and the batch closes immediately, "full": steady
  state packs every dispatch to the biggest compiled bucket.
* **light load** — the oldest waiting request hits the effective
  ``max_wait``: the batch closes with whatever is queued, "deadline", so
  latency under light load is bounded by ``max_wait`` + one batch's
  service time instead of waiting for a batch that may never fill.  With
  ``adaptive_wait`` the effective wait shrinks below ``max_wait_ms`` when
  the observed arrival rate (an EWMA of inter-arrival gaps) says the
  remaining slots cannot fill in time anyway — holding a batch open for
  arrivals that are not coming only adds latency.

What PACKS a batch is deadline-aware, not FIFO:

* **EDF within a lane** — each lane is an earliest-deadline-first heap
  (requests without a deadline order by arrival, after every
  deadline-bearing request at the same instant); the batch takes the most
  urgent work first, so a tight-deadline request never waits behind a
  loose one that happened to arrive earlier.
* **WFQ across lanes** — lanes are served by weighted fair queueing
  (virtual-time, one request per grant): lane ``i`` with weight ``w_i``
  receives ``w_i / sum(w)`` of batch slots under contention, so a
  background tenant cannot starve interactive traffic and interactive
  bursts cannot permanently lock background out either.
* **shed-before-execute** — the scheduler learns service times from
  measured batches, *per ladder rung*: ``S(b)`` is an EWMA per bucket
  (unmeasured rungs scale linearly from the nearest measured one — these
  padded pipelines cost ~linearly in the bucket), and a per-slot EWMA
  tracks the drain rate.  At submit, a request whose deadline cannot
  survive the estimated queue wait (``queued`` slots at the per-slot
  rate) plus one *smallest-rung* batch service time is rejected
  (:class:`~repro_torch.serve.request.DeadlineUnmeetable`) — if even a
  minimum-size batch after the queue drains cannot make it, nothing can;
  at batch close the same test (queue wait already paid, the batch it
  would actually join) drops it into ``Batch.shed`` instead of a ladder
  slot.  Overloaded servers therefore spend capacity only on answers
  that can still arrive in time — goodput tracks throughput instead of
  collapsing.
* **deadline-capped packing** — a batch never packs past the rung the
  most urgent taken deadline can survive: when ``S(max_batch)`` exceeds
  the SLO but ``S(small rung)`` fits, the scheduler closes smaller
  batches rather than riding every deadline past its budget inside one
  giant bucket.  The cap re-tightens as more urgent requests join.

Admission control is a bounded queue: ``submit`` raises
:class:`~repro_torch.serve.request.ServerOverloaded` rather than growing a
backlog nobody will be served from before their deadline.

For generate-stage pipelines the scheduler also owns the *decode* queue —
iteration-level scheduling: a request that finished its retrieval prefix
and assembled a prompt waits here until the decode pool frees a KV-cache
slot, and the server admits from this queue *between decode steps*
(``decode_take``), EDF-ordered so urgent answers claim slots first.

The scheduler is clock-driven and thread-safe but owns no thread itself —
``PipelineServer.step()`` (or its serving thread) pulls batches; tests
drive it synchronously with ``drain=True``.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import threading
import time
from collections import deque

from repro_torch.common import select_ladder_bucket
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import NOOP_TRACER
from repro_torch.serve.request import (DeadlineUnmeetable, ServeRequest,
                                 ServerOverloaded)

_INF = float("inf")


def _ms(seconds: float | None) -> float | None:
    return None if seconds is None else round(1000.0 * seconds, 3)


@dataclasses.dataclass
class Batch:
    requests: list       # EDF/WFQ-packed live requests (occupy ladder slots)
    reason: str          # "full" | "deadline" | "drain"
    t_closed: float
    shed: list = dataclasses.field(default_factory=list)   # dropped pre-exec


class _Lane:
    """One WFQ lane: an EDF heap plus its virtual-time account."""

    __slots__ = ("name", "weight", "heap", "vtime", "n_submitted", "n_taken")

    def __init__(self, name: str, weight: float):
        self.name = name
        self.weight = float(weight)
        #: (deadline key, seq, request); deadline None sorts after every
        #: deadline at +inf, then by arrival seq — EDF with FIFO fallback
        self.heap: list = []
        self.vtime = 0.0
        self.n_submitted = 0
        self.n_taken = 0


class MicroBatchScheduler:
    def __init__(self, *, ladder, max_queue: int = 1024,
                 max_wait_ms: float = 5.0, max_batch: int | None = None,
                 lanes=(("default", 1.0),), default_lane: str | None = None,
                 adaptive_wait: bool = False, shed: bool = True,
                 service_ewma_alpha: float = 0.2,
                 registry: MetricsRegistry | None = None,
                 tracer=None, recorder=None):
        self.ladder = tuple(sorted(int(b) for b in ladder))
        self.max_queue = int(max_queue)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.max_batch = (self.ladder[-1] if max_batch is None
                          else min(int(max_batch), self.ladder[-1]))
        self.adaptive_wait = bool(adaptive_wait)
        self.shed_enabled = bool(shed)
        self._alpha = float(service_ewma_alpha)
        self.lanes: dict[str, _Lane] = {
            str(n): _Lane(str(n), w) for n, w in lanes}
        self.default_lane = (default_lane if default_lane is not None
                             else next(iter(self.lanes)))
        if self.default_lane not in self.lanes:
            raise ValueError(f"default lane {self.default_lane!r} not in "
                             f"{sorted(self.lanes)}")
        self._n_queued = 0
        self._seq = 0
        #: arrival-ordered view for the max_wait closure rule (heap order is
        #: deadline order); popped batches mark requests taken, and stale
        #: heads are lazily discarded
        self._arrivals: deque = deque()
        self._cv = threading.Condition()
        self._service_ewma: float | None = None   # seconds per batch (any)
        self._bucket_ewma: dict[int, float] = {}  # ladder rung -> seconds
        self._slot_ewma: float | None = None      # seconds per ladder slot
        self._gap_ewma: float | None = None       # seconds between arrivals
        self._last_arrival: float | None = None
        # counters live in the metrics registry (one source of truth for
        # stats()); tracer/recorder are the opt-in decision-event sinks
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.recorder = recorder
        self._events = self.metrics.counter(
            "sched_requests_total", "scheduler admission/shedding events",
            ("event",))
        for e in ("submitted", "rejected", "shed_submit", "shed_queue",
                  "decode_submitted", "decode_taken"):
            self._events.touch((e,))
        self._batch_close = self.metrics.counter(
            "sched_batches_total", "closed batches by reason", ("reason",))
        #: decode-side EDF queue: (deadline key, seq, request) of requests
        #: whose retrieval prefix is done and whose prompt awaits a free
        #: KV-cache slot in the decode pool
        self._decode_heap: list = []

    # -- registry-backed views (legacy attribute surface) --------------------
    @property
    def n_submitted(self) -> int:
        return int(self._events.value(("submitted",)))

    @property
    def n_rejected(self) -> int:
        return int(self._events.value(("rejected",)))

    @property
    def n_shed_submit(self) -> int:
        return int(self._events.value(("shed_submit",)))

    @property
    def n_shed_queue(self) -> int:
        return int(self._events.value(("shed_queue",)))

    @property
    def n_decode_submitted(self) -> int:
        return int(self._events.value(("decode_submitted",)))

    @property
    def n_decode_taken(self) -> int:
        return int(self._events.value(("decode_taken",)))

    # -- feedback ------------------------------------------------------------
    def _ewma(self, old: float | None, new: float) -> float:
        return (new if old is None
                else (1.0 - self._alpha) * old + self._alpha * new)

    def note_service_time(self, seconds: float,
                          batch_size: int | None = None) -> None:
        """One measured batch service time (close -> results ready); the
        EWMAs of these are ``S`` in every shedding decision.  With
        ``batch_size`` the measurement also lands in the per-rung and
        per-slot EWMAs — service time depends strongly on the bucket a
        batch padded to, and feasibility must compare a deadline against
        the batch the request would actually ride in, not against
        whatever mix of sizes recent traffic happened to close."""
        with self._cv:
            self._service_ewma = self._ewma(self._service_ewma, seconds)
            if batch_size:
                b = select_ladder_bucket(self.ladder, int(batch_size),
                                         clamp=True)
                self._bucket_ewma[b] = self._ewma(self._bucket_ewma.get(b),
                                                  seconds)
                self._slot_ewma = self._ewma(self._slot_ewma, seconds / b)

    def _bucket_est(self, n: int) -> float | None:
        """Estimated service time of a batch of ``n``: the covering rung's
        EWMA if measured; else an affine fit ``c0 + c1*b`` through the
        measured rungs (padded pipeline cost is ~linear in the bucket PLUS
        a fixed dispatch/plumbing term — pure linear scaling from a small
        rung wildly underestimates big batches and vice versa); with a
        single measured rung, linear scaling; else the scalar EWMA, else
        None (nothing measured yet)."""
        if self._bucket_ewma:
            b = select_ladder_bucket(self.ladder, max(int(n), 1), clamp=True)
            S = self._bucket_ewma.get(b)
            if S is not None:
                return S
            pts = sorted(self._bucket_ewma.items())
            if len(pts) == 1:
                b0, S0 = pts[0]
                return S0 * (b / b0)
            m = len(pts)
            mx = sum(p[0] for p in pts) / m
            my = sum(p[1] for p in pts) / m
            denom = sum((p[0] - mx) ** 2 for p in pts)
            c1 = (sum((p[0] - mx) * (p[1] - my) for p in pts) / denom
                  if denom else 0.0)
            c1 = max(c1, 0.0)            # noise can invert the slope
            c0 = max(my - c1 * mx, 0.0)
            est = c0 + c1 * b
            if est <= 0.0:               # degenerate fit: fall back to scale
                b0 = min(self._bucket_ewma,
                         key=lambda r: abs(math.log(b / r)))
                est = self._bucket_ewma[b0] * (b / b0)
            return est
        return self._service_ewma

    def service_estimate(self, n: int | None = None) -> float | None:
        """Scalar service-time EWMA, or — with ``n`` — the per-bucket
        estimate for a batch of ``n`` requests."""
        with self._cv:
            return self._service_ewma if n is None else self._bucket_est(n)

    def arrival_gap_estimate(self) -> float | None:
        with self._cv:
            return self._gap_ewma

    # -- shedding math -------------------------------------------------------
    def _infeasible(self, req: ServeRequest, now: float, n_ahead: int,
                    own_n: int = 1) -> bool:
        """True when ``req``'s deadline cannot survive the estimated queue
        wait (``n_ahead`` slots at the per-slot drain rate) plus its own
        batch's service time (a batch of ``own_n`` — at the door that is
        the *smallest* rung: if even a minimum-size batch after the queue
        drains cannot make it, no packing can).  Never sheds before the
        first measurement (no estimate) except for already-expired
        deadlines."""
        if req.deadline is None:
            return False
        S_own = self._bucket_est(own_n)
        if S_own is None:
            return req.deadline <= now
        wait_est = (n_ahead * self._slot_ewma if self._slot_ewma is not None
                    else (n_ahead / self.max_batch) * S_own)
        return now + wait_est + S_own > req.deadline

    def _deadline_cap(self, d_min: float | None, now: float) -> int:
        """Largest batch size whose estimated service time still fits the
        most urgent taken deadline — packing past it would ride that
        request (and every tighter one) past its budget inside a bucket
        too big to finish in time."""
        if d_min is None:
            return self.max_batch
        budget = d_min - now
        cap = 0
        for b in self.ladder:
            if b > self.max_batch:
                break
            S = self._bucket_est(b)
            if S is not None and S > budget:
                break
            cap = b
        # the head passed its own feasibility test, so never cap below it
        return max(cap, 1)

    # -- producer side ------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        self.submit_many([req])

    def submit_many(self, reqs) -> None:
        """Admit a burst atomically: all requests enqueue, or none do and
        :class:`ServerOverloaded` is raised (partial admission would leak
        in-flight requests the caller holds no handles to).  Shedding is
        part of admission: a burst containing a request whose deadline the
        service-time model says cannot be met is rejected whole with
        :class:`DeadlineUnmeetable` before it occupies queue space."""
        with self._cv:
            if self._n_queued + len(reqs) > self.max_queue:
                self._events.inc(len(reqs), ("rejected",))
                if self.recorder is not None:
                    self.recorder.record(
                        "reject_overload", n=len(reqs),
                        queued=self._n_queued, max_queue=self.max_queue)
                raise ServerOverloaded(
                    f"request queue full ({self._n_queued}/{self.max_queue}, "
                    f"burst of {len(reqs)}); shedding load")
            now = time.monotonic()
            if self.shed_enabled:
                doomed = [r for r in reqs
                          if self._infeasible(r, now, self._n_queued)]
                if doomed:
                    self._events.inc(len(reqs), ("rejected",))
                    self._events.inc(len(reqs), ("shed_submit",))
                    S = self._service_ewma
                    if self.recorder is not None:
                        r0 = doomed[0]
                        self.recorder.record(
                            "shed_door", n=len(reqs),
                            rid=r0.trace.rid, queued=self._n_queued,
                            service_ewma_ms=_ms(S),
                            s1_ms=_ms(self._bucket_est(1)),
                            slot_ms=_ms(self._slot_ewma),
                            slack_ms=(None if r0.deadline is None
                                      else _ms(r0.deadline - now)))
                    self.tracer.event(
                        "sched.shed_door", "sched", n=len(reqs),
                        queued=self._n_queued, service_ewma_ms=_ms(S))
                    raise DeadlineUnmeetable(
                        f"deadline cannot be met: ~{self._n_queued} queued, "
                        f"EWMA batch service "
                        f"{0.0 if S is None else 1000.0 * S:.1f}ms; "
                        f"shedding before execution")
            for req in reqs:
                lane = self.lanes.get(req.lane)
                if lane is None:
                    raise KeyError(f"unknown lane {req.lane!r}; configured "
                                   f"lanes: {sorted(self.lanes)}")
                req.t_enqueued = now
                if self._last_arrival is not None:
                    gap = now - self._last_arrival
                    self._gap_ewma = (gap if self._gap_ewma is None
                                      else 0.8 * self._gap_ewma + 0.2 * gap)
                self._last_arrival = now
                self._seq += 1
                dl = _INF if req.deadline is None else req.deadline
                heapq.heappush(lane.heap, (dl, self._seq, req))
                lane.n_submitted += 1
                self._arrivals.append(req)
                self._n_queued += 1
                if self.recorder is not None:
                    self.recorder.record(
                        "admit", rid=req.trace.rid, lane=req.lane,
                        queued=self._n_queued,
                        slack_ms=(None if req.deadline is None
                                  else _ms(req.deadline - now)))
            self._events.inc(len(reqs), ("submitted",))
            self._cv.notify()

    def qsize(self) -> int:
        with self._cv:
            return self._n_queued

    # -- consumer side ------------------------------------------------------
    def select_bucket(self, n: int) -> int:
        """Smallest ladder rung covering ``n`` — the same shared policy as
        ``ShardedQueryEngine.select_bucket``
        (:func:`repro_torch.common.select_ladder_bucket`), clamped so a
        sequential backend without an engine still reports a bucket for
        any batch this scheduler could close."""
        return select_ladder_bucket(self.ladder, n, clamp=True)

    def _oldest_wait(self, now: float) -> float | None:
        while self._arrivals and self._arrivals[0].done.is_set():
            self._arrivals.popleft()
        # a request is removed from _arrivals lazily; anything still queued
        # has done unset (it is set only at completion, post-scheduling),
        # so the head may be an already-taken-but-unfinished request:
        while self._arrivals and getattr(self._arrivals[0], "_taken", False):
            self._arrivals.popleft()
        if not self._arrivals:
            return None
        return now - self._arrivals[0].t_enqueued

    def _effective_wait(self) -> float:
        """Batch-close wait bound: ``max_wait_s``, shrunk under
        ``adaptive_wait`` to the time the arrival-rate EWMA says the
        remaining batch slots could plausibly fill in."""
        if not self.adaptive_wait or self._gap_ewma is None:
            return self.max_wait_s
        remaining = max(self.max_batch - self._n_queued, 0)
        return min(self.max_wait_s, self._gap_ewma * remaining)

    def _next_lane(self) -> _Lane | None:
        """WFQ grant: the non-empty lane with the smallest virtual time;
        charging ``1/weight`` per granted request yields weight-
        proportional batch slots under contention."""
        active = [ln for ln in self.lanes.values() if ln.heap]
        if not active:
            return None
        return min(active, key=lambda ln: (ln.vtime, ln.name))

    def _take(self, n: int, reason: str, now: float) -> Batch:
        """Pack a batch of up to ``n`` live requests: WFQ across lanes, EDF
        within a lane, shedding requests that cannot survive one more batch
        service time — a shed request never occupies a ladder slot, so the
        batch back-fills with the next most urgent feasible work.  The
        batch never packs past the rung the most urgent taken deadline can
        survive (``_deadline_cap``); later-granted requests with tighter
        deadlines re-shrink the cap."""
        live: list = []
        shed: list = []
        vbase = None
        d_min: float | None = None
        cap = self.max_batch
        while len(live) < min(n, cap):
            lane = self._next_lane()
            if lane is None:
                break
            if vbase is None:
                vbase = lane.vtime
            _, _, req = heapq.heappop(lane.heap)
            req._taken = True
            self._n_queued -= 1
            if self.shed_enabled and self._infeasible(req, now, 0,
                                                      own_n=len(live) + 1):
                self._events.inc(1, ("shed_queue",))
                req.trace.shed = True
                shed.append(req)
                if self.recorder is not None:
                    self.recorder.record(
                        "shed_queue", rid=req.trace.rid, lane=req.lane,
                        own_n=len(live) + 1,
                        s_own_ms=_ms(self._bucket_est(len(live) + 1)),
                        slack_ms=(None if req.deadline is None
                                  else _ms(req.deadline - now)))
                continue
            lane.vtime += 1.0 / lane.weight
            lane.n_taken += 1
            live.append(req)
            if req.deadline is not None and (d_min is None
                                             or req.deadline < d_min):
                d_min = req.deadline
                cap = self._deadline_cap(d_min, now)
        # keep idle lanes' virtual clocks from lagging unboundedly behind
        # (an hours-idle lane would otherwise monopolise every batch until
        # its stale clock caught up)
        if vbase is not None:
            for ln in self.lanes.values():
                if ln.vtime < vbase:
                    ln.vtime = vbase
        self._batch_close.inc(1, (reason,))
        rung = select_ladder_bucket(self.ladder, max(len(live), 1),
                                    clamp=True)
        if self.recorder is not None:
            self.recorder.record(
                "batch_close", reason=reason, size=len(live), rung=rung,
                shed=len(shed), cap=cap, queued_after=self._n_queued,
                s_rung_ms=_ms(self._bucket_est(rung)))
        self.tracer.event(
            "sched.batch_close", "sched", reason=reason, size=len(live),
            rung=rung, shed=len(shed), cap=cap,
            s_rung_ms=_ms(self._bucket_est(rung)),
            slot_ms=_ms(self._slot_ewma))
        return Batch(requests=live, reason=reason, t_closed=now, shed=shed)

    def next_batch(self, *, block: bool = False, timeout: float | None = None,
                   drain: bool = False) -> Batch | None:
        """Return the next micro-batch, or None.

        Non-blocking unless ``block``: then waits until a batch closes (or
        ``timeout`` elapses).  ``drain=True`` closes a batch from whatever
        is queued immediately — the synchronous replay/test mode.  A batch
        that shed its every candidate (all deadlines infeasible) is still
        returned — the server must fail the shed requests' waiters."""
        t_give_up = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                now = time.monotonic()
                wait = None
                if self._n_queued:
                    if self._n_queued >= self.max_batch:
                        return self._take(self.max_batch, "full", now)
                    if drain:
                        return self._take(self._n_queued, "drain", now)
                    oldest = self._oldest_wait(now)
                    eff = self._effective_wait()
                    if oldest is not None and oldest >= eff:
                        return self._take(self._n_queued, "deadline", now)
                    wait = (eff if oldest is None else eff - oldest)
                elif drain:
                    return None
                if not block:
                    return None
                if t_give_up is not None:
                    remaining = t_give_up - now
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None else min(wait, remaining)
                self._cv.wait(wait)

    # -- decode-side (iteration-level) queue ---------------------------------
    def decode_submit(self, req: ServeRequest) -> None:
        """Queue a retrieval-complete request for a decode slot.  No
        bounded-queue check: the request was already admitted at the door
        and holds no ladder slot while waiting here."""
        with self._cv:
            self._seq += 1
            dl = _INF if req.deadline is None else req.deadline
            heapq.heappush(self._decode_heap, (dl, self._seq, req))
            self._events.inc(1, ("decode_submitted",))

    def decode_take(self, n: int) -> list:
        """Admit up to ``n`` requests into freed decode slots, most urgent
        deadline first — called between decode steps, which is what makes
        the decode loop iteration-level rather than run-to-completion."""
        out: list = []
        with self._cv:
            while self._decode_heap and len(out) < n:
                _, _, req = heapq.heappop(self._decode_heap)
                self._events.inc(1, ("decode_taken",))
                out.append(req)
        return out

    def decode_pending(self) -> int:
        with self._cv:
            return len(self._decode_heap)

    def stats(self) -> dict:
        with self._cv:
            S = self._service_ewma
            gap = self._gap_ewma
            return {
                "queued": self._n_queued,
                "submitted": self.n_submitted,
                "rejected": self.n_rejected,
                "shed_submit": self.n_shed_submit,
                "shed_queue": self.n_shed_queue,
                "max_queue": self.max_queue,
                "max_batch": self.max_batch,
                "max_wait_ms": 1000.0 * self.max_wait_s,
                "adaptive_wait": self.adaptive_wait,
                "effective_wait_ms": round(1000.0 * self._effective_wait(), 3),
                "service_ewma_ms": (None if S is None
                                    else round(1000.0 * S, 3)),
                "service_ms_by_bucket": {
                    b: round(1000.0 * v, 3)
                    for b, v in sorted(self._bucket_ewma.items())},
                "slot_ms_ewma": (None if self._slot_ewma is None
                                 else round(1000.0 * self._slot_ewma, 3)),
                "arrival_gap_ewma_ms": (None if gap is None
                                        else round(1000.0 * gap, 3)),
                "decode_pending": len(self._decode_heap),
                "decode_submitted": self.n_decode_submitted,
                "decode_taken": self.n_decode_taken,
                "lanes": {ln.name: {"weight": ln.weight,
                                    "queued": len(ln.heap),
                                    "submitted": ln.n_submitted,
                                    "served_slots": ln.n_taken}
                          for ln in self.lanes.values()},
            }
