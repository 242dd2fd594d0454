"""Structured span tracing with Chrome trace-event export, mirrored into
``torch.profiler``.

Two sinks share one span API.  The in-memory records: an enabled
:class:`Tracer` keeps each span and event (the instrumentation sites route
to the process-global tracer only where the backend's descriptor opts in,
:func:`tracer_for`).  The profiler: while a ``torch.profiler`` is
recording, every context-manager span (:meth:`Tracer.span`) is also a
profiler range of the same name, whether or not the tracer is enabled, so
a profile of any call shows the program's layers on the device timeline.
``begin()`` spans (which may end on another thread), ``add_span`` and
``event`` (retrospective) are not mirrored.  The ranges are torch's
function-scope record functions: host ranges only, with no copy on the
device's rows.

Spans carry explicit ``span_id``/``parent_id`` links — nesting is a
property of the data, not of wall-clock containment — so spans recorded
retrospectively (a request's queue/batch/decode children are emitted
when the request finishes, from its ``RequestTrace`` timestamps) link
exactly like spans recorded live around a synchronous call.

Parenting rules:
  * ``span(...)`` (context manager) nests via a thread-local stack: the
    enclosing live span on the same thread is the parent.
  * an explicit ``parent=`` always wins — this is how cross-thread
    lifecycles (request admitted on the caller thread, executed on the
    serving thread) attach their children.
  * ``add_span``/``event`` never touch the thread-local stack.

Clocks: a record's times are ``time.monotonic()`` relative to the
tracer's epoch.  :attr:`Tracer.clock_offset_ns` is the offset of the
profiler's clock from ``time.monotonic()``, read anew at each use (the
realtime clock is slewed against the monotonic one over a long-lived
tracer's life), and :meth:`Tracer.export_chrome` writes ``ts`` on the
profiler's clock, so a tracer export and a ``prof.export_chrome_trace``
file merge into one timeline.  A mirrored span's record lies inside its
profiler range.

With no profiler recording, the disabled path is one flag check
returning the shared no-op span; a disabled tracer allocates nothing per
call.
"""
from __future__ import annotations

import itertools
import json
import threading
import time

import torch

#: whether a ``torch.profiler`` is recording on this thread
_profiling = torch._C._autograd._profiler_enabled
#: a host range of the profiler: the function-scope record function (no
#: copy on the device's rows, which would read as device work)
_Range = torch._C._profiler._RecordFunctionFast


def _profiler_clock_offset_ns() -> int:
    """The profiler's clock less ``time.monotonic_ns()``.  The profiler
    stamps its host events in Unix time (its approximate clock, converted
    at the end of the profile over the profile's whole span);
    ``tests/test_torch_obs.py`` holds the tracer's records to its ranges."""
    m0 = time.monotonic_ns()
    now = time.time_ns()
    return now - (m0 + time.monotonic_ns()) // 2


class _NoopSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        return self

    def end(self, t=None):
        return self


NOOP_SPAN = _NoopSpan()


class _RangeSpan:
    """A span of the profiler sink alone (the tracer is disabled)."""

    __slots__ = ("_range",)
    span_id = None

    def __init__(self, name: str):
        self._range = _Range(name)
        self._range.__enter__()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def set(self, **kw):
        return self

    def end(self, t=None):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        return self


class Span:
    __slots__ = ("name", "cat", "span_id", "parent_id", "t0", "t1",
                 "tid", "args", "_tracer", "_on_stack", "_range")

    def __init__(self, tracer, name, cat, span_id, parent_id, t0, tid, args):
        self.name = name
        self.cat = cat
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1 = None
        self.tid = tid
        self.args = args
        self._tracer = tracer
        self._on_stack = False
        self._range = None

    def set(self, **kw):
        self.args.update(kw)
        return self

    def end(self, t: float | None = None):
        if self.t1 is None:
            self._tracer._finish(self, t)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class Tracer:
    """Bounded in-memory span/event collector.

    ``capacity`` bounds retained records (oldest dropped); ``enabled``
    may be flipped at runtime (``clear()`` resets retained records and
    the drop counter, not the id sequence).
    """

    def __init__(self, enabled: bool = False, capacity: int = 65536):
        self._enabled = bool(enabled)
        self.capacity = int(capacity)
        self._epoch = time.monotonic()
        self._lock = threading.Lock()
        self._records: list[dict] = []
        self._dropped = 0
        self._ids = itertools.count(1)
        self._tls = threading.local()

    # -- state ---------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, on: bool = True) -> None:
        self._enabled = bool(on)

    def clear(self) -> None:
        with self._lock:
            self._records = []
            self._dropped = 0

    def now(self) -> float:
        """Seconds since the tracer epoch (monotonic)."""
        return time.monotonic() - self._epoch

    def rel(self, t: float) -> float:
        """Convert a raw ``time.monotonic()`` stamp to epoch-relative —
        for :meth:`add_span` callers holding timestamps taken elsewhere
        (e.g. a ``RequestTrace``)."""
        return t - self._epoch

    @property
    def clock_offset_ns(self) -> int:
        """The profiler's clock less ``time.monotonic()``, in ns, now."""
        return _profiler_clock_offset_ns()

    def profiler_ns(self, t: float, offset_ns: int | None = None) -> int:
        """An epoch-relative time on the profiler's clock, in ns
        (``offset_ns``: a :attr:`clock_offset_ns` already read)."""
        if offset_ns is None:
            offset_ns = self.clock_offset_ns
        return round((self._epoch + t) * 1e9) + offset_ns

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_id(self) -> int | None:
        st = getattr(self._tls, "stack", None)
        return st[-1].span_id if st else None

    # -- recording -----------------------------------------------------------
    def span(self, name: str, cat: str = "", parent: int | None = None,
             **args):
        """Live nested span (context manager).  Parent defaults to the
        enclosing live span on this thread.  While a profiler records, also
        a profiler range named ``name``."""
        if not self._enabled:
            return _RangeSpan(name) if _profiling() else NOOP_SPAN
        rng = None
        if _profiling():
            rng = _Range(name)
            rng.__enter__()
        st = self._stack()
        pid = parent if parent is not None else (
            st[-1].span_id if st else None)
        sp = Span(self, name, cat, next(self._ids), pid, self.now(),
                  threading.get_ident(), args)
        sp._range = rng
        sp._on_stack = True
        st.append(sp)
        return sp

    def begin(self, name: str, cat: str = "", parent: int | None = None,
              **args):
        """Manually-ended span; never joins the thread-local stack (safe
        to end from another thread)."""
        if not self._enabled:
            return NOOP_SPAN
        return Span(self, name, cat, next(self._ids), parent, self.now(),
                    threading.get_ident(), args)

    def _finish(self, sp: Span, t: float | None) -> None:
        sp.t1 = self.now() if t is None else t
        if sp._range is not None:
            sp._range.__exit__(None, None, None)
            sp._range = None
        if sp._on_stack:
            st = self._stack()
            if sp in st:
                # pop through sp: tolerates a child left unended
                while st and st[-1] is not sp:
                    st.pop()
                if st:
                    st.pop()
        self._append({"ph": "X", "name": sp.name, "cat": sp.cat,
                      "id": sp.span_id, "parent": sp.parent_id,
                      "t0": sp.t0, "t1": sp.t1, "tid": sp.tid,
                      "args": sp.args})

    def add_span(self, name: str, t0: float, t1: float, *, cat: str = "",
                 parent: int | None = None, tid: int | None = None,
                 **args) -> int | None:
        """Retrospective span from explicit epoch-relative times."""
        if not self._enabled:
            return None
        sid = next(self._ids)
        self._append({"ph": "X", "name": name, "cat": cat, "id": sid,
                      "parent": parent, "t0": float(t0), "t1": float(t1),
                      "tid": tid if tid is not None
                      else threading.get_ident(), "args": args})
        return sid

    def event(self, name: str, cat: str = "", parent: int | None = None,
              t: float | None = None, tid: int | None = None,
              **args) -> int | None:
        """Instant event (a point, not a duration)."""
        if not self._enabled:
            return None
        sid = next(self._ids)
        self._append({"ph": "i", "name": name, "cat": cat, "id": sid,
                      "parent": parent,
                      "t0": self.now() if t is None else float(t),
                      "t1": None,
                      "tid": tid if tid is not None
                      else threading.get_ident(), "args": args})
        return sid

    def _append(self, rec: dict) -> None:
        with self._lock:
            self._records.append(rec)
            if len(self._records) > self.capacity:
                drop = len(self._records) - self.capacity
                del self._records[:drop]
                self._dropped += drop

    # -- reads ---------------------------------------------------------------
    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def export_chrome(self, base_ns: int = 0) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable): complete (``X``)
        events with microsecond ``ts``/``dur``, ``ts`` on the profiler's
        clock less ``base_ns`` (a ``prof.export_chrome_trace`` file's
        ``baseTimeNanoseconds``, to merge this export's events into it);
        ``args`` carries the explicit ``span_id``/``parent_id`` links."""
        events = []
        off = self.clock_offset_ns
        for r in self.records():
            args = {"span_id": r["id"], "parent_id": r["parent"], **r["args"]}
            ev = {"name": r["name"], "cat": r["cat"] or "default",
                  "pid": 1, "tid": int(r["tid"]) & 0x7FFFFFFF,
                  "ts": (self.profiler_ns(r["t0"], off) - base_ns) / 1e3,
                  "args": args}
            if r["ph"] == "X":
                ev["ph"] = "X"
                ev["dur"] = round(max(0.0, (r["t1"] - r["t0"])) * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_records": self._dropped}}

    def export_chrome_json(self) -> str:
        return json.dumps(self.export_chrome())


#: shared disabled tracer: the default wiring target, so instrumented
#: code never branches on None
NOOP_TRACER = Tracer(enabled=False)

_GLOBAL = NOOP_TRACER


def get_tracer() -> Tracer:
    """Process-global tracer (disabled no-op until ``set_tracer``)."""
    return _GLOBAL


def set_tracer(tracer: Tracer | None) -> Tracer:
    """Install (or with None, reset) the process-global tracer used by
    compile-pass / plan instrumentation gated on the descriptor flag."""
    global _GLOBAL
    _GLOBAL = tracer if tracer is not None else NOOP_TRACER
    return _GLOBAL


def tracer_for(descriptor) -> Tracer:
    """The tracer an instrumentation site records to: the process-global
    one where the backend's descriptor opted in (``observability``), else
    the shared disabled one (whose spans still reach a recording
    profiler)."""
    return (_GLOBAL if getattr(descriptor, "observability", False)
            else NOOP_TRACER)
