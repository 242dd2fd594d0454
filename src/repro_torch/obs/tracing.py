"""Structured span tracing with Chrome trace-event export.

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

Clocks: every timestamp is ``time.monotonic()`` relative to the
tracer's epoch.  No wall-clock is recorded, so traces from restarted
processes never interleave misleadingly (Perfetto renders relative
time anyway).

The disabled path is one attribute check returning shared no-op
singletons; a disabled tracer allocates nothing per call.
"""
from __future__ import annotations

import itertools
import json
import threading
import time


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


class Span:
    __slots__ = ("name", "cat", "span_id", "parent_id", "t0", "t1",
                 "tid", "args", "_tracer", "_on_stack")

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
        enclosing live span on this thread."""
        if not self._enabled:
            return NOOP_SPAN
        st = self._stack()
        pid = parent if parent is not None else (
            st[-1].span_id if st else None)
        sp = Span(self, name, cat, next(self._ids), pid, self.now(),
                  threading.get_ident(), args)
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

    def export_chrome(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable): complete (``X``)
        events with microsecond ``ts``/``dur``; ``args`` carries the
        explicit ``span_id``/``parent_id`` links."""
        events = []
        for r in self.records():
            args = {"span_id": r["id"], "parent_id": r["parent"], **r["args"]}
            ev = {"name": r["name"], "cat": r["cat"] or "default",
                  "pid": 1, "tid": int(r["tid"]) & 0x7FFFFFFF,
                  "ts": round(r["t0"] * 1e6, 3), "args": args}
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
