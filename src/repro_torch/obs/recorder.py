"""Flight recorder: a bounded ring of recent scheduler/engine events.

The serving layer's aggregate counters say *how many* requests were
shed; they cannot say *why request 4117 specifically* was turned away.
The flight recorder keeps the last N decision-level events — admissions,
door/queue sheds with the service-model inputs (S(n) estimate, queue
depth, deadline slack) that justified them, deadline drops, and engine
recompiles — so an overload incident can be reconstructed after the
fact with ``dump()``.

Events are plain dicts (JSON-serialisable by construction: callers pass
only str/int/float/bool/None fields), appended to a ``deque(maxlen=N)``;
appends are atomic under the GIL, so the hot path takes no lock.  A
disabled recorder is represented by ``None`` at the call sites (one
``is not None`` check).
"""
from __future__ import annotations

import time
from collections import deque


class FlightRecorder:
    """Bounded event ring with a monotonic per-recorder clock."""

    def __init__(self, capacity: int = 1024):
        self.capacity = int(capacity)
        self._epoch = time.monotonic()
        self._events: deque[dict] = deque(maxlen=self.capacity)
        self.n_recorded = 0

    def now(self) -> float:
        return time.monotonic() - self._epoch

    def record(self, kind: str, **fields) -> None:
        self.n_recorded += 1
        self._events.append({"t": round(self.now(), 6), "kind": kind,
                             **fields})

    def dump(self, last: int | None = None) -> list[dict]:
        """Most recent events, oldest first (``last`` trims to a tail)."""
        evs = list(self._events)
        return evs[-last:] if last is not None else evs

    def clear(self) -> None:
        self._events.clear()
        self.n_recorded = 0

    def __len__(self) -> int:
        return len(self._events)

    def kinds(self) -> dict[str, int]:
        """Event-kind histogram of the retained window."""
        out: dict[str, int] = {}
        for e in self._events:
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out
