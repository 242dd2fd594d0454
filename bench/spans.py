"""The program's own spans in a traced run, and the device work launched
under them.

The program mirrors each of its spans (``experiment.call``, ``plan.build``,
``sparse.gather``, ``generate.lm``, ...) into ``torch.profiler`` as a host
range of the same name.  ``Spans.of(profile)`` reads the profiler's events
once (cached on the ``devtrace.Profile``) and keeps:

- each program span (a host range with a dotted name): start, end and
  thread, clipped to the window;
- each device operation (kernel, copy, set), clipped to the window, with
  the runtime call that launched it (a kernel launch, a copy, a set or a
  ``cudaGraphLaunch``), joined by the correlation id the two share.

A device operation counts under span X when its launch lies inside an X
interval on the same thread; nested spans count for their ancestors too,
and a name's intervals are merged first, so nested or repeated spans of
one name count once.  Nothing is guessed from time overlap: an operation
whose launch the profiler did not record counts under no span."""
from __future__ import annotations

import bisect
import re

import torch

from devtrace import WINDOW

#: the host ranges the program names: dotted words, as ``plan.stage``
PROGRAM = re.compile(r"[A-Za-z_][\w-]*(\.[\w-]+)+")
#: the CUDA API's calls (``cuda*`` and ``cu*``), among them every call that
#: puts work on the card (``cudaLaunchKernel``, ``cuLaunchKernel``,
#: ``cudaMemcpyAsync``, ``cudaGraphLaunch``, ...)
RUNTIME = re.compile(r"cu(da)?[A-Z]")


def merge(intervals) -> list[tuple[int, int]]:
    """The union of ``(start, end)`` intervals, merged, in order."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _inside(merged: list[tuple[int, int]], starts: list[int], t: int) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= merged[i][1]


class Spans:
    """Program spans ``{name: [(start, end, thread)]}`` and device
    operations ``[(launch, thread, start, end)]`` (``launch`` None where
    the launch was not recorded), in ns, clipped to ``window``."""

    def __init__(self, spans: dict, ops: list, window: tuple[int, int]):
        a, b = window
        self.window = window
        clipped = {n: [(max(s, a), min(e, b), t) for s, e, t in v
                       if e > a and s < b] for n, v in spans.items()}
        self.spans = {n: v for n, v in clipped.items() if v}
        self.ops = [(launch, t, max(s, a), min(e, b))
                    for launch, t, s, e in ops if e > a and s < b]

    @classmethod
    def of(cls, profile) -> "Spans | None":
        """The spans of a traced run's ``devtrace.Profile`` (None without
        one), read from its profiler once."""
        if profile is None:
            return None
        if getattr(profile, "_spans", None) is None:
            profile._spans = cls.read(profile._prof, profile.window_ns)
        return profile._spans

    @classmethod
    def read(cls, prof, window: tuple[int, int]) -> "Spans":
        cpu = torch.autograd.DeviceType.CPU
        spans: dict = {}
        launches: dict = {}
        device = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cpu:
                name = e.name()
                if RUNTIME.match(name):
                    launches[e.correlation_id()] = (e.start_ns(),
                                                    e.start_thread_id())
                elif name != WINDOW and PROGRAM.fullmatch(name):
                    spans.setdefault(name, []).append(
                        (e.start_ns(), e.start_ns() + e.duration_ns(),
                         e.start_thread_id()))
            elif not e.is_user_annotation():   # not a range's copy on the card
                device.append((e.correlation_id(), e.start_ns(),
                               e.start_ns() + e.duration_ns()))
        ops = [(*launches.get(c, (None, None)), s, e) for c, s, e in device]
        return cls(spans, ops, window)

    def intervals(self, *names: str) -> list[tuple[int, int]]:
        """The union of the spans of ``names`` on the time axis."""
        return merge((s, e) for n in names for s, e, _ in
                     self.spans.get(n, ()))

    def seconds(self, *names: str) -> float | None:
        """Seconds of the window inside a span of ``names`` (None where
        there is no such span)."""
        iv = self.intervals(*names)
        return sum(e - s for s, e in iv) / 1e9 if iv else None

    def device_seconds_under(self, *names: str) -> float | None:
        """Seconds of the union of the device operations launched under a
        span of ``names`` (None where no operation was)."""
        by_thread: dict = {}
        for n in names:
            for s, e, t in self.spans.get(n, ()):
                by_thread.setdefault(t, []).append((s, e))
        tables = {}
        for t, iv in by_thread.items():
            m = merge(iv)
            tables[t] = (m, [s for s, _ in m])
        hit = [(s, e) for launch, t, s, e in self.ops
               if launch is not None and t in tables
               and _inside(*tables[t], launch)]
        return sum(e - s for s, e in merge(hit)) / 1e9 if hit else None
