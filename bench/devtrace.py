"""What a traced run reads: the profiler's device timeline over the
measured window, and the shapes of the hand kernels' calls.

``Profile`` wraps ``torch.profiler`` around the window (marked by a
``bench.window`` range) and reduces its events to device intervals (every
kernel, copy and set on the card), the union of those intervals (busy
seconds), time by kernel name, and the host activity under each idle gap.
``CallRecorder`` wraps the program's kernel entries to record each call's
shapes, from which the roofline readers price the calls."""
from __future__ import annotations

import bisect
import contextlib
import functools
import time
from collections import defaultdict

import torch

WINDOW = "bench.window"


class Profile:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.device: list[tuple[str, int, int]] = []   # (name, start, end) ns
        self.host: list[tuple[int, int, str]] = []     # (start, end, name)
        self.window_ns = (0, 0)
        self._busy = None

    @contextlib.contextmanager
    def window(self):
        self._prof.__enter__()
        try:
            with torch.profiler.record_function(WINDOW):
                yield self
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            self._prof.__exit__(None, None, None)
        self._collect()

    def _collect(self) -> None:
        t0 = time.perf_counter()
        try:
            events = self._prof.profiler.kineto_results.events()
            rows = [(e.name(), e.device_type(), e.start_ns(), e.duration_ns(),
                     str(e.activity_type()) if hasattr(e, "activity_type")
                     else "") for e in events]
        except AttributeError:           # older profilers: FunctionEvents
            rows = [(e.name, e.device_type, int(e.time_range.start * 1000),
                     int(e.time_range.elapsed_us() * 1000), "")
                    for e in self._prof.events()]
        cpu = torch.autograd.DeviceType.CPU
        for name, dev, start, dur, kind in rows:
            if dev != cpu and (name == WINDOW or "annotation" in kind.lower()):
                continue                  # a host range mirrored on the card
            if dev == cpu:
                if name == WINDOW:
                    self.window_ns = (start, start + dur)
                else:
                    self.host.append((start, start + dur, name))
            else:
                self.device.append((name, start, start + dur))
        a, b = self.window_ns
        self.device = [(n, max(s, a), min(e, b)) for n, s, e in self.device
                       if e > a and s < b]
        self.host.sort()
        self.collect_s = time.perf_counter() - t0

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device's operation intervals, merged, in
        order (computed once)."""
        if self._busy is None:
            merged: list[list[int]] = []
            for s, e in sorted((s, e) for _, s, e in self.device):
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._busy = [(s, e) for s, e in merged]
        return self._busy

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernels(self, *substrings: str) -> tuple[int, float]:
        """(launches, device seconds) of device operations whose name holds
        any of ``substrings``."""
        n, t = 0, 0
        for name, s, e in self.device:
            if any(x in name for x in substrings):
                n += 1
                t += e - s
        return n, t / 1e9

    def device_ops(self, top: int = 10) -> list:
        by = defaultdict(int)
        for name, s, e in self.device:
            by[name[:120]] += e - s
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, scan: int = 64,
                  short_ns: int = 20_000) -> list:
        """Idle seconds of the window by the host operation that was
        running at each gap's midpoint (the innermost one found; none
        where the host ran Python without a torch operation, or slept).
        Gaps under ``short_ns`` (the launch gaps between back-to-back
        operations, millions in a long window) are summed as one entry."""
        a, b = self.window_ns
        gaps, prev = [], a
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if b > prev:
            gaps.append((prev, b))
        starts = [h[0] for h in self.host]
        by = defaultdict(int)
        for g0, g1 in gaps:
            if g1 - g0 < short_ns:
                by[f"(gaps under {short_ns // 1000} us)"] += g1 - g0
                continue
            mid = (g0 + g1) // 2
            i = bisect.bisect_right(starts, mid)
            best = None
            for j in range(i - 1, max(i - 1 - scan, -1), -1):
                s, e, name = self.host[j]
                if e >= mid and (best is None or e - s < best[0]):
                    best = (e - s, name)
            by[best[1][:120] if best else "(Python, no torch operation)"] += \
                g1 - g0
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


#: (module, attribute) of each hand kernel's entry the recorder wraps
ENTRIES = {
    "fused_scoring": [("repro_torch.kernels.fused_scoring.ops",
                       "fused_scoring")],
    "topk": [("repro_torch.kernels.topk.ops", "streaming_topk")],
    "flash": [("repro_torch.kernels.flash_attention.ops", "flash_attention"),
              ("repro_torch.models.layers", "flash_attention")],
}


def _shape(entry: str, args, kwargs) -> tuple:
    if entry == "fused_scoring":
        tf, df = args[0], args[2]
        return (tf.numel(), df.numel(), tuple(kwargs["models"]))
    if entry == "topk":
        s = args[0]
        return (s.numel() // s.shape[-1], s.shape[-1], int(kwargs["k"]),
                s.element_size())
    q, k = args[0], args[1]
    B, S, H, D = q.shape
    return (B, S, k.shape[1], H, k.shape[2], D, q.element_size(),
            bool(kwargs.get("causal", True)), int(kwargs.get("chunk", 0)))


class CallRecorder:
    """Records (in_window, shape) of every call of the hand kernels'
    entries while installed; ``in_window`` flips with :meth:`window`."""

    def __init__(self):
        self.calls: dict[str, list] = defaultdict(list)
        self.in_window = False
        self._undo = []

    def install(self) -> "CallRecorder":
        import importlib
        for entry, places in ENTRIES.items():
            for mod_name, attr in places:
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, attr)
                setattr(mod, attr, self._wrap(entry, orig))
                self._undo.append((mod, attr, orig))
        return self

    def _wrap(self, entry, orig):
        @functools.wraps(orig)
        def call(*args, **kwargs):
            self.calls[entry].append((self.in_window,
                                      _shape(entry, args, kwargs)))
            return orig(*args, **kwargs)
        return call

    def uninstall(self) -> None:
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()

    @contextlib.contextmanager
    def window(self):
        self.in_window = True
        try:
            yield
        finally:
            self.in_window = False
