"""Metrics registry: counters, gauges, and log-spaced histograms.

One ``MetricsRegistry`` is the source of truth for every counter the
stack used to keep as ad-hoc attributes (``TraceLog`` serve counters,
scheduler shed/lane counters, ``StageResultCache`` hits/misses, engine
jit/chunk cache stats, ``PassContext`` tuning counters).  Components
register *instruments* (``Counter``/``Gauge``/``Histogram``) keyed by
name; instrument registration is idempotent, so a component re-created
against the same registry shares the existing series.

Instruments carry label *names* at registration and label *values* per
observation; each distinct label-value tuple is an independent series.
Reads come in two shapes: ``snapshot()`` (a plain nested dict, the form
``stats()``/``summary()`` readers consume) and ``render_text()`` (the
Prometheus text exposition format, label escaping included).

Cost model: an increment is one dict lookup on the instrument's series
table plus a float add under a per-instrument lock — cheap enough to be
always-on.  The opt-in machinery (``ServeConfig.with_observability``)
gates only the *tracing* and *flight-recorder* layers, which allocate
per-event records.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterator, Mapping

#: fixed log-spaced latency buckets (milliseconds): 0.1ms .. ~52s, x2 per
#: rung.  Shared by every latency histogram so series stay comparable.
LATENCY_BUCKETS_MS: tuple[float, ...] = tuple(
    0.1 * (2.0 ** i) for i in range(20))


def _label_key(labels) -> tuple:
    if isinstance(labels, tuple):
        return labels
    if isinstance(labels, (list,)):
        return tuple(labels)
    return (labels,)


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


class _Instrument:
    """Base: a named family of series, one per label-value tuple."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict[tuple, float] = {}

    def _check(self, key: tuple) -> None:
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: got {len(key)} label values for "
                f"{len(self.labelnames)} label names {self.labelnames}")

    def touch(self, labels=()) -> None:
        """Materialise a zero-valued series (so renders/summaries list it
        before the first observation)."""
        key = _label_key(labels)
        self._check(key)
        with self._lock:
            self._series.setdefault(key, 0.0)

    def value(self, labels=()) -> float:
        key = _label_key(labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def series(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._series)

    def _set(self, labels, v: float) -> None:
        key = _label_key(labels)
        self._check(key)
        with self._lock:
            self._series[key] = float(v)

    def _render_series(self) -> Iterator[str]:
        for key, v in sorted(self.series().items(), key=lambda kv: kv[0]):
            yield f"{self.name}{self._labelstr(key)} {_fmt(float(v))}"

    def _labelstr(self, key: tuple, extra: str = "") -> str:
        parts = [f'{n}="{escape_label_value(v)}"'
                 for n, v in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""


class Counter(_Instrument):
    """Monotone counter.  ``inc`` only; ``_set`` is reserved for internal
    views (``CounterMap``) that need dict-style assignment."""

    kind = "counter"

    def inc(self, n: float = 1.0, labels=()) -> None:
        key = _label_key(labels)
        self._check(key)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + n

    def snapshot_value(self, key: tuple):
        with self._lock:
            v = float(self._series.get(key, 0.0))
        return int(v) if v.is_integer() else v


class Gauge(_Instrument):
    """Point-in-time value.  ``set_fn`` registers a pull-style collector:
    the callable is invoked at snapshot/render time (used to surface LRU
    cache internals without mirroring every update)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labelnames: tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)
        self._fns: dict[tuple, Callable[[], float]] = {}

    def set(self, v: float, labels=()) -> None:
        self._set(labels, v)

    def add(self, n: float = 1.0, labels=()) -> None:
        key = _label_key(labels)
        self._check(key)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + n

    def set_fn(self, fn: Callable[[], float], labels=()) -> None:
        key = _label_key(labels)
        self._check(key)
        with self._lock:
            self._fns[key] = fn

    def series(self) -> dict[tuple, float]:
        with self._lock:
            out = dict(self._series)
            fns = dict(self._fns)
        for key, fn in fns.items():
            try:
                out[key] = float(fn())
            except Exception:
                out.setdefault(key, 0.0)
        return out


class Histogram(_Instrument):
    """Fixed-bucket histogram (log-spaced by default).  Each series keeps
    per-bucket counts plus sum/count/min/max; exposition renders the
    Prometheus cumulative ``_bucket{le=...}`` form."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = LATENCY_BUCKETS_MS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        self._h: dict[tuple, dict] = {}

    def _blank(self) -> dict:
        return {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0,
                "count": 0, "min": None, "max": None}

    def touch(self, labels=()) -> None:
        key = _label_key(labels)
        self._check(key)
        with self._lock:
            self._h.setdefault(key, self._blank())

    def observe(self, v: float, labels=()) -> None:
        key = _label_key(labels)
        self._check(key)
        v = float(v)
        lo, hi = 0, len(self.buckets)
        while lo < hi:                      # first bucket with v <= bound
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            h = self._h.get(key)
            if h is None:
                h = self._h[key] = self._blank()
            h["counts"][lo] += 1
            h["sum"] += v
            h["count"] += 1
            h["min"] = v if h["min"] is None else min(h["min"], v)
            h["max"] = v if h["max"] is None else max(h["max"], v)

    def stats(self, labels=()) -> dict:
        """sum/count/mean/min/max for one series (zeros when unseen)."""
        key = _label_key(labels)
        with self._lock:
            h = self._h.get(key)
            if h is None:
                return {"count": 0, "sum": 0.0, "mean": 0.0,
                        "min": None, "max": None}
            return {"count": h["count"], "sum": h["sum"],
                    "mean": h["sum"] / h["count"] if h["count"] else 0.0,
                    "min": h["min"], "max": h["max"]}

    def series(self) -> dict[tuple, dict]:
        with self._lock:
            return {k: {"counts": list(h["counts"]), "sum": h["sum"],
                        "count": h["count"], "min": h["min"],
                        "max": h["max"]}
                    for k, h in self._h.items()}

    def _render_series(self) -> Iterator[str]:
        for key, h in sorted(self.series().items(), key=lambda kv: kv[0]):
            cum = 0
            for bound, c in zip(self.buckets, h["counts"]):
                cum += c
                ls = self._labelstr(key, f'le="{_fmt(bound)}"')
                yield f"{self.name}_bucket{ls} {cum}"
            cum += h["counts"][-1]
            ls = self._labelstr(key, 'le="+Inf"')
            yield f"{self.name}_bucket{ls} {cum}"
            yield f"{self.name}_sum{self._labelstr(key)} {_fmt(h['sum'])}"
            yield f"{self.name}_count{self._labelstr(key)} {h['count']}"


class CounterMap(Mapping):
    """Dict-shaped view over one labelled ``Counter`` — the bridge that
    lets ``PassContext.counters['gate_estimates'] += 1`` land on the
    registry while ``dict(pctx.counters)`` keeps its legacy shape."""

    def __init__(self, counter: Counter, keys: tuple[str, ...]):
        self._counter = counter
        self._keys = tuple(keys)
        for k in self._keys:
            counter.touch((k,))

    def __getitem__(self, k: str):
        if k not in self._keys:
            raise KeyError(k)
        return self._counter.snapshot_value((k,))

    def __setitem__(self, k: str, v) -> None:
        if k not in self._keys:
            raise KeyError(k)
        self._counter._set((k,), v)

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)


class MetricsRegistry:
    """Named instrument table.  ``counter``/``gauge``/``histogram`` are
    get-or-create: re-registration with the same name returns the
    existing instrument (kind-checked), so shared components aggregate
    into one series instead of colliding."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}

    def _get(self, cls, name: str, help: str, labelnames, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise TypeError(
                        f"instrument {name!r} already registered as "
                        f"{inst.kind}, requested {cls.kind}")
                return inst
            inst = cls(name, help, tuple(labelnames), **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets: tuple[float, ...] = LATENCY_BUCKETS_MS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def instruments(self) -> list[_Instrument]:
        with self._lock:
            return [self._instruments[n] for n in sorted(self._instruments)]

    def snapshot(self) -> dict:
        """name -> {kind, and per-series values keyed by the label tuple
        rendered ``a=x,b=y`` (empty string for the unlabelled series)}."""
        out: dict[str, dict] = {}
        for inst in self.instruments():
            entry: dict = {"kind": inst.kind, "series": {}}
            if isinstance(inst, Histogram):
                for key, h in inst.series().items():
                    entry["series"][self._keystr(inst, key)] = {
                        "count": h["count"], "sum": h["sum"],
                        "min": h["min"], "max": h["max"]}
            else:
                for key, v in inst.series().items():
                    v = float(v)
                    entry["series"][self._keystr(inst, key)] = (
                        int(v) if v.is_integer() else v)
            out[inst.name] = entry
        return out

    @staticmethod
    def _keystr(inst: _Instrument, key: tuple) -> str:
        return ",".join(f"{n}={v}" for n, v in zip(inst.labelnames, key))

    def render_text(self) -> str:
        """Prometheus text exposition (``# HELP`` / ``# TYPE`` + series)."""
        lines: list[str] = []
        for inst in self.instruments():
            if inst.help:
                lines.append(f"# HELP {inst.name} {inst.help}")
            lines.append(f"# TYPE {inst.name} {inst.kind}")
            lines.extend(inst._render_series())
        return "\n".join(lines) + ("\n" if lines else "")


#: process-global default registry (components take ``registry=None`` to
#: mean "a private registry"; pass this one to aggregate across them)
GLOBAL_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return GLOBAL_REGISTRY
