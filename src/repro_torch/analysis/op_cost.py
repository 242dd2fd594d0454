"""Cost model over the op stream of an eager torch program.

The counterpart of the parts of ``repro.analysis.hlo_cost`` that the fusion
gate (core/passes.py) uses.  There is no HLO here: a candidate program runs
once, concretely, under a ``TorchDispatchMode`` that sees every aten op it
issues, and each op is priced with ``hlo_cost``'s own rules:

* flops  — a dot costs 2·out·K (K the contracted length); every other op 1
           flop per output element;
* bytes  — an op's operands plus its result; a gather costs 2·result +
           index bytes; a scatter (``index_add_``, ``scatter_add_``, …)
           costs result + 3·updates; views, allocations and ``arange``
           (XLA's iota) are free.

A hand-written kernel is priced by its own formula: while a counter is
active its public entry (``kernels/pricing.py``) charges the kernel's
inputs read once, its outputs written once and its arithmetic (the formula
of PERF.md's bound column), and returns zeros of its output shapes.  So no
plain version runs and no kernel launches in a pricing run: a candidate
prices the same on the CPU as on the card, and what comes out of it is
only shapes, for the ops around the kernel to go on with.

Eager execution materialises every intermediate of an unfused chain, so
these counts are the eager program's real traffic, where XLA's fused HLO
would hide some of it.

:func:`analyze` is the counterpart of ``hlo_cost.analyze`` for a whole
step (``launch/dryrun.py``): a counter with ``memory=True`` also follows
the bytes of live storages over the call, so a step built on the ``meta``
device is priced, and its peak memory estimated, without allocating.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import weakref
from typing import Any

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import collectives
from repro_torch.kernels import pricing

#: nominal peaks of the roofline time proxy: the H100 SXM datasheet's
#: float32 rate outside the tensor cores and its HBM3 bandwidth (the
#: figures PERF.md's bound column prices with).  A ratio gate needs only
#: the flops:bytes weighting to be plausible; a calibrated descriptor
#: replaces both with a fit of measured probes (:func:`fit_peaks`)
PEAK_FLOPS_PER_S = 67.0e12
PEAK_BYTES_PER_S = 3.35e12

_aten = torch.ops.aten

#: contractions: 2·out·K flops, K read off the first matrix operand
_DOTS = {_aten.mm.default: 0, _aten.bmm.default: 0, _aten.mv.default: 0,
         _aten.dot.default: 0, _aten.addmm.default: 1,
         _aten.baddbmm.default: 1, _aten.addmv.default: 1}
#: gathers: (index argument position)
_GATHERS = {_aten.gather.default: 2, _aten.index_select.default: 2,
            _aten.index.Tensor: 1, _aten.embedding.default: 1,
            _aten.take.default: 1}
#: scatters: (updates argument position)
_SCATTERS = {_aten.index_add_.default: 3, _aten.index_add.default: 3,
             _aten.scatter_add_.default: 3, _aten.scatter_add.default: 3,
             _aten.scatter_.src: 3, _aten.scatter.src: 3,
             _aten.scatter_.value: None, _aten.scatter.value: None,
             _aten.index_put_.default: 2, _aten.index_put.default: 2,
             _aten.index_copy_.default: 3, _aten.index_copy.default: 3,
             _aten.scatter_reduce_.two: 3, _aten.scatter_reduce.two: 3}
#: zero-traffic bookkeeping: allocations and iota (views are found by
#: ``OpOverload.is_view``)
_FREE = {_aten.empty.memory_format, _aten.empty_like.default,
         _aten.empty_strided.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten.arange.default,
         _aten.arange.start, _aten.arange.start_step, _aten.lift_fresh.default,
         _aten.detach.default, _aten._local_scalar_dense.default,
         _aten.sym_size.int, _aten.sym_stride.int, _aten.sym_numel.default}


#: ops whose later outputs the card does not allocate (CUDA's kernel makes
#: them empty where the CPU's and meta's are full-size): the number of
#: outputs the memory count follows
_CARD_OUTPUTS = {torch.ops.aten.log_sigmoid_forward.default: 1}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)


def _all_tensors(tree):
    """The tensors of a tree of tuples, lists, dicts and modules (a
    module's parameters and buffers)."""
    if isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _all_tensors(x)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _all_tensors(x)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _storage(t: torch.Tensor) -> tuple[int, int] | None:
    """(identity, bytes) of a tensor's storage, which its views share;
    None for a tensor without one."""
    try:
        st = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None
    return st._cdata, st.nbytes()


def _storages(tree) -> dict[int, int]:
    out = {}
    for t in _all_tensors(tree):
        st = _storage(t)
        if st is not None:
            out[st[0]] = st[1]
    return out


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    n = 0
    if isinstance(tree, (list, tuple)):
        for x in tree:
            if isinstance(x, torch.Tensor):
                n += x.numel() * x.element_size()
            elif isinstance(x, (list, tuple)):
                n += _nbytes(x)
    return n


def _nelems(tree) -> int:
    return sum(t.numel() for t in _tensors(tree))


#: id(op) -> (its pricing rule, the argument position the rule reads):
#: ops are long-lived objects whose own hash is Python code, so each is
#: classified once
_RULES: dict[int, tuple[str, int | None]] = {}


def _rule(func) -> tuple[str, int | None]:
    rule = _RULES.get(id(func))
    if rule is None:
        if getattr(func, "is_view", False):
            rule = ("view", None)
        elif func in _FREE:
            rule = ("free", None)
        elif func in _DOTS:
            rule = ("dot", _DOTS[func])
        elif func in _GATHERS:
            rule = ("gather", _GATHERS[func])
        elif func in _SCATTERS:
            rule = ("scatter", _SCATTERS[func])
        else:
            rule = ("other", None)
        _RULES[id(func)] = rule
    return rule


def op_cost(func, args, kwargs, out) -> tuple[float, float]:
    """(flops, bytes) of one aten op call by ``hlo_cost``'s rules."""
    rule, pos = _rule(func)
    if rule in ("view", "free"):
        return 0.0, 0.0
    rb = _nbytes(out)
    if rule == "dot":
        return 2.0 * _nelems(out) * args[pos].shape[-1], float(
            rb + _nbytes(args))
    if rule == "gather":
        return float(_nelems(out)), 2.0 * rb + _nbytes(args[pos])
    if rule == "scatter":
        upd = _nbytes(args[pos]) if pos is not None else 0
        return float(_nelems(out)), float(rb + 3 * upd)
    nb = rb + _nbytes(args)
    if kwargs:
        nb += _nbytes(tuple(kwargs.values()))
    return float(_nelems(out)), float(nb)


class OpCounter(TorchDispatchMode):
    """Sums ``op_cost`` over every aten op issued while it is active (a
    ``with`` block), and the formula of every kernel entry called there
    (``kernels/pricing.py``), whose zero outputs it does not count."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # torch wraps a mode's handler to keep its compiler out, and the
        # wrapper imports torch._dynamo at the first op (seconds, once a
        # process); the counter never runs under torch.compile
        return False

    def __init__(self, memory: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.paused = 0
        #: with ``memory``: the bytes of the storages that ops made and
        #: that are alive, and their peak (``hold`` adds storages that live
        #: throughout, the call's arguments).  A storage counts once, views
        #: included, and is freed when the last tensor on it dies, saved
        #: tensors of autograd's graph included (autograd saves an op's
        #: result through a ``detach`` that passes here)
        self.memory = memory
        self.live = 0
        self.peak = 0
        self._held: set[int] = set()
        self._refs: dict[int, list] = {}
        self._weak: dict[int, tuple] = {}
        self._key: dict[int, int] = {}      # id(tensor) -> storage followed

    def __enter__(self):
        self._pricing = pricing.counting(self)
        self._pricing.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._pricing.__exit__(None, None, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused:
            f, b = op_cost(func, args, kwargs, out)
            self.flops += f
            self.bytes += b
        if self.memory:
            # a view's storage is its base's: known without asking when
            # the base is a tensor followed here
            base = self._key.get(id(args[0])) if args and \
                _rule(func)[0] == "view" else None
            if isinstance(out, torch.Tensor):
                self._track(out, base)
            else:
                for t in list(_tensors(out))[:_CARD_OUTPUTS.get(func)]:
                    self._track(t, base)
        return out

    def hold(self, storages: dict[int, int]) -> None:
        """Count ``storages`` (identity -> bytes) as live throughout."""
        for key, n in storages.items():
            if key not in self._held:
                self._held.add(key)
                self.live += n
        self.peak = max(self.peak, self.live)

    def _track(self, t: torch.Tensor, key: int | None = None) -> None:
        if key is None:
            st = _storage(t)
            if st is None or st[0] in self._held:
                return
            key, n = st
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [0, n]
            self.live += n
            if self.live > self.peak:
                self.peak = self.live
        ref[0] += 1
        w = weakref.ref(t, self._release)
        self._weak[id(w)] = (w, key, id(t))
        self._key[id(t)] = key

    def _release(self, w) -> None:
        _, key, tid = self._weak.pop(id(w))
        if self._key.get(tid) == key:
            del self._key[tid]
        ref = self._refs[key]
        ref[0] -= 1
        if ref[0] == 0:
            del self._refs[key]
            self.live -= ref[1]

    def charge(self, flops: float, nbytes: float) -> None:
        self.flops += float(flops)
        self.bytes += float(nbytes)

    @contextlib.contextmanager
    def pause(self):
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1


def host_fingerprint(device=None) -> str:
    """Short identity digest of this host and the device the estimates are
    priced for (``torch.cuda.get_device_name``, or ``"cpu"``): peak
    constants are properties of both, and estimates made on the CPU and on
    the card must never share a cache."""
    import platform
    dev = torch.device("cuda" if device is None and torch.cuda.is_available()
                       else device if device is not None else "cpu")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    raw = f"{platform.node()}:{platform.machine()}:{os.cpu_count()}:{name}"
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def estimate_callable(fn, *args, peaks: tuple[float, float] | None = None
                      ) -> dict[str, Any]:
    """Run ``fn(*args)`` once under ``torch.no_grad()`` and an
    :class:`OpCounter`; returns ``flops_per_chip``, ``bytes_per_chip`` and
    ``time_proxy_s`` = flops/peak + bytes/peak, an additive roofline proxy
    (comparing two candidates' proxies orders them by modelled cost even
    when one resource dominates).  ``peaks`` overrides the nominal
    ``(PEAK_FLOPS_PER_S, PEAK_BYTES_PER_S)``.  Callers cache per content
    key: the run is the expensive part."""
    pf, pb = peaks if peaks is not None else (PEAK_FLOPS_PER_S,
                                              PEAK_BYTES_PER_S)
    with torch.no_grad(), OpCounter() as counter:
        fn(*args)
    return {"flops_per_chip": counter.flops, "bytes_per_chip": counter.bytes,
            "time_proxy_s": counter.flops / pf + counter.bytes / pb}


def analyze(fn, *args) -> dict[str, Any]:
    """Run ``fn(*args)`` once under an :class:`OpCounter` with memory and
    return ``hlo_cost.analyze``'s keys and ``memory``.  The collectives
    are those the call makes through ``repro_torch/collectives.py`` (on a
    mesh; none on one card), under the reference's kind names and with
    its volumes; their operands' and results' bytes join
    ``bytes_per_chip``, as ``hlo_cost`` adds them.  ``memory`` is the
    split of ``compiled.memory_analysis()``:
    ``argument_bytes`` (the arguments' storages), ``output_bytes`` (the
    result's), ``alias_bytes`` (the result's storages that are
    arguments': state updated in place, the donated KV cache),
    ``temp_bytes`` (the rest of the peak) and ``peak_bytes`` = argument +
    temp + output - alias, the most bytes alive at once.  The arguments
    may lie on ``meta``: nothing is allocated then, and kernel entries
    are priced by their formulas (``kernels/pricing.py``)."""
    arg_st = _storages(args)
    with OpCounter(memory=True) as counter, \
            collectives.recording() as rec:
        counter.hold(arg_st)
        out = fn(*args)
        out_st = _storages(out)
        peak = counter.peak
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    arg_b, out_b = sum(arg_st.values()), sum(out_st.values())
    del out
    return {
        "flops_per_chip": counter.flops,
        "bytes_per_chip": counter.bytes + rec.io_bytes,
        "collective_bytes_per_chip": rec.total,
        "collectives": dict(rec.bytes),
        "collective_counts": {k: float(n) for k, n in rec.counts.items()},
        "memory": {"argument_bytes": arg_b, "output_bytes": out_b,
                   "alias_bytes": alias,
                   "temp_bytes": peak - arg_b - (out_b - alias),
                   "peak_bytes": peak},
    }


# ---------------------------------------------------------------------------
# peak calibration from measured gate records
# ---------------------------------------------------------------------------

def _ratio(rec: dict, gamma: float) -> float | None:
    """Predicted fused/unfused time ratio at flops:bytes weight ``gamma``
    (gamma = peak_flops / peak_bytes — the byte premium in flop units)."""
    try:
        fu = rec["unfused"]["flops"] + gamma * rec["unfused"]["bytes"]
        ff = rec["fused"]["flops"] + gamma * rec["fused"]["bytes"]
    except (KeyError, TypeError):
        return None
    if fu <= 0 or ff <= 0:
        return None
    return ff / fu


def fit_peaks(records: list[dict]) -> dict | None:
    """Fit per-host roofline peaks from measured gate-calibration records.

    Each record carries, per candidate (``unfused`` / ``fused``), the op
    counts and a measured wall-clock: ``{"flops", "bytes", "measured_s"}``.
    The proxy is ``t = (F + gamma*B) / Pf`` with ``gamma = Pf/Pb``, so the
    *ratio* of two candidates depends only on gamma: step 1 grid-searches
    gamma to minimise the squared log-ratio error against the measured
    ratios; step 2 anchors the absolute scale by the median of
    ``(F + gamma*B) / measured_s`` over every candidate.  Returns None when
    no record is usable (the caller keeps the nominal constants)."""
    import math

    usable = []
    for rec in records or ():
        ok = True
        for side in ("unfused", "fused"):
            c = rec.get(side) or {}
            if not all(isinstance(c.get(f), (int, float)) and c.get(f) > 0
                       for f in ("flops", "bytes", "measured_s")):
                ok = False
        if ok:
            usable.append(rec)
    if not usable:
        return None

    def log_err(gamma: float) -> float:
        total = 0.0
        for rec in usable:
            pred = _ratio(rec, gamma)
            meas = rec["fused"]["measured_s"] / rec["unfused"]["measured_s"]
            total += (math.log(pred) - math.log(meas)) ** 2
        return total

    # gamma grid: 1 (pure-flops pricing) .. 1e4 (extreme byte premium)
    grid = [10 ** (e / 8.0) for e in range(0, 33)]
    gamma = min(grid, key=log_err)
    scales = []
    for rec in usable:
        for side in ("unfused", "fused"):
            c = rec[side]
            scales.append((c["flops"] + gamma * c["bytes"]) / c["measured_s"])
    scales.sort()
    pf = scales[len(scales) // 2]          # median: robust to one bad probe
    err = math.sqrt(log_err(gamma) / len(usable))
    return {"peak_flops_per_s": pf, "peak_bytes_per_s": pf / gamma,
            "gamma": gamma, "n_records": len(usable),
            "rms_log_ratio_error": err}


#: the ends of ``fit_peaks``'s gamma grid, and the largest rms log-ratio
#: error of a fit that may replace a descriptor's peaks: the autotune
#: band's 0.25, past which the fit mispredicts the ratios the gate decides
#: on by more than the margin it trusts estimates within
FIT_GAMMA_RANGE = (1.0, 1.0e4)
FIT_MAX_RMS_LOG_ERROR = 0.25


def fit_refusal(fit: dict) -> str | None:
    """Why a ``fit_peaks`` result must not be noted or applied on its own
    (``with_profile``'s auto-refit), or None where it may: a gamma at
    either end of the grid is not identified by the records (the best fit
    may lie past it), and an rms log-ratio error above
    ``FIT_MAX_RMS_LOG_ERROR`` predicts the measured ratios too poorly.  A
    fit without these keys (one written by hand) is not refused."""
    gamma = fit.get("gamma")
    if gamma is not None and not FIT_GAMMA_RANGE[0] < gamma \
            < FIT_GAMMA_RANGE[1]:
        return (f"gamma {gamma} at the grid's edge "
                f"{list(FIT_GAMMA_RANGE)}: not identified by the records")
    err = fit.get("rms_log_ratio_error")
    if err is not None and err > FIT_MAX_RMS_LOG_ERROR:
        return (f"rms log-ratio error {err} above "
                f"{FIT_MAX_RMS_LOG_ERROR}")
    return None


def calibration_records(summary: dict) -> list[dict]:
    """Extract usable calibration records from a bench ``summary.json``
    (the ``calibration`` blocks the fusion/dense/autotune sections emit per
    workload).  Tolerant of older artifacts that lack the per-candidate
    counts — those records are simply skipped by ``fit_peaks``."""
    out = []
    for section in ("fusion", "dense", "autotune"):
        sec = summary.get(section) or {}
        for w in (sec.get("workloads") or {}).values():
            cal = w.get("calibration")
            if cal:
                out.append(cal)
    return out
