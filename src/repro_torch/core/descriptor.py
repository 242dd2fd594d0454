"""Backend capability descriptors + persisted tuning profiles.

A :class:`BackendDescriptor` is a frozen config object carrying what the
compiler needs to know about a backend *as data*:

* capability flags            (which rewrites/lowerings are legal),
* kernel limits               (the native-k ceilings of the CUDA kernels,
                               read off the port's own ``kernels/*/ops.py``,
                               so "will this K hit the kernel" is a
                               descriptor lookup),
* roofline peaks              (the constants the fusion gate's op-stream
                               cost model prices with: the H100 datasheet's
                               by default, refitted from measured probes via
                               ``analysis.op_cost.fit_peaks``),
* a tuning-profile handle     (persisted gate decisions keyed by
                               ``(backend digest, op key, bucket)``),
* autotune policy             (opt-in measurement of gate candidates whose
                               estimated margin is within a band, with CUDA
                               events on the card), and
* observability               (route compile-pass spans to the
                               process-global tracer).

Passes receive the descriptor at build time (``default_passes(desc)``);
``TorchBackend`` exposes one as ``backend.descriptor``.

:class:`TuningProfile` is the persistence layer: an on-disk JSON store of
fusion-gate decisions, hardened the same way ``plan.ArtifactCache`` is —
pid-suffixed tmp file + atomic replace on write, corrupt/truncated files
degrade to an empty profile instead of taking the compile down.  A profile
hit replays the stored decision with ZERO candidate estimates and ZERO
probe measurements, which is what lets repeated Experiments and server
restarts skip the expensive half of compilation.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path

from repro_torch.analysis.op_cost import (PEAK_BYTES_PER_S, PEAK_FLOPS_PER_S,
                                          fit_refusal)

#: the full capability set of the torch backend, the JAX backend's: block-max
#: pruning, fat postings, single-pass multi-model retrieval (LinearFusion),
#: and the kernel lowerings: sparse top-k, fused scoring, dense retrieval,
#: dense rerank, IVF-PQ
DEFAULT_CAPABILITIES = frozenset({
    "pruned_topk", "fat", "multi_model", "fused_topk", "fused_scoring",
    "dense_topk", "fused_dense", "pq_topk",
})


# ---------------------------------------------------------------------------
# tuning profile — persisted fusion-gate decisions
# ---------------------------------------------------------------------------

class TuningProfile:
    """On-disk store of fusion-gate decisions keyed by
    ``(backend digest, op key, bucket)``.

    The key is fully content-derived: the backend digest covers the index
    arrays + execution config (``plan.backend_digest``), the op key names
    the candidate pair the gate compared, and the bucket is the query-term
    width the candidates were priced/probed at.  A profile written on one
    backend therefore can never serve decisions to a different index — the
    digest misses and the gate re-derives.

    ``path=None`` keeps the profile in memory (tests, throwaway tuning).
    """

    VERSION = 1

    def __init__(self, path: str | Path | None = None):
        self.path = None if path is None else Path(path)
        self.entries: dict[str, dict] = {}
        self.calibration: dict | None = None
        self.hits = 0
        self.misses = 0
        self.dirty = False
        self._load()

    # -- persistence --------------------------------------------------------
    def _load(self) -> None:
        if self.path is None or not self.path.exists():
            return
        try:
            doc = json.loads(self.path.read_text())
            if doc.get("version") != self.VERSION:
                raise ValueError(f"profile version {doc.get('version')!r}")
            entries = doc["entries"]
            if not isinstance(entries, dict):
                raise TypeError("entries must be a mapping")
            self.entries = entries
            cal = doc.get("calibration")
            self.calibration = cal if isinstance(cal, dict) else None
        except Exception:
            # corrupt / truncated / foreign / old-version file: a tuning
            # store must degrade to re-tuning, never take the compile down
            self.path.unlink(missing_ok=True)
            self.entries = {}
            self.calibration = None

    def save(self) -> None:
        """Atomic publish (pid-suffixed tmp + replace — the ArtifactCache
        hardening pattern; concurrent writers race benignly)."""
        if self.path is None or not self.dirty:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        doc = {"version": self.VERSION, "entries": self.entries}
        if self.calibration is not None:
            doc["calibration"] = self.calibration
        tmp = self.path.with_name(f"{self.path.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(doc, indent=1))
        tmp.replace(self.path)
        self.dirty = False

    # -- keying -------------------------------------------------------------
    @staticmethod
    def key(backend_digest: str, op_key, bucket: int) -> str:
        return hashlib.sha256(
            f"{backend_digest}:{op_key!r}:{bucket}".encode()).hexdigest()

    # -- access -------------------------------------------------------------
    def lookup(self, backend_digest: str, op_key, bucket: int) -> dict | None:
        ent = self.entries.get(self.key(backend_digest, op_key, bucket))
        if ent is None:
            self.misses += 1
            return None
        self.hits += 1
        return ent["decision"]

    def record(self, backend_digest: str, op_key, bucket: int,
               decision: dict) -> None:
        k = self.key(backend_digest, op_key, bucket)
        ent = {"decision": _jsonable(decision), "bucket": bucket,
               "op": repr(op_key)}
        if self.entries.get(k) != ent:
            self.entries[k] = ent
            self.dirty = True

    # -- roofline auto-refit ------------------------------------------------
    def note_calibration(self, fit: dict | None) -> None:
        """Record the bench trajectory's latest roofline fit
        (``op_cost.fit_peaks`` output).  Descriptors attaching this
        profile via ``with_profile`` auto-apply a noted fit that is newer
        than their current ``peak_digest`` — no explicit
        ``descriptor.calibrated(fit)`` call needed.  A fit that
        ``op_cost.fit_refusal`` refuses (gamma at the grid's edge, or too
        large an error) is not noted."""
        if not isinstance(fit, dict) or \
                "peak_flops_per_s" not in fit or "peak_bytes_per_s" not in fit \
                or fit_refusal(fit) is not None:
            return
        ent = {"fit": _jsonable(fit), "applied_digest": None}
        if (self.calibration or {}).get("fit") != ent["fit"]:
            self.calibration = ent
            self.dirty = True

    def refresh_from_summary(self, summary: dict) -> None:
        """Pull the ``calibration_fit`` block out of a bench-trajectory
        summary (the autotune section emits it) into this profile."""
        self.note_calibration((summary.get("autotune") or
                               {}).get("calibration_fit"))

    def pending_fit(self, peak_digest: str) -> dict | None:
        """The noted fit, if it has not yet been applied to a descriptor
        with this ``peak_digest`` (i.e. the trajectory is newer than the
        profile's recorded calibration state)."""
        cal = self.calibration
        if not cal or not isinstance(cal.get("fit"), dict) or \
                fit_refusal(cal["fit"]) is not None:
            return None
        if cal.get("applied_digest") == peak_digest:
            return None
        return cal["fit"]

    def mark_calibrated(self, peak_digest: str) -> None:
        if self.calibration is not None and \
                self.calibration.get("applied_digest") != peak_digest:
            self.calibration["applied_digest"] = peak_digest
            self.dirty = True

    def info(self) -> dict:
        return {"path": None if self.path is None else str(self.path),
                "entries": len(self.entries), "hits": self.hits,
                "misses": self.misses, "dirty": self.dirty,
                "calibrated": bool(self.calibration)}


def _jsonable(d: dict) -> dict:
    """Round-trip a decision dict through JSON semantics now, so what the
    profile serves on a hit is bit-identical to what a reloaded file would
    serve (tuples become lists either way)."""
    return json.loads(json.dumps(d))


# ---------------------------------------------------------------------------
# backend descriptor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BackendDescriptor:
    """Frozen description of a backend's optimisation surface.

    ``kernel_limits`` maps gate pattern -> max kernel-native k (None = no
    k ceiling for that pattern).  ``peak_flops_per_s`` /
    ``peak_bytes_per_s`` parameterise the op-stream roofline proxy;
    ``host`` fingerprints the host and device they price (it scopes the
    backend's estimate cache, so estimates made on the CPU never answer for
    the card).  ``profile`` / ``autotune*`` are the measurement-driven
    layer: see the module docstring.
    """

    capabilities: frozenset = DEFAULT_CAPABILITIES
    kernel_limits: tuple = ()
    peak_flops_per_s: float = PEAK_FLOPS_PER_S
    peak_bytes_per_s: float = PEAK_BYTES_PER_S
    host: str = ""
    profile: TuningProfile | None = dataclasses.field(
        default=None, compare=False, repr=False)
    autotune: bool = False
    #: probe-measure both candidates when |fused - unfused| / unfused of the
    #: estimated proxies is within this band (the regime where the static
    #: roofline is least trustworthy)
    autotune_band: float = 0.25
    probe_queries: int = 4
    probe_repeats: int = 2
    #: route compile-pass spans to the process-global tracer
    #: (``repro_torch.obs.set_tracer``); off, the instrumentation sites
    #: cost one attribute check
    observability: bool = False

    # -- construction -------------------------------------------------------
    @classmethod
    def default(cls, capabilities: frozenset | None = None, *, device=None,
                **overrides) -> "BackendDescriptor":
        """Descriptor for the torch backend on ``device`` (None: the card
        if there is one): full (or given) capability set, kernel limits
        read off the kernel packages, the datasheet's roofline peaks, this
        host's and device's fingerprint."""
        from repro_torch.analysis.op_cost import host_fingerprint
        from repro_torch.kernels.dense_scoring.ops import \
            MAX_KERNEL_K as DENSE_K
        from repro_torch.kernels.pq_scoring.ops import MAX_KERNEL_K as PQ_K
        from repro_torch.kernels.topk.ops import MAX_KERNEL_K as TOPK_K
        kw = dict(
            capabilities=(DEFAULT_CAPABILITIES if capabilities is None
                          else frozenset(capabilities)),
            kernel_limits=(("topk", TOPK_K), ("fat", None),
                           ("dense_topk", DENSE_K), ("dense_rerank", DENSE_K),
                           ("pq_topk", PQ_K)),
            host=host_fingerprint(device),
        )
        kw.update(overrides)
        return cls(**kw)

    def with_profile(self, profile: TuningProfile | None, *,
                     auto_refit: bool = True) -> "BackendDescriptor":
        """Attach a tuning profile.  If the profile carries a roofline
        calibration fit newer than this descriptor's ``peak_digest`` (the
        peaks were refitted since the profile last calibrated a
        descriptor), apply ``calibrated(fit)`` automatically."""
        d = dataclasses.replace(self, profile=profile)
        if auto_refit and profile is not None:
            fit = profile.pending_fit(d.peak_digest)
            if fit is not None:
                d = d.calibrated(fit)
                profile.mark_calibrated(d.peak_digest)
        return d

    def with_autotune(self, enabled: bool = True, *,
                      band: float | None = None,
                      probe_queries: int | None = None,
                      probe_repeats: int | None = None) -> "BackendDescriptor":
        kw: dict = {"autotune": enabled}
        if band is not None:
            kw["autotune_band"] = band
        if probe_queries is not None:
            kw["probe_queries"] = probe_queries
        if probe_repeats is not None:
            kw["probe_repeats"] = probe_repeats
        return dataclasses.replace(self, **kw)

    def with_observability(self, enabled: bool = True) -> "BackendDescriptor":
        return dataclasses.replace(self, observability=enabled)

    def calibrated(self, fit: dict) -> "BackendDescriptor":
        """Descriptor with peaks replaced by an ``op_cost.fit_peaks``
        result (accepts any mapping with the two peak keys)."""
        return dataclasses.replace(
            self, peak_flops_per_s=float(fit["peak_flops_per_s"]),
            peak_bytes_per_s=float(fit["peak_bytes_per_s"]))

    # -- queries ------------------------------------------------------------
    def supports(self, capability: str) -> bool:
        return capability in self.capabilities

    def native_limit(self, pattern: str) -> int | None:
        for name, lim in self.kernel_limits:
            if name == pattern:
                return lim
        return None

    def kernel_native(self, pattern: str, k: int) -> bool:
        lim = self.native_limit(pattern)
        return lim is None or k <= lim

    @property
    def peak_digest(self) -> str:
        """Digest of (host, peak constants) — the estimate-cache scope: two
        descriptors pricing with different peaks (or for another host or
        device) must never share cached proxy estimates."""
        return hashlib.sha256(
            f"{self.host}:{self.peak_flops_per_s:.8e}:"
            f"{self.peak_bytes_per_s:.8e}".encode()).hexdigest()[:16]


def as_descriptor(backend) -> BackendDescriptor:
    """The descriptor of ``backend``: its own if it exposes one, else the
    full default (a backend of None, as ``explain()`` may pass)."""
    desc = getattr(backend, "descriptor", None)
    return desc if isinstance(desc, BackendDescriptor) \
        else BackendDescriptor.default()
