"""Backend capability descriptor.

A :class:`BackendDescriptor` is a frozen config object carrying what the
compiler needs to know about a backend *as data*:

* capability flags  (which rewrites/lowerings are legal),
* kernel limits     (the native-k ceilings of the CUDA kernels, read off
                     the port's own ``kernels/*/ops.py``, so "will this K
                     hit the kernel" is a descriptor lookup), and
* observability     (route compile-pass spans to the process-global
                     tracer).

Passes receive the descriptor at build time (``default_passes(desc)``);
``TorchBackend`` exposes one as ``backend.descriptor``.  The JAX package's
descriptor also carries HLO roofline peaks and a persisted tuning profile
for its cost-gated fusion; the port's gate is capability plus
kernel-native (core/passes.py), so those wait for the measured gate.
"""
from __future__ import annotations

import dataclasses

#: the full capability set of the torch backend, the JAX backend's: block-max
#: pruning, fat postings, single-pass multi-model retrieval (LinearFusion),
#: and the kernel lowerings: sparse top-k, fused scoring, dense retrieval,
#: dense rerank, IVF-PQ
DEFAULT_CAPABILITIES = frozenset({
    "pruned_topk", "fat", "multi_model", "fused_topk", "fused_scoring",
    "dense_topk", "fused_dense", "pq_topk",
})


@dataclasses.dataclass(frozen=True)
class BackendDescriptor:
    """Frozen description of a backend's optimisation surface.

    ``kernel_limits`` maps gate pattern -> max kernel-native k (None = no
    k ceiling for that pattern)."""

    capabilities: frozenset = DEFAULT_CAPABILITIES
    kernel_limits: tuple = ()
    #: route compile-pass spans to the process-global tracer
    #: (``repro_torch.obs.set_tracer``); off, the instrumentation sites
    #: cost one attribute check
    observability: bool = False

    @classmethod
    def default(cls, capabilities: frozenset | None = None,
                **overrides) -> "BackendDescriptor":
        """Descriptor for the torch backend: full (or given) capability
        set, kernel limits read off the kernel packages."""
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
        )
        kw.update(overrides)
        return cls(**kw)

    def with_observability(self, enabled: bool = True) -> "BackendDescriptor":
        return dataclasses.replace(self, observability=enabled)

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


def as_descriptor(backend) -> BackendDescriptor:
    """The descriptor of ``backend``: its own if it exposes one, else the
    full default (a backend of None, as ``explain()`` may pass)."""
    desc = getattr(backend, "descriptor", None)
    return desc if isinstance(desc, BackendDescriptor) \
        else BackendDescriptor.default()
