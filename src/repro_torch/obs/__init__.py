"""Observability: metrics registry, span tracing and the flight recorder
(copies of the JAX package's pure-Python ``obs`` modules)."""
from repro_torch.obs.metrics import (Counter, CounterMap, Gauge,  # noqa: F401
                                     Histogram, MetricsRegistry, get_registry)
from repro_torch.obs.recorder import FlightRecorder  # noqa: F401
from repro_torch.obs.tracing import (NOOP_SPAN, NOOP_TRACER, Span,  # noqa: F401
                                     Tracer, get_tracer, set_tracer,
                                     tracer_for)
