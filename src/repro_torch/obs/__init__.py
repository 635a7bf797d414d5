"""repro_torch.obs — the metrics registry and host-side span tracing.

Stdlib-only copies of ``repro/obs/metrics.py`` and ``repro/obs/tracing.py``,
so the port keeps the reference's counter names and the serving engine's
outcome conservation law (``engine_request_outcomes_total`` sums to
``engine_requests_total{event="submitted"}`` once drained).

THE RULE: no metrics inside captured or compiled regions (a CUDA graph
capture, ``torch.compile``). The port runs eagerly, so instrumentation
sits at host boundaries: engine tick phases, wrapper entry points and the
offline quantization path. Kernel launch counts live beside the kernels
(``repro_torch.kernels._build.LAUNCHES``), not in the registry.
"""
from .metrics import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram,
                      Registry, current_registry, default_registry,
                      use_registry)
from .tracing import Span, span

__all__ = [
    "DEFAULT_LATENCY_BUCKETS", "Counter", "Gauge", "Histogram", "Registry",
    "Span", "current_registry", "default_registry", "span", "use_registry",
]
