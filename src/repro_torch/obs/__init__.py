"""repro_torch.obs — the metrics registry, host-side span tracing, device
timers and the Perfetto timeline.

Stdlib-only copies of ``repro/obs/metrics.py``, ``repro/obs/tracing.py``
and ``repro/obs/timeline.py``, plus a port of ``repro/obs/profile.py``
(``device_timer`` synchronizes with ``torch.cuda.synchronize()``;
``trace_window`` is ``torch.profiler``; torch is imported inside them, so
this package imports no torch). The port keeps the reference's counter
names and the serving engine's outcome conservation law
(``engine_request_outcomes_total`` sums to
``engine_requests_total{event="submitted"}`` once drained).

THE RULE: no metrics inside captured or compiled regions (a CUDA graph
capture, ``torch.compile``). The port runs eagerly, so instrumentation
sits at host boundaries: engine tick phases, wrapper entry points and the
offline quantization path. Kernel launch counts live beside the kernels
(``repro_torch.kernels._build.LAUNCHES``), not in the registry.
"""
from . import profile, timeline
from .metrics import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram,
                      Registry, current_registry, default_registry,
                      use_registry)
from .profile import device_timer, trace_window
from .timeline import build_trace, write_trace
from .tracing import Span, span

__all__ = [
    "DEFAULT_LATENCY_BUCKETS", "Counter", "Gauge", "Histogram", "Registry",
    "Span", "build_trace", "current_registry", "default_registry",
    "device_timer", "profile", "span", "timeline", "trace_window",
    "use_registry", "write_trace",
]
