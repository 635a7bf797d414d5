"""Span timing helpers for host-side tick tracing.

A :class:`Span` measures wall-clock around a host-side block (an engine
tick phase, a benchmark section), observes the duration into a labeled
histogram, and optionally emits one event into the registry's JSONL log.
Time comes from the registry's monotonic clock (injectable for tests),
and the emitted event is stamped with the span's START time (``ts``) plus
its duration (``seconds``) — the pair a timeline export turns into
slices. Spans are HOST constructs — never open one inside a captured or
compiled region (see the package docstring's "no metrics inside
captured regions" rule).
"""
from __future__ import annotations

from .metrics import DEFAULT_LATENCY_BUCKETS, Registry


class Span:
    """Context manager: time a block, observe it, optionally emit an event.

    ``span.fields`` is a mutable dict the caller can annotate while the
    span is open; the fields land in the emitted event (when ``event`` is
    set). ``span.seconds`` holds the duration after exit.
    """

    def __init__(self, registry: Registry, metric: str, *,
                 event: str | None = None,
                 buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
                 help: str = "", **labels):
        self.registry = registry
        self.metric = metric
        self.event = event
        self.buckets = buckets
        self.help = help
        self.labels = labels
        self.fields: dict = {}
        self.seconds = 0.0
        self._t0 = 0.0

    def __enter__(self) -> "Span":
        self._t0 = self.registry.now()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.seconds = self.registry.now() - self._t0
        hist = self.registry.histogram(
            self.metric, self.help, tuple(sorted(self.labels)),
            buckets=self.buckets)
        hist.observe(self.seconds, **self.labels)
        if self.event is not None:
            self.registry.emit({"ev": self.event,
                                "ts": round(self._t0, 6), **self.labels,
                                "seconds": round(self.seconds, 6),
                                **self.fields})


def span(registry: Registry, metric: str, **kw) -> Span:
    """Shorthand: ``with obs.span(reg, "engine_phase_seconds",
    phase="decode") as sp: ...``."""
    return Span(registry, metric, **kw)
