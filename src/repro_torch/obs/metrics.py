"""Process-local metrics registry: counters, gauges, histograms, events.

Dependency-free (stdlib only — no torch import, so ``repro_torch.core`` /
``repro_torch.kernels`` can instrument without import cycles) and
deterministic:
histogram bucket edges are fixed at metric creation, snapshot/Prometheus
output is sorted by metric name then label key, and label series are keyed
by the declared ``labelnames`` order. Values are plain python floats.

The registry is resolved dynamically via :func:`current_registry` — a
default process-global instance with a ``use_registry`` override stack so
tests and benchmarks isolate their series without threading a handle
through every layer.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time

#: Fixed wall-clock latency bucket edges (seconds). Chosen to straddle both
#: CPU test ticks (tens of ms .. s) and GPU ticks (sub-ms .. tens of ms).
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

#: Events kept in memory before older ones are dropped (dropped count is
#: tracked in the ``obs_events_dropped_total`` counter).
MAX_EVENTS = 200_000


def _fmt(v: float) -> str:
    """Prometheus number formatting: integers without the trailing .0."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    """Prometheus HELP text escaping: backslash and newline only."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: dict = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def _series_name(self, key: tuple) -> str:
        return ",".join(f'{k}="{v}"' for k, v in zip(self.labelnames, key))

    def _prom_series_name(self, key: tuple) -> str:
        """Like :meth:`_series_name` but with label values escaped per the
        Prometheus exposition format (snapshot keys stay raw)."""
        return ",".join(f'{k}="{_escape_label(v)}"'
                        for k, v in zip(self.labelnames, key))

    def items(self) -> list[tuple[tuple, object]]:
        """Sorted (label-key tuple, value) pairs."""
        with self._lock:
            return sorted(self._series.items())

    def series(self) -> dict[str, object]:
        """{'lbl="v",...': value} in sorted-series order ('' = unlabeled)."""
        return {self._series_name(k): v for k, v in self.items()}


class Counter(_Metric):
    """Monotone float counter; ``inc`` only (negative increments rejected)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counter increment < 0")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def get(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))

    def total(self) -> float:
        """Sum across every label series."""
        with self._lock:
            return float(sum(self._series.values()))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[self._key(labels)] = float(value)

    def get(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))


class Histogram(_Metric):
    """Fixed-bucket histogram: cumulative bucket counts + sum + count.

    Bucket edges are frozen at creation (deterministic across runs); the
    implicit ``+Inf`` bucket always exists.
    """

    kind = "histogram"

    def __init__(self, name, help, labelnames,
                 buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        edges = tuple(sorted(float(b) for b in buckets))
        if len(set(edges)) != len(edges) or not edges:
            raise ValueError(f"{name}: bucket edges must be unique, non-empty")
        self.buckets = edges

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = {"buckets": [0] * (len(self.buckets) + 1),
                      "sum": 0.0, "count": 0}
                self._series[key] = st
            i = len(self.buckets)
            for j, edge in enumerate(self.buckets):
                if v <= edge:
                    i = j
                    break
            st["buckets"][i] += 1
            st["sum"] += v
            st["count"] += 1

    def get(self, **labels) -> dict:
        st = self._series.get(self._key(labels))
        if st is None:
            return {"buckets": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0}
        return {"buckets": list(st["buckets"]), "sum": st["sum"],
                "count": st["count"]}

    def cumulative(self, **labels) -> dict[str, int]:
        """{'le_edge': cumulative count, ..., '+Inf': total}."""
        st = self.get(**labels)
        out, acc = {}, 0
        for edge, n in zip(self.buckets, st["buckets"]):
            acc += n
            out[_fmt(edge)] = acc
        out["+Inf"] = acc + st["buckets"][-1]
        return out

    def quantile(self, q: float, **labels) -> float:
        """Estimate the q-quantile from the fixed cumulative buckets.

        Prometheus ``histogram_quantile`` semantics: linear interpolation
        inside the bucket holding the ``q * count``-th observation (lower
        bound of the first bucket is 0 — these record non-negative
        latencies). Observations in the ``+Inf`` overflow bucket clamp to
        the highest finite edge (the honest answer without raw values).
        NaN when the series is empty.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"{self.name}: quantile q={q} not in [0, 1]")
        st = self.get(**labels)
        return self._quantile_of(st, q)

    def _quantile_of(self, st: dict, q: float) -> float:
        if st["count"] == 0:
            return float("nan")
        target = q * st["count"]
        cum, lo = 0, 0.0
        for edge, n in zip(self.buckets, st["buckets"]):
            if n and cum + n >= target:
                return lo + (edge - lo) * (target - cum) / n
            cum += n
            lo = edge
        return self.buckets[-1]  # overflow bucket: clamp to last edge

    def quantiles(self, qs=(0.5, 0.95, 0.99), **labels) -> dict[str, float]:
        """{'p50': v, 'p95': v, 'p99': v} (the snapshot convention)."""
        st = self.get(**labels)
        return {f"p{round(q * 100):d}": self._quantile_of(st, q)
                for q in qs}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """A namespace of metrics + an event log (the JSONL trace).

    ``clock`` is the monotonic time source used to stamp events (``ts``)
    and to time spans/device timers — injectable so tests can drive a
    deterministic fake clock through the whole telemetry pipeline
    (``time.perf_counter`` by default; its origin is arbitrary, only
    deltas and relative placement on the timeline are meaningful).
    """

    def __init__(self, clock=None):
        self._metrics: dict[str, _Metric] = {}
        self._events: list[dict] = []
        self._seq = 0
        self._dropped = 0
        self._lock = threading.Lock()
        self._clock = clock if clock is not None else time.perf_counter

    def now(self) -> float:
        """Current reading of this registry's monotonic clock."""
        return self._clock()

    # -- metric creation (get-or-create; shape must match) ------------------
    def _get(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, tuple(labelnames), **kw)
                self._metrics[name] = m
                return m
        if type(m) is not cls or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} re-declared as {cls.kind} "
                f"labels={tuple(labelnames)} (was {m.kind} "
                f"labels={m.labelnames})")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
                  ) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    # -- events (JSONL export) ---------------------------------------------
    def emit(self, event: dict) -> None:
        """Append one event (a JSON-able dict). ``seq`` is added here, and
        ``ts`` (the registry clock reading) unless the caller already
        stamped one — spans stamp their START time."""
        ts = round(self.now(), 6)
        with self._lock:
            self._seq += 1
            ev = {"seq": self._seq, "ts": ts, **event}
            self._events.append(ev)
            if len(self._events) > MAX_EVENTS:
                del self._events[: len(self._events) - MAX_EVENTS]
                self._dropped += 1

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def write_events_jsonl(self, path: str, *,
                           final_snapshot: bool = True) -> int:
        """Write the event log as JSONL; optionally append one trailing
        ``{"snapshot": ...}`` line. Returns the number of lines written."""
        evs = self.events()
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
            if final_snapshot:
                f.write(json.dumps({"snapshot": self.snapshot()}) + "\n")
        return len(evs) + int(final_snapshot)

    # -- export -------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able view: {"counters": {name: {series: v}}, "gauges": ...,
        "histograms": {name: {series: {"buckets": {le: n}, "sum", "count",
        "quantiles": {"p50"/"p95"/"p99": v}}}}, "events_total": n}."""
        out = {"counters": {}, "gauges": {}, "histograms": {},
               "events_total": self._seq, "events_dropped": self._dropped}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                out["histograms"][name] = {
                    sk: {"buckets": dict(zip(map(_fmt, m.buckets),
                                             _cum(st["buckets"])))
                         | {"+Inf": sum(st["buckets"])},
                         "sum": st["sum"], "count": st["count"],
                         "quantiles": {
                             k: round(v, 9)
                             for k, v in zip(
                                 ("p50", "p95", "p99"),
                                 (m._quantile_of(st, q)
                                  for q in (0.5, 0.95, 0.99)))}}
                    for sk, st in m.series().items()}
            else:
                out[m.kind + "s"][name] = dict(m.series())
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition format, deterministically ordered."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key, st in m.items():
                    sk = m._prom_series_name(key)
                    pre = sk + "," if sk else ""
                    acc = 0
                    for edge, n in zip(m.buckets, st["buckets"]):
                        acc += n
                        lines.append(
                            f'{name}_bucket{{{pre}le="{_fmt(edge)}"}} '
                            f"{acc}")
                    lines.append(f'{name}_bucket{{{pre}le="+Inf"}} '
                                 f"{acc + st['buckets'][-1]}")
                    suffix = f"{{{sk}}}" if sk else ""
                    lines.append(f"{name}_sum{suffix} {_fmt(st['sum'])}")
                    lines.append(f"{name}_count{suffix} {st['count']}")
            else:
                for key, v in m.items():
                    sk = m._prom_series_name(key)
                    suffix = f"{{{sk}}}" if sk else ""
                    lines.append(f"{name}{suffix} {_fmt(v)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._events.clear()
            self._seq = 0
            self._dropped = 0


def _cum(buckets: list[int]) -> list[int]:
    out, acc = [], 0
    for n in buckets[:-1]:
        acc += n
        out.append(acc)
    return out


# ---------------------------------------------------------------------------
# Registry resolution: process default + scoped overrides
# ---------------------------------------------------------------------------

_DEFAULT = Registry()
_STACK: list[Registry] = []


def default_registry() -> Registry:
    """The process-global registry (what serve/benchmark CLIs snapshot)."""
    return _DEFAULT


def current_registry() -> Registry:
    """Registry instrumentation writes to: innermost ``use_registry``
    override, else the process default."""
    return _STACK[-1] if _STACK else _DEFAULT


@contextlib.contextmanager
def use_registry(registry: Registry):
    """Scoped override of :func:`current_registry` (test/bench isolation)."""
    _STACK.append(registry)
    try:
        yield registry
    finally:
        _STACK.pop()
