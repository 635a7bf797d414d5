"""Perfetto / chrome://tracing export of the registry event log.

A stdlib-only copy of ``repro/obs/timeline.py`` (the port imports nothing
of ``repro``): the same pure function of ``Registry.events()``, so the
port's engine events render on the same tracks. Open the written file at
https://ui.perfetto.dev ("Open trace file") or chrome://tracing. Tracks:

* **engine phases** (pid 1, tid 0): one slice per host-side tick phase
  (admit / prefill / decode / retire) from span events carrying
  ``phase`` + ``ts``/``seconds``.
* **request slots** (pid 2, tid = slot index): each admitted request's
  lifecycle on its slot: ``queued``, ``prefill``, one ``decode`` slice
  per live tick, a TTFT instant and a retire instant. Non-``ok`` retires
  render as distinct markers (``r<rid> retire:nan`` / ``:timeout`` /
  ``:error`` ...); retires that never held a slot land on the engine
  lane, as do ``kernel_failure:<phase>``, ``fallback:<reason>``,
  ``slow_tick`` and ``engine abort:<reason>`` instants.
* **counter tracks** (pid 1) from ``counters`` events, and ``trace``
  instants, which the reference's engine emits and the port's does not.

Timestamps are the registry clock converted to microseconds; only
relative placement is meaningful. Events lacking ``ts`` are skipped.
"""
from __future__ import annotations

import json

from .metrics import Registry

#: Perfetto process ids (purely presentational grouping).
PID_ENGINE = 1
PID_REQUESTS = 2

_ENGINE_TID = 0


def _meta(pid: int, name: str, tid: int | None = None,
          tname: str | None = None) -> list[dict]:
    out = [{"ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": name}}]
    if tid is not None:
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": tname}})
    return out


def _slice(pid: int, tid: int, name: str, ts_us: float, dur_us: float,
           args: dict | None = None) -> dict:
    ev = {"ph": "X", "pid": pid, "tid": tid, "name": name,
          "ts": round(ts_us, 3), "dur": round(dur_us, 3)}
    if args:
        ev["args"] = args
    return ev


def _instant(pid: int, tid: int, name: str, ts_us: float,
             args: dict | None = None) -> dict:
    ev = {"ph": "i", "s": "t", "pid": pid, "tid": tid, "name": name,
          "ts": round(ts_us, 3)}
    if args:
        ev["args"] = args
    return ev


def _counter(name: str, ts_us: float, values: dict) -> dict:
    return {"ph": "C", "pid": PID_ENGINE, "name": name,
            "ts": round(ts_us, 3), "args": values}


def trace_events(events: list[dict]) -> list[dict]:
    """Convert a registry event list into chrome-tracing ``traceEvents``.

    Pure and deterministic: output order is metadata first, then source
    event order (the registry's ``seq`` order).
    """
    submits = {ev["rid"]: ev for ev in events
               if ev.get("ev") == "submit" and "ts" in ev}
    out: list[dict] = list(_meta(PID_ENGINE, "engine", _ENGINE_TID,
                                 "phases"))
    out += _meta(PID_REQUESTS, "requests")
    slots_named: set[int] = set()

    def name_slot(slot: int) -> None:
        if slot not in slots_named:
            slots_named.add(slot)
            out.extend(_meta(PID_REQUESTS, "requests", slot,
                             f"slot {slot}")[1:])

    for ev in events:
        kind = ev.get("ev")
        ts = ev.get("ts")
        if ts is None:
            continue
        us = ts * 1e6
        dur = ev.get("seconds", 0.0) * 1e6

        if kind in ("phase", "admit", "tick") and "phase" in ev:
            args = {k: ev[k] for k in ("tick", "slots_active",
                                       "queue_depth", "rid", "slot",
                                       "prompt_len") if k in ev}
            out.append(_slice(PID_ENGINE, _ENGINE_TID, ev["phase"],
                              us, dur, args or None))

        if kind == "admit" and "slot" in ev:
            rid, slot = ev["rid"], ev["slot"]
            name_slot(slot)
            sub = submits.get(rid)
            if sub is not None and sub["ts"] <= ts:
                out.append(_slice(PID_REQUESTS, slot, f"r{rid} queued",
                                  sub["ts"] * 1e6, us - sub["ts"] * 1e6))
            out.append(_slice(
                PID_REQUESTS, slot, f"r{rid} prefill", us, dur,
                {"rid": rid, "prompt_len": ev.get("prompt_len"),
                 "trace_id": ev.get("trace_id")}))
            ttft = ev.get("ttft_s")
            if ttft is not None:
                out.append(_instant(
                    PID_REQUESTS, slot, f"r{rid} TTFT", us + dur,
                    {"ttft_ms": round(ttft * 1e3, 3)}))

        if kind == "tick":
            for slot, rid in enumerate(ev.get("slot_rids", ())):
                if rid is None or rid < 0:
                    continue
                name_slot(slot)
                out.append(_slice(PID_REQUESTS, slot, f"r{rid} decode",
                                  us, dur, {"tick": ev.get("tick")}))

        if kind == "retire":
            slot = ev.get("slot")
            outcome = ev.get("outcome")
            # error/timeout/nan/... retires get DISTINCT marker names so
            # they're searchable in Perfetto apart from clean finishes
            suffix = "" if outcome in (None, "ok") else f":{outcome}"
            args = {"tokens": ev.get("tokens"),
                    "tpot_ms": round(ev.get("tpot_s", 0.0) * 1e3, 3),
                    "trace_id": ev.get("trace_id")}
            if outcome is not None:
                args["outcome"] = outcome
            if slot is not None:
                name_slot(slot)
                out.append(_instant(
                    PID_REQUESTS, slot, f"r{ev['rid']} retire{suffix}",
                    us, args))
            elif suffix:
                # rejected/cancelled/timed-out before ever holding a slot
                out.append(_instant(
                    PID_ENGINE, _ENGINE_TID,
                    f"r{ev['rid']} retire{suffix}", us, args))

        if kind == "counters":
            out.append(_counter("moe_m_tiles", us,
                                {"executed": ev.get("moe_executed", 0),
                                 "total": ev.get("moe_total", 0)}))
            out.append(_counter("qgemm_calls", us,
                                {"calls": ev.get("qgemm_calls", 0)}))

        if kind == "trace":
            out.append(_instant(PID_ENGINE, _ENGINE_TID,
                                f"jit trace:{ev.get('fn', '?')}", us,
                                {"count": ev.get("engine_count")}))

        if kind == "fallback":
            out.append(_instant(
                PID_ENGINE, _ENGINE_TID,
                f"fallback:{ev.get('reason', '?')}", us,
                {"from": ev.get("from"), "to": ev.get("to"),
                 "fallbacks": ev.get("fallbacks")}))

        if kind == "kernel_failure":
            out.append(_instant(
                PID_ENGINE, _ENGINE_TID,
                f"kernel_failure:{ev.get('phase', '?')}", us,
                {"streak": ev.get("streak"), "error": ev.get("error")}))

        if kind == "slow_tick":
            out.append(_instant(
                PID_ENGINE, _ENGINE_TID, "slow_tick", us,
                {"tick": ev.get("tick"), "seconds": ev.get("seconds"),
                 "median_s": ev.get("median_s")}))

        if kind == "abort":
            out.append(_instant(
                PID_ENGINE, _ENGINE_TID,
                f"engine abort:{ev.get('reason', '?')}", us,
                {"error": ev.get("error")}))
    return out


def build_trace(registry: Registry) -> dict:
    """The full Perfetto-loadable document for a registry's event log."""
    return {"traceEvents": trace_events(registry.events()),
            "displayTimeUnit": "ms"}


def write_trace(path: str, registry: Registry) -> int:
    """Write the trace JSON; returns the number of traceEvents written."""
    doc = build_trace(registry)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])
