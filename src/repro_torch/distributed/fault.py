"""Heartbeats, straggler detection and deterministic failure injection.

A stdlib-only copy of ``repro/distributed/fault.py`` (the port imports
nothing of ``repro``). The serving engine uses :class:`Heartbeat` as its
per-tick watchdog and ``repro_torch.serving.chaos`` builds its
deterministic fault schedules on :class:`FailureInjector`.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Mapping


@dataclasses.dataclass
class HeartbeatConfig:
    straggler_factor: float = 3.0   # step slower than 3x median => straggler
    window: int = 32                # median window
    deadline_s: float = 600.0       # hard per-step deadline


class Heartbeat:
    """Wraps the train/serve loop's step boundary; detects stragglers.

    ``clock`` is the monotonic time source (``time.monotonic`` by
    default) — injectable so the serving engine can run it off the
    telemetry registry clock and tests can drive it deterministically.
    """

    def __init__(self, cfg: HeartbeatConfig | None = None,
                 on_straggler: Callable[[int, float, float], None] | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or HeartbeatConfig()
        self.times: list[float] = []
        self.straggler_steps: list[int] = []
        self._t0: float | None = None
        self._on_straggler = on_straggler
        self._clock = clock

    def start(self) -> None:
        self._t0 = self._clock()

    def stop(self, step: int) -> float:
        # an unmatched stop used to fall back to ``now`` and record a ~0s
        # sample, silently dragging the straggler median toward zero —
        # refuse instead of corrupting the window
        if self._t0 is None:
            raise RuntimeError(
                "Heartbeat.stop() without a matching start(): refusing "
                "to record a bogus ~0s sample into the straggler median")
        dt = self._clock() - self._t0
        self._t0 = None
        self.times.append(dt)
        window = self.times[-self.cfg.window:]
        if len(window) >= 5:
            med = statistics.median(window)
            if dt > self.cfg.straggler_factor * med or dt > self.cfg.deadline_s:
                self.straggler_steps.append(step)
                if self._on_straggler:
                    self._on_straggler(step, dt, med)
        return dt

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0


class FailureInjector:
    """Deterministic failure injection for restart drills and the serving
    chaos harness.

    Legacy form — ``FailureInjector(fail_at_step=3)`` — raises exactly
    once at the configured step. The generalized ``schedule`` maps a step
    to how many calls at that step should raise (serving retries re-enter
    the same step, so per-step counts express "fail the first N
    attempts"); ``exc_factory(step)`` builds the raised exception.
    ``fired_at`` logs every injection for test assertions.
    """

    def __init__(self, fail_at_step: int | None = None, *,
                 schedule: Mapping[int, int] | None = None,
                 exc_factory: Callable[[int], Exception] | None = None):
        self.fail_at_step = fail_at_step
        merged = dict(schedule or {})
        if fail_at_step is not None:
            merged[fail_at_step] = merged.get(fail_at_step, 0) + 1
        self.schedule = merged
        self._remaining = dict(merged)
        self.fired = False
        self.fired_at: list[int] = []
        self._exc = exc_factory or (
            lambda step: RuntimeError(f"injected node failure at step {step}"))

    def maybe_fail(self, step: int) -> None:
        if self._remaining.get(step, 0) > 0:
            self._remaining[step] -= 1
            self.fired = True
            self.fired_at.append(step)
            raise self._exc(step)
