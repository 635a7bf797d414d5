"""Deterministic fault injection for the serving engine. Port of
``repro/serving/chaos.py``.

NaN logits, kernel-path exceptions and slow ticks fire at configured
ticks/rids, with no randomness, so tests can assert exact outcomes
(which slot retired ``nan``, how many decode retries, that co-batched
streams stayed equal).

Build a :class:`ChaosConfig`, wrap it in a :class:`ChaosMonkey`, and
install it on an engine before ``run()``::

    from repro_torch.serving.chaos import (ChaosConfig, ChaosMonkey,
                                           KernelFault, NanFault, SlowTick)

    monkey = ChaosMonkey(ChaosConfig(
        nan_logits=(NanFault(tick=3, rid=1),),   # rid=None poisons all
        kernel_failures=(KernelFault(tick=5, count=2),),
        slow_ticks=(SlowTick(tick=7, seconds=2.0),),
    ))
    monkey.install(engine)          # via Engine.add_decode_wrapper
    engine.run()
    print(monkey.injected)          # log of every fault that fired

The monkey wraps the engine's decode callable (``fn -> fn``, whatever
arguments the engine passes; the callable returns the (B, V) logits),
and ``Engine.add_decode_wrapper`` re-applies it after every circuit
breaker rebuild of the model.

* :class:`NanFault` overwrites the decode logit rows of the targeted
  active slots in place (``logits[i] = value``) AFTER the model ran: the
  KV cache and every other row are untouched.
* :class:`KernelFault` raises from the decode call at a given tick,
  ``count`` times, before the model runs. The engine does not advance the
  tick on failure, so ``count`` means "fail the first N attempts"
  (``count >= breaker_threshold`` forces a fallback or an abort).
* :class:`SlowTick` stalls the decode (``sleep_fn``; pass a fake clock's
  ``advance`` for deterministic tests) inside the watchdog window.
* :func:`flood` submits ``n`` copies of a prompt at once (``max_queue``
  backpressure).

``repro_torch.launch.serve`` exposes ``--chaos-nan-ticks`` and
``--chaos-kernel-ticks``.
"""
from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Callable, Sequence

from repro_torch.distributed.fault import FailureInjector


@dataclasses.dataclass(frozen=True)
class NanFault:
    """Poison decode logits at ``tick`` for ``rid`` (None = every active
    slot) with ``value`` (any non-finite float)."""
    tick: int
    rid: int | None = None
    value: float = math.nan


@dataclasses.dataclass(frozen=True)
class KernelFault:
    """Raise from the decode path at ``tick``, for the first ``count``
    attempts (the engine retries without advancing the tick)."""
    tick: int
    count: int = 1


@dataclasses.dataclass(frozen=True)
class SlowTick:
    """Stall the decode at ``tick`` by ``seconds`` (watchdog straggler)."""
    tick: int
    seconds: float


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    nan_logits: Sequence[NanFault] = ()
    kernel_failures: Sequence[KernelFault] = ()
    slow_ticks: Sequence[SlowTick] = ()


class ChaosError(RuntimeError):
    """The exception :class:`KernelFault` raises (distinguishable from
    genuine kernel failures in logs and tests)."""


class ChaosMonkey:
    """Installs a :class:`ChaosConfig` onto an engine's decode path.

    ``injected`` logs every fault that actually fired, in order
    (``{"kind": "nan"|"kernel"|"slow", "tick": ..., ...}``), so a test can
    assert that its schedule was exercised.
    """

    def __init__(self, cfg: ChaosConfig, *,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.cfg = cfg
        self.injected: list[dict] = []
        self._sleep = sleep_fn
        self._failer = FailureInjector(
            schedule={f.tick: f.count for f in cfg.kernel_failures},
            exc_factory=lambda t: ChaosError(
                f"chaos: injected kernel failure at tick {t}"))
        self._slow_done: set[int] = set()
        self._engine = None

    def install(self, engine) -> "ChaosMonkey":
        """Attach to ``engine`` via :meth:`Engine.add_decode_wrapper`
        (held weakly; survives breaker rebuilds)."""
        self._engine = weakref.ref(engine)
        engine.add_decode_wrapper(self._wrap)
        return self

    # the fn -> fn decode wrapper
    def _wrap(self, fn):
        def chaotic_decode(*args, **kwargs):
            eng = self._engine() if self._engine is not None else None
            tick = eng.ticks if eng is not None else -1
            try:
                self._failer.maybe_fail(tick)
            except ChaosError:
                self.injected.append({"kind": "kernel", "tick": tick})
                raise
            for st in self.cfg.slow_ticks:
                if st.tick == tick and tick not in self._slow_done:
                    self._slow_done.add(tick)
                    self.injected.append(
                        {"kind": "slow", "tick": tick,
                         "seconds": st.seconds})
                    self._sleep(st.seconds)
            logits = fn(*args, **kwargs)
            if eng is not None:
                for nf in self.cfg.nan_logits:
                    if nf.tick != tick:
                        continue
                    for i, s in enumerate(eng.slots):
                        if s.active and (nf.rid is None
                                         or s.request_id == nf.rid):
                            logits[i] = nf.value
                            self.injected.append(
                                {"kind": "nan", "tick": tick,
                                 "rid": s.request_id, "slot": i})
            return logits
        return chaotic_decode


def flood(engine, n: int, prompt: Sequence[int] = (1, 2, 3)) -> list[int]:
    """Queue flood: submit ``n`` copies of ``prompt`` back to back.
    Returns the rids (with ``ServeConfig.max_queue`` set, the surplus is
    ``rejected``)."""
    return [engine.submit(list(prompt)) for _ in range(n)]
