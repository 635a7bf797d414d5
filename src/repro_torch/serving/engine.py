"""Continuous-batching serving engine (vLLM-style slots). Port of
``repro/serving/engine.py``.

Slot model: a fixed decode batch of ``max_slots`` sequences. A new
request prefills alone (batch 1, padded to ``prefill_len``, in
``mode="train"`` so the logit at the true prompt end is available) into
its slot's rows of the KV cache; every engine tick runs ONE batched
decode step across all slots with per-slot positions; finished sequences
(eos / max_new / max_seq) retire and free their slot. With a recipe
attached, every linear inside runs the fine-grained quantized GEMM —
through the Hopper kernels when the weights are on the card, through
their plain versions when they are on the CPU.

Request lifecycle
-----------------
Every submitted request ends in EXACTLY ONE terminal outcome::

    submitted -> rejected                 (queue full / over-length prompt)
              -> queued    -> cancelled   (Engine.cancel on a queued rid)
                           -> error       (the run crashed while queued)
              -> active    -> ok          (eos / max_new / max_seq)
                           -> cancelled   (Engine.cancel on an active rid)
                           -> nan         (non-finite logits quarantined)
                           -> error       (the run crashed)

Outcomes are recorded through one chokepoint (:meth:`Engine._finish`),
which raises on a double retire, so ``sum(engine_request_outcomes_total)
== engine_requests_total{event="submitted"}`` once the engine drains.
``timeout`` stays in :data:`OUTCOMES` (zero-seeded) for the deadlines that
come with a later slice, as do the circuit breaker, the tick watchdog,
device timers, fault injection and the MoE routing sink. Here an
exception in prefill or decode retires every in-flight request as
``error`` and propagates.

NaN quarantine: with ``ServeConfig.nan_guard`` (default on) logits are
checked host-side at tick boundaries, and only the poisoned slots retire
with outcome ``nan``; co-batched requests continue unchanged.

Telemetry (repro_torch.obs), all host-side at tick boundaries:
admit/prefill/decode/retire spans into ``engine_phase_seconds{phase}``,
tick/token/request counters, slot and queue gauges, per-request TTFT and
TPOT histograms, and structured submit/admit/tick/retire events carrying
a per-request ``trace_id``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import torch

from repro_torch import obs
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelApi
from repro_torch.nn import spec as S
from . import sampler

#: The terminal request outcomes (the state machine's accepting states).
OUTCOMES = ("ok", "timeout", "cancelled", "rejected", "nan", "error")


@dataclasses.dataclass
class ServeConfig:
    max_slots: int = 4
    max_seq: int = 256
    prefill_len: int = 64          # prompts padded to this length
    max_new_tokens: int = 32
    eos_id: int = -1               # -1: never stop early
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    max_queue: int = 0             # admission queue bound; 0 = unbounded
    truncate_prompts: bool = False  # opt-in: clip over-length prompts
    nan_guard: bool = True         # host-side NaN/Inf logit quarantine


@dataclasses.dataclass
class _Slot:
    request_id: int = -1
    length: int = 0            # tokens currently in cache
    generated: list = dataclasses.field(default_factory=list)
    active: bool = False
    t_first: float = 0.0       # registry clock at first generated token


class Engine:
    # process-wide engine numbering keeps trace ids ("eng3/r7") unique
    _ids = itertools.count()

    def __init__(self, api: ModelApi, cfg: ModelConfig, params: Any,
                 serve_cfg: ServeConfig, recipe=None):
        self.engine_id = f"eng{next(Engine._ids)}"
        self.cfg = cfg
        self.sc = serve_cfg
        self.model = api.build(cfg, params, recipe)
        self.device = self.model.embed.device
        B = serve_cfg.max_slots
        self.cache = S.materialize(api.cache_specs(cfg, B, serve_cfg.max_seq),
                                   device=self.device)
        self.slots = [_Slot() for _ in range(B)]
        self.queue: list[tuple[int, list[int]]] = []
        self.outputs: dict[int, list[int]] = {}
        #: rid -> terminal outcome (exactly one entry per finished request)
        self.outcomes: dict[int, str] = {}
        self._next_id = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(serve_cfg.seed)
        self._steps = 0
        self._submit_t: dict[int, float] = {}
        # pre-create the headline series so snapshots show explicit zeros
        reg = obs.current_registry()
        reg.counter("engine_ticks_total", "batched decode ticks")
        reg.counter("engine_tokens_total", "tokens decoded across slots")
        reg.counter("engine_requests_total", "request lifecycle events",
                    ("event",))
        out = reg.counter("engine_request_outcomes_total",
                          "terminal per-request outcomes (conservation: "
                          "sums to submitted once drained)", ("outcome",))
        for o in OUTCOMES:
            out.inc(0, outcome=o)

    def trace_id(self, rid: int) -> str:
        return f"{self.engine_id}/r{rid}"

    # -- public API ------------------------------------------------------------
    def submit(self, prompt: list[int]) -> int:
        """Enqueue a request. ALWAYS returns a rid; requests refused by
        admission control (bounded queue, over-length prompt) are
        immediately terminal with outcome ``rejected``."""
        rid = self._next_id
        self._next_id += 1
        reg = obs.current_registry()
        reg.counter("engine_requests_total", "", ("event",)).inc(
            event="submitted")
        self._submit_t[rid] = reg.now()
        reg.emit({"ev": "submit", "rid": rid, "trace_id": self.trace_id(rid),
                  "prompt_len": len(prompt)})
        if len(prompt) > self.sc.prefill_len and not self.sc.truncate_prompts:
            self._finish(rid, "rejected", reason="prompt_overlength",
                         prompt_len=len(prompt))
        elif self.sc.max_queue and len(self.queue) >= self.sc.max_queue:
            self._finish(rid, "rejected", reason="queue_full",
                         queue_depth=len(self.queue))
        else:
            self.queue.append((rid, list(prompt)))
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or active request (outcome ``cancelled``; tokens
        generated so far are delivered). False for unknown or terminal
        rids."""
        if rid in self.outcomes or not 0 <= rid < self._next_id:
            return False
        for j, (qrid, _) in enumerate(self.queue):
            if qrid == rid:
                del self.queue[j]
                self._finish(rid, "cancelled")
                return True
        for i, s in enumerate(self.slots):
            if s.active and s.request_id == rid:
                self._finish(rid, "cancelled", slot=i, output=s.generated,
                             tokens=len(s.generated))
                self.slots[i] = _Slot()
                return True
        return False

    def outcome(self, rid: int) -> str | None:
        """Terminal outcome for ``rid`` (None while still in flight)."""
        return self.outcomes.get(rid)

    @torch.inference_mode()
    def run(self, max_ticks: int = 10_000) -> dict[int, list[int]]:
        reg = obs.current_registry()
        try:
            while (self.queue or any(s.active for s in self.slots)) \
                    and self._steps < max_ticks:
                with obs.span(reg, "engine_phase_seconds", phase="admit",
                              event="phase"):
                    self._admit()
                self._tick()
        except Exception:
            # a crashed run leaves no slot active and every in-flight
            # request with a terminal outcome
            self._quiesce("error")
            raise
        return dict(self.outputs)

    @property
    def ticks(self) -> int:
        return self._steps

    # -- request state machine ---------------------------------------------
    def _finish(self, rid: int, outcome: str, *, slot: int | None = None,
                output: list | None = None, **fields) -> None:
        """The SINGLE chokepoint recording a terminal outcome. Raises on a
        second retire of the same rid."""
        if rid in self.outcomes:
            raise RuntimeError(
                f"request {rid} already terminal "
                f"({self.outcomes[rid]!r}); double retire as {outcome!r}")
        self.outcomes[rid] = outcome
        self._submit_t.pop(rid, None)
        if output is not None:
            self.outputs[rid] = list(output)
        reg = obs.current_registry()
        reg.counter("engine_request_outcomes_total", "", ("outcome",)).inc(
            outcome=outcome)
        ev = {"ev": "retire", "rid": rid, "outcome": outcome,
              "trace_id": self.trace_id(rid), **fields}
        if slot is not None:
            ev["slot"] = slot
        reg.emit(ev)

    def _quiesce(self, outcome: str) -> None:
        """Drive every in-flight request to a terminal outcome and free all
        slots (crashed-run path). Idempotent per rid."""
        for i, s in enumerate(self.slots):
            if s.active and s.request_id not in self.outcomes:
                self._finish(s.request_id, outcome, slot=i,
                             output=s.generated, tokens=len(s.generated))
            self.slots[i] = _Slot()
        for rid, _ in self.queue:
            if rid not in self.outcomes:
                self._finish(rid, outcome)
        self.queue.clear()

    # -- internals ----------------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sampler.sample(logits, self._gen,
                              temperature=self.sc.temperature,
                              top_k=self.sc.top_k)

    def _admit(self) -> None:
        reg = obs.current_registry()
        P = self.sc.prefill_len
        for i in [i for i, s in enumerate(self.slots) if not s.active]:
            if not self.queue:
                break
            # the request leaves the queue only once its prefill has run
            # and synchronized, so a crash in it (a device fault surfaces
            # at the first sync) leaves the request to _quiesce
            rid, prompt = self.queue[0]
            with obs.span(reg, "engine_phase_seconds", phase="prefill",
                          event="admit") as sp:
                # over-length prompts were rejected at submit unless
                # truncate_prompts explicitly opted into this clip
                toks = prompt[:P] + [0] * max(0, P - len(prompt))
                true_len = min(len(prompt), P)
                # the slot's rows of the batched cache, cleared, are the
                # batch-1 prefill cache
                cache1 = {"blocks": [{k: t[i:i + 1] for k, t in c.items()}
                                     for c in self.cache["blocks"]]}
                for c in cache1["blocks"]:
                    for t in c.values():
                        t.zero_()
                logits, _, _ = self.model(
                    torch.tensor([toks], dtype=torch.int64,
                                 device=self.device),
                    mode="train", cache=cache1, pos=0)
                first_row = logits[:, true_len - 1]
                poisoned = self.sc.nan_guard and \
                    not bool(torch.isfinite(first_row).all())
                first = None if poisoned else int(self._sample(first_row)[0])
                self.queue.pop(0)
                if poisoned:
                    sp.fields.update(rid=rid, slot=i, outcome="nan")
                    self._finish(rid, "nan", slot=i, output=[],
                                 where="prefill")
                    continue
                t_first = reg.now()
                self.slots[i] = _Slot(request_id=rid, length=true_len,
                                      generated=[first], active=True,
                                      t_first=t_first)
                sp.fields.update(rid=rid, slot=i, prompt_len=true_len,
                                 trace_id=self.trace_id(rid))
                t_sub = self._submit_t.get(rid)
                if t_sub is not None:
                    ttft = t_first - t_sub
                    reg.histogram("engine_ttft_seconds",
                                  "submit -> first generated token"
                                  ).observe(ttft)
                    sp.fields["ttft_s"] = round(ttft, 6)
            reg.counter("engine_requests_total", "", ("event",)).inc(
                event="admitted")

    def _tick(self) -> None:
        if not any(s.active for s in self.slots):
            return
        reg = obs.current_registry()
        B = self.sc.max_slots
        last = [[0] for _ in range(B)]
        pos = [0] * B
        slot_rids = [-1] * B
        for i, s in enumerate(self.slots):
            if s.active:
                last[i][0] = s.generated[-1]
                pos[i] = s.length
                slot_rids[i] = s.request_id
        active = sum(r >= 0 for r in slot_rids)
        with obs.span(reg, "engine_phase_seconds", phase="decode",
                      event="tick") as sp:
            logits, _, _ = self.model(
                torch.tensor(last, dtype=torch.int64, device=self.device),
                mode="decode", cache=self.cache,
                pos=torch.tensor(pos, dtype=torch.int64, device=self.device))
            logits = logits[:, 0]
            finite = torch.isfinite(logits).all(dim=-1).tolist() \
                if self.sc.nan_guard else [True] * B
            nxt = self._sample(logits).tolist()  # waits for the step
            sp.fields.update(tick=self._steps, slots_active=active,
                             queue_depth=len(self.queue),
                             slot_rids=slot_rids)
        bad = {i for i, s in enumerate(self.slots)
               if s.active and not finite[i]}
        self._steps += 1
        reg.counter("engine_ticks_total", "").inc()
        reg.counter("engine_tokens_total", "").inc(active - len(bad))
        with obs.span(reg, "engine_phase_seconds", phase="retire",
                      event="phase"):
            now = reg.now()
            for i, s in enumerate(self.slots):
                if not s.active:
                    continue
                rid = s.request_id
                if i in bad:
                    # quarantine: ONLY the poisoned slot retires; its token
                    # is never appended
                    self._finish(rid, "nan", slot=i, output=s.generated,
                                 tokens=len(s.generated))
                    self.slots[i] = _Slot()
                    continue
                s.length += 1
                tok = int(nxt[i])
                s.generated.append(tok)
                if (tok == self.sc.eos_id
                        or len(s.generated) >= self.sc.max_new_tokens
                        or s.length + 1 >= self.sc.max_seq):
                    n = len(s.generated)
                    tpot = (now - s.t_first) / max(1, n - 1)
                    reg.histogram("engine_tpot_seconds",
                                  "mean inter-token latency per request"
                                  ).observe(tpot)
                    reg.counter("engine_requests_total", "",
                                ("event",)).inc(event="retired")
                    self._finish(rid, "ok", slot=i, output=s.generated,
                                 tokens=n, tpot_s=round(tpot, 6))
                    self.slots[i] = _Slot()
        reg.gauge("engine_slots_active",
                  "occupied decode slots after retire").set(
                      sum(1 for s in self.slots if s.active))
        reg.gauge("engine_queue_depth", "requests waiting for a slot").set(
            len(self.queue))
