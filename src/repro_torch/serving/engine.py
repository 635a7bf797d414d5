"""Continuous-batching serving engine (vLLM-style slots). Port of
``repro/serving/engine.py``.

Slot model: a fixed decode batch of ``max_slots`` sequences. A new
request prefills alone (batch 1, padded to ``prefill_len``, in
``mode="train"`` so the logit at the true prompt end is available) into a
batch-1 cache, which is then spliced into its slot's rows of the KV
cache; every engine tick runs ONE batched decode step across all slots
with per-slot positions; finished sequences (eos / max_new / max_seq)
retire and free their slot. With a recipe attached, every linear inside
runs the quantized GEMM of its scheme — through the Hopper kernels when
the weights are on the card, through their plain versions when they are
on the CPU.

Compiled steps
--------------
Prefill and decode are each one :class:`serving.graphs.Step` on static
buffers: (B, 1) tokens and (B,) positions for decode; (1, prefill_len)
tokens, a (1,) slot index and a batch-1 cache for prefill, whose graph
splices that cache into the slot (``index_copy_`` on the batch axis), so
one graph serves every slot. On the card each step is captured once as a
CUDA graph (both graphs in one memory pool: they never replay at the same
time) and replayed on every later call; on the CPU the same buffers run
eagerly. ``prefill_traces`` / ``decode_traces`` (the reference's names,
``engine_traces_total{fn}`` and a ``trace`` event) count captures on the
card and, on the CPU, where nothing is captured, the establishments of a
step: its first call after construction or after a fallback, when the
reference traces. Steady state holds ``decode_traces == 1 + fallbacks``.
A capture or replay that raises is a prefill or decode failure like any
other (counted, breaker streak), and the next call captures again: the
engine never carries on eagerly on the card.

Request lifecycle / fault tolerance
-----------------------------------
Every submitted request ends in EXACTLY ONE terminal outcome::

    submitted -> rejected                 (queue full / over-length prompt)
              -> queued    -> cancelled   (Engine.cancel on a queued rid)
                           -> timeout     (deadline expired before a slot)
                           -> error       (engine aborted while queued)
              -> active    -> ok          (eos / max_new / max_seq)
                           -> cancelled   (Engine.cancel on an active rid)
                           -> timeout     (deadline expired mid-decode)
                           -> nan         (non-finite logits quarantined)
                           -> error       (prefill raised / engine aborted)

Outcomes are recorded through one chokepoint (:meth:`Engine._finish`),
which raises on a double retire, so ``sum(engine_request_outcomes_total)
== engine_requests_total{event="submitted"}`` once the engine drains.

* **Backpressure**: ``ServeConfig.max_queue`` bounds the admission queue;
  surplus submits are *rejected*. Over-length prompts are rejected unless
  ``truncate_prompts`` opts into clipping to ``prefill_len``.
* **Deadlines**: ``ServeConfig.deadline_s`` arms a per-request deadline
  (registry clock) checked at tick boundaries, for queued and active
  requests alike; overruns retire as ``timeout`` with partial output.
* **NaN quarantine**: with ``ServeConfig.nan_guard`` (default on) logits
  are checked host-side at tick boundaries, and only the poisoned slots
  retire with outcome ``nan``; co-batched requests continue unchanged.
* **Circuit breaker**: a prefill exception retires that request as
  ``error``; a decode exception leaves the slots intact and the tick is
  retried. ``breaker_threshold`` consecutive exceptions, or that many
  consecutive poisoned decode ticks, trip the breaker: it swaps in
  ``fallback_params``/``fallback_recipe`` given at construction
  (integer scale -> float scale, the paper's two-tier degradation) by
  rebuilding the model with ``api.build``. With no fallback left the
  engine quiesces (every in-flight request retires as ``error``) and
  raises :class:`EngineAborted`. :meth:`Engine.trip_breaker` forces the
  same path. The reference also degrades its kernel mode
  (``ServeConfig.fallback_kernel_mode``); the port has no counterpart,
  because the tensor's device is the port's only kernel switch.
* **Retries on the in-place cache**: the port writes the KV cache in
  place (``models/attention.py``), where the reference commits a new
  cache only on success. A retried decode writes the same K/V at the same
  positions, so a retry is idempotent (and so is the warm-up call before
  a capture). A recurrent state (xLSTM) is advanced, not overwritten: the
  decode step's warm-up restores it (``graphs.Step(state=)``), and a
  decode that raises part of the way through its layers leaves them
  advanced (the reference's would be discarded); a failure injected
  before the step, as ``serving.chaos`` injects it, leaves it whole.
* **Tick watchdog**: a ``distributed.fault.Heartbeat`` on the registry
  clock times every decode tick; stragglers (> ``slow_tick_factor`` x the
  rolling median) bump ``engine_slow_ticks_total`` and emit a
  ``slow_tick`` event.

Fault injection for all of the above lives in ``repro_torch.serving.chaos``
(through :meth:`Engine.add_decode_wrapper`).

Recurrent models
----------------
The xLSTM ("ssm") serves with the reference's semantics: each prefill
starts from a zero state (the step zeroes its batch-1 cache before the
model reads it) and runs over the prompt padded with token 0 to
``prefill_len``, so the state that decode starts from has read the pad
tokens too; the first token is taken at the prompt's true end. Decode
does not read the positions. Griffin ("hybrid") is refused: the engine
decodes every slot at its own position, as the reference's does, and
Griffin's ring-buffer write takes one scalar position (the reference's
engine fails there at its first decode). So are the families that read a
``memory`` the engine does not pass (:func:`refusal`).

MoE routing
-----------
For a MoE config the engine registers a routing sink
(``models.moe.add_routing_sink``, as a ``WeakMethod`` so the global sink
list never keeps a retired engine alive). Each MoE layer call hands it
the routed counts as a device tensor; a replayed graph hands on the
records its capture made, whose counts each replay rewrites. After each
prefill and each decode tick the engine copies the buffered counts to
the host in ONE transfer and folds them into
``engine_moe_m_tiles_total{kind=executed|total}`` with the grouped
kernels' own row tile (``kernels.w4a8_gemm.pick_tile_m``): ``total`` is
what a capacity-padded launch runs, ``executed`` what the ragged kernels
run (dense on the CPU, where the plain versions compute every row, and
with ``dispatch_groups`` > 1). :meth:`Engine.close` detaches the sink.

Telemetry (repro_torch.obs), all host-side at tick boundaries:
admit/prefill/decode/retire spans into ``engine_phase_seconds{phase}``;
prefill and decode wrapped in ``obs.device_timer`` into
``engine_phase_device_seconds{phase}`` (synchronize-bracketed, the first
call excluded); tick/token/request counters, slot and queue gauges,
per-request TTFT and TPOT histograms, ``engine_fallback_events_total
{reason}``, ``engine_kernel_failures_total{phase}``,
``engine_slow_ticks_total``, and structured submit/admit/tick/retire/
kernel_failure/fallback/abort events carrying a per-request
``trace_id``.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import weakref
from typing import Any

import torch

from repro_torch import obs
from repro_torch.distributed.fault import Heartbeat, HeartbeatConfig
from repro_torch.kernels.moe_gemm import ragged_tile_stats
from repro_torch.kernels.w4a8_gemm import pick_tile_m
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelApi
from repro_torch.nn import spec as S
from . import graphs, sampler

#: The terminal request outcomes (the state machine's accepting states).
OUTCOMES = ("ok", "timeout", "cancelled", "rejected", "nan", "error")


class EngineAborted(RuntimeError):
    """The circuit breaker exhausted every fallback: the engine quiesced
    (all in-flight requests retired with outcome ``error``, no slot left
    active). Telemetry flushed by the caller's ``finally`` still holds the
    full event log."""


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
    # -- robustness ---------------------------------------------------------
    max_queue: int = 0             # admission queue bound; 0 = unbounded
    deadline_s: float = 0.0        # per-request deadline; 0 = none
    truncate_prompts: bool = False  # opt-in: clip over-length prompts
    nan_guard: bool = True         # host-side NaN/Inf logit quarantine
    breaker_threshold: int = 3     # consecutive failures tripping fallback
    slow_tick_factor: float = 3.0  # watchdog straggler multiple of median


#: families whose model reads a ``memory`` the engine does not pass
MEMORY_FAMILIES = ("vlm", "audio")
#: families whose decode takes one scalar position, not one per slot
SCALAR_POSITION_FAMILIES = ("hybrid",)


def refusal(cfg: ModelConfig) -> str | None:
    """Why the engine cannot serve ``cfg`` (None: it can)."""
    if cfg.family in MEMORY_FAMILIES:
        return (f"{cfg.name}: the {cfg.family} family reads image or frame "
                "embeddings (memory=) that the engine does not pass, as "
                "the reference's does not; run it through the model API "
                "(prefill with memory=, then decode over the cache)")
    if cfg.family in SCALAR_POSITION_FAMILIES:
        return (f"{cfg.name}: the {cfg.family} family (Griffin) decodes at "
                "one scalar position, since its ring-buffer KV write takes "
                "one slot, and the engine decodes each slot at its own "
                "position, as the reference's does (which fails there); run "
                "it through the model API (prefill, then decode at a "
                "scalar pos)")
    return None


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
                 serve_cfg: ServeConfig, recipe=None, *,
                 fallback_params: Any = None, fallback_recipe=None):
        why = refusal(cfg)
        if why is not None:
            raise NotImplementedError(why)
        self.engine_id = f"eng{next(Engine._ids)}"
        self.api = api
        self.cfg = cfg
        self.params = params
        self.recipe = recipe
        self.sc = serve_cfg
        self.slots = [_Slot() for _ in range(serve_cfg.max_slots)]
        self.queue: list[tuple[int, list[int]]] = []
        self.outputs: dict[int, list[int]] = {}
        #: rid -> terminal outcome (exactly one entry per finished request)
        self.outcomes: dict[int, str] = {}
        self._next_id = 0
        self._steps = 0
        self._submit_t: dict[int, float] = {}
        self._deadlines: dict[int, float] = {}
        # circuit-breaker state
        self._fail_streak = 0      # consecutive prefill/decode exceptions
        self._nan_streak = 0       # consecutive poisoned decode ticks
        self._fallbacks = 0
        self._fallback_params = fallback_params
        self._fallback_recipe = fallback_recipe
        # host-side decode wrappers (chaos injection), re-applied after
        # every breaker rebuild — see add_decode_wrapper
        self._decode_wrappers: list = []
        # tick watchdog on the registry clock (deterministic under a fake
        # clock); stragglers surface as engine_slow_ticks_total + events
        self._watchdog = Heartbeat(
            HeartbeatConfig(straggler_factor=serve_cfg.slow_tick_factor),
            on_straggler=self._on_slow_tick,
            clock=lambda: obs.current_registry().now())
        # MoE routing sink: a WeakMethod, so the global sink list never
        # pins a retired engine alive (see the module docstring)
        self._routing_buf: list[dict] = []
        self._routing_sink = None
        if cfg.num_experts:
            self._routing_sink = weakref.WeakMethod(self._on_routing)
            moe.add_routing_sink(self._routing_sink)
        self.model = api.build(cfg, params, recipe)
        self.device = self.model.embed.device
        self.cache = S.materialize(
            api.cache_specs(cfg, serve_cfg.max_slots, serve_cfg.max_seq),
            device=self.device)
        # the compiled steps' static buffers (see the module docstring)
        B, P = serve_cfg.max_slots, serve_cfg.prefill_len
        i64 = dict(dtype=torch.int64, device=self.device)
        self._decode_in = (torch.zeros((B, 1), **i64),
                           torch.zeros((B,), **i64))
        self._prefill_in = (torch.zeros((1, P), **i64),
                            torch.zeros((1,), **i64))
        self._cache1 = S.materialize(
            api.cache_specs(cfg, 1, serve_cfg.max_seq), device=self.device)
        self._trace_counts: collections.Counter = collections.Counter()
        self._build_fns()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(serve_cfg.seed)
        # pre-create the headline series so snapshots show explicit zeros
        reg = obs.current_registry()
        reg.counter("engine_ticks_total", "batched decode ticks")
        reg.counter("engine_tokens_total", "tokens decoded across slots")
        reg.counter("engine_requests_total", "request lifecycle events",
                    ("event",))
        reg.counter("engine_moe_m_tiles_total",
                    "MoE grouped-GEMM m-tiles from live routing: executed "
                    "(ragged skipping applied) vs dense total", ("kind",))
        out = reg.counter("engine_request_outcomes_total",
                          "terminal per-request outcomes (conservation: "
                          "sums to submitted once drained)", ("outcome",))
        for o in OUTCOMES:
            out.inc(0, outcome=o)
        reg.counter("engine_fallback_events_total",
                    "circuit-breaker parameter-set fallbacks", ("reason",))
        reg.counter("engine_kernel_failures_total",
                    "exceptions from the prefill/decode path (captures "
                    "and replays included)", ("phase",))
        reg.counter("engine_slow_ticks_total",
                    "watchdog: decode ticks slower than "
                    "slow_tick_factor x rolling median").inc(0)

    # -- step establishment -------------------------------------------------
    def _build_fns(self) -> None:
        """Make the prefill and decode steps of ``self.model`` (one graph
        pool for both on the card) and wrap them in device timers — at
        construction and again after a breaker fallback. The timers'
        first call, which holds the capture, is excluded as warmup, as the
        reference excludes the compile."""
        model, cache, cache1 = self.model, self.cache, self._cache1
        pool = (torch.cuda.graph_pool_handle()
                if self.device.type == "cuda" else None)
        tokens1, slot = self._prefill_in

        # batch-1 prefill in mode="train": FULL-sequence logits (the
        # engine needs the logit at the true prompt end, which may be
        # before the padded end) while writing the batch-1 cache, whose
        # whole rows then replace the slot's, for every key of the cache
        # (an int8 cache's scales with its codes). Prefill writes only the
        # batch-1 cache's first prefill_len positions, so the rest stay
        # zero and the splice clears the slot's rows past the prompt: no
        # stale value (a quarantined request's NaN) reaches the masked
        # terms of decode_attention. The batch-1 cache is zeroed first:
        # a recurrent state is read by the prefill, which starts from
        # zeros, as the reference's (a KV cache's zeros change nothing).
        def prefill_fn():
            for one in cache1["blocks"]:
                for t in one.values():
                    t.zero_()
            logits = model(tokens1, mode="train", cache=cache1, pos=0)[0]
            for big, one in zip(cache["blocks"], cache1["blocks"]):
                for k, t in big.items():
                    t.index_copy_(0, slot, one[k])
            return logits

        self._prefill_step = graphs.Step(
            prefill_fn, self.device, pool=pool,
            on_establish=lambda: self._note_trace("prefill"),
            on_replay=self._on_replayed_routing)
        self._prefill = obs.device_timer(
            self._prefill_step, "engine_phase_device_seconds",
            help="device time (synchronize-bracketed) per engine phase",
            phase="prefill")

        # batched decode with per-slot positions -> (B, V) logits
        tokens, pos = self._decode_in

        def decode_fn():
            return model(tokens, mode="decode", cache=cache, pos=pos)[0][:, 0]

        # a recurrent cache is advanced by every call, the warm-up's too
        self._decode_step = graphs.Step(
            decode_fn, self.device, pool=pool,
            on_establish=lambda: self._note_trace("decode"),
            on_replay=self._on_replayed_routing,
            state=S.leaves(cache) if self.cfg.family == "ssm" else ())
        self._decode_base = obs.device_timer(
            self._decode_step, "engine_phase_device_seconds",
            help="device time (synchronize-bracketed) per engine phase",
            phase="decode")
        self._rewrap_decode()

    def _release_steps(self) -> None:
        """Drop both steps' graphs and their pool's memory (before a
        fallback captures under other weights)."""
        self._prefill_step.release()
        self._decode_step.release()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _rewrap_decode(self) -> None:
        fn = self._decode_base
        for wrap in self._decode_wrappers:
            fn = wrap(fn)
        self._decode = fn

    def add_decode_wrapper(self, wrap) -> None:
        """Install a host-side ``fn -> fn`` wrapper around the decode
        callable ``fn(tokens, pos) -> logits (B, V)`` (fault injection,
        extra instrumentation). It runs outside the captured step, on its
        static buffers; the logits are the graph's output buffer, which
        the next replay rewrites, so a wrapper may write into them. It is
        re-applied automatically when the circuit breaker rebuilds the
        model. ``repro_torch.serving.chaos`` is the canonical client."""
        self._decode_wrappers.append(wrap)
        self._rewrap_decode()

    # -- telemetry plumbing -------------------------------------------------
    def _note_trace(self, fn: str) -> None:
        """One establishment of step ``fn``: a CUDA graph capture on the
        card, the first eager call on the CPU. Replays do not pass here,
        which makes it a recapture detector, as the reference's trace-time
        hook is a retrace detector."""
        self._trace_counts[fn] += 1
        reg = obs.current_registry()
        reg.counter("engine_traces_total",
                    "step establishments (CUDA graph captures on the card)",
                    ("fn",)).inc(fn=fn)
        reg.emit({"ev": "trace", "fn": fn,
                  "engine_count": self._trace_counts[fn]})

    @property
    def prefill_traces(self) -> int:
        return self._trace_counts["prefill"]

    @property
    def decode_traces(self) -> int:
        return self._trace_counts["decode"]

    @property
    def fallbacks(self) -> int:
        """Circuit-breaker fallbacks taken so far: steady-state decode
        holds ``decode_traces == 1 + fallbacks``."""
        return self._fallbacks

    def _on_slow_tick(self, step: int, dt: float, med: float) -> None:
        reg = obs.current_registry()
        reg.counter("engine_slow_ticks_total", "").inc()
        reg.emit({"ev": "slow_tick", "tick": step,
                  "seconds": round(dt, 6), "median_s": round(med, 6)})

    def _on_routing(self, rec: dict) -> None:
        self._routing_buf.append(rec)

    def _on_replayed_routing(self, records: list) -> None:
        """A replay's routing records (its capture's, with this replay's
        counts), drained before the next replay rewrites them."""
        if self._routing_sink is not None:
            self._routing_buf.extend(records)

    def _drain_routing(self) -> None:
        """Fold the buffered routing records into the m-tile counters: ONE
        host copy of all their counts, at the tick boundary."""
        if not self._routing_buf:
            return
        buf, self._routing_buf = self._routing_buf, []
        flat = torch.cat([r["counts"].reshape(-1) for r in buf]).tolist()
        ragged = self.device.type == "cuda" and self.recipe is not None
        E = self.cfg.num_experts
        executed = total = at = 0
        for rec in buf:
            C, groups = rec["capacity"], rec["counts"].shape[0]
            for _ in range(groups):
                st = ragged_tile_stats(flat[at:at + E], C, bm=pick_tile_m(C))
                at += E
                total += st["dense_m_tiles"]
                executed += (st["ragged_m_tiles"] if ragged and groups == 1
                             else st["dense_m_tiles"])
        tiles = obs.current_registry().counter(
            "engine_moe_m_tiles_total", "", ("kind",))
        tiles.inc(executed, kind="executed")
        tiles.inc(total, kind="total")

    def _sample_counters(self, reg) -> None:
        """One ``counters`` event per tick sampling the cumulative m-tile
        and qgemm counters: the timeline's counter tracks. The wrappers
        are called at the capture on the card (the reference's trace-time
        count under jit) and on every call on the CPU."""
        tiles = reg.counter("engine_moe_m_tiles_total", "", ("kind",))
        calls = reg.counter("qgemm_calls_total", "kernels.ops wrapper calls",
                            ("scheme", "kind", "shape", "block"))
        reg.emit({"ev": "counters", "tick": self._steps - 1,
                  "moe_executed": tiles.get(kind="executed"),
                  "moe_total": tiles.get(kind="total"),
                  "qgemm_calls": calls.total()})

    def close(self) -> None:
        """Detach the MoE routing sink. Idempotent; safe to skip, since the
        WeakMethod is pruned once the engine dies."""
        if self._routing_sink is not None:
            moe.remove_routing_sink(self._routing_sink)
            self._routing_sink = None
        self._routing_buf.clear()

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
            return rid
        if self.sc.max_queue and len(self.queue) >= self.sc.max_queue:
            self._finish(rid, "rejected", reason="queue_full",
                         queue_depth=len(self.queue))
            return rid
        if self.sc.deadline_s > 0:
            self._deadlines[rid] = self._submit_t[rid] + self.sc.deadline_s
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

    def trip_breaker(self, reason: str) -> None:
        """Force a circuit-breaker trip (external quant-health monitors).
        Falls back if a parameter set remains, else aborts the engine."""
        self._trip_breaker(reason)

    @torch.inference_mode()
    def run(self, max_ticks: int = 10_000) -> dict[int, list[int]]:
        reg = obs.current_registry()
        try:
            while (self.queue or any(s.active for s in self.slots)) \
                    and self._steps < max_ticks:
                self._expire_queued()
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
        self._deadlines.pop(rid, None)
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
        slots (abort / crashed-run path). Idempotent per rid."""
        for i, s in enumerate(self.slots):
            if s.active and s.request_id not in self.outcomes:
                self._finish(s.request_id, outcome, slot=i,
                             output=s.generated, tokens=len(s.generated))
            self.slots[i] = _Slot()
        for rid, _ in self.queue:
            if rid not in self.outcomes:
                self._finish(rid, outcome)
        self.queue.clear()

    def _expire_queued(self) -> None:
        """Retire queued requests whose deadline passed before a slot
        freed up (they never prefill)."""
        if not self._deadlines or not self.queue:
            return
        now = obs.current_registry().now()
        keep = []
        for rid, prompt in self.queue:
            dl = self._deadlines.get(rid)
            if dl is not None and now > dl:
                self._finish(rid, "timeout", where="queued")
            else:
                keep.append((rid, prompt))
        self.queue[:] = keep

    # -- circuit breaker ----------------------------------------------------
    def _on_phase_failure(self, phase: str, exc: Exception,
                          rid: int | None = None) -> None:
        """An exception escaped ``phase``: count it, retire the directly
        affected rid (prefill only — decode failures leave the slots
        intact for the retry), and trip the breaker when the streak
        reaches the threshold."""
        self._fail_streak += 1
        reg = obs.current_registry()
        reg.counter("engine_kernel_failures_total", "", ("phase",)).inc(
            phase=phase)
        ev = {"ev": "kernel_failure", "phase": phase,
              "streak": self._fail_streak, "error": repr(exc)[:200]}
        if rid is not None:
            ev["rid"] = rid
        reg.emit(ev)
        if rid is not None:
            self._finish(rid, "error", error=repr(exc)[:200])
        if self._fail_streak >= max(1, self.sc.breaker_threshold):
            self._trip_breaker(f"{phase}_exception", exc)

    def _trip_breaker(self, reason: str, exc: Exception | None = None):
        if self._fallback_params is not None:
            self._fallback(reason)
        else:
            self._abort(reason, exc)

    def _fallback(self, reason: str) -> None:
        """Graceful degradation: swap in the fallback parameter set and
        recipe, reset the breaker state, release the old steps' graphs and
        rebuild the model and its steps (the KV cache and the slots carry
        over; the next prefill and decode each capture once more)."""
        reg = obs.current_registry()
        frm = getattr(self.recipe, "name", None)
        self.params, self._fallback_params = self._fallback_params, None
        self.recipe, self._fallback_recipe = self._fallback_recipe, None
        self._fallbacks += 1
        self._fail_streak = 0
        self._nan_streak = 0
        reg.counter("engine_fallback_events_total", "", ("reason",)).inc(
            reason=reason)
        reg.emit({"ev": "fallback", "reason": reason, "from": str(frm),
                  "to": str(getattr(self.recipe, "name", None)),
                  "params_swapped": True, "fallbacks": self._fallbacks})
        self._release_steps()
        self.model = self.api.build(self.cfg, self.params, self.recipe)
        self._build_fns()

    def _abort(self, reason: str, exc: Exception | None = None):
        reg = obs.current_registry()
        reg.emit({"ev": "abort", "reason": reason,
                  "error": repr(exc)[:200] if exc else None})
        self._quiesce("error")
        raise EngineAborted(
            f"{self.engine_id}: breaker tripped ({reason}) with no "
            f"fallback remaining") from exc

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
            rid, prompt = self.queue.pop(0)
            poisoned = False
            try:
                with obs.span(reg, "engine_phase_seconds", phase="prefill",
                              event="admit") as sp:
                    # over-length prompts were rejected at submit unless
                    # truncate_prompts explicitly opted into this clip
                    toks = prompt[:P] + [0] * max(0, P - len(prompt))
                    true_len = min(len(prompt), P)
                    tokens1, slot = self._prefill_in
                    tokens1.copy_(torch.tensor([toks], dtype=torch.int64))
                    slot.fill_(i)
                    logits = self._prefill(tokens1, slot)
                    # the routing of this replay, before the next rewrites it
                    self._drain_routing()
                    first_row = logits[:, true_len - 1]
                    if self.sc.nan_guard and \
                            not bool(torch.isfinite(first_row).all()):
                        poisoned = True
                        sp.fields.update(rid=rid, slot=i, outcome="nan")
                    else:
                        first = int(self._sample(first_row)[0])
                        t_first = reg.now()
                        self.slots[i] = _Slot(request_id=rid,
                                              length=true_len,
                                              generated=[first], active=True,
                                              t_first=t_first)
                        sp.fields.update(rid=rid, slot=i,
                                         prompt_len=true_len,
                                         trace_id=self.trace_id(rid))
                        t_sub = self._submit_t.get(rid)
                        if t_sub is not None:
                            ttft = t_first - t_sub
                            reg.histogram("engine_ttft_seconds",
                                          "submit -> first generated token"
                                          ).observe(ttft)
                            sp.fields["ttft_s"] = round(ttft, 6)
            except Exception as exc:
                self._on_phase_failure("prefill", exc, rid=rid)
                continue
            if poisoned:
                self._finish(rid, "nan", slot=i, output=[], where="prefill")
                continue
            self._fail_streak = 0
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
        tokens, positions = self._decode_in
        try:
            with obs.span(reg, "engine_phase_seconds", phase="decode",
                          event="tick") as sp:
                self._watchdog.start()
                tokens.copy_(torch.tensor(last, dtype=torch.int64))
                positions.copy_(torch.tensor(pos, dtype=torch.int64))
                logits = self._decode(tokens, positions)
                finite = torch.isfinite(logits).all(dim=-1).tolist() \
                    if self.sc.nan_guard else [True] * B
                # sampled only after the decode succeeded, so a failed
                # attempt never advances the sampling generator
                nxt = self._sample(logits).tolist()  # waits for the step
                self._watchdog.stop(self._steps)
                sp.fields.update(tick=self._steps, slots_active=active,
                                 queue_depth=len(self.queue),
                                 slot_rids=slot_rids)
        except Exception as exc:
            # tick NOT advanced: the run loop retries (bounded — the
            # breaker trips fallback/abort on a streak)
            self._on_phase_failure("decode", exc)
            return
        self._fail_streak = 0
        bad = {i for i, s in enumerate(self.slots)
               if s.active and not finite[i]}
        self._nan_streak = self._nan_streak + 1 if bad else 0
        self._steps += 1
        reg.counter("engine_ticks_total", "").inc()
        reg.counter("engine_tokens_total", "").inc(active - len(bad))
        self._drain_routing()
        self._sample_counters(reg)
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
                done = (tok == self.sc.eos_id
                        or len(s.generated) >= self.sc.max_new_tokens
                        or s.length + 1 >= self.sc.max_seq)
                dl = self._deadlines.get(rid)
                if done:
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
                elif dl is not None and now > dl:
                    self._finish(rid, "timeout", slot=i, output=s.generated,
                                 tokens=len(s.generated))
                    self.slots[i] = _Slot()
        reg.gauge("engine_slots_active",
                  "occupied decode slots after retire").set(
                      sum(1 for s in self.slots if s.active))
        reg.gauge("engine_queue_depth", "requests waiting for a slot").set(
            len(self.queue))
        if self._nan_streak >= max(1, self.sc.breaker_threshold):
            # persistent poisoned logits = quant-health alarm: degrade to
            # the fallback parameter set instead of burning ticks on NaNs
            self._trip_breaker("nan_logits")
