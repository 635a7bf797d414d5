"""The port's serving robustness layer, CLI and telemetry tooling on the CPU:
``repro_torch.serving.chaos`` driving the engine's retries, circuit
breaker, deadlines, NaN quarantine and watchdog; ``repro_torch.launch.serve``
in-process; and the stdlib/numpy copies (``obs.timeline``,
``data.pipeline``, ``distributed.fault``) against the reference's modules
on the same inputs.

Every stream comparison here is exact (greedy tokens); the fault runs are
held to a fault-free run of the same engine and weights.
"""
import json

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.distributed import fault as jfault
from repro.obs import timeline as jtimeline
from repro_torch import obs
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.distributed import fault
from repro_torch.launch import serve
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.nn import spec as S
from repro_torch.serving.chaos import (ChaosConfig, ChaosError, ChaosMonkey,
                                       KernelFault, NanFault, SlowTick, flood)
from repro_torch.serving.engine import (OUTCOMES, Engine, EngineAborted,
                                        ServeConfig)

TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=64, dtype="float32")


class StepClock:
    """Monotonic stub: every reading advances by ``step``; ``advance``
    jumps time (the chaos SlowTick sleep_fn)."""

    def __init__(self, step: float = 0.0):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


@pytest.fixture(scope="module")
def tiny():
    cfg = ModelConfig(**TINY)
    api = get_model(cfg)
    params = S.materialize(api.param_specs(cfg),
                           torch.Generator().manual_seed(0), device="cpu")
    # a second parameter set for the breaker to fall back on
    other = S.materialize(api.param_specs(cfg),
                          torch.Generator().manual_seed(1), device="cpu")
    return api, cfg, params, other


def _prompts(n, seed=0, size=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=size).tolist() for _ in range(n)]


def _engine(tiny, fallback=False, **kw):
    api, cfg, params, other = tiny
    kw.setdefault("max_slots", 3)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_len", 8)
    kw.setdefault("max_new_tokens", 6)
    return Engine(api, cfg, params, ServeConfig(**kw),
                  fallback_params=other if fallback else None)


def _baseline(tiny, prompts, **kw):
    eng = _engine(tiny, **kw)
    rids = [eng.submit(p) for p in prompts]
    outs = eng.run()
    return {r: outs[r] for r in rids}


def _conserved(reg, eng):
    c = reg.snapshot()["counters"]
    submitted = c["engine_requests_total"]['event="submitted"']
    assert sum(c["engine_request_outcomes_total"].values()) == submitted
    assert len(eng.outcomes) == submitted
    assert set(eng.outcomes.values()) <= set(OUTCOMES)
    assert not eng.queue and not any(s.active for s in eng.slots)


def test_decode_retry_is_idempotent_on_the_in_place_cache(tiny):
    """Decode failures below the threshold are retried without advancing
    the tick, and the streams equal a fault-free run. One failure strikes
    AFTER the model ran, so the KV cache was already written in place: the
    retry rewrites the same K/V at the same positions."""
    prompts = _prompts(5, seed=1)
    ref = _baseline(tiny, prompts)
    reg = obs.Registry()
    with obs.use_registry(reg):
        eng = _engine(tiny, breaker_threshold=3)
        struck = []

        def fail_after_the_step(fn):
            def decode(*args, **kwargs):
                logits = fn(*args, **kwargs)
                if eng.ticks == 3 and not struck:
                    struck.append(eng.ticks)
                    raise ChaosError("after the cache write")
                return logits
            return decode

        eng.add_decode_wrapper(fail_after_the_step)
        monkey = ChaosMonkey(ChaosConfig(kernel_failures=(
            KernelFault(tick=1, count=2),))).install(eng)
        rids = [eng.submit(p) for p in prompts]
        outs = eng.run()
    assert struck == [3] and len(monkey.injected) == 2
    assert eng.fallbacks == 0
    assert {r: outs[r] for r in rids} == ref
    assert reg.counter("engine_kernel_failures_total", "", ("phase",)).get(
        phase="decode") == 3
    _conserved(reg, eng)


def test_breaker_exhausted_aborts_with_error_outcomes(tiny):
    reg = obs.Registry()
    with obs.use_registry(reg):
        eng = _engine(tiny, max_slots=2, breaker_threshold=2)
        ChaosMonkey(ChaosConfig(kernel_failures=(
            KernelFault(tick=0, count=99),))).install(eng)
        rids = [eng.submit(p) for p in _prompts(3, seed=4)]
        with pytest.raises(EngineAborted, match="no fallback"):
            eng.run()
    assert [eng.outcome(r) for r in rids] == ["error"] * 3
    _conserved(reg, eng)
    names = [e["name"] for e in obs.timeline.trace_events(reg.events())]
    assert any(n.startswith("engine abort:") for n in names)
    assert any(n.startswith("kernel_failure:decode") for n in names)


def test_nan_streak_trips_breaker(tiny):
    reg = obs.Registry()
    with obs.use_registry(reg):
        eng = _engine(tiny, fallback=True, max_slots=2, breaker_threshold=2,
                      max_new_tokens=12)
        ChaosMonkey(ChaosConfig(nan_logits=tuple(
            NanFault(tick=t) for t in (1, 2)))).install(eng)
        for p in _prompts(6, seed=5):
            eng.submit(p)
        eng.run()
    assert eng.fallbacks == 1 and eng.params is tiny[3]
    c = reg.snapshot()["counters"]
    assert c["engine_fallback_events_total"]['reason="nan_logits"'] == 1
    assert c["engine_request_outcomes_total"]['outcome="nan"'] == 4
    _conserved(reg, eng)


def test_nan_quarantine_keeps_cobatched_streams(tiny):
    prompts = _prompts(3, seed=0)
    ref = _baseline(tiny, prompts)
    reg = obs.Registry()
    with obs.use_registry(reg):
        eng = _engine(tiny)
        monkey = ChaosMonkey(ChaosConfig(
            nan_logits=(NanFault(tick=2, rid=1),))).install(eng)
        rids = [eng.submit(p) for p in prompts]
        outs = eng.run()
    assert monkey.injected == [{"kind": "nan", "tick": 2, "rid": 1,
                                "slot": 1}]
    assert eng.outcome(rids[1]) == "nan"
    assert outs[rids[1]] == ref[rids[1]][:len(outs[rids[1]])]
    assert outs[rids[0]] == ref[rids[0]] and outs[rids[2]] == ref[rids[2]]
    _conserved(reg, eng)


def test_external_breaker_trip(tiny):
    reg = obs.Registry()
    with obs.use_registry(reg):
        eng = _engine(tiny, fallback=True)
        eng.trip_breaker("alpha_cap_alarm")
        assert eng.fallbacks == 1 and eng.params is tiny[3]
        rids = [eng.submit(p) for p in _prompts(2, seed=6)]
        eng.run()
        with pytest.raises(EngineAborted):
            eng.trip_breaker("again")  # no fallback left
    assert all(eng.outcome(r) == "ok" for r in rids)
    assert reg.counter("engine_fallback_events_total", "", ("reason",)).get(
        reason="alpha_cap_alarm") == 1
    _conserved(reg, eng)


def test_deadline_timeout_active_and_queued(tiny):
    clock = StepClock(step=0.01)
    reg = obs.Registry(clock=clock)
    with obs.use_registry(reg):
        eng = _engine(tiny, max_slots=1, max_new_tokens=30, deadline_s=1.0)
        rid_a, rid_b = (eng.submit(p) for p in _prompts(2, seed=7))
        clock.advance(0.9)
        outs = eng.run()
    assert eng.outcome(rid_a) == "timeout"
    assert 0 < len(outs[rid_a]) < 30
    assert eng.outcome(rid_b) == "timeout"
    retires = {e["rid"]: e for e in reg.events() if e.get("ev") == "retire"}
    assert retires[rid_b].get("where") == "queued"
    assert "slot" in retires[rid_a]
    _conserved(reg, eng)


def test_slow_tick_watchdog_and_queue_flood(tiny):
    clock = StepClock(step=0.0)
    reg = obs.Registry(clock=clock)
    with obs.use_registry(reg):
        eng = _engine(tiny, max_slots=1, max_new_tokens=10, max_queue=2)
        ChaosMonkey(ChaosConfig(slow_ticks=(SlowTick(tick=6, seconds=5.0),)),
                    sleep_fn=clock.advance).install(eng)
        rids = flood(eng, 4)
        assert [eng.outcome(r) for r in rids[2:]] == ["rejected"] * 2
        eng.run()
    assert [eng.outcome(r) for r in rids[:2]] == ["ok", "ok"]
    assert reg.counter("engine_slow_ticks_total").total() == 1
    assert [e["tick"] for e in reg.events() if e.get("ev") == "slow_tick"] \
        == [6]
    _conserved(reg, eng)


def test_device_timer_and_trace_window(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="_device_seconds"):
        obs.device_timer(lambda: None, "engine_phase_seconds")
    clock = StepClock(step=0.5)
    reg = obs.Registry(clock=clock)
    # CPU tensors: nothing to synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: pytest.fail("synchronized a CPU call"))
    timed = obs.device_timer(lambda t: t + 1, "x_device_seconds", phase="p")
    with obs.use_registry(reg):
        for _ in range(3):
            timed(torch.ones(2))
    assert timed.calls() == 3
    assert reg.counter("x_device_warmup_total", "", ("phase",)).get(
        phase="p") == 1
    h = reg.histogram("x_device_seconds", "", ("phase",)).get(phase="p")
    assert h["count"] == 2 and h["sum"] == pytest.approx(1.0)
    with obs.trace_window(None) as prof:
        assert prof is None
    with obs.trace_window(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    (trace,) = tmp_path.glob("torch_trace_*.json")
    assert json.loads(trace.read_text())["traceEvents"]


def test_timeline_matches_reference(tiny):
    """The port's engine events through both packages' ``trace_events``:
    equal, on a run with a NaN quarantine, decode retries, a breaker
    fallback and a queued timeout."""
    clock = StepClock(step=0.001)
    reg = obs.Registry(clock=clock)
    with obs.use_registry(reg):
        eng = _engine(tiny, fallback=True, max_slots=2, breaker_threshold=2,
                      deadline_s=0.5)
        ChaosMonkey(ChaosConfig(
            nan_logits=(NanFault(tick=1, rid=0),),
            kernel_failures=(KernelFault(tick=3, count=2),))).install(eng)
        for p in _prompts(4, seed=9):
            eng.submit(p)
        eng.run()
    events = reg.events()
    kinds = {e["ev"] for e in events}
    assert {"submit", "admit", "tick", "retire", "kernel_failure",
            "fallback"} <= kinds
    got = obs.timeline.trace_events(events)
    assert got == jtimeline.trace_events(events)
    assert obs.build_trace(reg)["traceEvents"] == got


@pytest.mark.parametrize("cfg", [dict(vocab_size=512, seq_len=32,
                                      batch_size=1),
                                 dict(vocab_size=64, seq_len=100,
                                      batch_size=4, num_shards=2)])
def test_pipeline_matches_reference(cfg):
    mine, ref = SyntheticPipeline(DataConfig(**cfg)), JPipeline(
        JDataConfig(**cfg))
    for step in (0, 300_001):
        a, b = mine.global_batch(step), ref.global_batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.unigram_entropy() == ref.unigram_entropy()


def test_fault_utilities_match_reference():
    for mod in (fault, jfault):
        inj = mod.FailureInjector(fail_at_step=2, schedule={5: 2})
        fired = []
        for step in (1, 2, 2, 5, 5, 5):
            try:
                inj.maybe_fail(step)
            except RuntimeError:
                fired.append(step)
        assert fired == [2, 5, 5] and inj.fired_at == fired
        clock = StepClock()
        slow = []
        hb = mod.Heartbeat(mod.HeartbeatConfig(straggler_factor=2.0),
                           on_straggler=lambda *a: slow.append(a[0]),
                           clock=clock)
        for step, dt in enumerate((1, 1, 1, 1, 1, 5, 1)):
            hb.start()
            clock.advance(dt)
            hb.stop(step)
        assert slow == [5] and hb.median == 1
        with pytest.raises(RuntimeError, match="without a matching start"):
            hb.stop(9)


CLI = ["--device", "cpu", "--arch", "llama2-7b", "--smoke", "--requests",
       "3", "--max-new", "4", "--prefill-len", "16", "--max-seq", "64"]


@pytest.mark.parametrize("recipe,name", [
    ([], "W4A8-g128-IS-rtn"),
    (["--scale-mode", "float"], "W4A8-g128-FS-rtn"),
    (["--a-bits", "16"], "W4A16-g128-IS-rtn"),
])
def test_serve_cli_runs_each_recipe(capsys, recipe, name):
    with obs.use_registry(obs.Registry()):
        assert serve.main(CLI + recipe) == 0
    out = capsys.readouterr().out
    assert f"quantized ({name})" in out
    assert "3 requests, 12 tokens" in out
    assert "conserved=yes" in out and 'outcome="ok"\': 3' in out


def test_serve_cli_chaos_drill_writes_telemetry(capsys, tmp_path):
    metrics, trace = tmp_path / "m.jsonl", tmp_path / "t.json"
    with obs.use_registry(obs.Registry()):
        serve.main(CLI + ["--chaos-nan-ticks", "2", "--chaos-kernel-ticks",
                          "1", "--metrics-out", str(metrics),
                          "--trace-out", str(trace)])
    out = capsys.readouterr().out
    assert "chaos armed" in out and "conserved=yes" in out
    assert 'outcome="nan"\': 3' in out
    snap = json.loads(metrics.read_text().splitlines()[-1])["snapshot"]
    assert snap["counters"]["engine_kernel_failures_total"][
        'phase="decode"'] == 1
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]]
    assert sum(n.endswith("retire:nan") for n in names) == 3
    with pytest.raises(NotImplementedError, match="calibration slice"):
        serve.main(CLI + ["--algo", "gptq"])
