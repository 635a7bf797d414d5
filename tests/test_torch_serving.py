"""The port's serving robustness layer, CLI and telemetry tooling on the CPU:
``repro_torch.serving.chaos`` driving the engine's retries, circuit
breaker, deadlines, NaN quarantine and watchdog; ``repro_torch.launch.serve``
in-process; and the stdlib/numpy copies (``obs.timeline``,
``data.pipeline``, ``distributed.fault``) against the reference's modules
on the same inputs.

Every stream comparison here is exact (greedy tokens); the fault runs are
held to a fault-free run of the same engine and weights. The fault drills
of ``tests/test_chaos.py`` run on both engines (the reference's and the
port's, on the same weights and seeded prompts) and compare outcomes,
streams, step establishments and every ``engine_*`` counter. The
telemetry of ``tests/test_obs.py::TestEngineTelemetry`` is held on the
port's smoke Mixtral.
"""
import collections
import json

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.distributed import fault as jfault
from repro.models.config import ModelConfig as JConfig
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro.obs import timeline as jtimeline
from repro.serving import chaos as jchaos
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import convert, obs
from repro_torch.core import ptq
from repro_torch.core.recipe import QuantRecipe, QuantSpec
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.distributed import fault
from repro_torch.launch import serve
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.nn import spec as S
from repro_torch.serving import chaos
from repro_torch.serving.chaos import (ChaosConfig, ChaosError, ChaosMonkey,
                                       KernelFault, NanFault, SlowTick, flood)
from repro_torch.serving.engine import (OUTCOMES, Engine, EngineAborted,
                                        ServeConfig)
# the card tests' eager greedy loop and NaN-row wrapper, exercised here too
from test_torch_cuda import eager_greedy, poison_quarantined_rows

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
    assert "step establishments: prefill_traces=1 decode_traces=1" in out
    assert "conserved=yes" in out and 'outcome="ok"\': 3' in out


def test_serve_cli_chaos_drill_writes_telemetry(capsys, tmp_path):
    metrics, trace = tmp_path / "m.jsonl", tmp_path / "t.json"
    with obs.use_registry(obs.Registry()):
        serve.main(CLI + ["--chaos-nan-ticks", "2", "--chaos-kernel-ticks",
                          "1", "--metrics-out", str(metrics),
                          "--trace-out", str(trace)])
    out = capsys.readouterr().out
    assert "chaos armed" in out and "conserved=yes" in out
    # the injected decode failure is retried on the same step: no fallback,
    # and the run's check decode_traces == 1 + fallbacks held
    assert "0 breaker fallbacks" in out
    assert "step establishments: prefill_traces=1 decode_traces=1" in out
    assert 'outcome="nan"\': 3' in out
    snap = json.loads(metrics.read_text().splitlines()[-1])["snapshot"]
    assert snap["counters"]["engine_kernel_failures_total"][
        'phase="decode"'] == 1
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]]
    assert sum(n.endswith("retire:nan") for n in names) == 3
    # the calibration algorithms serve too (without calibration rows on
    # a registry arch, as in the reference: RTN codes under their spec)
    for algo in ("gptq", "awq"):
        with obs.use_registry(obs.Registry()):
            assert serve.main(CLI + ["--algo", algo]) == 0
        out = capsys.readouterr().out
        assert f"quantized (W4A8-g128-IS-{algo})" in out
        assert "conserved=yes" in out and 'outcome="ok"\': 3' in out


@pytest.mark.parametrize("algo", ["gptq", "awq"])
def test_serve_cli_calibrates_bench_lm(capsys, monkeypatch, algo):
    """``--arch bench-lm`` is served calibrated, as in the reference: its
    tree differs from the RTN tree of the same weights in every linear's
    codes (GPTQ) or carries ``pre_scale`` on every linear (AWQ), and every
    request ends ok."""
    served = {}

    def spy(*a):
        served["model"] = load(*a)
        return served["model"]

    load = serve._load_model
    monkeypatch.setattr(serve, "_load_model", spy)
    with obs.use_registry(obs.Registry()):
        assert serve.main(["--device", "cpu", "--algo", algo, "--requests",
                           "3", "--max-new", "4", "--prefill-len", "16",
                           "--max-seq", "64"]) == 0
    out = capsys.readouterr().out
    assert f"quantized (W4A8-g128-IS-{algo}) with calibration" in out
    assert "conserved=yes" in out and 'outcome="ok"\': 3' in out
    api, cfg, qp, _ = served["model"]
    lins = [lin for blk in qp["blocks"] for part in ("attn", "mlp")
            for lin in blk[part].values()]
    assert len(lins) == 7 * cfg.num_layers
    if algo == "awq":
        assert all("pre_scale" in lin for lin in lins)
        return
    rtn = ptq.post_training_quantize(
        api, cfg, ptq.materialize_by_layer(api, cfg, device="cpu"),
        QuantRecipe(rules=(("*", QuantSpec()),)))
    rtn_lins = [lin for blk in rtn["blocks"] for part in ("attn", "mlp")
                for lin in blk[part].values()]
    assert not any("pre_scale" in lin for lin in lins)
    assert all(not torch.equal(a["qvalue"], b["qvalue"])
               for a, b in zip(lins, rtn_lins))


# -- the fault drills of tests/test_chaos.py, on both engines -------------------


@pytest.fixture(scope="module")
def pair():
    """The tiny model of ``tests/test_chaos.py`` for both packages: the
    reference's weights from ``PRNGKey(0)``, converted for the port."""
    jcfg = JConfig(**TINY, q_chunk=16, kv_chunk=16, remat=False)
    japi = jget_model(jcfg)
    jparams = JS.materialize(japi.param_specs(jcfg, None),
                             jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY)
    params = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    return (japi, jcfg, jparams), (get_model(cfg), cfg, params)


# side -> (Engine, ServeConfig, chaos, obs, ServeConfig fields of its own);
# the reference's breaker would fall back to another kernel mode, the
# port's has no fallback parameters here: both abort
SIDES = {"reference": (JEngine, JServeConfig, jchaos, jobs,
                       dict(fallback_kernel_mode=None)),
         "port": (Engine, ServeConfig, chaos, obs, {})}


def _drill(pair, body, **kw):
    """Run ``body(eng, side)`` on the reference engine and on the port's,
    each under a registry of its own package on a stopped ``StepClock``
    (so no host time reaches the watchdog) with the same ServeConfig;
    ``side`` carries the package's ``chaos``, ``obs`` and ``reg``.
    Returns {side name: (engine, registry, body's result)}."""
    kw = {**dict(max_slots=3, max_seq=64, prefill_len=8, max_new_tokens=6),
          **kw}
    out = {}
    for name, (api, cfg, params) in zip(SIDES, pair):
        E, SC, ch, o, extra = SIDES[name]
        reg = o.Registry(clock=StepClock())
        with o.use_registry(reg):
            eng = E(api, cfg, params, SC(**kw, **extra))
            side = type("Side", (), dict(chaos=ch, obs=o, reg=reg,
                                         port=name == "port"))
            result = body(eng, side)
            eng.close()
        out[name] = (eng, reg, result)
    return out


def _engine_counters(reg) -> dict:
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith("engine_")}


def _same_as_reference(runs):
    """Outcomes, streams, step establishments, ticks and every engine_*
    counter of the port's run equal the reference's; the port's books
    balance."""
    (jeng, jreg, _), (eng, reg, _) = runs["reference"], runs["port"]
    assert eng.outcomes == jeng.outcomes
    assert eng.outputs == jeng.outputs
    assert (eng.prefill_traces, eng.decode_traces, eng.fallbacks,
            eng.ticks) == (jeng.prefill_traces, jeng.decode_traces,
                           jeng.fallbacks, jeng.ticks)
    assert _engine_counters(reg) == _engine_counters(jreg)
    _conserved(reg, eng)


def test_nan_slot_reuse_after_quarantine(pair):
    """A quarantined slot is freed and reused: the next request admits into
    the SAME slot and serves a clean stream, equal to the reference's and
    to a fresh engine's. In the port's run the quarantined slot's cache
    rows are also NaN: the next prefill's splice must clear every row,
    since decode attention multiplies its masked zero probabilities by
    every cached row."""
    prompts = _prompts(2, seed=3)

    def body(eng, side):
        side.chaos.ChaosMonkey(side.chaos.ChaosConfig(
            nan_logits=(side.chaos.NanFault(tick=0, rid=0),))).install(eng)
        if side.port:
            eng.add_decode_wrapper(poison_quarantined_rows(eng))
        for p in prompts:
            eng.submit(p)
        return eng.run()

    runs = _drill(pair, body, max_slots=1)
    eng, _, outs = runs["port"]
    assert eng.outcome(0) == "nan" and eng.outcome(1) == "ok"
    assert eng.decode_traces == eng.prefill_traces == 1
    _same_as_reference(runs)
    fresh = _drill(pair, lambda e, s: (e.submit(prompts[1]), e.run())[1],
                   max_slots=1)
    assert outs[1] == fresh["port"][2][0] == fresh["reference"][2][0]


def test_cancel_queued_and_active(pair):
    def body(eng, side):
        rid_a, rid_b = (eng.submit(p) for p in _prompts(2, seed=8))
        assert eng.cancel(rid_b) is True          # queued -> cancelled
        assert eng.cancel(rid_b) is False         # already terminal
        assert eng.cancel(999) is False           # unknown rid
        eng.run(max_ticks=3)                      # rid_a still active
        assert eng.outcome(rid_a) is None
        assert eng.cancel(rid_a) is True          # active -> cancelled
        assert not any(s.active for s in eng.slots)
        return rid_a, rid_b

    runs = _drill(pair, body, max_slots=1, max_new_tokens=10)
    eng, _, (rid_a, rid_b) = runs["port"]
    assert eng.outcome(rid_a) == eng.outcome(rid_b) == "cancelled"
    assert 0 < len(eng.outputs[rid_a]) < 10       # partial tokens kept
    _same_as_reference(runs)


def test_overlength_prompt_rejected_not_truncated(pair):
    """Prompts longer than prefill_len are rejected with a structured
    reason; only the explicit truncate_prompts opt-in clips them."""
    long_prompt = list(range(1, 20))  # 19 > prefill_len = 8

    def body(eng, side):
        rid = eng.submit(long_prompt)
        assert eng.outcome(rid) == "rejected" and eng.queue == []
        ev = [e for e in side.reg.events() if e.get("ev") == "retire"][-1]
        assert ev["reason"] == "prompt_overlength"
        assert eng.run() == {}
        return rid

    runs = _drill(pair, body)
    _same_as_reference(runs)
    assert runs["port"][0].decode_traces == 0  # nothing ever ran

    def clipped(eng, side):
        return eng.submit(long_prompt), eng.run()

    runs = _drill(pair, clipped, truncate_prompts=True)
    eng, _, (rid, outs) = runs["port"]
    assert eng.outcome(rid) == "ok" and len(outs[rid]) == 6
    _same_as_reference(runs)


def test_double_retire_raises(pair):
    """The ``_finish`` chokepoint refuses a second retire of a rid."""
    def body(eng, side):
        rid = eng.submit([1, 2, 3])
        eng.run()
        assert eng.outcome(rid) == "ok"
        with pytest.raises(RuntimeError, match="already terminal"):
            eng._finish(rid, "error")
        return rid

    runs = _drill(pair, body)
    assert runs["port"][0].outcome(runs["port"][2]) == "ok"
    _same_as_reference(runs)


def test_mixed_fault_drill_conservation(pair):
    """NaN, a transient kernel fault, flood rejects, a cancel and an
    over-length reject at once: the books balance, on one decode
    establishment, as in the reference."""
    def body(eng, side):
        ch = side.chaos
        ch.ChaosMonkey(ch.ChaosConfig(
            nan_logits=(ch.NanFault(tick=1, rid=0),),
            kernel_failures=(ch.KernelFault(tick=3, count=1),))).install(eng)
        rids = ch.flood(eng, 6, prompt=[4, 5, 6])  # 2 rejected (queue 4)
        over = eng.submit(list(range(30)))         # rejected: over-length
        cancelled = next(r for r in rids if eng.outcome(r) is None
                         and r != rids[0])
        eng.cancel(cancelled)
        eng.run()
        return rids, over, cancelled

    runs = _drill(pair, body, max_slots=2, max_queue=4, breaker_threshold=5)
    eng, _, (rids, over, cancelled) = runs["port"]
    assert eng.decode_traces == 1 and eng.fallbacks == 0
    assert eng.outcome(over) == "rejected"
    assert eng.outcome(cancelled) == "cancelled"
    assert eng.outcome(rids[0]) == "nan"
    tally = collections.Counter(eng.outcomes.values())
    assert (tally["rejected"], tally["cancelled"], tally["nan"],
            tally["error"], tally["ok"]) == (3, 1, 1, 0, 2)
    _same_as_reference(runs)


def test_crashed_run_flushes_conserved_telemetry(pair, tmp_path):
    """After a crashed ``run()`` the event log and snapshot still flush,
    the snapshot satisfies the conservation law, and the trace is
    well-formed with error markers."""
    def body(eng, side):
        ch = side.chaos
        ch.ChaosMonkey(ch.ChaosConfig(
            kernel_failures=(ch.KernelFault(tick=1, count=9),))).install(eng)
        for p in _prompts(2, seed=10):
            eng.submit(p)
        with pytest.raises(RuntimeError, match="no fallback"):
            eng.run()
        mpath = tmp_path / f"{side.port}.jsonl"
        tpath = tmp_path / f"{side.port}.json"
        assert side.reg.write_events_jsonl(str(mpath)) > 0
        side.obs.write_trace(str(tpath), side.reg)
        return mpath, tpath

    runs = _drill(pair, body, breaker_threshold=1)
    _same_as_reference(runs)
    mpath, tpath = runs["port"][2]
    c = json.loads(mpath.read_text().splitlines()[-1])["snapshot"]["counters"]
    outcomes = c["engine_request_outcomes_total"]
    assert outcomes['outcome="error"'] == 2
    assert sum(outcomes.values()) == \
        c["engine_requests_total"]['event="submitted"']
    names = [e["name"] for e in json.loads(tpath.read_text())["traceEvents"]]
    assert any(n.endswith("retire:error") for n in names)
    jm = runs["reference"][2][0]
    assert json.loads(jm.read_text().splitlines()[-1])["snapshot"][
        "counters"]["engine_request_outcomes_total"] == outcomes


def test_engine_streams_equal_an_eager_greedy_loop(tiny):
    """The loop the card tests hold the captured engine against
    (``tests/test_torch_cuda.py``) gives the engine's streams here, with
    more requests than slots."""
    api, cfg, params, _ = tiny
    prompts = [p[:n] for p, n in zip(_prompts(5, seed=11), (5, 8, 3, 7, 6))]
    eng = _engine(tiny, max_slots=2)
    rids = [eng.submit(p) for p in prompts]
    outs = eng.run()
    assert [outs[r] for r in rids] == eager_greedy(
        api, cfg, eng.model, prompts, eng.sc)
    assert eng.decode_traces == eng.prefill_traces == 1


# -- tests/test_obs.py::TestEngineTelemetry on the port --------------------------


class TestEngineTelemetry:
    """The port's smoke Mixtral under W4A8 IS served on the CPU: the
    m-tile counters against the routing trace's ground truth, one
    establishment per step, tick and token accounting, and each request's
    lifecycle once in the timeline."""

    @pytest.fixture(scope="class")
    def run(self):
        from repro_torch.core import ptq
        from repro_torch.core.recipe import DEFAULT_RECIPE
        from repro_torch.models import moe
        from repro_torch.models.registry import get_arch

        cfg = get_arch("mixtral-8x7b", smoke=True)
        api = get_model(cfg)
        reg = obs.Registry()
        with obs.use_registry(reg):
            qp = ptq.quantize_by_layer(api, cfg, DEFAULT_RECIPE, device="cpu")
            sc = ServeConfig(max_slots=2, max_seq=32, prefill_len=8,
                             max_new_tokens=3)
            trace = moe.start_routing_trace()
            eng = Engine(api, cfg, qp, sc, recipe=DEFAULT_RECIPE)
            rng = np.random.default_rng(0)
            for _ in range(3):
                eng.submit(rng.integers(1, cfg.vocab_size, 6).tolist())
            outs = eng.run()
            moe.stop_routing_trace(trace)
            eng.close()
        return reg, eng, trace, outs

    def test_ragged_m_tiles_match_ground_truth(self, run):
        from repro_torch.kernels.moe_gemm import ragged_tile_stats
        from repro_torch.kernels.w4a8_gemm import pick_tile_m

        reg, eng, trace, _ = run
        assert trace, "routing trace captured no records"
        dense = ragged = 0
        for rec in trace:
            C = rec["capacity"]
            for row in rec["counts"].tolist():
                st = ragged_tile_stats(row, C, bm=pick_tile_m(C))
                dense += st["dense_m_tiles"]
                ragged += st["ragged_m_tiles"]
        tiles = reg.snapshot()["counters"]["engine_moe_m_tiles_total"]
        # the plain versions compute every row: executed is the dense
        # count on the CPU (the ragged one on the card: test_torch_cuda)
        assert tiles['kind="executed"'] == tiles['kind="total"'] == dense
        assert 0 < ragged < dense  # the card's kernels would skip tiles

    def test_no_retrace_and_tick_accounting(self, run):
        reg, eng, _, outs = run
        assert eng.decode_traces == eng.prefill_traces == 1
        snap = reg.snapshot()
        c = snap["counters"]
        assert c["engine_traces_total"] == {'fn="decode"': 1.0,
                                            'fn="prefill"': 1.0}
        assert c["engine_ticks_total"][""] == eng.ticks
        assert c["engine_requests_total"] == {'event="submitted"': 3.0,
                                              'event="admitted"': 3.0,
                                              'event="retired"': 3.0}
        out = c["engine_request_outcomes_total"]
        assert out['outcome="ok"'] == 3.0
        assert sum(out.values()) == c["engine_requests_total"][
            'event="submitted"']
        assert c["engine_tokens_total"][""] == sum(
            len(v) - 1 for v in outs.values())  # first token from prefill
        h = snap["histograms"]
        assert h["engine_ttft_seconds"][""]["count"] == 3
        assert h["engine_tpot_seconds"][""]["count"] == 3
        assert h["engine_phase_seconds"]['phase="decode"']["count"] \
            == eng.ticks
        assert c["alpha_cap_events_total"] == {"": 0.0}
        assert any('scheme="w4a8-is"' in k for k in c["qgemm_calls_total"])

    def test_events_carry_decode_latency_and_rids(self, run):
        reg, _, _, outs = run
        evs = reg.events()
        ticks = [e for e in evs if e.get("ev") == "tick"]
        assert ticks and all("seconds" in e and "slots_active" in e
                             for e in ticks)
        assert {e["rid"] for e in evs if e.get("ev") == "retire"} \
            == set(outs)
        assert [(e["fn"], e["engine_count"]) for e in evs
                if e.get("ev") == "trace"] == [("prefill", 1), ("decode", 1)]

    def test_timeline_lifecycle_exactly_once(self, run):
        reg, _, _, outs = run
        names = [e["name"] for e in obs.build_trace(reg)["traceEvents"]]
        for rid in outs:
            for stage in ("queued", "prefill", "TTFT", "retire"):
                assert names.count(f"r{rid} {stage}") == 1, (rid, stage)
            assert names.count(f"r{rid} decode") == len(outs[rid]) - 1
        assert names.count("prefill") == len(outs)  # engine-phase lane
