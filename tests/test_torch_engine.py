"""The port's serving engine (``repro_torch.serving``) against the JAX
``Engine`` on the CPU, its request lifecycle, and the port's independence
from JAX and from the ``repro`` package.

Greedy token streams must be EQUAL to the reference engine's on the tiny
config of ``tests/test_serving.py`` (fp, and W4A8-IS, W4A8-FS and W4A16
g64 through both packages' RTN PTQ), with all requests admitted at once
and with more requests than slots (staggered admission, per-slot decode
positions). The reference engine runs W4A16 through its Pallas kernel in
interpret mode: its reference path dequantizes to the f32 activation
dtype, where the kernel and the port round the dequantized weight to
bf16. The other schemes run its reference path. The circuit breaker's
IS -> FS swap is held to the reference engine's too.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.extend
import numpy as np
import pytest

from repro.core import ptq as jptq
from repro.core.recipe import QuantRecipe as JRecipe
from repro.core.recipe import QuantSpec as JSpec
from repro.models.config import ModelConfig as JConfig
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro.serving import chaos as jchaos
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import convert, obs
from repro_torch.core import ptq
from repro_torch.core.recipe import QuantRecipe, QuantSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.serving.chaos import ChaosConfig, ChaosMonkey, KernelFault
from repro_torch.serving.engine import (OUTCOMES, Engine, EngineAborted,
                                        ServeConfig)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=64, dtype="float32")
# the reference's chunked attention takes its chunk sizes from the config
JCHUNKS = dict(q_chunk=16, kv_chunk=16)
# the reference engine's kernel mode per scheme (see the module docstring)
JMODES = {"fp": "reference", "w4a8-is": "reference", "w4a8-fs": "reference",
          "w4a16": "pallas_interpret"}
LAYOUTS = {  # name -> (max_slots, prompt count, prompt lengths)
    "aligned": (3, 3, (8, 8, 8)),
    "staggered": (2, 5, (5, 8, 3, 7, 6)),
}


@pytest.fixture(scope="module")
def models():
    """fp, W4A8-IS, W4A8-FS and W4A16 g64 weights for both packages. The
    reference's
    overflow certificate reads ``jax.core.Literal``, which JAX 0.9 moved
    to ``jax.extend.core``: it is aliased only while the reference
    quantizes, and restored at once."""
    jcfg = JConfig(**TINY, **JCHUNKS, remat=False)
    japi = jget_model(jcfg)
    jparams = JS.materialize(japi.param_specs(jcfg, None),
                             jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY)
    api = get_model(cfg)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    jrecipe = JRecipe(rules=(("*", JSpec(group_size=64)),), name="w4a8-is")
    recipe = QuantRecipe(rules=(("*", QuantSpec(group_size=64)),),
                         name="w4a8-is")
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "Literal"):
            mp.setattr(jax.core, "Literal", jax.extend.core.Literal,
                       raising=False)
        jq = jptq.post_training_quantize(japi, jcfg, jparams, jrecipe, None)
    tq = ptq.post_training_quantize(api, cfg, tparams, recipe)
    out = {"fp": ((japi, jcfg, jparams, None), (api, cfg, tparams, None)),
           "w4a8-is": ((japi, jcfg, jq, jrecipe), (api, cfg, tq, recipe))}
    for name, kw in (("w4a8-fs", dict(scale_mode="float")),
                     ("w4a16", dict(a_bits=16))):
        jr = JRecipe(rules=(("*", JSpec(group_size=64, **kw)),), name=name)
        r = QuantRecipe(rules=(("*", QuantSpec(group_size=64, **kw)),),
                        name=name)
        out[name] = (
            (japi, jcfg, jptq.post_training_quantize(japi, jcfg, jparams, jr,
                                                     None), jr),
            (api, cfg, ptq.post_training_quantize(api, cfg, tparams, r), r))
    return out


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=n).tolist() for n in lengths]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("scheme", ["fp", "w4a8-is", "w4a8-fs", "w4a16"])
def test_greedy_streams_equal_reference_engine(models, scheme, layout):
    (japi, jcfg, jparams, jrecipe), (api, cfg, params, recipe) = \
        models[scheme]
    slots, n, lengths = LAYOUTS[layout]
    prompts = _prompts(len(lengths), lengths)
    kw = dict(max_slots=slots, max_seq=64, prefill_len=8, max_new_tokens=6)
    jeng = JEngine(japi, jcfg, jparams,
                   JServeConfig(**kw, kernel_mode=JMODES[scheme]),
                   recipe=jrecipe)
    jrids = [jeng.submit(p) for p in prompts]
    want = jeng.run()
    eng = Engine(api, cfg, params, ServeConfig(**kw), recipe=recipe)
    rids = [eng.submit(p) for p in prompts]
    got = eng.run()
    assert rids == jrids and len(rids) == n
    for r in rids:
        assert eng.outcome(r) == jeng.outcome(r) == "ok"
        assert got[r] == want[r], (r, got[r], want[r])
    assert eng.ticks == jeng._steps
    assert (eng.prefill_traces, eng.decode_traces) == (
        jeng.prefill_traces, jeng.decode_traces) == (1, 1)


def test_breaker_swaps_is_to_fs_like_reference(models):
    """Two injected decode failures at tick 2 trip the breaker
    (threshold 2) in both engines; each swaps the IS weights for the FS
    ones (the reference in reference mode has no kernel mode to fall back
    on, so it swaps parameters only) and the streams stay equal."""
    (japi, jcfg, jis, jr_is), (api, cfg, tis, r_is) = models["w4a8-is"]
    (_, _, jfs, jr_fs), (_, _, tfs, r_fs) = models["w4a8-fs"]
    prompts = _prompts(5, LAYOUTS["staggered"][2])
    kw = dict(max_slots=2, max_seq=64, prefill_len=8, max_new_tokens=6,
              breaker_threshold=2)
    jeng = JEngine(japi, jcfg, jis, JServeConfig(**kw, kernel_mode="reference"),
                   recipe=jr_is, fallback_params=jfs, fallback_recipe=jr_fs)
    jchaos.ChaosMonkey(jchaos.ChaosConfig(kernel_failures=(
        jchaos.KernelFault(tick=2, count=2),))).install(jeng)
    jrids = [jeng.submit(p) for p in prompts]
    want = jeng.run()
    reg = obs.Registry()
    with obs.use_registry(reg):
        eng = Engine(api, cfg, tis, ServeConfig(**kw), recipe=r_is,
                     fallback_params=tfs, fallback_recipe=r_fs)
        monkey = ChaosMonkey(ChaosConfig(kernel_failures=(
            KernelFault(tick=2, count=2),))).install(eng)
        rids = [eng.submit(p) for p in prompts]
        got = eng.run()
    assert rids == jrids
    assert jeng.fallbacks == eng.fallbacks == 1
    assert eng.recipe is r_fs and jeng.recipe is jr_fs
    assert monkey.injected == [{"kind": "kernel", "tick": 2}] * 2
    assert all(eng.outcome(r) == jeng.outcome(r) == "ok" for r in rids)
    assert {r: got[r] for r in rids} == {r: want[r] for r in rids}
    assert reg.counter("engine_fallback_events_total", "", ("reason",)).get(
        reason="decode_exception") == 1
    # the fallback establishes both steps once more, as it re-jits both
    assert (eng.prefill_traces, eng.decode_traces) == (
        jeng.prefill_traces, jeng.decode_traces) == (2, 2)
    assert reg.counter("engine_traces_total", "", ("fn",)).get(
        fn="decode") == 1 + eng.fallbacks


def test_outcomes_are_conserved(models):
    """Every submitted request ends in exactly one outcome: admission
    rejects (over-length prompt, full queue), cancels (queued and active),
    a NaN quarantine that retires only the poisoned slot, and the rest ok;
    the outcome counter sums to the submissions."""
    _, (api, cfg, params, _) = models["fp"]
    reg = obs.Registry()
    with obs.use_registry(reg):
        eng = Engine(api, cfg, params, ServeConfig(
            max_slots=2, max_seq=64, prefill_len=8, max_new_tokens=5,
            max_queue=5))
        prompts = _prompts(9, (4, 5, 6, 7, 3))
        rids = [eng.submit(p) for p in prompts]
        over = eng.submit(list(range(9)))        # longer than prefill_len
        full = eng.submit([1, 2])                # the queue holds 5 already
        assert eng.outcome(over) == eng.outcome(full) == "rejected"
        assert eng.cancel(rids[3])               # still queued
        eng.run(max_ticks=1)                     # rids 0, 1 are active
        assert eng.cancel(rids[1]) and not eng.cancel(rids[1])
        forward = eng.model.forward

        def poison_slot_0(tokens, *, mode, **kw):
            logits, cache, aux = forward(tokens, mode=mode, **kw)
            if mode == "decode":
                logits[0] = float("nan")
            return logits, cache, aux

        eng.model.forward = poison_slot_0
        eng.run(max_ticks=2)                     # slot 0 holds rids[0]
        eng.model.forward = forward
        outs = eng.run()
    assert [eng.outcome(r) for r in rids] == \
        ["nan", "cancelled", "ok", "cancelled", "ok"]
    assert all(len(outs[r]) == 5 for r in (rids[2], rids[4]))
    total = reg.counter("engine_request_outcomes_total", "", ("outcome",))
    submitted = reg.counter("engine_requests_total", "", ("event",)).get(
        event="submitted")
    assert submitted == 7 and total.total() == submitted
    assert {o: total.get(outcome=o) for o in OUTCOMES} == {
        "ok": 2, "timeout": 0, "cancelled": 2, "rejected": 2, "nan": 1,
        "error": 0}
    assert not eng.queue and not any(s.active for s in eng.slots)


def test_nan_prefill_retires_only_that_request(models):
    _, (api, cfg, params, _) = models["fp"]
    eng = Engine(api, cfg, params, ServeConfig(max_slots=2, max_seq=64,
                                               prefill_len=8,
                                               max_new_tokens=3))
    rids = [eng.submit(p) for p in _prompts(4, (3, 5, 4))]
    forward, calls = eng.model.forward, []

    def poison_first_prefill(tokens, *, mode, **kw):
        logits, cache, aux = forward(tokens, mode=mode, **kw)
        calls.append(mode)
        if calls.count("train") == 1 and mode == "train":
            logits[:] = float("inf")
        return logits, cache, aux

    eng.model.forward = poison_first_prefill
    outs = eng.run()
    assert [eng.outcome(r) for r in rids] == ["nan", "ok", "ok"]
    assert outs[rids[0]] == [] and all(len(outs[r]) == 3 for r in rids[1:])


def test_a_crashed_run_retires_every_request_as_error(models):
    """Each failed prefill retires its request as ``error``; the second in
    a row trips the breaker, which has no fallback and aborts."""
    _, (api, cfg, params, _) = models["fp"]
    eng = Engine(api, cfg, params, ServeConfig(max_slots=1, max_seq=64,
                                               prefill_len=8,
                                               breaker_threshold=2))
    rids = [eng.submit(p) for p in _prompts(2, (3, 4))]

    def broken(*a, **kw):
        raise RuntimeError("device lost")

    eng.model.forward = broken
    with pytest.raises(EngineAborted, match="prefill_exception"):
        eng.run()
    assert [eng.outcome(r) for r in rids] == ["error", "error"]
    assert not eng.queue and not any(s.active for s in eng.slots)


def test_port_imports_and_runs_without_jax_or_repro():
    """In a fresh interpreter where ``import jax`` and ``import repro``
    fail, every module of the port imports, and the port builds a model on
    the CPU and serves it."""
    code = "\n".join([
        "import sys, importlib, pkgutil",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        "import repro_torch",
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]",
        "for m in mods: importlib.import_module(m)",
        "assert {'repro_torch.launch.serve', 'repro_torch.serving.chaos',"
        " 'repro_torch.obs.profile', 'repro_torch.obs.timeline',"
        " 'repro_torch.distributed.fault', 'repro_torch.data.pipeline',"
        " 'repro_torch.kernels.w4a8_gemm_fscale',"
        " 'repro_torch.kernels.w4a16_gemm', 'repro_torch.kernels.moe_gemm',"
        " 'repro_torch.models.moe', 'repro_torch.configs.mixtral_8x7b',"
        " 'repro_torch.models.xlstm', 'repro_torch.models.griffin',"
        " 'repro_torch.configs.xlstm_1b3',"
        " 'repro_torch.configs.recurrentgemma_9b',"
        " 'repro_torch.training.optimizer', 'repro_torch.training.train_step',"
        " 'repro_torch.checkpoint.manager', 'repro_torch.launch.train',"
        " 'repro_torch.distributed.sharding', 'repro_torch.launch.mesh',"
        " 'repro_torch.launch.dryrun'}"
        " <= set(mods), mods",
        "from repro_torch.models.config import ModelConfig",
        "from repro_torch.models.registry import get_model",
        "from repro_torch.nn import spec as S",
        "from repro_torch.serving.engine import Engine, ServeConfig",
        "import torch",
        f"cfg = ModelConfig(**{TINY!r})",
        "api = get_model(cfg)",
        "p = S.materialize(api.param_specs(cfg),"
        " torch.Generator().manual_seed(0), device='cpu')",
        "logits, _, _ = api.build(cfg, p)(torch.zeros((1, 5), dtype=torch.long))",
        "assert logits.shape == (1, 5, 64) and bool(logits.isfinite().all())",
        "eng = Engine(api, cfg, p, ServeConfig(max_slots=2, prefill_len=8,"
        " max_new_tokens=3))",
        "r = eng.submit([1, 2, 3])",
        "assert len(eng.run()[r]) == 3",
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))"
        " for m in sys.modules if sys.modules[m] is not None)",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_no_jax_or_repro_import_in_the_port():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m == "jax" or m.startswith("jax.") or m == "repro"
           or m.startswith("repro.")]
    assert not bad, bad
