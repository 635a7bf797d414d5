"""The port's serving engine (``repro_torch.serving``) against the JAX
``Engine`` on the CPU, its request lifecycle, and the port's independence
from JAX and from the ``repro`` package.

Greedy token streams must be EQUAL to the reference engine's on the tiny
config of ``tests/test_serving.py`` (fp, and W4A8-IS g64 through both
packages' RTN PTQ), with all requests admitted at once and with more
requests than slots (staggered admission, per-slot decode positions).
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
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import convert, obs
from repro_torch.core import ptq
from repro_torch.core.recipe import QuantRecipe, QuantSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import OUTCOMES, Engine, ServeConfig

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=64, dtype="float32")
# the reference's chunked attention takes its chunk sizes from the config
JCHUNKS = dict(q_chunk=16, kv_chunk=16)
LAYOUTS = {  # name -> (max_slots, prompt count, prompt lengths)
    "aligned": (3, 3, (8, 8, 8)),
    "staggered": (2, 5, (5, 8, 3, 7, 6)),
}


@pytest.fixture(scope="module")
def models():
    """fp and W4A8-IS g64 weights for both packages. The reference's
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
    return {"fp": ((japi, jcfg, jparams, None), (api, cfg, tparams, None)),
            "w4a8-is": ((japi, jcfg, jq, jrecipe), (api, cfg, tq, recipe))}


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=n).tolist() for n in lengths]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("scheme", ["fp", "w4a8-is"])
def test_greedy_streams_equal_reference_engine(models, scheme, layout):
    (japi, jcfg, jparams, jrecipe), (api, cfg, params, recipe) = \
        models[scheme]
    slots, n, lengths = LAYOUTS[layout]
    prompts = _prompts(len(lengths), lengths)
    kw = dict(max_slots=slots, max_seq=64, prefill_len=8, max_new_tokens=6)
    jeng = JEngine(japi, jcfg, jparams, JServeConfig(**kw), recipe=jrecipe)
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
    _, (api, cfg, params, _) = models["fp"]
    eng = Engine(api, cfg, params, ServeConfig(max_slots=1, max_seq=64,
                                               prefill_len=8))
    rids = [eng.submit(p) for p in _prompts(2, (3, 4))]

    def broken(*a, **kw):
        raise RuntimeError("device lost")

    eng.model.forward = broken
    with pytest.raises(RuntimeError, match="device lost"):
        eng.run()
    assert [eng.outcome(r) for r in rids] == ["error", "error"]


def test_port_imports_and_runs_without_jax_or_repro():
    """In a fresh interpreter where ``import jax`` and ``import repro``
    fail, the port imports, builds a model on the CPU and serves it."""
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        "import repro_torch, repro_torch.kernels.ops, repro_torch.convert",
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
