"""The port's Qwen2-72B, Granite-34B (MQA) and Phi-3.5-MoE configs
(``repro_torch.configs``) against the JAX reference's, on the CPU, at each
config's ``smoke()`` shape.

* Fields: the port's equal the reference's, for ``full()`` and
  ``smoke()`` (the reference's attention chunk sizes have no counterpart
  in the port).
* Logits: both packages run the smoke model in f32 (as
  ``tests/test_torch_calib_model.py`` does) on the reference's weights,
  carried over by ``repro_torch.convert``: fp prefill and decode within
  1e-4; W4A8-IS g128 within 2e-2 of the largest logit (an f32 rounding
  upstream can move an activation code by one).
* The W4A8-IS PTQ trees are equal leaf for leaf.
* Greedy streams of the port's engine EQUAL the reference engine's under
  W4A8-IS (the fp engines are held in ``tests/test_torch_engine.py`` and
  ``tests/test_torch_kvcache.py``).
"""
import dataclasses
import functools

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ptq as jptq
from repro.core.recipe import QuantRecipe as JRecipe
from repro.core.recipe import QuantSpec as JSpec
from repro.models.registry import get_arch as jget_arch
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import convert
from repro_torch.core import ptq
from repro_torch.core.recipe import QuantRecipe, QuantSpec
from repro_torch.models.registry import get_arch, get_model
from repro_torch.nn import spec as S
from repro_torch.serving.engine import Engine, ServeConfig

FP_TOL = 1e-4
Q_REL_TOL = 2e-2
ARCHS = ("qwen2-72b", "granite-34b", "phi3.5-moe-42b-a6.6b")
FULL = {  # arch -> (layers, d_model, query heads, KV heads, d_ff, experts)
    "qwen2-72b": (80, 8192, 64, 8, 29568, 0),
    "granite-34b": (88, 6144, 48, 1, 24576, 0),
    "phi3.5-moe-42b-a6.6b": (32, 4096, 32, 8, 6400, 16),
}


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _by_path(tree, path="") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_by_path(v, f"{path}/{k}" if path else str(k)))
    return out


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    """Both packages' f32 smoke model of ``arch`` on the reference's
    weights, and each package's W4A8-IS g128 tree of it."""
    jcfg = _f32(jget_arch(arch, smoke=True))
    japi = jget_model(jcfg)
    jparams = JS.materialize(japi.param_specs(jcfg, None),
                             jax.random.PRNGKey(0))
    cfg = _f32(get_arch(arch, smoke=True))
    api = get_model(cfg)
    fp = convert.from_reference(_np_tree(jparams), device="cpu")
    jrecipe = JRecipe(rules=(("*", JSpec()),), name="w4a8-is")
    recipe = QuantRecipe(rules=(("*", QuantSpec()),), name="w4a8-is")
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "Literal"):
            mp.setattr(jax.core, "Literal", jax.extend.core.Literal,
                       raising=False)
        jq = jptq.post_training_quantize(japi, jcfg, jparams, jrecipe, None)
    tq = ptq.post_training_quantize(api, cfg, fp, recipe)
    return {"fp": ((japi, jcfg, jparams, None), (api, cfg, fp, None)),
            "w4a8-is": ((japi, jcfg, jq, jrecipe), (api, cfg, tq, recipe))}


def _tokens(seed, shape, V):
    return np.random.default_rng(seed).integers(0, V, size=shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch):
    for smoke in (False, True):
        j, t = jget_arch(arch, smoke=smoke), get_arch(arch, smoke=smoke)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (smoke, f.name)
    full = get_arch(arch)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.moe_d_ff or full.d_ff, full.num_experts) == FULL[arch]
    assert full.head_dim == 128 and full.dtype == "bfloat16"


@pytest.mark.parametrize("arch", ARCHS)
def test_fp_prefill_and_decode_logits_match_reference(arch):
    """Prefill 10 tokens into a cache, then three batched decode steps at
    per-row positions."""
    (japi, jcfg, jparams, _), (api, cfg, fp, _) = _model(arch)["fp"]
    B, P, Smax = 2, 10, 32
    V = cfg.vocab_size
    model = api.build(cfg, fp)
    jcache = JS.materialize(japi.cache_specs(jcfg, B, Smax),
                            jax.random.PRNGKey(1))
    cache = S.materialize(api.cache_specs(cfg, B, Smax), device="cpu")
    toks = _tokens(3, (B, P), V)
    want, jcache, _ = japi.apply(jparams, jcfg, jnp.asarray(toks),
                                 mode="prefill", cache=jcache, pos=0)
    got, cache, _ = model(torch.from_numpy(toks), mode="prefill",
                          cache=cache, pos=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FP_TOL,
                               atol=FP_TOL)
    pos = np.array([P, P - 4])
    for step in range(3):
        nxt = _tokens(10 + step, (B, 1), V)
        want, jcache, _ = japi.apply(jparams, jcfg, jnp.asarray(nxt),
                                     mode="decode", cache=jcache,
                                     pos=jnp.asarray(pos))
        got, cache, _ = model(torch.from_numpy(nxt), mode="decode",
                              cache=cache, pos=torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FP_TOL, atol=FP_TOL)
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_ptq_tree_equals_reference_leaf_for_leaf(arch):
    (*_, jq, _), (*_, tq, _) = _model(arch)["w4a8-is"]
    want = _by_path(convert.from_reference(_np_tree(jq), device="cpu"))
    got = _by_path(tq)
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path
    q = tq["blocks"][0]["attn"]["q"]
    assert q["scale"].dtype == torch.int32
    assert ("b" in q) == get_arch(arch).qkv_bias


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_logits_match_reference(arch):
    (japi, jcfg, jq, jrecipe), (api, cfg, tq, recipe) = \
        _model(arch)["w4a8-is"]
    toks = _tokens(5, (2, 12), cfg.vocab_size)
    want = np.asarray(japi.apply(jq, jcfg, jnp.asarray(toks), recipe=jrecipe,
                                 mode="train")[0])
    got = api.build(cfg, tq, recipe)(torch.from_numpy(toks))[0]
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= Q_REL_TOL, err


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_equal_reference_engine(arch):
    """W4A8-IS, more requests than slots (staggered admission, per-slot
    decode positions)."""
    (japi, jcfg, jparams, jrecipe), (api, cfg, params, recipe) = \
        _model(arch)["w4a8-is"]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 8, 3)]
    kw = dict(max_slots=2, max_seq=32, prefill_len=8, max_new_tokens=4)
    jeng = JEngine(japi, jcfg, jparams,
                   JServeConfig(**kw, kernel_mode="reference"),
                   recipe=jrecipe)
    jrids = [jeng.submit(p) for p in prompts]
    want = jeng.run()
    jeng.close()
    eng = Engine(api, cfg, params, ServeConfig(**kw), recipe=recipe)
    rids = [eng.submit(p) for p in prompts]
    got = eng.run()
    eng.close()
    assert rids == jrids
    for r in rids:
        assert eng.outcome(r) == jeng.outcome(r) == "ok"
        assert got[r] == want[r], (r, got[r], want[r])
    assert (eng.prefill_traces, eng.decode_traces) == (1, 1)
