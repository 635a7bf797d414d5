"""The port's dense transformer (``repro_torch.models``), its RTN PTQ and the
weight converter against the JAX reference, on the CPU.

Both packages run the same weights: the reference's tree is materialized
once, carried across with ``repro_torch.convert`` and compared leaf for
leaf. Tolerances: fp logits in f32 agree to atol/rtol 1e-4 (the two
frameworks sum in other orders; the logits are O(1)). The quantized trees
are bit-identical. Quantized logits may differ by more, because an f32
rounding difference upstream can move an activation code by one: the
bound there is 2e-2 of the largest logit.
"""
import dataclasses

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ptq as jptq
from repro.core.recipe import QuantRecipe as JRecipe
from repro.core.recipe import QuantSpec as JSpec
from repro.models.config import ModelConfig as JConfig
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro_torch import convert
from repro_torch.core import ptq
from repro_torch.core.recipe import QuantRecipe, QuantSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.nn import spec as S

FP_TOL = 1e-4
Q_REL_TOL = 2e-2

TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=64, dtype="float32")
# the reference's chunked attention takes its chunk sizes from the config
JCHUNKS = dict(q_chunk=16, kv_chunk=16)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JConfig(**TINY, **JCHUNKS, remat=False)
    japi = jget_model(jcfg)
    jparams = JS.materialize(japi.param_specs(jcfg, None),
                             jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY)
    return japi, jcfg, jparams, get_model(cfg), cfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, B, Sq, V=64):
    return np.random.default_rng(seed).integers(0, V, size=(B, Sq))


def _by_path(tree, path="") -> dict:
    """{"blocks/0/attn/q/qvalue": tensor, ...} of a port tree."""
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


def _close(port: torch.Tensor, ref, tol=FP_TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_convert_round_trips_weights(tiny):
    japi, jcfg, jparams, api, cfg = tiny
    ref = _np_tree(jparams)
    port = convert.from_reference(ref, device="cpu")
    assert len(port["blocks"]) == cfg.num_layers
    want = S.materialize(api.param_specs(cfg), device="meta")
    got_shapes = S.tree_map(lambda t: tuple(t.shape), port)
    assert got_shapes == S.tree_map(lambda t: tuple(t.shape), want)
    back = convert.to_reference(port)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, a in flat_ref:
        np.testing.assert_array_equal(flat_back[path], a, err_msg=str(path))


def test_convert_keeps_bf16_bits():
    a = np.asarray(jnp.asarray(np.random.default_rng(1).normal(size=(3, 5)),
                               jnp.bfloat16))
    tree = {"embed": a, "blocks": {"s0": {"g": a[None]}}}
    port = convert.from_reference(tree, device="cpu")
    assert port["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(port["embed"].float().numpy(),
                                  a.astype(np.float32))
    np.testing.assert_array_equal(
        port["blocks"][0]["g"].view(torch.int16).numpy(), a.view(np.int16))


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_fp_logits_match_reference(tiny, mode):
    japi, jcfg, jparams, api, cfg = tiny
    toks = _tokens(3, 2, 12)
    want, _, _ = japi.apply(jparams, jcfg, jnp.asarray(toks), mode=mode)
    model = api.build(cfg, convert.from_reference(_np_tree(jparams),
                                                  device="cpu"))
    got, _, _ = model(torch.from_numpy(toks), mode=mode)
    assert got.shape == tuple(want.shape)
    _close(got, want)


def test_fp_decode_with_cache_matches_reference(tiny):
    """Prefill 10 tokens into a cache, then three batched decode steps at
    per-row positions, in both packages."""
    japi, jcfg, jparams, api, cfg = tiny
    B, P, Smax = 2, 10, 32
    toks = _tokens(4, B, P)
    jcache = JS.materialize(japi.cache_specs(jcfg, B, Smax),
                            jax.random.PRNGKey(1))
    model = api.build(cfg, convert.from_reference(_np_tree(jparams),
                                                  device="cpu"))
    cache = S.materialize(api.cache_specs(cfg, B, Smax), device="cpu")
    jl, jcache, _ = japi.apply(jparams, jcfg, jnp.asarray(toks),
                               mode="prefill", cache=jcache, pos=0)
    tl, cache, _ = model(torch.from_numpy(toks), mode="prefill", cache=cache,
                         pos=0)
    _close(tl, jl)
    pos = np.array([P, P])
    for step in range(3):
        nxt = _tokens(10 + step, B, 1)
        jl, jcache, _ = japi.apply(jparams, jcfg, jnp.asarray(nxt),
                                   mode="decode", cache=jcache,
                                   pos=jnp.asarray(pos))
        tl, cache, _ = model(torch.from_numpy(nxt), mode="decode",
                             cache=cache, pos=torch.from_numpy(pos))
        _close(tl, jl)
        pos = pos + 1
    for i in range(cfg.num_layers):
        for name in ("k", "v"):
            _close(cache["blocks"][i][name],
                   jcache["blocks"]["s0"][name][i])


@pytest.fixture(scope="module")
def quantized(tiny):
    """W4A8-IS g64 (every K here is 64 or 128) through both PTQs. The
    reference's overflow certificate reads ``jax.core.Literal``, which
    JAX 0.9 moved to ``jax.extend.core``: it is aliased only while the
    reference quantizes, and restored at once, so other tests see JAX
    unchanged."""
    japi, jcfg, jparams, api, cfg = tiny
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "Literal"):
            mp.setattr(jax.core, "Literal", jax.extend.core.Literal,
                       raising=False)
        jq = jptq.post_training_quantize(
            japi, jcfg, jparams,
            JRecipe(rules=(("*", JSpec(group_size=64)),), name="w4a8-is"),
            None)
    recipe = QuantRecipe(rules=(("*", QuantSpec(group_size=64)),),
                         name="w4a8-is")
    tq = ptq.post_training_quantize(
        api, cfg, convert.from_reference(_np_tree(jparams), device="cpu"),
        recipe)
    return jq, tq, recipe


def test_ptq_tree_equals_reference_leaf_for_leaf(tiny, quantized):
    japi, jcfg, jparams, api, cfg = tiny
    jq, tq, recipe = quantized
    want = _by_path(convert.from_reference(_np_tree(jq), device="cpu"))
    got = _by_path(tq)
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.dtype == want[path].dtype, path
        assert torch.equal(t, want[path]), path
    # embed / head / norms stay fp; every linear is W4A8-IS
    blk = tq["blocks"][0]
    assert tq["embed"].dtype == torch.float32 and "w" in tq["head"]
    assert blk["attn"]["q"]["scale"].dtype == torch.int32
    assert float(blk["mlp"]["down"]["alpha"]) == 1024.0


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_quantized_logits_match_reference(tiny, quantized, mode):
    japi, jcfg, jparams, api, cfg = tiny
    jq, tq, recipe = quantized
    toks = _tokens(5, 2, 12)
    jrecipe = JRecipe(rules=(("*", JSpec(group_size=64)),), name="w4a8-is")
    want, _, _ = japi.apply(jq, jcfg, jnp.asarray(toks), recipe=jrecipe,
                            mode=mode)
    got, _, _ = api.build(cfg, tq, recipe)(torch.from_numpy(toks), mode=mode)
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= Q_REL_TOL, err


BASELINES = {  # the paper's baselines: name -> QuantSpec kwargs (g=64:
    # every K here is 64 or 128). Float-scale and weight-only trees need
    # no overflow certificate, so no ``jax.core.Literal`` alias.
    "w4a8-fs": dict(scale_mode="float", group_size=64),
    "w4a8-coarse": dict(group_size=-1),
    "w4a16": dict(a_bits=16, group_size=64),
}


@pytest.fixture(scope="module")
def baselines(tiny):
    japi, jcfg, jparams, api, cfg = tiny
    fp = convert.from_reference(_np_tree(jparams), device="cpu")
    out = {}
    for name, kw in BASELINES.items():
        jrecipe = JRecipe(rules=(("*", JSpec(**kw)),), name=name)
        recipe = QuantRecipe(rules=(("*", QuantSpec(**kw)),), name=name)
        jq = jptq.post_training_quantize(japi, jcfg, jparams, jrecipe, None)
        out[name] = (jq, jrecipe, ptq.post_training_quantize(
            api, cfg, fp, recipe), recipe)
    return out


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_ptq_trees_equal_reference(baselines, name):
    """FS, coarse and W4A16 RTN trees equal the reference's leaf for leaf
    (f32 scales, no alpha), and ``convert`` carries them both ways bit for
    bit."""
    jq, _, tq, _ = baselines[name]
    want = _by_path(convert.from_reference(_np_tree(jq), device="cpu"))
    got = _by_path(tq)
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path
    q = tq["blocks"][0]["attn"]["q"]
    assert q["scale"].dtype == torch.float32 and "alpha" not in q
    back = dict(jax.tree_util.tree_leaves_with_path(convert.to_reference(tq)))
    for path, a in jax.tree_util.tree_leaves_with_path(_np_tree(jq)):
        np.testing.assert_array_equal(back[path], a, err_msg=str(path))


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_quantized_logits_match_reference(tiny, baselines, name):
    """Within 2e-2 of the largest logit, as for W4A8-IS. W4A16 is held
    against the reference's Pallas kernel (interpret): its reference path
    dequantizes to the f32 activation dtype, where the kernel and the port
    round the dequantized weight to bf16."""
    japi, jcfg, jparams, api, cfg = tiny
    jq, jrecipe, tq, recipe = baselines[name]
    if name == "w4a16":
        jcfg = dataclasses.replace(jcfg, kernel_mode="pallas_interpret")
    toks = _tokens(6, 2, 12)
    want, _, _ = japi.apply(jq, jcfg, jnp.asarray(toks), recipe=jrecipe,
                            mode="train")
    got, _, _ = api.build(cfg, tq, recipe)(torch.from_numpy(toks))
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= Q_REL_TOL, err


def test_entry_points_need_a_gpu_unless_asked(monkeypatch, tiny):
    *_, api, cfg = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        S.materialize(api.param_specs(cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.from_reference({"blocks": {"s0": {}}})


def _counting(monkeypatch, module, name):
    """Wrap ``module.name`` with a call counter; returns the count list."""
    real, calls = getattr(module, name), []

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


def _shared_and_alone(monkeypatch, api, cfg, tq, recipe, toks):
    """(logits, act_quant calls) of one forward, with each shared
    activation quantized once and with sharing turned off."""
    from repro_torch.kernels import ops

    out = []
    for share in (True, False):
        with monkeypatch.context() as mp:
            if not share:
                mp.setattr(ops, "quantize_for", lambda *a, **k: None)
            calls = _counting(mp, ops, "act_quant")
            got, _, _ = api.build(cfg, tq, recipe)(torch.from_numpy(toks))
        out.append((got, len(calls)))
    return out


@pytest.mark.parametrize("name", ["w4a8-is", *sorted(set(BASELINES)
                                                      - {"w4a16"})])
def test_shared_activation_quantized_once(monkeypatch, tiny, quantized,
                                          baselines, name):
    """Every activation is quantized once however many W4A8 linears read
    it: 4 act_quant a layer (q/k/v, o, gate/up, down) where each linear
    alone ran 7, under IS, FS and coarse. The logits equal those with
    sharing turned off bit for bit (act_quant is a pure function of
    (x, a_bits)), and stay within the reference bound."""
    japi, jcfg, jparams, api, cfg = tiny
    if name == "w4a8-is":
        jq, tq, recipe = quantized
        jrecipe = JRecipe(rules=(("*", JSpec(group_size=64)),), name=name)
    else:
        jq, jrecipe, tq, recipe = baselines[name]
    toks = _tokens(7, 2, 12)
    (shared, n_shared), (alone, n_alone) = _shared_and_alone(
        monkeypatch, api, cfg, tq, recipe, toks)
    assert (n_shared, n_alone) == (4 * cfg.num_layers, 7 * cfg.num_layers)
    assert torch.equal(shared, alone)
    want = np.asarray(japi.apply(jq, jcfg, jnp.asarray(toks),
                                 recipe=jrecipe, mode="train")[0])
    err = np.abs(shared.numpy() - want).max() / np.abs(want).max()
    assert err <= Q_REL_TOL, err


MIXED = {  # name -> (rules of both recipes, act_quant calls a layer)
    # v left in bf16: q and k quantize their own
    "v-bf16": ((("*/attn/v", None), ("*", dict(group_size=64))), 5),
    # v in float scale among integer-scale linears: one quantization
    "v-fs": ((("*/attn/v", dict(scale_mode="float", group_size=64)),
              ("*", dict(group_size=64))), 4),
}


@pytest.mark.parametrize("name", sorted(MIXED))
def test_mixed_recipe_shares_only_alike_linears(monkeypatch, tiny, name):
    """A recipe that gives q/k/v different specs: a linear left in bf16
    takes its own path and the others quantize their own, while IS and FS
    linears, which read the same codes, still share one quantization. The
    logits match the reference's within its bound and equal the unshared
    ones bit for bit."""
    japi, jcfg, jparams, api, cfg = tiny
    rules, per_layer = MIXED[name]

    def recipe(cls, spec_cls):
        return cls(rules=tuple((p, kw if kw is None else spec_cls(**kw))
                               for p, kw in rules), name=name)

    jrecipe, trecipe = recipe(JRecipe, JSpec), recipe(QuantRecipe, QuantSpec)
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "Literal"):
            mp.setattr(jax.core, "Literal", jax.extend.core.Literal,
                       raising=False)
        jq = jptq.post_training_quantize(japi, jcfg, jparams, jrecipe, None)
    tq = ptq.post_training_quantize(
        api, cfg, convert.from_reference(_np_tree(jparams), device="cpu"),
        trecipe)
    toks = _tokens(8, 2, 12)
    (shared, n_shared), (alone, n_alone) = _shared_and_alone(
        monkeypatch, api, cfg, tq, trecipe, toks)
    assert n_shared == per_layer * cfg.num_layers
    assert n_alone == (6 if name == "v-bf16" else 7) * cfg.num_layers
    assert torch.equal(shared, alone)
    want = np.asarray(japi.apply(jq, jcfg, jnp.asarray(toks),
                                 recipe=jrecipe, mode="train")[0])
    err = np.abs(shared.numpy() - want).max() / np.abs(want).max()
    assert err <= Q_REL_TOL, err
