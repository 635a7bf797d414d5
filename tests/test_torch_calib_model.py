"""The port's calibration PTQ on whole models against the JAX reference,
on the CPU: the calibration capture (``models.common``), whole-model
``core.ptq`` on the smoke LLaMA-2-7B, LLaMA-3.2-3B and Mixtral under
GPTQ, AWQ, SmoothQuant, OmniQuant and the LLaMA-3 recipe, the trees'
conversion, and the act_quant launches a layer. The algorithms one layer
at a time are held in ``tests/test_torch_calib.py``.

Weights come from the reference's own materialized smoke models (f32:
activations in bf16 would differ across the two frameworks by bf16
ulps), carried over with ``repro_torch.convert``; tokens from the
benchmarks' calibration batch. Tolerances:

* The capture: the same rows per (path, layer) within atol/rtol 1e-6 (the
  two frameworks sum in other orders; the rows are O(1)).
* Whole-model PTQ from the same captured rows: every leaf equal (codes,
  integer scales, alphas, ``pre_scale``; ``rot`` as bf16 bits), the
  seeds those of the reference's stacked layout; logits of the port's own
  calibrated PTQ within 2e-2 of the largest logit of the reference's
  (``tests/test_torch_model.py``'s bound for quantized logits).

The reference's overflow certificate reads ``jax.core.Literal``, which
JAX 0.9 moved to ``jax.extend.core``: it is aliased only while the
reference quantizes, and restored at once.
"""
import dataclasses
import functools

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as bcommon
from repro.core import ptq as jptq
from repro.core import recipe as jrecipe_mod
from repro.models.registry import get_arch as jget_arch
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro_torch import convert
from repro_torch.core import ptq, qlinear
from repro_torch.core import recipe as recipe_mod
from repro_torch.core.algorithms import quarot
from repro_torch.core.recipe import QuantRecipe, QuantSpec
from repro_torch.data.pipeline import calib_batches
from repro_torch.kernels import ops
from repro_torch.models.registry import get_arch, get_model

CAPTURE_TOL = 1e-6
Q_REL_TOL = 2e-2

# -- whole models -----------------------------------------------------------

ARCHS = ("llama2-7b", "llama3.2-3b", "mixtral-8x7b")
ALGO_RECIPES = ("gptq", "awq", "smoothquant", "omniquant")


def _recipes(name: str):
    """(reference recipe, port recipe) of a test recipe name."""
    if name == "llama3":
        return jrecipe_mod.LLAMA3_RECIPE, recipe_mod.LLAMA3_RECIPE
    return (jrecipe_mod.QuantRecipe(
        rules=(("*", jrecipe_mod.QuantSpec(algo=name)),), name=name),
            QuantRecipe(rules=(("*", QuantSpec(algo=name)),), name=name))


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32",
                               kv_cache_dtype="float32")


def _port_captured(jcap: dict, num_layers: int) -> dict:
    """The reference's records (scanned path ``blocks/s0/...``, in call
    order: batch b, layer l at ``b * L + l``) under the port's paths
    (``blocks/<l>/...``), one tensor per batch."""
    out = {}
    for path, recs in jcap.items():
        for i, r in enumerate(recs):
            port = path.replace("blocks/s0/", f"blocks/{i % num_layers}/")
            out.setdefault(port, []).append(torch.from_numpy(np.array(r)))
    return out


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    """Both packages' f32 smoke model of ``arch`` on the reference's
    weights, and one calibration batch captured by the reference."""
    jcfg = _f32(jget_arch(arch, smoke=True))
    japi = jget_model(jcfg)
    jparams = JS.materialize(japi.param_specs(jcfg, None),
                             jax.random.PRNGKey(0))
    cfg = _f32(get_arch(arch, smoke=True))
    fp = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    batches = calib_batches(1)
    jcap = jptq.collect_calibration(japi, jcfg, jparams, batches)
    return (japi, jcfg, jparams), (get_model(cfg), cfg, fp), batches, jcap


def _reference_ptq(japi, jcfg, jparams, jrecipe, batches):
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "Literal"):
            mp.setattr(jax.core, "Literal", jax.extend.core.Literal,
                       raising=False)
        return jptq.post_training_quantize(japi, jcfg, jparams, jrecipe,
                                           batches)


@functools.lru_cache(maxsize=None)
def _ptq_pair(arch: str, name: str):
    """(reference tree, port tree) of one recipe on one arch, the port
    quantizing the same batches from the reference's captured rows (its
    own capture of them is held in :func:`test_capture_matches_reference`)."""
    (japi, jcfg, jparams), (api, cfg, fp), batches, jcap = _model(arch)
    jr, tr = _recipes(name)
    jq = _reference_ptq(japi, jcfg, jparams, jr, batches)
    calls = []

    def reference_rows(api_, cfg_, fp_, batches_):
        assert batches_ is batches
        calls.append(1)
        return _port_captured(jcap, cfg.num_layers)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ptq, "collect_calibration", reference_rows)
        tq = ptq.post_training_quantize(api, cfg, fp, tr, batches)
    assert calls == [1]
    return jq, tq


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


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.bfloat16:
        return b.dtype == a.dtype and torch.equal(a.view(torch.int16),
                                                  b.view(torch.int16))
    return a.dtype == b.dtype and torch.equal(a, b)


def test_capture_matches_reference():
    """The port's capture of one calibration batch (8 x 128 tokens: every
    4th row, 256 a record) equals the reference's per (path, layer), in
    the f32 smoke LLaMA-2-7B, and the port's ``calib_batches`` is the
    benchmarks' calibration batch."""
    (_, jcfg, _), (api, cfg, fp), batches, jcap = _model("llama2-7b")
    want_batches = bcommon.calib_batches(1)
    np.testing.assert_array_equal(batches[0]["tokens"],
                                  want_batches[0]["tokens"])
    got = ptq.collect_calibration(api, cfg, fp, batches)
    want = _port_captured(jcap, cfg.num_layers)
    assert sorted(got) == sorted(want)
    assert len(got) == 7 * cfg.num_layers
    for path, recs in want.items():
        assert len(got[path]) == len(recs) == 1
        assert got[path][0].shape == recs[0].shape == (
            256, recs[0].shape[1]), path
        np.testing.assert_allclose(got[path][0].numpy(), recs[0].numpy(),
                                   rtol=CAPTURE_TOL, atol=CAPTURE_TOL,
                                   err_msg=path)


@pytest.mark.parametrize("name", [*ALGO_RECIPES, "llama3"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ptq_tree_equals_reference_leaf_for_leaf(arch, name):
    """Whole-model PTQ from the same captured rows: every leaf equal to the
    reference's (rot as bf16 bits). Seeds: block l's linears rotate by
    seed l; on Mixtral expert e of block l by seed l * E + e, and expert
    stacks get no calibration rows (RTN under the four algorithms)."""
    jq, tq = _ptq_pair(arch, name)
    want = _by_path(convert.from_reference(jax.tree.map(np.asarray, jq),
                                           device="cpu"))
    got = _by_path(tq)
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert _same(t, want[path]), path
    blk = tq["blocks"][1]
    if name in ("awq", "smoothquant"):
        assert "pre_scale" in blk["attn"]["q"]
    if name == "llama3":
        assert blk["mlp"]["down"]["qvalue"].shape[-2] == \
            blk["mlp"]["down"]["rot"].shape[-1]  # W8: one code a byte
        K = blk["attn"]["q"]["rot"].shape[0]
        assert torch.equal(blk["attn"]["q"]["rot"], quarot.random_orthogonal(
            K, 1).to(torch.bfloat16))
    if arch == "mixtral-8x7b":
        E = len(blk["mlp"]["gate"]["qvalue"])
        if name == "llama3":
            K = blk["mlp"]["gate"]["rot"].shape[-1]
            assert torch.equal(blk["mlp"]["gate"]["rot"][2],
                               quarot.random_orthogonal(K, E + 2).to(
                                   torch.bfloat16))
        else:
            _, _, fp = _model(arch)[1]
            w = fp["blocks"][1]["mlp"]["gate"]["w"][2].float()
            rtn = qlinear.quantize_linear(w, QuantSpec())
            for k in ("qvalue", "scale", "alpha"):
                assert torch.equal(blk["mlp"]["gate"][k][2], rtn[k]), k
            assert "pre_scale" not in blk["mlp"]["gate"]


@pytest.mark.parametrize("name", [*ALGO_RECIPES, "llama3"])
@pytest.mark.parametrize("arch", ARCHS)
def test_calibrated_logits_match_reference(arch, name):
    """The port's own PTQ (its capture of the calibration batch, then its
    algorithms) serves logits within 2e-2 of the largest logit of the
    reference's PTQ (its own capture)."""
    (japi, jcfg, _), (api, cfg, fp), batches, _ = _model(arch)
    jq, _ = _ptq_pair(arch, name)
    jr, tr = _recipes(name)
    tq = ptq.post_training_quantize(api, cfg, fp, tr, batches)
    toks = np.random.default_rng(50).integers(0, cfg.vocab_size, (2, 12))
    want = np.asarray(japi.apply(jq, jcfg, jnp.asarray(toks), recipe=jr,
                                 mode="train")[0])
    got = api.build(cfg, tq, tr)(torch.from_numpy(toks))[0].numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= Q_REL_TOL, err


def test_convert_carries_pre_scale_and_rot_bit_for_bit():
    """``to_reference`` of the port's AWQ and LLaMA-3 trees equals the
    reference's trees (rot's bf16 values as f32), and ``from_reference``
    of those gives the port's trees back, bit for bit."""
    for name in ("awq", "llama3"):
        jq, tq = _ptq_pair("llama2-7b", name)
        back = dict(jax.tree_util.tree_leaves_with_path(
            convert.to_reference(tq)))
        ref = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jq))
        assert len(back) == len(ref)
        for path, a in ref:
            np.testing.assert_array_equal(
                back[path], a.astype(back[path].dtype), err_msg=str(path))
        again = _by_path(convert.from_reference(convert.to_reference(tq),
                                                device="cpu"))
        for path, t in _by_path(tq).items():
            want = again[path].to(t.dtype)
            assert _same(t, want), path


def _act_quant_calls(monkeypatch, api, cfg, tq, recipe, toks) -> int:
    real, calls = ops.act_quant, []

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    with monkeypatch.context() as mp:
        mp.setattr(ops, "act_quant", counted)
        api.build(cfg, tq, recipe)(torch.from_numpy(toks))
    return len(calls)


@pytest.mark.parametrize("name,per_layer", [("gptq", 4), ("omniquant", 4),
                                            ("awq", 7), ("smoothquant", 7),
                                            ("llama3", 7)])
def test_act_quant_launches_a_layer(monkeypatch, name, per_layer):
    """A forward of the calibrated smoke LLaMA-2-7B quantizes each shared
    activation once under GPTQ and OmniQuant (4 act_quant a layer), and
    each linear's own input where AWQ's / SmoothQuant's ``pre_scale`` or
    the LLaMA-3 recipe's rotation transforms it (7 a layer)."""
    _, (api, cfg, _), _, _ = _model("llama2-7b")
    _, tq = _ptq_pair("llama2-7b", name)
    toks = np.random.default_rng(51).integers(0, cfg.vocab_size, (2, 12))
    n = _act_quant_calls(monkeypatch, api, cfg, tq, _recipes(name)[1], toks)
    assert n == per_layer * cfg.num_layers


def test_quantize_by_layer_is_ptq_without_calibration():
    """``quantize_by_layer`` equals ``post_training_quantize`` of the same
    fp draw with no calibration, leaf for leaf: the LLaMA-3 recipe still
    rotates (seed l per block), GPTQ falls back to RTN."""
    cfg = get_arch("llama3.2-3b", smoke=True)
    api = get_model(cfg)
    fp = ptq.materialize_by_layer(api, cfg, seed=3, device="cpu")
    for recipe in (recipe_mod.LLAMA3_RECIPE,
                   QuantRecipe(rules=(("*", QuantSpec(algo="gptq")),))):
        got = _by_path(ptq.quantize_by_layer(api, cfg, recipe, seed=3,
                                             device="cpu"))
        want = _by_path(ptq.post_training_quantize(api, cfg, fp, recipe))
        assert sorted(got) == sorted(want)
        for path, t in got.items():
            assert _same(t, want[path]), path
    rtn = qlinear.quantize_linear(fp["blocks"][0]["attn"]["q"]["w"].float(),
                                  QuantSpec())
    assert torch.equal(want["blocks/0/attn/q/qvalue"], rtn["qvalue"])
