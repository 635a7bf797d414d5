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

This file holds the smoke LLaMA-2-7B's cases and the capture;
``tests/test_torch_calib_model_llama3_mixtral.py`` the other two archs'
(the shared fixtures are in ``tests/torch_calib_model_common.py``).
"""
import jax
import numpy as np
import pytest
import torch

from benchmarks import common as bcommon
from repro_torch import convert
from repro_torch.core import ptq, qlinear
from repro_torch.core import recipe as recipe_mod
from repro_torch.core.recipe import QuantRecipe, QuantSpec
from repro_torch.kernels import ops
from repro_torch.models.registry import get_arch, get_model
from torch_calib_model_common import (ALGO_RECIPES, CAPTURE_TOL, _by_path,
                                      _model, _port_captured, _ptq_pair,
                                      _recipes, _same, check_calibrated_logits,
                                      check_ptq_tree,
                                      one_blas_thread)  # noqa: F401

ARCHS = ("llama2-7b",)


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
    check_ptq_tree(arch, name)


@pytest.mark.parametrize("name", [*ALGO_RECIPES, "llama3"])
@pytest.mark.parametrize("arch", ARCHS)
def test_calibrated_logits_match_reference(arch, name):
    """The port's own PTQ (its capture of the calibration batch, then its
    algorithms) serves logits within 2e-2 of the largest logit of the
    reference's PTQ (its own capture)."""
    check_calibrated_logits(arch, name)


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
