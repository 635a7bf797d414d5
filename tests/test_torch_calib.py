"""The port's calibration algorithms against the JAX reference, on the
CPU: the five algorithms (``repro_torch.core.algorithms``), ``pre_scale``
and ``rot`` in ``core.qlinear``'s applies, ``kernels.ops.quantize_for``
over linears that transform their input, the llama3.2-3b config and the
LLaMA-3 recipe. Whole models (the capture, ``core.ptq``) are held in
``tests/test_torch_calib_model.py``.

Inputs come from numpy seeds. Tolerances:

* Each algorithm on the same (w, x): codes bit-equal; scales and
  ``pre_scale`` within rtol 1e-6 (the port forms them in the reference's
  order; they come out equal); ``rot`` equal as bf16 bits, its stored
  form.
* ``linear_apply`` / ``grouped_linear_apply`` with ``pre_scale``: bit-equal
  (x / pre_scale is one exact division, then the IS path, which is
  bit-exact); with ``rot``: within ``ROT_REL_TOL`` x max|y|, because
  ``x @ rot`` is an f32 product summed in another order, which can move
  an activation code by one.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qlinear as jqlinear
from repro.core import recipe as jrecipe_mod
from repro.core.algorithms import awq as jawq
from repro.core.algorithms import gptq as jgptq
from repro.core.algorithms import omniquant as jomni
from repro.core.algorithms import quarot as jquarot
from repro.core.algorithms import smoothquant as jsmooth
from repro.models.registry import get_arch as jget_arch
from repro_torch.core import ptq, qlinear
from repro_torch.core import recipe as recipe_mod
from repro_torch.core.algorithms import awq, gptq, omniquant, quarot
from repro_torch.core.algorithms import smoothquant
from repro_torch.core.recipe import QuantRecipe, QuantSpec
from repro_torch.kernels import ops
from repro_torch.models.common import Linear
from repro_torch.models.registry import get_arch

ROT_REL_TOL = 2e-2

# -- each algorithm on one layer ----------------------------------------------

ALGOS = ("gptq", "awq", "smoothquant", "omniquant", "quarot")
SHAPES = ((256, 128, 64), (512, 384, 256))  # K, N, calibration rows


def _layer(K, N, n, seed):
    """A (K, N) weight and n calibration rows whose channels have spread
    magnitudes (AWQ's and SmoothQuant's outliers) and one dead input."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    x = (rng.standard_normal((n, K)) * rng.uniform(0.2, 4.0, K)
         ).astype(np.float32)
    x[:, 3] = 0.0
    return w, x


def _bf16_bits(a) -> np.ndarray:
    """bf16 bit patterns of a numpy f32 array (JAX's rounding) or of a
    tensor (PyTorch's)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.bfloat16).view(torch.int16).numpy()
    return np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.int16)


def _run_algo(algo, w, x, bits, group, seed):
    """(reference outputs, port outputs) of one algorithm."""
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    if algo == "gptq":
        return (jgptq.gptq_quantize(w, x, bits, group),
                gptq.gptq_quantize(tw, tx, bits, group))
    if algo == "awq":
        return (jawq.awq_quantize(w, x, bits, group),
                awq.awq_quantize(tw, tx, bits, group))
    if algo == "smoothquant":
        return (jsmooth.smoothquant_quantize(w, x, bits, group),
                smoothquant.smoothquant_quantize(tw, tx, bits, group))
    if algo == "omniquant":
        return (jomni.omniquant_quantize(w, x, bits, group),
                omniquant.omniquant_quantize(tw, tx, bits, group))
    return (jquarot.quarot_quantize(w, bits, group, seed=seed),
            quarot.quarot_quantize(tw, bits, group, seed=seed))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("group", [128, -1])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("algo", ALGOS)
def test_algorithm_matches_reference(algo, bits, group, shape):
    """Codes bit-equal, scales (and AWQ's / SmoothQuant's pre_scale)
    within rtol 1e-6, QuaRot's rotation equal as bf16 bits; W4 and W8,
    g128 and coarse, with a dead input (GPTQ's guard)."""
    K, N, n = shape
    w, x = _layer(K, N, n, seed=K + n + bits + max(group, 0))
    want, got = _run_algo(algo, w, x, bits, group, seed=n)
    assert got[0].dtype == torch.int8
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-6, atol=0)
    if algo in ("awq", "smoothquant"):
        np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-6,
                                   atol=0)
    if algo == "quarot":
        np.testing.assert_array_equal(_bf16_bits(got[2]),
                                      _bf16_bits(want[2]))


def test_random_orthogonal_is_the_references():
    """The same seeded matrix (numpy's draw, QR and sign fix) to within
    f32 rounding of an f64 QR, orthogonal, and another for another seed."""
    for K, seed in ((128, 0), (384, 7)):
        got = quarot.random_orthogonal(K, seed)
        want = jquarot.random_orthogonal(K, seed)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        eye = (got.double().T @ got.double()).numpy()
        np.testing.assert_allclose(eye, np.eye(K), atol=1e-5)
    assert not torch.equal(quarot.random_orthogonal(128, 1),
                           quarot.random_orthogonal(128, 0))


def test_searches_never_lose_to_rtn():
    """AWQ's grid (exponent 0) and OmniQuant's (clip 1.0) hold the RTN
    point, so their output MSE on the calibration rows is at most RTN's,
    computed by the same objective."""
    w, x = _layer(512, 384, 256, seed=9)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    ref = tx @ tw
    rtn = awq.output_mse(tx, ref, *awq._rtn(tw, 4, 128))
    codes, scales, pre = awq.awq_quantize(tw, tx, 4, 128)
    assert awq.output_mse(tx, ref, codes, scales, pre) <= rtn
    codes, scales = omniquant.omniquant_quantize(tw, tx, 4, 128)
    assert awq.output_mse(tx, ref, codes, scales) <= rtn


# -- pre_scale and rot in the applies ---------------------------------------

TRANSFORMS = {  # name -> (QuantSpec kwargs, the transform it stores)
    "awq": (dict(algo="awq"), "pre_scale"),
    "smoothquant": (dict(algo="smoothquant"), "pre_scale"),
    "quarot": (dict(rotate=True), "rot"),
    "quarot-w8": (dict(rotate=True, w_bits=8, amplifier="heuristic+6"),
                  "rot"),
}


def _jtree(params: dict) -> dict:
    """A port param dict as the reference's jnp arrays (rot as bf16)."""
    return {k: (jnp.asarray(v.float().numpy(), jnp.bfloat16)
                if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy()))
            for k, v in params.items()}


def _close_or_equal(got: torch.Tensor, want, kind: str):
    want = np.asarray(want)
    if TRANSFORMS[kind][1] == "pre_scale":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= ROT_REL_TOL, err


@pytest.mark.parametrize("kind", sorted(TRANSFORMS))
def test_linear_apply_with_transform_matches_reference(kind):
    """``linear_apply`` over a linear carrying ``pre_scale`` or ``rot``
    against the reference's ``linear_apply`` (reference mode) on the same
    params, for a (2, 5, K) f32 activation."""
    kw, leaf = TRANSFORMS[kind]
    spec = QuantSpec(**kw)
    w, x = _layer(256, 128, 64, seed=21)
    params = ptq.quantize_one(torch.from_numpy(w), torch.from_numpy(x), spec,
                              seed=3)
    assert leaf in params
    xin = np.random.default_rng(22).normal(size=(2, 5, 256)).astype(
        np.float32) * 2
    want = jqlinear.linear_apply(_jtree(params), jnp.asarray(xin),
                                 jrecipe_mod.QuantSpec(**kw),
                                 mode="reference")
    got = qlinear.linear_apply(params, torch.from_numpy(xin), spec)
    assert got.shape == tuple(want.shape)
    _close_or_equal(got, want, kind)


@pytest.mark.parametrize("kind", sorted(TRANSFORMS))
def test_grouped_linear_apply_with_transform_matches_reference(kind):
    """``grouped_linear_apply`` over an expert stack carrying per-expert
    ``pre_scale`` (E, K) or ``rot`` (E, K, K) against the reference's
    (reference mode), on a dispatch buffer zero past the counts."""
    kw, leaf = TRANSFORMS[kind]
    spec = QuantSpec(**kw)
    E, C, K, N = 3, 6, 256, 128
    outs = []
    for e in range(E):
        w, x = _layer(K, N, 64, seed=30 + e)
        outs.append(ptq.quantize_one(torch.from_numpy(w),
                                     torch.from_numpy(x), spec, seed=e))
    stack = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    assert stack[leaf].shape[:2] == (E, K)
    rng = np.random.default_rng(33)
    xin = rng.normal(size=(E, C, K)).astype(np.float32)
    counts = np.array([6, 0, 4])
    xin[np.arange(C)[None, :] >= counts[:, None]] = 0.0
    want = jqlinear.grouped_linear_apply(
        _jtree(stack), jnp.asarray(xin), jrecipe_mod.QuantSpec(**kw),
        mode="reference")
    got = qlinear.grouped_linear_apply(
        stack, torch.from_numpy(xin), spec,
        row_counts=torch.from_numpy(counts.astype(np.int32)))
    assert got.shape == tuple(want.shape)
    _close_or_equal(got, want, kind)
    assert not got[1].any() and not got[2, 4:].any()


def test_quantize_for_quantizes_nothing_over_transformed_linears():
    """A shared activation is quantized once only when no linear over it
    carries ``pre_scale`` or ``rot``."""
    x = torch.from_numpy(np.random.default_rng(40).normal(
        size=(2, 3, 256)).astype(np.float32))
    recipe = QuantRecipe(rules=(("*", QuantSpec()),))
    plain = {"qvalue": torch.zeros(1)}

    def lin(**extra):
        return Linear(recipe, "l", {**plain, **extra})

    assert ops.quantize_for(x, [lin(), lin()]) is not None
    for leaf in ("pre_scale", "rot"):
        assert ops.quantize_for(
            x, [lin(), lin(**{leaf: torch.ones(1)})]) is None
        assert ops.quantize_for(
            x[None], [lin(**{leaf: torch.ones(1)})] * 2, grouped=True,
            row_counts=torch.tensor([3], dtype=torch.int32)) is None


@pytest.mark.parametrize("smoke", [False, True])
def test_llama32_3b_config_equals_reference(smoke):
    """Every field of the port's config equals the reference's."""
    t = get_arch("llama3.2-3b", smoke=smoke)
    j = jget_arch("llama3.2-3b", smoke=smoke)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    if not smoke:
        assert (t.num_layers, t.d_model, t.num_heads, t.num_kv_heads,
                t.d_ff, t.vocab_size, t.head_dim, t.rope_theta) == (
            28, 3072, 24, 8, 8192, 128256, 128, 500_000.0)


def test_recipes_equal_reference():
    """``LLAMA3_RECIPE`` and ``W8A8_FG`` equal the reference's field for
    field."""
    for name in ("LLAMA3_RECIPE", "W8A8_FG", "W4A8_IS"):
        got, want = getattr(recipe_mod, name), getattr(jrecipe_mod, name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
