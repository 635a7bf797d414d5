"""Parity of the port's quantization core (``repro_torch.core``) with the
JAX reference (``repro.core``) on the CPU.

Every input is made with numpy from a seed and handed to both packages.
Bit-exact where the reference is: int4 packing (including the small-K
unit), weight and activation codes and scales, the Listing-1 amplifier,
integer scales and alpha, and the Eq. 2 integer-scale GEMM. The Eq. 1
float-scale and the §B.4 safe GEMM sum floats in another order: rtol 1e-5.
"""
import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import integer_scale as jisc
from repro.core import packing as jpacking
from repro.core import qlinear as jqlinear
from repro.core import quant as jquant
from repro.core.recipe import QuantRecipe as JQuantRecipe
from repro.core.recipe import QuantSpec as JQuantSpec
from repro_torch.core import integer_scale as tisc
from repro_torch.core import packing as tpacking
from repro_torch.core import qlinear as tqlinear
from repro_torch.core import quant as tquant
from repro_torch.core.recipe import QuantRecipe, QuantSpec


@pytest.fixture
def jax_literal():
    """The reference's overflow certificate reads ``jax.core.Literal``,
    which JAX 0.9 moved to ``jax.extend.core``; alias it for this test
    only (undone at teardown, so other tests see JAX unchanged)."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "Literal"):
            mp.setattr(jax.core, "Literal", jax.extend.core.Literal,
                       raising=False)
        yield


def _eq(port: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _weights(seed, K, N, scale=0.05):
    return (np.random.default_rng(seed).normal(size=(K, N)) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("K", [64, 128, 256, 384])
def test_pack_unpack_bit_exact(K):
    q = np.random.default_rng(K).integers(-8, 8, size=(K, 24)).astype(np.int8)
    tp = tpacking.pack_int4(torch.from_numpy(q))
    _eq(tp, jpacking.pack_int4(jnp.asarray(q)))
    assert tpacking.layout_unit_for(K) == jpacking.layout_unit_for(K)
    _eq(tpacking.unpack_int4(tp), q)


@pytest.mark.parametrize("bits,group", [(4, 128), (4, 64), (4, -1), (8, 128)])
def test_quantize_weight_codes_and_scales_bit_exact(bits, group):
    w = _weights(1, 256, 48)
    tq = tquant.quantize_weight(torch.from_numpy(w), bits, group)
    jq = jquant.quantize_weight(jnp.asarray(w), bits, group)
    _eq(tq.qvalue, jq.qvalue)
    _eq(tq.scale, jq.scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activation_bit_exact(dtype):
    x = (np.random.default_rng(2).normal(size=(9, 320)) * 3).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    tq, ts = tquant.quantize_activation(tx)
    jq, js = jquant.quantize_activation(jx)
    _eq(tq, jq)
    _eq(ts, js)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("amplifier", [1024, "heuristic", "heuristic+6"])
def test_integerize_int_scale_and_alpha_bit_exact(bits, amplifier):
    w = _weights(3, 256, 40, scale=0.02)
    tq = tquant.quantize_weight(torch.from_numpy(w), bits, 64)
    jq = jquant.quantize_weight(jnp.asarray(w), bits, 64)
    ti, ji = tisc.integerize(tq, amplifier), jisc.integerize(jq, amplifier)
    assert ti.alpha == ji.alpha
    _eq(ti.int_scale, ji.int_scale)
    assert tisc.heuristic_amplifier_exp(tq.scale) == \
        int(jisc.heuristic_amplifier_exp(jq.scale))
    assert tisc.overflow_bound(ti) == jisc.overflow_bound(ji)


def test_is_gemm_references_match():
    w = _weights(4, 256, 32)
    x = np.random.default_rng(5).normal(size=(2, 3, 256)).astype(np.float32)
    tq = tquant.quantize_weight(torch.from_numpy(w), 4, 128)
    jq = jquant.quantize_weight(jnp.asarray(w), 4, 128)
    txq, tsa = tquant.quantize_activation(torch.from_numpy(x))
    jxq, jsa = jquant.quantize_activation(jnp.asarray(x))
    ti, ji = tisc.integerize(tq, 1024), jisc.integerize(jq, 1024)
    # Eq. 2: integer accumulation, one convert -> bit-exact
    _eq(tisc.fg_gemm_integer_scale(txq, tsa, ti),
        jisc.fg_gemm_integer_scale(jxq, jsa, ji))
    # Eq. 1 and the §B.4 safe variant sum f32 in another order
    np.testing.assert_allclose(
        tquant.fg_gemm_float_scale(txq, tsa, tq).numpy(),
        np.asarray(jquant.fg_gemm_float_scale(jxq, jsa, jq)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tisc.fg_gemm_integer_scale_safe(txq, tsa, ti).numpy(),
        np.asarray(jisc.fg_gemm_integer_scale_safe(jxq, jsa, ji)),
        rtol=1e-5, atol=1e-5)


def _capping_weights(G, N, big):
    """Every group holds one entry of magnitude ``big`` in column 0, so
    each group's max integer scale equals the global max: the closed-form
    bound (sum of per-group maxima) and the reference's interval bound
    (groups x global max) then coincide."""
    w = _weights(6, G * 128, N, scale=0.01)
    w[::128, 0] = big
    return w


@pytest.mark.parametrize("amplifier", [1024, 2**16, 2**20, 2**30])
@pytest.mark.parametrize("bits", [4, 8])
def test_alpha_cap_equals_reference_certificate(jax_literal, amplifier,
                                                bits):
    w = _capping_weights(4, 24, big=3.0)
    spec = QuantSpec(w_bits=bits, amplifier=amplifier)
    tp = tqlinear.quantize_linear(torch.from_numpy(w), spec)
    jp = jqlinear.quantize_linear(jnp.asarray(w), JQuantSpec(
        w_bits=bits, amplifier=amplifier))
    assert float(tp["alpha"]) == float(jp["alpha"])
    for k in ("qvalue", "scale", "alpha"):
        _eq(tp[k], jp[k])
    if amplifier >= 2**20:  # the case that actually caps
        assert float(tp["alpha"]) < amplifier


@pytest.mark.parametrize("amplifier", [1024, 2**16, 2**20, 2**30])
@pytest.mark.parametrize("bits", [4, 8])
def test_alpha_cap_equals_reference_certificate_uneven_groups(
        jax_literal, amplifier, bits):
    """Group maxima that differ (one large entry in group 0 only): the
    reference's certificate bounds by groups x the global max integer
    scale, which a sum of per-group maxima undercuts; alpha, codes and
    integer scales still equal the reference's."""
    w = _weights(6, 4 * 128, 24, scale=0.01)
    w[0, 0] = 3.0
    spec = QuantSpec(w_bits=bits, amplifier=amplifier)
    tp = tqlinear.quantize_linear(torch.from_numpy(w), spec)
    jp = jqlinear.quantize_linear(jnp.asarray(w), JQuantSpec(
        w_bits=bits, amplifier=amplifier))
    for k in ("qvalue", "scale", "alpha"):
        _eq(tp[k], jp[k])
    if amplifier >= 2**20:
        assert float(tp["alpha"]) < amplifier


def test_quantize_tree_equals_reference(jax_literal):
    """Every 2-D ``{"w"}`` node whose path the recipe matches quantizes,
    first rule winning (W8A8-IS heuristic+6 on ``*down*``, W4A8-IS g128
    elsewhere); other leaves pass through."""
    rng = np.random.default_rng(8)
    w1, w2 = (rng.normal(size=s).astype(np.float32) * 0.05
              for s in ((256, 32), (128, 16)))
    bias = rng.normal(size=(16,)).astype(np.float32)
    g = np.ones((8,), np.float32)
    rules = (("*down*", dict(w_bits=8, amplifier="heuristic+6")),
             ("*", {}))
    tree = {"up": {"w": torch.from_numpy(w1)},
            "mlp": {"down": {"w": torch.from_numpy(w2),
                             "b": torch.from_numpy(bias)}},
            "norm": {"g": torch.from_numpy(g)}}
    got = tqlinear.quantize_tree(tree, QuantRecipe(
        rules=tuple((p, QuantSpec(**kw)) for p, kw in rules)))
    want = jqlinear.quantize_tree(
        {"up": {"w": jnp.asarray(w1)},
         "mlp": {"down": {"w": jnp.asarray(w2), "b": jnp.asarray(bias)}},
         "norm": {"g": jnp.asarray(g)}},
        None, JQuantRecipe(rules=tuple((p, JQuantSpec(**kw))
                                       for p, kw in rules)))
    assert set(got["up"]) == {"qvalue", "scale", "alpha"}
    for a, b in ((got["up"], want["up"]),
                 (got["mlp"]["down"], want["mlp"]["down"])):
        assert set(a) == set(b)
        for k in a:
            _eq(a[k], b[k])
    assert float(got["mlp"]["down"]["alpha"]) != 1024.0
    assert got["norm"]["g"] is tree["norm"]["g"]
