"""The port's quantized MoE path (``repro_torch.models.moe``, the grouped
GEMMs of ``repro_torch.kernels.moe_gemm``, ``ops.qgemm_grouped``,
``qlinear.grouped_linear_apply``, the expert PTQ, the Mixtral config and
the engine's routing sink) against the JAX reference, on the CPU, where
every grouped wrapper takes its plain version.

Inputs come from numpy seeds (or from the reference's own materialized
smoke Mixtral, carried over with ``repro_torch.convert``). Tolerances:

* Grouped GEMMs against the reference's jnp oracle (``grouped_linear_apply``
  on its non-Pallas branch): integer scale (with per-expert alphas) and
  coarse float scale bit-exact; fine float scale rtol 1e-5 / atol 1e-4
  (f32 group sums in another order). Against the Pallas kernels in
  interpret mode: the dense-grouped ones bit-exact on the same codes
  (fine FS within the FS bound); the ragged ones, whose fused ``act_quant``
  is only +-1-code exact at rounding ties, within rtol 2e-3 / atol 2e-2
  as ``tests/test_moe_ragged.py`` holds them; W4A16 within
  ``REL_TOLERANCE`` x max|y| of the Pallas kernel (both round the
  dequantized weight to bf16; the jnp oracle keeps it f32).
* The reference's ragged contracts hold in the port exactly (ragged ==
  dense grouped, zeros past counts, clamping, ``None`` == all C).
* ``moe_apply`` in f32: outputs and aux loss within 1e-5 relative.
* Smoke-Mixtral logits: fp within 1e-4, quantized within 2e-2 of the
  largest logit (the slice-1 bounds); PTQ trees bit-identical.
* Engines: greedy token streams and per-tick routed counts EQUAL.
"""
import dataclasses

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import integer_scale as jisc
from repro.core import packing as jpacking
from repro.core import ptq as jptq
from repro.core import qlinear as jqlinear
from repro.core import quant as jquant
from repro.core.recipe import QuantRecipe as JRecipe
from repro.core.recipe import QuantSpec as JSpec
from repro.kernels import moe_gemm as jmg
from repro.kernels import ref as JR
from repro.models import moe as jmoe
from repro.models.registry import get_arch as jget_arch
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import convert, obs
from repro_torch.core import ptq, qlinear
from repro_torch.core.recipe import QuantRecipe, QuantSpec
from repro_torch.kernels import _build, ops
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels.w4a16_gemm import REL_TOLERANCE
from repro_torch.kernels.w4a8_gemm import pick_tile_m
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_arch, get_model
from repro_torch.nn import spec as S
from repro_torch.serving.engine import Engine, ServeConfig

FP_TOL = 1e-4
Q_REL_TOL = 2e-2
FS_TOL = dict(rtol=1e-5, atol=1e-4)
RAGGED_PALLAS_TOL = dict(rtol=2e-3, atol=2e-2)

RECIPES = {  # name -> QuantSpec kwargs, for both packages
    "w4a8-is": {},
    "w4a8-fs": dict(scale_mode="float"),
    "w4a16-fg": dict(a_bits=16),
}
# the reference engine's kernel mode per recipe: its reference path
# dequantizes W4A16 to the f32 activation dtype, where its Pallas kernel
# and the port round the dequantized weight to bf16
JMODES = {"w4a8-is": "reference", "w4a8-fs": "reference",
          "w4a16-fg": "pallas_interpret"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


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


# ---------------------------------------------------------------------------
# Grouped GEMMs
# ---------------------------------------------------------------------------


def _experts(seed, E, K, N, g, w_bits=4, amplifier="heuristic+6"):
    """Per-expert RTN weights through the reference quantizer, with a
    magnitude spread so the heuristic amplifiers differ per expert."""
    rng = np.random.default_rng(seed)
    packed, iscale, fscale, alphas = [], [], [], []
    for e in range(E):
        w = rng.normal(size=(K, N)).astype(np.float32) * 0.05 * 4.0 ** (e % 3)
        qw = jquant.quantize_weight(jnp.asarray(w), w_bits, g)
        isw = jisc.integerize(qw, amplifier)
        packed.append(np.asarray(jpacking.pack_int4(qw.qvalue)
                                 if w_bits == 4 else qw.qvalue))
        iscale.append(np.asarray(isw.int_scale))
        fscale.append(np.asarray(qw.scale))
        alphas.append(float(isw.alpha))
    return (np.stack(packed), np.stack(iscale), np.stack(fscale),
            np.asarray(alphas, np.float32))


def _ragged_acts(seed, E, C, K, counts):
    """A dispatch-style buffer: rows at or past counts[e] zero-filled."""
    x = np.random.default_rng(seed).normal(size=(E, C, K)).astype(np.float32)
    x[np.arange(C)[None, :] >= np.asarray(counts)[:, None]] = 0.0
    return x


COUNTS = [[0, 24, 24], [5, 13, 21], [24, 24, 24]]


@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("w_bits", [4, 8])
def test_grouped_is_plain_bit_exact_vs_jnp_oracle(counts, w_bits):
    E, C, K, N, g = 3, 24, 256, 128, 128
    qv, iscale, _, alphas = _experts(0, E, K, N, g, w_bits)
    assert len(set(alphas.tolist())) > 1
    x = _ragged_acts(1, E, C, K, counts)
    spec = JSpec(w_bits=w_bits, amplifier="heuristic+6")
    want = jqlinear.grouped_linear_apply(
        {"qvalue": jnp.asarray(qv), "scale": jnp.asarray(iscale),
         "alpha": jnp.asarray(alphas)}, jnp.asarray(x), spec,
        mode="reference")
    rc = torch.tensor(counts, dtype=torch.int32)
    got = mg.fg_grouped_gemm_integer_scale_ragged(
        _t(x), rc, _t(qv), _t(iscale), alpha=_t(alphas), w_bits=w_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # through the port's qlinear entry point as well
    params = {"qvalue": _t(qv), "scale": _t(iscale), "alpha": _t(alphas)}
    tspec = QuantSpec(w_bits=w_bits, amplifier="heuristic+6")
    assert torch.equal(qlinear.grouped_linear_apply(
        params, _t(x), tspec, row_counts=rc), got)
    # the dense-grouped entry on the reference's codes == its Pallas kernel
    xq, sa = JR.act_quant_ref(jnp.asarray(x.reshape(E * C, K)))
    xq, sa = xq.reshape(E, C, K), sa.reshape(E, C, 1)
    y_k = jmg.fg_grouped_gemm_integer_scale(
        xq, sa, jnp.asarray(qv), jnp.asarray(iscale), group_size=g,
        alpha=jnp.asarray(alphas), w_bits=w_bits, interpret=True)
    y_d = mg.fg_grouped_gemm_integer_scale(
        _t(xq), _t(sa), _t(qv), _t(iscale), group_size=g, alpha=_t(alphas),
        w_bits=w_bits)
    np.testing.assert_array_equal(y_d.numpy(), np.asarray(y_k))
    # the ragged Pallas kernel: its fused act-quant is +-1 code at ties
    y_r = jmg.fg_grouped_gemm_integer_scale_ragged(
        jnp.asarray(x), jnp.asarray(counts, jnp.int32), jnp.asarray(qv),
        jnp.asarray(iscale), group_size=g, alpha=jnp.asarray(alphas),
        w_bits=w_bits, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(y_r),
                               **RAGGED_PALLAS_TOL)


@pytest.mark.parametrize("mode", ["fine", "coarse"])
@pytest.mark.parametrize("counts", COUNTS[:2])
def test_grouped_fs_plain_vs_jnp_oracle(mode, counts):
    E, C, K, N = 3, 24, 256, 128
    gs = 128 if mode == "fine" else -1
    rng = np.random.default_rng(2)
    packs, scales = [], []
    for _ in range(E):
        qw = jquant.quantize_weight(
            jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05),
            4, gs)
        packs.append(np.asarray(jpacking.pack_int4(qw.qvalue)))
        scales.append(np.asarray(qw.scale if gs > 0 else qw.scale[None, :]))
    qv, sc = np.stack(packs), np.stack(scales)
    x = _ragged_acts(3, E, C, K, counts)
    want = np.asarray(jqlinear.grouped_linear_apply(
        {"qvalue": jnp.asarray(qv), "scale": jnp.asarray(sc)},
        jnp.asarray(x), JSpec(scale_mode="float", group_size=gs),
        mode="reference"))
    got = mg.fg_grouped_gemm_float_scale_ragged(
        _t(x), torch.tensor(counts), _t(qv), _t(sc), group_size=gs).numpy()
    if gs < 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **FS_TOL)
    y_r = jmg.fg_grouped_gemm_float_scale_ragged(
        jnp.asarray(x), jnp.asarray(counts, jnp.int32), jnp.asarray(qv),
        jnp.asarray(sc), group_size=gs, interpret=True)
    np.testing.assert_allclose(got, np.asarray(y_r), **RAGGED_PALLAS_TOL)


def test_grouped_w4a16_plain_vs_pallas():
    E, C, K, N, g = 3, 24, 256, 256, 128
    qv, _, fscale, _ = _experts(4, E, K, N, g)
    counts = [0, 7, 24]
    x = _ragged_acts(5, E, C, K, counts)
    got = mg.grouped_w4a16_gemm_ragged(
        _t(x), torch.tensor(counts), _t(qv), _t(fscale), group_size=g)
    for want in (
            jmg.grouped_w4a16_gemm_ragged(
                jnp.asarray(x, jnp.bfloat16), jnp.asarray(counts, jnp.int32),
                jnp.asarray(qv), jnp.asarray(fscale), group_size=g,
                interpret=True),
            jmg.grouped_w4a16_gemm(
                jnp.asarray(x, jnp.bfloat16), jnp.asarray(qv),
                jnp.asarray(fscale), group_size=g, interpret=True)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= \
            REL_TOLERANCE * np.abs(want).max()


def _port_operands(seed, E, C, K, N, g, counts):
    qv, iscale, fscale, alphas = _experts(seed, E, K, N, g)
    x = _t(_ragged_acts(seed + 1, E, C, K, counts))
    return x, torch.tensor(counts, dtype=torch.int32), _t(qv), _t(iscale), \
        _t(fscale), _t(alphas)


@pytest.mark.parametrize("scheme", ["is", "fs", "coarse", "w4a16"])
@pytest.mark.parametrize("counts", COUNTS)
def test_ragged_equals_dense_grouped_in_the_port(scheme, counts):
    """The reference's central invariant, on the port's plain versions:
    ragged (fused act-quant, counts) == dense grouped on pre-quantized
    codes, bit for bit, for a buffer zero-filled past the counts."""
    E, C, K, N, g = 3, 24, 256, 128, 128
    x, rc, qv, iscale, fscale, alphas = _port_operands(6, E, C, K, N, g,
                                                       counts)
    xq, sa = mg._quantize_buffer(x, 8)
    if scheme == "is":
        y = mg.fg_grouped_gemm_integer_scale_ragged(x, rc, qv, iscale,
                                                    alpha=alphas)
        y_d = mg.fg_grouped_gemm_integer_scale(xq, sa, qv, iscale,
                                               alpha=alphas)
    elif scheme == "w4a16":
        y = mg.grouped_w4a16_gemm_ragged(x, rc, qv, fscale)
        y_d = mg.grouped_w4a16_gemm(x, qv, fscale)
    else:
        gs, sc = (128, fscale) if scheme == "fs" else (-1, fscale[:, :1])
        y = mg.fg_grouped_gemm_float_scale_ragged(x, rc, qv, sc,
                                                  group_size=gs)
        y_d = mg.fg_grouped_gemm_float_scale(xq, sa, qv, sc, group_size=gs)
    assert torch.equal(y, y_d)


@pytest.mark.parametrize("scheme", ["is", "fs", "w4a16"])
def test_ragged_contracts_in_the_port(scheme):
    """Zeros past the counts (whatever the buffer holds there), counts
    clamped to C, ``row_counts=None`` == every count C, as
    ``tests/test_moe_ragged.py`` holds the reference."""
    E, C, K, N, g = 2, 16, 256, 128, 128
    x, _, qv, iscale, fscale, alphas = _port_operands(10, E, C, K, N, g,
                                                      [C, C])

    def run(rc):
        if scheme == "is":
            return mg.fg_grouped_gemm_integer_scale_ragged(
                x, rc, qv, iscale, alpha=alphas)
        if scheme == "fs":
            return mg.fg_grouped_gemm_float_scale_ragged(x, rc, qv, fscale)
        return mg.grouped_w4a16_gemm_ragged(x, rc, qv, fscale)

    y = run(torch.tensor([9, 0]))
    assert not y[0, 9:].any() and not y[1].any() and y[0, :9].all()
    assert torch.equal(run(torch.tensor([100, 16])),
                       run(torch.tensor([16, 16])))
    assert torch.equal(run(None), run(torch.tensor([16, 16])))


@pytest.mark.parametrize("counts,C,bm", [
    ([0, 5, 128, 200], 128, 128), ([0, 5, 9], 24, 8), ([0, 8, 1, 3], 8, 16),
    ([40, 0, 17, 39, 3, 3, 3, 3], 40, 64), ([33, 5], 40, 16)])
def test_ragged_tile_stats_equal_reference(counts, C, bm):
    assert mg.ragged_tile_stats(counts, C, bm) == \
        jmg.ragged_tile_stats(counts, C, bm)


@pytest.mark.parametrize("spec,args", [
    ("is", dict()), ("fs", dict(scale_mode="float")),
    ("coarse", dict(group_size=-1)), ("w4a16", dict(a_bits=16))])
def test_qgemm_grouped_matches_reference_every_scheme(spec, args):
    """``ops.qgemm_grouped`` against the reference's, scheme for scheme:
    the jnp oracle for IS (bit-exact) and float scale (FS bound; coarse
    bit-exact), the Pallas kernel for W4A16."""
    E, C, K, N = 4, 16, 256, 128
    counts = [0, 5, 16, 11]
    rng = np.random.default_rng(14)
    w = rng.normal(size=(E, K, N)).astype(np.float32) * 0.05
    tspec, jspec = QuantSpec(**args), JSpec(**args)
    params = qlinear.quantize_experts(_t(w), tspec)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    x = _ragged_acts(15, E, C, K, counts)
    got = ops.qgemm_grouped(_t(x), params, tspec,
                            row_counts=torch.tensor(counts)).numpy()
    want = np.asarray(jqlinear.grouped_linear_apply(
        jparams, jnp.asarray(x), jspec, row_counts=jnp.asarray(counts),
        mode="pallas_interpret" if spec == "w4a16" else "reference"))
    if spec in ("is", "coarse"):
        np.testing.assert_array_equal(got, want)
    elif spec == "fs":
        np.testing.assert_allclose(got, want, **FS_TOL)
    else:
        assert np.abs(got - want).max() <= REL_TOLERANCE * np.abs(want).max()
    with pytest.raises(NotImplementedError, match="W4A16"):
        ops.qgemm_grouped(_t(x), params, QuantSpec(w_bits=8, a_bits=16))


def test_grouped_wrappers_take_plain_versions_on_cpu():
    E, C, K, N, g = 2, 8, 256, 128, 128
    x, rc, qv, iscale, fscale, alphas = _port_operands(20, E, C, K, N, g,
                                                       [3, 8])
    xq, sa = mg._quantize_buffer(x, 8)
    _build.reset_launches()
    for got, want in (
            (mg.fg_grouped_gemm_integer_scale_ragged(x, rc, qv, iscale,
                                                     alpha=alphas),
             mg.fg_grouped_gemm_integer_scale_ragged_plain(
                 x, rc, qv, iscale, group_size=g, alpha=alphas)),
            (mg.fg_grouped_gemm_float_scale(xq, sa, qv, fscale),
             mg.fg_grouped_gemm_float_scale_plain(xq, sa, qv, fscale,
                                                  group_size=g)),
            (mg.grouped_w4a16_gemm_ragged(x, rc, qv, fscale),
             mg.grouped_w4a16_gemm_ragged_plain(x, rc, qv, fscale,
                                                group_size=g))):
        assert torch.equal(got, want)
    assert _build.LAUNCHES == {name: 0 for name in _build.KERNELS}
    meta = {k: v.to("meta") for k, v in
            dict(qvalue=qv, scale=iscale, alpha=alphas).items()}
    with pytest.raises(ValueError, match="CUDA"):
        ops.qgemm_grouped(x.to("meta"), meta, QuantSpec(), row_counts=None)


@pytest.mark.parametrize("name,symbol", [
    ("moe_w4a8_is", "moe_w4a8_is_launch"),
    ("moe_w4a8_fs", "moe_w4a8_fs_launch"),
    ("moe_w4a16", "moe_w4a16_launch"),
    ("act_quant", "act_quant_routed_launch"),
])
def test_grouped_ctypes_argtypes_match_c_signatures(name, symbol):
    """The CUDA sources cannot compile here; hold the declared ctypes
    argtypes to each C entry point's parameter list instead: the grouped
    GEMMs and the routed-row quantization the W4A8 ones launch first."""
    import ctypes
    import re

    from repro_torch.kernels import act_quant as aq

    src = (_build.CSRC / f"{name}.cu").read_text()
    sig = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src).group(1)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    params = [re.sub(r"\s", "", re.sub(r"\bconst\b|\w+\s*$", "", p))
              for p in sig.split(",")]
    argtypes = {"moe_w4a8_is": mg._IS_ARGS, "moe_w4a8_fs": mg._FS_ARGS,
                "moe_w4a16": mg._WO_ARGS, "act_quant": aq._ROUTED_ARGS}[name]
    assert argtypes == [kinds[p] for p in params]
    assert name in _build.KERNELS


# ---------------------------------------------------------------------------
# The smoke Mixtral in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mix():
    """The reference's smoke Mixtral, materialized once, and the port's,
    carrying the same weights."""
    jcfg = jget_arch("mixtral-8x7b", smoke=True)
    japi = jget_model(jcfg)
    jparams = JS.materialize(japi.param_specs(jcfg, None),
                             jax.random.PRNGKey(0))
    cfg = get_arch("mixtral-8x7b", smoke=True)
    tparams = convert.from_reference(_np_tree(jparams), device="cpu")
    return japi, jcfg, jparams, get_model(cfg), cfg, tparams


@pytest.fixture(scope="module")
def mix_q(mix):
    """Each recipe's quantized smoke Mixtral through both PTQs (the
    reference's IS certificate needs the ``jax.core.Literal`` alias, set
    only while it quantizes)."""
    japi, jcfg, jparams, api, cfg, tparams = mix
    out = {}
    for name, kw in RECIPES.items():
        jr = JRecipe(rules=(("*", JSpec(**kw)),), name=name)
        tr = QuantRecipe(rules=(("*", QuantSpec(**kw)),), name=name)
        with pytest.MonkeyPatch.context() as mp:
            if not hasattr(jax.core, "Literal"):
                mp.setattr(jax.core, "Literal", jax.extend.core.Literal,
                           raising=False)
            jq = jptq.post_training_quantize(japi, jcfg, jparams, jr, None)
        out[name] = (jq, jr, ptq.post_training_quantize(api, cfg, tparams,
                                                        tr), tr)
    return out


def test_mixtral_configs_equal_reference():
    for smoke in (False, True):
        j, t = jget_arch("mixtral-8x7b", smoke=smoke), get_arch(
            "mixtral-8x7b", smoke=smoke)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    full = get_arch("mixtral-8x7b")
    assert (full.num_layers, full.d_model, full.moe_d_ff, full.num_experts,
            full.top_k, full.capacity_factor) == (32, 4096, 14336, 8, 2, 1.25)
    assert moe.capacity(4, 2, 8, 1.25) == 8
    assert moe.capacity(128, 2, 8, 1.25) == 40
    # shared experts and leading dense layers are ported (DeepSeek-V2),
    # and the int8 dispatch (tests/test_torch_train_moe.py)
    for kw in (dict(num_shared_experts=2), dict(first_dense_layers=1),
               dict(moe_int8_dispatch=True)):
        dataclasses.replace(full, **kw)


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_apply_fp_matches_reference(mix, groups):
    japi, jcfg, jparams, api, cfg, tparams = mix
    jc = dataclasses.replace(jcfg, dispatch_groups=groups)
    tc = dataclasses.replace(cfg, dispatch_groups=groups)
    x = np.random.default_rng(30).normal(size=(2, 12, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["s0"]["mlp"])
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jc, None, "blocks/s0/mlp")
    got, aux = moe.moe_apply(tparams["blocks"][0]["mlp"], _t(x), tc, None,
                             "blocks/0/mlp")
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)


def test_moe_drops_tokens_past_capacity_like_reference(mix):
    """At capacity factor 0.5 experts overflow: the dropped tokens and the
    routed counts are the reference's."""
    japi, jcfg, jparams, api, cfg, tparams = mix
    jc = dataclasses.replace(jcfg, capacity_factor=0.5)
    tc = dataclasses.replace(cfg, capacity_factor=0.5)
    x = np.random.default_rng(31).normal(size=(1, 32, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"]["s0"]["mlp"])
    jtrace = jmoe.start_routing_trace()
    try:
        want, _ = jmoe.moe_apply(jp, jnp.asarray(x), jc, None, "b")
    finally:
        jmoe.stop_routing_trace(jtrace)
    trace = moe.start_routing_trace()
    try:
        got, _ = moe.moe_apply(tparams["blocks"][1]["mlp"], _t(x), tc, None,
                               "b")
    finally:
        moe.stop_routing_trace(trace)
    assert trace[0]["capacity"] == jtrace[0]["capacity"] == 8
    np.testing.assert_array_equal(trace[0]["counts"].numpy(),
                                  jtrace[0]["counts"])
    assert (trace[0]["counts"] == 8).any()  # an expert at capacity
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_fp_logits_match_reference(mix, mode):
    japi, jcfg, jparams, api, cfg, tparams = mix
    toks = np.random.default_rng(32).integers(0, cfg.vocab_size, (2, 12))
    want, _, jaux = japi.apply(jparams, jcfg, jnp.asarray(toks), mode=mode)
    got, _, aux = api.build(cfg, tparams)(torch.from_numpy(toks), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FP_TOL,
                               atol=FP_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_moe_ptq_tree_equals_reference_leaf_for_leaf(mix_q, name):
    """Codes, scales and the per-expert alphas of every expert stack (and
    the attention linears) equal the reference's; ``convert`` carries the
    MoE tree both ways bit for bit."""
    jq, _, tq, _ = mix_q[name]
    want = _by_path(convert.from_reference(_np_tree(jq), device="cpu"))
    got = _by_path(tq)
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path
    down = tq["blocks"][0]["mlp"]["down"]
    assert down["qvalue"].shape == (8, 128, 256)
    assert tq["blocks"][0]["mlp"]["router"].dtype == torch.float32
    if name == "w4a8-is":
        assert down["alpha"].shape == (8,)
    back = dict(jax.tree_util.tree_leaves_with_path(convert.to_reference(tq)))
    for path, a in jax.tree_util.tree_leaves_with_path(_np_tree(jq)):
        np.testing.assert_array_equal(back[path], a, err_msg=str(path))


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_quantized_logits_and_routing_match_reference(mix, mix_q, name):
    """Logits within 2e-2 of the largest; every MoE layer routes the same
    rows to the same experts (counts from both packages' routing traces)."""
    japi, jcfg, jparams, api, cfg, tparams = mix
    jq, jr, tq, tr = mix_q[name]
    jc = dataclasses.replace(jcfg, kernel_mode=JMODES[name])
    toks = np.random.default_rng(33).integers(0, cfg.vocab_size, (2, 12))
    jtrace = jmoe.start_routing_trace()
    try:
        want, _, _ = japi.apply(jq, jc, jnp.asarray(toks), recipe=jr)
        jax.effects_barrier()
    finally:
        jmoe.stop_routing_trace(jtrace)
    trace = moe.start_routing_trace()
    try:
        got, _, _ = api.build(cfg, tq, tr)(torch.from_numpy(toks))
    finally:
        moe.stop_routing_trace(trace)
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= Q_REL_TOL, err
    assert len(trace) == len(jtrace) == cfg.num_layers
    for r, jrec in zip(trace, jtrace):
        np.testing.assert_array_equal(r["counts"].numpy(), jrec["counts"])


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_block_wise_build_equals_whole_tree_ptq(mix, name):
    """``quantize_by_layer`` (one block's fp weights at a time) equals
    ``post_training_quantize`` of the tree drawn with the same per-block
    seeding, leaf for leaf."""
    *_, api, cfg, _ = mix
    recipe = QuantRecipe(rules=(("*", QuantSpec(**RECIPES[name])),),
                         name=name)
    fp = ptq.materialize_by_layer(api, cfg, seed=3, device="cpu")
    want = _by_path(ptq.post_training_quantize(api, cfg, fp, recipe))
    got = _by_path(ptq.quantize_by_layer(api, cfg, recipe, seed=3,
                                         device="cpu"))
    assert list(got) == list(want)
    for path, t in got.items():
        assert torch.equal(t, want[path]), path
    # each block has its own generator: block 1 is not block 0 redrawn
    assert not torch.equal(fp["blocks"][0]["mlp"]["up"]["w"],
                           fp["blocks"][1]["mlp"]["up"]["w"])


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _prompts(seed, n, length, V=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=length).tolist() for _ in range(n)]


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_engine_streams_and_routing_equal_reference_engine(mix, mix_q, name):
    """Greedy streams equal the JAX engine's, tick for tick the same rows
    go to the same experts, and with one request a decode tick leaves an
    expert with no routed row (the ragged kernel's skipped-tile case,
    ``tests/test_serving_moe.py``)."""
    japi, jcfg, _, api, cfg, _ = mix
    jq, jr, tq, tr = mix_q[name]
    kw = dict(max_slots=2, max_seq=32, prefill_len=8, max_new_tokens=4)
    for n in (1, 3):  # one request; more requests than slots
        prompts = _prompts(40 + n, n, 8)
        jtrace = jmoe.start_routing_trace()
        try:
            jeng = JEngine(japi, jcfg, jq,
                           JServeConfig(**kw, kernel_mode=JMODES[name]),
                           recipe=jr)
            jrids = [jeng.submit(p) for p in prompts]
            want = jeng.run()
            jax.effects_barrier()
        finally:
            jmoe.stop_routing_trace(jtrace)
            jeng.close()
        trace = moe.start_routing_trace()
        try:
            eng = Engine(api, cfg, tq, ServeConfig(**kw), recipe=tr)
            rids = [eng.submit(p) for p in prompts]
            got = eng.run()
        finally:
            moe.stop_routing_trace(trace)
            eng.close()
        assert rids == jrids
        for r in rids:
            assert eng.outcome(r) == jeng.outcome(r) == "ok"
            assert got[r] == want[r], (name, r, got[r], want[r])
        assert len(trace) == len(jtrace)
        for rec, jrec in zip(trace, jtrace):
            assert rec["capacity"] == jrec["capacity"]
            np.testing.assert_array_equal(rec["counts"].numpy(),
                                          jrec["counts"])
    decode = [r for r in trace if r["capacity"] == 8]
    assert any(int(c) == 0 for r in decode for c in r["counts"][0])


def test_engine_counts_m_tiles_from_live_routing(mix, mix_q):
    """``engine_moe_m_tiles_total`` equals the tile accounting of the
    routing trace with the kernels' own row tile, drained once per tick;
    on the CPU the plain versions run every row (executed == total); each
    tick emits a ``counters`` event for the timeline's counter track."""
    *_, api, cfg, _ = mix
    _, _, tq, tr = mix_q["w4a8-is"]
    reg = obs.Registry()
    trace = moe.start_routing_trace()
    try:
        with obs.use_registry(reg):
            eng = Engine(api, cfg, tq, ServeConfig(
                max_slots=2, max_seq=32, prefill_len=8, max_new_tokens=4),
                recipe=tr)
            for p in _prompts(50, 3, 8):
                eng.submit(p)
            eng.run()
            assert not eng._routing_buf
            eng.close()
    finally:
        moe.stop_routing_trace(trace)
    total = sum(mg.ragged_tile_stats(r["counts"][0].tolist(), r["capacity"],
                                     pick_tile_m(r["capacity"]))
                ["dense_m_tiles"] for r in trace)
    tiles = reg.counter("engine_moe_m_tiles_total", "", ("kind",))
    assert tiles.get(kind="total") == total > 0
    assert tiles.get(kind="executed") == total
    events = [e for e in reg.events() if e.get("ev") == "counters"]
    assert len(events) == eng.ticks
    assert events[-1]["moe_total"] == total
    assert not moe.routing_sinks_active()


def test_serve_cli_serves_smoke_mixtral(capsys):
    with obs.use_registry(obs.Registry()):
        assert serve.main(["--device", "cpu", "--arch", "mixtral-8x7b",
                           "--smoke", "--requests", "3", "--max-new", "4",
                           "--prefill-len", "16", "--max-seq", "64"]) == 0
    out = capsys.readouterr().out
    assert "model=mixtral-smoke" in out and "block by block" in out
    assert "conserved=yes" in out and 'outcome="ok"\': 3' in out
    line = next(ln for ln in out.splitlines() if "moe m-tiles" in ln)
    executed, total = line.split("=")[1].split()[0].split("/")
    assert int(total) > 0 and int(executed) > 0
    assert not moe.routing_sinks_active()


def test_moe_config_family_builds_and_dense_still_does():
    """``get_model`` takes the moe family; a dense config still builds with
    no MoE block and no routing sink."""
    cfg = ModelConfig(name="d", family="dense", num_layers=1, d_model=64,
                      num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=32)
    api = get_model(cfg)
    p = S.materialize(api.param_specs(cfg), torch.Generator().manual_seed(0),
                      device="cpu")
    eng = Engine(api, cfg, p, ServeConfig(max_slots=1, prefill_len=4,
                                          max_new_tokens=2))
    assert eng._routing_sink is None
    m = get_model(get_arch("mixtral-8x7b", smoke=True))
    assert "router" in m.param_specs(get_arch("mixtral-8x7b",
                                              smoke=True))["blocks"][0]["mlp"]


@pytest.mark.parametrize("name", ["w4a8-fs", "w4a8-is"])
def test_moe_forward_quantizes_each_activation_once(monkeypatch, mix, mix_q,
                                                    name):
    """A MoE layer quantizes 2 dense activations (q/k/v, o) and 2 routed
    ones (gate/up over one dispatch buffer, down), where each linear alone
    ran 4 + 3; the logits equal the unshared ones bit for bit (gate and
    up, with their own per-expert alphas, divide in the epilogue) and
    match the reference's within its bound."""
    from repro_torch.kernels import act_quant as aq

    japi, jcfg, jparams, api, cfg, tparams = mix
    jq, jr, tq, tr = mix_q[name]
    toks = np.random.default_rng(34).integers(0, cfg.vocab_size, (2, 12))
    runs = []
    for share in (True, False):
        with monkeypatch.context() as mp:
            if not share:
                mp.setattr(ops, "quantize_for", lambda *a, **k: None)
            calls = {"dense": [], "routed": []}
            for kind, mod, fn in (("dense", ops, "act_quant"),
                                  ("routed", aq, "act_quant_routed_plain")):
                def counted(*a, _real=getattr(mod, fn), _n=calls[kind], **k):
                    _n.append(1)
                    return _real(*a, **k)
                mp.setattr(mod, fn, counted)
            got, _, _ = api.build(cfg, tq, tr)(torch.from_numpy(toks))
        runs.append((got, {k: len(v) for k, v in calls.items()}))
    (shared, n_shared), (alone, n_alone) = runs
    L = cfg.num_layers
    assert n_shared == {"dense": 2 * L, "routed": 2 * L}
    assert n_alone == {"dense": 4 * L, "routed": 3 * L}
    assert torch.equal(shared, alone)
    jc = dataclasses.replace(jcfg, kernel_mode=JMODES[name])
    want = np.asarray(japi.apply(jq, jc, jnp.asarray(toks), recipe=jr)[0])
    err = np.abs(shared.numpy() - want).max() / np.abs(want).max()
    assert err <= Q_REL_TOL, err
