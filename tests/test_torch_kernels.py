"""The port's kernel wrappers and their plain versions against the JAX
reference kernels, on the CPU. The Hopper kernels against their plain
versions are in ``tests/test_torch_cuda.py``, which imports no JAX so that
it runs on the GPU machine.

Tolerances: plain ``act_quant`` and the plain IS GEMM are bit-exact to
the reference oracles (``repro.kernels.ref``) and the IS GEMM also to the
Pallas kernel in interpret mode; the Pallas ``act_quant`` may differ by
one code at rounding ties, as ``tests/test_kernels.py`` allows. Plain
flash attention vs the Pallas kernel (interpret, f32): atol 2e-5 — the
two visit keys in different blocks. Float-scale GEMM (fine W4/W8 and
coarse) vs the reference oracle and the Pallas kernel: f32 sums in another
order, rtol 1e-5, atol 1e-4 (as ``tests/test_kernels.py`` holds the Pallas
kernel). W4A16: bf16 operands, 2e-2 as the reference's own test.
``ops.qgemm`` for every scheme vs the reference ``qgemm`` in interpret
mode within those tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import integer_scale as jisc
from repro.core import packing as jpacking
from repro.core import quant as jquant
from repro.kernels import ref as JR
from repro.kernels.act_quant import act_quant as pallas_act_quant
from repro.core.recipe import QuantSpec as JSpec
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_tpu
from repro.kernels.w4a16_gemm import w4a16_gemm as pallas_w4a16_gemm
from repro.kernels.w4a8_gemm import fg_gemm_integer_scale as pallas_is_gemm
from repro.kernels.w4a8_gemm_fscale import \
    fg_gemm_float_scale as pallas_fs_gemm
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.recipe import QuantSpec
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels.act_quant import act_quant, act_quant_plain
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.w4a16_gemm import w4a16_gemm, w4a16_gemm_plain
from repro_torch.kernels.w4a8_gemm import (fg_gemm_integer_scale,
                                           fg_gemm_integer_scale_plain)
from repro_torch.kernels.w4a8_gemm_fscale import (fg_gemm_float_scale,
                                                  fg_gemm_float_scale_plain)

FS_TOL = dict(rtol=1e-5, atol=1e-4)
W4A16_TOL = dict(rtol=2e-2, atol=2e-2)

SHAPES = [  # (M, K, N, group) — tests/test_kernels.py
    (1, 256, 128, 128),
    (7, 512, 256, 128),
    (48, 1024, 512, 128),
    (16, 512, 384, 256),
    (128, 384, 128, 128),
]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _gemm_operands(seed, M, K, N, g, w_bits=4, amplifier=1024):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    qw = jquant.quantize_weight(jnp.asarray(w), w_bits, g)
    xq, sa = jquant.quantize_activation(jnp.asarray(x))
    packed = jpacking.pack_int4(qw.qvalue) if w_bits == 4 else qw.qvalue
    isw = jisc.integerize(qw, amplifier)
    return xq, sa, packed, isw.int_scale, float(isw.alpha)


@pytest.mark.parametrize("M,K", [(1, 128), (5, 384), (64, 1024)])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_quant_plain_vs_reference(M, K, bits, dtype):
    x = jnp.asarray(np.random.default_rng(7).normal(size=(M, K)) * 3
                    ).astype(dtype)
    tx = _t(x.astype(jnp.float32)).to(getattr(torch, dtype))
    q, s = act_quant_plain(tx, bits)
    q_r, s_r = JR.act_quant_ref(x, bits=bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    # the Pallas kernel: one code at rounding ties, as tests/test_kernels.py
    q_k, s_k = pallas_act_quant(x, bits=bits, interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_k), rtol=1e-6,
                               atol=1e-9)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(q_k, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 5e-3


@pytest.mark.parametrize("M,K,N,g", SHAPES)
def test_is_gemm_plain_bit_exact(M, K, N, g):
    xq, sa, packed, ints, alpha = _gemm_operands(0, M, K, N, g)
    y = fg_gemm_integer_scale_plain(_t(xq), _t(sa), _t(packed), _t(ints),
                                    group_size=g, alpha=alpha)
    y_r = JR.fg_gemm_is_ref(xq, sa, packed, ints, group_size=g, alpha=alpha)
    y_k = pallas_is_gemm(xq, sa, packed, ints, group_size=g, alpha=alpha,
                         interpret=True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_r))
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_k))


@pytest.mark.parametrize("M,K,N,g", SHAPES[:3])
def test_w8_is_gemm_plain_bit_exact(M, K, N, g):
    xq, sa, w8, ints, alpha = _gemm_operands(3, M, K, N, g, w_bits=8,
                                             amplifier="heuristic+6")
    y = fg_gemm_integer_scale_plain(_t(xq), _t(sa), _t(w8), _t(ints),
                                    group_size=g, alpha=alpha, w_bits=8)
    y_r = JR.fg_gemm_is_ref(xq, sa, w8, ints, group_size=g, alpha=alpha,
                            w_bits=8)
    y_k = pallas_is_gemm(xq, sa, w8, ints, group_size=g, alpha=alpha,
                         w_bits=8, interpret=True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_r))
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_k))


def test_fs_and_w4a16_oracles_match_reference():
    M, K, N, g = 6, 256, 64, 128
    rng = np.random.default_rng(11)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    qw = jquant.quantize_weight(jnp.asarray(w), 4, g)
    xq, sa = jquant.quantize_activation(jnp.asarray(x))
    packed = jpacking.pack_int4(qw.qvalue)
    np.testing.assert_allclose(
        TR.fg_gemm_fs_ref(_t(xq), _t(sa), _t(packed), _t(qw.scale),
                          group_size=g).numpy(),
        np.asarray(JR.fg_gemm_fs_ref(xq, sa, packed, qw.scale, group_size=g)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TR.w4a16_gemm_ref(_t(x), _t(packed), _t(qw.scale),
                          group_size=g).numpy(),
        np.asarray(JR.w4a16_gemm_ref(jnp.asarray(x), packed, qw.scale,
                                     group_size=g)),
        rtol=2e-2, atol=2e-2)


def _fs_operands(seed, M, K, N, g, w_bits):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    qw = jquant.quantize_weight(jnp.asarray(w), w_bits, g)
    xq, sa = jquant.quantize_activation(jnp.asarray(x))
    packed = jpacking.pack_int4(qw.qvalue) if w_bits == 4 else qw.qvalue
    scale = qw.scale if g > 0 else qw.scale[None, :]
    return x, xq, sa, packed, scale


@pytest.mark.parametrize("M,K,N,g", SHAPES)
@pytest.mark.parametrize("variant", ["fine-w4", "fine-w8", "coarse-w4"])
def test_fs_gemm_plain_vs_reference(M, K, N, g, variant):
    w_bits = 8 if variant.endswith("w8") else 4
    g = -1 if variant.startswith("coarse") else g
    _, xq, sa, packed, scale = _fs_operands(5, M, K, N, g, w_bits)
    y = fg_gemm_float_scale_plain(_t(xq), _t(sa), _t(packed), _t(scale),
                                  group_size=g, w_bits=w_bits)
    y_r = JR.fg_gemm_fs_ref(xq, sa, packed, scale, group_size=g,
                            w_bits=w_bits)
    y_k = pallas_fs_gemm(xq, sa, packed, scale, group_size=g, w_bits=w_bits,
                         interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **FS_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), **FS_TOL)
    assert torch.equal(TR.fg_gemm_fs_ref(_t(xq), _t(sa), _t(packed),
                                         _t(scale), group_size=g,
                                         w_bits=w_bits), y)


@pytest.mark.parametrize("M,K,N,g", SHAPES)
def test_w4a16_gemm_plain_vs_reference(M, K, N, g):
    x, _, _, packed, scale = _fs_operands(6, M, K, N, g, 4)
    y = w4a16_gemm_plain(_t(x), _t(packed), _t(scale), group_size=g)
    y_r = JR.w4a16_gemm_ref(jnp.asarray(x), packed, scale, group_size=g)
    y_k = pallas_w4a16_gemm(jnp.asarray(x), packed, scale, group_size=g,
                            interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **W4A16_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), **W4A16_TOL)
    assert torch.equal(TR.w4a16_gemm_ref(_t(x), _t(packed), _t(scale),
                                         group_size=g), y)


SCHEMES = {  # name -> (QuantSpec kwargs, tolerance vs the reference)
    "w4a8-is": (dict(), dict(rtol=0, atol=0)),
    "w8a8-is": (dict(w_bits=8, amplifier="heuristic+6"), dict(rtol=0, atol=0)),
    "w4a8-fs": (dict(scale_mode="float"), FS_TOL),
    "w8a8-fs": (dict(w_bits=8, scale_mode="float"), FS_TOL),
    "w4a8-coarse-is": (dict(group_size=-1), FS_TOL),
    "w4a8-coarse-fs": (dict(group_size=-1, scale_mode="float"), FS_TOL),
    "w4a16": (dict(a_bits=16), W4A16_TOL),
}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_qgemm_matches_reference_every_scheme(scheme):
    """The port's dispatch on the CPU (plain versions) against the
    reference ``qgemm`` with its Pallas kernels in interpret mode, on the
    same quantized operands."""
    kw, tol = SCHEMES[scheme]
    rng = np.random.default_rng(8)
    w = torch.from_numpy((rng.normal(size=(256, 128)) * 0.05)
                         .astype(np.float32))
    x = rng.normal(size=(5, 256)).astype(np.float32)
    params = tqlinear.quantize_linear(w, QuantSpec(**kw))
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    got = ops.qgemm(_t(x), params, QuantSpec(**kw))
    want = jops.qgemm(jnp.asarray(x), jparams, JSpec(**kw),
                      block=jops.BlockConfig(interpret=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_w8a16_raises_in_both_packages():
    w = torch.from_numpy(np.random.default_rng(9).normal(size=(256, 64))
                         .astype(np.float32))
    params = tqlinear.quantize_linear(w, QuantSpec(w_bits=8, a_bits=16))
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    x = np.ones((2, 256), np.float32)
    with pytest.raises(NotImplementedError, match="weight-only kernel is "
                                                  "W4A16"):
        ops.qgemm(_t(x), params, QuantSpec(w_bits=8, a_bits=16))
    with pytest.raises(NotImplementedError, match="weight-only kernel is "
                                                  "W4A16"):
        jops.qgemm(jnp.asarray(x), jparams, JSpec(w_bits=8, a_bits=16),
                   block=jops.BlockConfig(interpret=True))


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,window", [
    (2, 40, 40, 4, 2, 32, None),    # GQA, ragged length
    (1, 70, 70, 4, 4, 16, 24),      # sliding window
    (1, 24, 56, 6, 2, 32, None),    # Sq < Sk
])
def test_flash_plain_vs_pallas(B, Sq, Sk, Hq, Hkv, D, window):
    rng = np.random.default_rng(B * 100 + Sq)
    q, k, v = (rng.normal(size=(B, s, h, D)).astype(np.float32)
               for s, h in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
    out = flash_attention_plain(_t(q), _t(k), _t(v), window=window)
    ref = flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              window=window, bq=32, bk=32, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=2e-5)


def test_wrappers_take_plain_versions_on_cpu():
    xq, sa, packed, ints, alpha = _gemm_operands(1, 7, 512, 256, 128)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 256))
                         .astype(np.float32))
    q = torch.randn(1, 9, 4, 32, generator=torch.Generator().manual_seed(0))
    _build.reset_launches()
    for got, want in (
            (act_quant(x), act_quant_plain(x)),
            ((fg_gemm_integer_scale(_t(xq), _t(sa), _t(packed), _t(ints),
                                    alpha=alpha),),
             (fg_gemm_integer_scale_plain(_t(xq), _t(sa), _t(packed),
                                          _t(ints), group_size=128,
                                          alpha=alpha),)),
            ((flash_attention(q, q, q),), (flash_attention_plain(q, q, q),)),
            ((fg_gemm_float_scale(_t(xq), _t(sa), _t(packed),
                                  torch.ones((4, 256))),),
             (fg_gemm_float_scale_plain(_t(xq), _t(sa), _t(packed),
                                        torch.ones((4, 256)),
                                        group_size=128),)),
            ((w4a16_gemm(x, _t(packed)[:128], torch.ones((2, 256))),),
             (w4a16_gemm_plain(x, _t(packed)[:128], torch.ones((2, 256)),
                               group_size=128),))):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert _build.LAUNCHES == {name: 0 for name in _build.KERNELS}


@pytest.mark.parametrize("name,symbol,module", [
    ("act_quant", "act_quant_launch", "act_quant"),
    ("w4a8_gemm_is", "w4a8_gemm_is_launch", "w4a8_gemm"),
    ("flash_attention", "flash_attention_launch", "flash_attention"),
    ("w4a8_gemm_fs", "w4a8_gemm_fs_launch", "w4a8_gemm_fscale"),
    ("w4a16_gemm", "w4a16_gemm_launch", "w4a16_gemm"),
])
def test_ctypes_argtypes_match_c_signatures(name, symbol, module):
    """The CUDA sources cannot compile here; hold each wrapper's declared
    ctypes argtypes to the C entry point's parameter list instead."""
    import ctypes
    import importlib
    import re

    src = (_build.CSRC / f"{name}.cu").read_text()
    sig = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src).group(1)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    params = [re.sub(r"\s", "", re.sub(r"\bconst\b|\w+\s*$", "", p))
              for p in sig.split(",")]
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    assert mod._ARGS == [kinds[p] for p in params]


def test_cuda_mode_on_cpu_tensor_raises():
    """The tensor's device is the only switch: CPU tensors take the plain
    versions, and a tensor on any other device than the CPU goes to the
    kernels, which raise unless it is a CUDA tensor. Here a meta tensor
    stands in for a non-CPU tensor: no plain version runs on it."""
    spec = QuantSpec(group_size=64)
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(128, 16))
                         .astype(np.float32))
    params = tqlinear.quantize_linear(w, spec)
    assert tqlinear.linear_apply(params, torch.ones(2, 128), spec).shape == \
        (2, 16)
    meta = {k: v.to("meta") for k, v in params.items()}
    with pytest.raises(ValueError, match="CUDA"):
        tqlinear.linear_apply(meta, torch.ones(2, 128, device="meta"), spec)
    q = torch.ones((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)


def test_qgemm_resolves_alpha_like_reference():
    rng = np.random.default_rng(4)
    w = torch.from_numpy((rng.normal(size=(256, 32)) * 0.03)
                         .astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(5, 256)).astype(np.float32))
    spec = QuantSpec(amplifier="heuristic+6")
    params = tqlinear.quantize_linear(w, spec)
    assert float(params["alpha"]) != 1024.0
    # the stored alpha wins and is folded into sa: equal to the unfolded
    # Eq. 2 epilogue ``* (sa / alpha)``
    xq, sa = act_quant_plain(x)
    y_ref = fg_gemm_integer_scale_plain(
        xq, sa, params["qvalue"], params["scale"], group_size=128,
        alpha=float(params["alpha"]))
    assert torch.equal(ops.qgemm(x, params, spec), y_ref)
    assert torch.equal(tqlinear.linear_apply(params, x, spec), y_ref)
    # no stored alpha: a static int amplifier is the fallback ...
    static = QuantSpec()
    p2 = tqlinear.quantize_linear(w, static)
    no_alpha = {k: v for k, v in p2.items() if k != "alpha"}
    assert torch.equal(ops.qgemm(x, no_alpha, static),
                       tqlinear.linear_apply(p2, x, static))
    # ... and a heuristic amplifier without one raises
    with pytest.raises(ValueError, match="per layer"):
        ops.qgemm(x, {k: v for k, v in params.items() if k != "alpha"}, spec)
    with pytest.raises(ValueError):
        ops.LaunchConfig(bm=32)
