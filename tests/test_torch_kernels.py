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
from repro.kernels import act_quant as jact
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
from repro_torch.core.recipe import QuantRecipe, QuantSpec
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels.act_quant import (act_quant, act_quant_plain,
                                           act_quant_routed_plain)
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


@pytest.mark.parametrize("counts", [[0, 6, 3], [6, 6, 6], [-2, 100, 1]])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_quant_routed_plain_vs_reference(counts, bits, dtype):
    """The grouped W4A8 kernels' quantization step (the routed rows of a
    dispatch buffer) against the reference: the codes and scales of
    ``_quantize_rows`` (the body the reference's ragged kernel fuses) and
    of ``act_quant_ref`` bit for bit, and zero codes and scales at or past
    the counts (clamped to [0, C]) whatever the buffer holds there (data,
    inf, NaN). The reference's ``sa / alpha`` fold is the GEMMs' epilogue
    now, so the step writes ``sa`` itself; without counts every row is
    routed."""
    E, C, K = 3, 6, 256
    rng = np.random.default_rng(31)
    x = (rng.normal(size=(E, C, K)) * 3).astype(np.float32)
    live = np.arange(C)[None, :] < np.clip(counts, 0, C)[:, None]
    dead = np.argwhere(~live)
    if len(dead):
        x[tuple(dead[0])][5] = np.inf
        x[tuple(dead[-1])][7] = np.nan
    xj = jnp.asarray(x).astype(dtype)
    tx = _t(xj.astype(jnp.float32)).to(getattr(torch, dtype))
    q, sa = act_quant_routed_plain(tx, torch.tensor(counts, dtype=torch.int32),
                                   bits)
    assert sa.shape == (E, C, 1)
    q_r, s_r = jact._quantize_rows(xj.reshape(E * C, K),
                                   qm=float(2 ** (bits - 1) - 1))
    q_o, s_o = JR.act_quant_ref(xj.reshape(E * C, K), bits=bits)
    q_r, q_o = (np.asarray(a).reshape(E, C, K) for a in (q_r, q_o))
    s_r, s_o = (np.asarray(a).reshape(E, C) for a in (s_r, s_o))
    np.testing.assert_array_equal(q_r[live], q_o[live])
    np.testing.assert_array_equal(s_r[live], s_o[live])
    np.testing.assert_array_equal(q.numpy(), np.where(live[..., None], q_r, 0))
    np.testing.assert_array_equal(sa[..., 0].numpy(), np.where(live, s_r, 0.0))
    assert not np.signbit(sa.numpy()).any()
    q2, s2 = act_quant_routed_plain(tx, None, bits)
    np.testing.assert_array_equal(q2.numpy()[live], q_o[live])
    np.testing.assert_array_equal(s2[..., 0].numpy()[live], s_o[live])


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
    ("act_quant", "act_quant_routed_launch", "act_quant:_ROUTED_ARGS"),
    ("w4a8_gemm_is", "w4a8_gemm_is_launch", "w4a8_gemm"),
    ("flash_attention", "flash_attention_launch", "flash_attention"),
    ("flash_attention_bwd", "flash_attention_bwd_launch",
     "flash_attention:_BWD_ARGS"),
    ("w4a8_gemm_fs", "w4a8_gemm_fs_launch", "w4a8_gemm_fscale"),
    ("w4a16_gemm", "w4a16_gemm_launch", "w4a16_gemm"),
    ("moe_w4a8_is", "moe_w4a8_is_launch", "moe_gemm:_IS_ARGS"),
    ("moe_w4a8_fs", "moe_w4a8_fs_launch", "moe_gemm:_FS_ARGS"),
    ("moe_w4a16", "moe_w4a16_launch", "moe_gemm:_WO_ARGS"),
])
def test_ctypes_argtypes_match_c_signatures(name, symbol, module):
    """The CUDA sources cannot compile here; hold each wrapper's declared
    ctypes argtypes (``module:attribute``, default ``_ARGS``) to the C
    entry point's parameter list instead."""
    import ctypes
    import importlib
    import re

    src = (_build.CSRC / f"{name}.cu").read_text()
    sig = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src).group(1)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    params = [re.sub(r"\s", "", re.sub(r"\bconst\b|\w+\s*$", "", p))
              for p in sig.split(",")]
    module, _, attr = module.partition(":")
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    assert getattr(mod, attr or "_ARGS") == [kinds[p] for p in params]
    assert name in _build.KERNELS


def _cu_constant(name: str, symbol: str) -> int:
    """An integer constexpr of csrc/<name> (``.cu`` when no suffix)."""
    import re

    src = (_build.CSRC / (name if "." in name else f"{name}.cu")).read_text()
    return int(re.search(rf"\b{symbol} = (\d+)", src).group(1))


# LLaMA-2-7B's linears (K, N) at decode (M 1..4) and the 128-token prefill
LLAMA_GEMMS = [(M, K, N) for M in (1, 2, 3, 4, 128)
               for K, N in ((4096, 4096), (4096, 11008), (11008, 4096))]


def _w4a16_blocks_and_ranges(plan: dict, M: int, N: int, K: int):
    """Blocks of the W4A16 launch and the packing units [u0, u1) of each
    split, as csrc/w4a16_ring.cuh computes them from the plan."""
    bn = _cu_constant("w4a16_ring.cuh", "BN")
    units, splits = K // 128, plan["splits"]
    blocks = -(-N // bn) * -(-M // plan["bm"]) * splits
    return blocks, [(z * units // splits, (z + 1) * units // splits)
                    for z in range(splits)]


@pytest.mark.parametrize("M,K,N", LLAMA_GEMMS)
def test_w4a16_launch_plan_fills_the_card(M, K, N):
    """The K split of the W4A16 kernel on an H100 (132 SMs): at least one
    block per SM, splits on packing-unit boundaries that cover K exactly
    once (K = 11008 is 86 units), and the f32 workspace of the splits."""
    from repro_torch.kernels import w4a8_gemm as w

    assert w.TILE_N == _cu_constant("w4a16_ring.cuh", "BN")
    plan = w.launch_plan(M, N, K, sms=132)
    assert plan["bm"] == (16 if M <= 16 else 64)
    blocks, ranges = _w4a16_blocks_and_ranges(plan, M, N, K)
    assert blocks >= 132
    assert ranges[0][0] == 0 and ranges[-1][1] == K // 128
    assert all(a < b for a, b in ranges)  # no empty split
    assert all(r[1] == n[0] for r, n in zip(ranges, ranges[1:]))
    assert plan["workspace"] == (plan["splits"] * M * N
                                 if plan["splits"] > 1 else 0)


@pytest.mark.parametrize("M,K,N,sms", [(1, 128, 64, 132), (3, 384, 80, 132),
                                       (200, 4096, 11008, 132),
                                       (4, 11008, 4096, 16)])
def test_w4a16_launch_plan_edges(M, K, N, sms):
    """One packing unit cannot split; a partial column tile counts as a
    block; many row tiles or few SMs need no split."""
    from repro_torch.kernels import w4a8_gemm as w

    plan = w.launch_plan(M, N, K, sms=sms)
    units = K // 128
    assert 1 <= plan["splits"] <= min(units, w.MAX_SPLITS)
    blocks, ranges = _w4a16_blocks_and_ranges(plan, M, N, K)
    assert sum(b - a for a, b in ranges) == units
    if units == 1 or blocks // plan["splits"] >= 2 * sms:
        assert plan["splits"] == 1 and plan["workspace"] == 0
    eight = _w4a16_blocks_and_ranges({"bm": 16, "splits": 8}, 4, 4096,
                                     11008)[1]
    assert eight == [(0, 10), (10, 21), (21, 32), (32, 43),
                     (43, 53), (53, 64), (64, 75), (75, 86)]


@pytest.mark.parametrize("B,S,Hq,dtype,blocks", [
    (1, 128, 32, torch.bfloat16, 128), (1, 77, 4, torch.bfloat16, 12),
    (1, 128, 32, torch.float32, 64)])
def test_flash_launch_plan(B, S, Hq, dtype, blocks):
    """The serving prefill (1 x 128 tokens x 32 heads) launches 128 blocks
    of the bf16 kernel (query tile TQ of csrc/flash_attention.cu); the f32
    kernel keeps its 64-row tile (BQ). Each grid is query tiles x B Hq."""
    tile = _cu_constant("flash_attention",
                        "TQ" if dtype == torch.bfloat16 else "BQ")
    assert -(-S // tile) * B * Hq == blocks


def test_cuda_mode_on_cpu_tensor_raises():
    """The tensor's device is the only switch: CPU tensors and ``meta``
    ones (shapes only: the dry-run's) take the plain versions, CUDA
    tensors the kernels, and a tensor on any other device raises. A
    stand-in carrying an ``xpu`` device is that other tensor (this build
    has no such device)."""
    import types

    from repro_torch.kernels.act_quant import act_quant

    spec = QuantSpec(group_size=64)
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(128, 16))
                         .astype(np.float32))
    params = tqlinear.quantize_linear(w, spec)
    assert tqlinear.linear_apply(params, torch.ones(2, 128), spec).shape == \
        (2, 16)
    meta = {k: v.to("meta") for k, v in params.items()}
    y = tqlinear.linear_apply(meta, torch.ones(2, 128, device="meta"), spec)
    assert y.device.type == "meta" and y.shape == (2, 16)
    q = torch.ones((1, 4, 2, 64), device="meta")
    o = flash_attention(q, q, q)
    assert o.device.type == "meta" and o.shape == q.shape
    other = types.SimpleNamespace(device=torch.device("xpu"),
                                  requires_grad=False)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(other, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        act_quant(other)


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


# -- the dense W4A8 loop (csrc/w4a8_ring.cuh) and the shared launch plan ----


@pytest.mark.parametrize("M,K,N", LLAMA_GEMMS)
def test_w4a8_launch_plan_splits_on_packing_units(M, K, N):
    """The dense IS and FS GEMMs take the one launch plan of every GEMM
    kernel: at least one block per SM of an H100, splits on packing-unit
    boundaries that cover K once, so at g128 every split boundary is a
    group boundary; the column tile is the loop's BN."""
    from repro_torch.kernels import w4a8_gemm as w

    assert w.TILE_N == _cu_constant("w4a8_ring.cuh", "BN")
    assert w.MAX_GROUP == 1 << 16  # MAX_GS = 1 << 16 in the loop
    assert "MAX_GS = 1 << 16" in (_build.CSRC / "w4a8_ring.cuh").read_text()
    plan = w.launch_plan(M, N, K, sms=132)
    blocks, ranges = _w4a16_blocks_and_ranges(plan, M, N, K)
    assert blocks >= 132
    assert ranges[0][0] == 0 and ranges[-1][1] == K // 128
    assert all(a < b for a, b in ranges)
    assert plan["workspace"] == (plan["splits"] * M * N
                                 if plan["splits"] > 1 else 0)


@pytest.mark.parametrize("C", [8, 40])
@pytest.mark.parametrize("K,N", [(4096, 14336), (14336, 4096)])
def test_grouped_w4a16_launch_plan(C, K, N):
    """Mixtral-8x7B's expert linears (8 experts) at the decode and the
    prefill capacity: the experts count as blocks, so the grouped W4A16
    kernel fills an H100 (132 SMs) at least twice over unsplit."""
    from repro_torch.kernels.w4a8_gemm import launch_plan

    plan = launch_plan(C, N, K, sms=132, experts=8)
    assert plan == {"bm": 16 if C <= 16 else 64, "splits": 1,
                    "workspace": 0}
    assert -(-N // 64) * -(-C // plan["bm"]) * 8 >= 2 * 132
    # a small grouped launch does split, and its workspace holds every
    # expert's rows
    small = launch_plan(C, 128, 512, sms=132, experts=3)
    assert small["splits"] == 4 and small["workspace"] == 4 * 3 * C * 128


@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("C", [8, 40])
@pytest.mark.parametrize("K,N", [(4096, 14336), (14336, 4096)])
def test_grouped_w4a8_launch_plan(C, K, N, w_bits):
    """Mixtral-8x7B's expert linears through the grouped W4A8 kernels on an
    H100 (132 SMs): unsplit (the 8 experts count as blocks), row tile 16
    at the decode capacity and 64 at the prefill one, so one m-tile an
    expert streams its weights once; the loop's dynamic shared memory at
    that tile (W8 stages 128 weight rows a unit) fits a block. A forced
    split, the card tests' way onto the split path, covers K once and
    its workspace holds splits x E x C x N; one past K's packing units
    is refused."""
    from repro_torch.kernels.w4a8_gemm import launch_plan

    plan = launch_plan(C, N, K, sms=132, experts=8)
    bm = 16 if C <= 16 else 64
    assert plan == {"bm": bm, "splits": 1, "workspace": 0}
    assert -(-N // 64) * -(-C // bm) * 8 >= 2 * 132
    src = (_build.CSRC / "w4a8_ring.cuh").read_text()
    assert "XS = KU + 16;" in src and "WSB = BN + 16;" in src
    bn, ku, stages, srows = (_cu_constant("w4a8_ring.cuh", k)
                             for k in ("BN", "KU", "STAGES", "SROWS"))
    smem = stages * (bm * (ku + 16) + (ku // 2 if w_bits == 4 else ku)
                     * (bn + 16) + srows * bn * 4)
    assert smem == {(4, 16): 33792, (4, 64): 61440, (8, 16): 54272,
                    (8, 64): 81920}[(w_bits, bm)]
    assert smem <= 232448  # a block's dynamic shared memory on the H100
    forced = launch_plan(C, 128, 512, sms=132, experts=3, splits=3)
    assert forced == {"bm": bm, "splits": 3, "workspace": 3 * 3 * C * 128}
    blocks, ranges = _w4a16_blocks_and_ranges(forced, C, 128, 512)
    assert ranges == [(0, 1), (1, 2), (2, 4)]
    with pytest.raises(ValueError, match="packing units"):
        launch_plan(C, N, 512, sms=132, experts=8, splits=5)


def _to_int8(b: torch.Tensor) -> torch.Tensor:
    """Low byte of each int64 as a signed int8 value."""
    return ((b & 0xFF) ^ 0x80) - 0x80


def test_nibble_times_16_unpack_is_exact():
    """The loop's W4 unpack, in plain integer arithmetic over every int4
    pair: a packed byte (low nibble lo, high nibble hi) masked with 0xF0
    is 16 hi as an int8, and shifted left by 4 then masked, 16 lo. The
    MMA's partial is then 16 x the true one; an arithmetic >> 4 restores
    it, with no int32 overflow for a group of up to 2^16 rows even at the
    extreme codes, and the IS group step at the largest amplifier the
    quantizer admits (its overflow cap) matches the plain int32 sum."""
    from repro_torch.analysis import certify
    from repro_torch.core import integer_scale as isc
    from repro_torch.core import packing, quant

    lo, hi = torch.meshgrid(torch.arange(-8, 8), torch.arange(-8, 8),
                            indexing="ij")
    # pack_int4 puts k and k + 64 of a 128-row unit in one byte
    q = torch.zeros((128, 256), dtype=torch.int8)
    q[0] = lo.reshape(-1)
    q[64] = hi.reshape(-1)
    byte = packing.pack_int4(q)[0].to(torch.int64) & 0xFF
    assert byte.shape == (256,) and len(set(byte.tolist())) == 256
    assert torch.equal(_to_int8(byte & 0xF0), 16 * hi.reshape(-1))
    assert torch.equal(_to_int8((byte << 4) & 0xF0), 16 * lo.reshape(-1))
    del byte

    # the extreme partials of a group of 2^16 rows: |16 w x| <= 2^14
    for w16, x in ((-128, -128), (-128, 127), (112, -128), (112, 127)):
        p16 = torch.tensor(w16 * x * (1 << 16), dtype=torch.int64)
        assert -(1 << 31) <= p16 < (1 << 31)
        assert torch.equal(p16.to(torch.int32) >> 4,
                           torch.tensor(w16 // 16 * x * (1 << 16),
                                        dtype=torch.int32))

    # group sums at the largest admitted alpha: the worst-case activation
    # codes (+-127 with each weight's sign), int32 all the way
    K, N, g = 1024, 64, 128
    rng = np.random.default_rng(12)
    w = torch.from_numpy((rng.normal(size=(K, N)) * 0.05).astype(np.float32))
    qw = quant.quantize_weight(w, 4, g)
    alpha = certify.resolve_amplifier(
        qw.scale.numpy(), alpha=1 << 20, group_size=g,
        w_bits=4).resolved_alpha
    isw = isc.integerize(qw, alpha)
    assert not isc.would_overflow(isw)
    xq = torch.where(qw.qvalue[:, :1] >= 0, 127, -127).T.to(torch.int8)
    x64 = xq.to(torch.int64)
    part16 = torch.stack([  # per group: 16 x the MMA's partial, as int32
        (x64[:, k:k + g] @ (16 * qw.qvalue[k:k + g].to(torch.int64)))
        for k in range(0, K, g)])
    assert part16.abs().max() < (1 << 31)
    acc = torch.sum((part16.to(torch.int32) >> 4) * isw.int_scale[:, None],
                    dim=0, dtype=torch.int32)
    want = fg_gemm_integer_scale_plain(
        xq, torch.ones((1, 1)), packing.pack_int4(qw.qvalue), isw.int_scale,
        group_size=g, alpha=1.0)
    assert torch.equal(acc.float(), want)


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm (PRMT, default mode) on python ints."""
    b = [(x >> 8 * i) & 0xFF for i in range(4)] + \
        [(y >> 8 * i) & 0xFF for i in range(4)]
    return sum(b[(s >> 4 * i) & 7] << 8 * i for i in range(4))


def _transpose4(words: list[int]) -> list[int]:
    """The loop's transpose4, run from its source: every ``v =
    __byte_perm(a, b, s);`` line of the function in order."""
    import re

    src = (_build.CSRC / "w4a8_ring.cuh").read_text()
    body = src[src.index("void transpose4("):]
    body = body[:body.index("\n}\n")]
    env = {f"w[{i}]": v for i, v in enumerate(words)}
    steps = re.findall(r"(\w+(?:\[\d\])?) = __byte_perm\((\w+(?:\[\d\])?), "
                       r"(\w+(?:\[\d\])?), (0x[0-9A-Fa-f]+)\);", body)
    assert len(steps) == 8
    for dst, a, b, sel in steps:
        env[dst] = _byte_perm(env[a], env[b], int(sel, 16))
    return [env[f"o[{f}]"] for f in range(4)]


def test_w4a8_transpose4_builds_the_b_fragments():
    """Four words (rows r..r+3 of columns 4j..4j+3 of a staged unit)
    become four words, word f holding column f's rows r..r+3 in bytes
    0..3: the k-contiguous operand of the int8 MMA."""
    rng = np.random.default_rng(13)
    for _ in range(50):
        rows = rng.integers(0, 256, size=(4, 4))  # [row i][column f]
        words = [int(sum(int(rows[i, f]) << 8 * f for f in range(4)))
                 for i in range(4)]
        out = _transpose4(words)
        for f in range(4):
            assert out[f] == sum(int(rows[i, f]) << 8 * i for i in range(4))


def _ring_emulate(xq, w, scale, gs, splits, mode, kw=2):
    """csrc/w4a8_ring.cuh's accumulation in plain integer and f32 torch
    arithmetic: per split, ``kw`` warps along k (warp kh takes k-steps
    32 kh + 32 kw j of each unit), each stepping its W4 partial (16 x,
    then >> 4) into its accumulator when its next k-step is in another
    group or its split ends; the k-halves summed, then the splits in
    order, then the epilogue. ``mode``: "is" (int32 wrap), "fs" or
    "defer" (one group over all of K: int32 sums first, one float step
    last)."""
    M, K = xq.shape
    units = K // 128
    x64, w64 = xq.to(torch.int64), w.to(torch.int64)

    def wrap(v):
        return ((v + (1 << 31)) % (1 << 32)) - (1 << 31)

    total = None
    for z in range(splits):
        u0, u1 = z * units // splits, (z + 1) * units // splits
        halves = []
        for kh in range(kw):
            acc = torch.zeros((M, w.shape[1]),
                              dtype=torch.float32 if mode == "fs"
                              else torch.int64)
            part = torch.zeros_like(acc, dtype=torch.int64)
            for u in range(u0, u1):
                lr = 128 * u % gs
                for h in range(4 // kw):
                    ka = 32 * kh + 32 * kw * h
                    k = 128 * u + ka
                    part += x64[:, k:k + 32] @ (16 * w64[k:k + 32])
                    assert part.abs().max() < (1 << 31)
                    if mode == "defer":
                        continue
                    grp = (lr + ka) // gs
                    if (grp != (lr + ka + 32 * kw) // gs
                            or (h == 4 // kw - 1 and u == u1 - 1)):
                        s = scale[(128 * u + ka) // gs]
                        p = part >> 4
                        if mode == "is":
                            acc = wrap(acc + p * s.to(torch.int64))
                        else:
                            acc = acc + p.float() * s
                        part = torch.zeros_like(part)
            halves.append(part >> 4 if mode == "defer" else acc)
        split_sum = sum(halves[1:], halves[0])
        total = split_sum if total is None else total + split_sum
        if mode != "fs":
            total = wrap(total)
    return total


@pytest.mark.parametrize("kw", [2, 1])
@pytest.mark.parametrize("g,splits", [(128, 1), (128, 3), (32, 2), (64, 5),
                                      (256, 3), (384, 2), (768, 4)])
def test_w4a8_ring_accumulation_matches_plain(g, splits, kw):
    """The loop's accumulation order against the plain versions, with two
    warps along k (the decode tile) and one (the prefill tile): Integer
    Scale bit-exact for every group size and split, also where a split
    cuts a group (the int32 step is linear mod 2^32); one group over all
    of K (coarse float scale) bit-exact with its int32 sums first; fine
    float scale within rtol 1e-5 / atol 1e-4."""
    M, K, N = 5, 768, 32
    xq, sa, packed, ints, alpha = _gemm_operands(20 + g, M, K, N, g)
    xq, sa, packed, ints = (_t(a) for a in (xq, sa, packed, ints))
    w = jpacking.unpack_int4(jnp.asarray(packed.numpy()))
    w = torch.from_numpy(np.array(w))
    fac = sa.reshape(M) / alpha
    acc = _ring_emulate(xq, w, ints, g, splits, "is", kw)
    y = acc.to(torch.int32).float() * fac[:, None]
    assert torch.equal(y, fg_gemm_integer_scale_plain(
        xq, sa, packed, ints, group_size=g, alpha=alpha))

    rng = np.random.default_rng(g)
    fscale = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(K // g, N))
                              .astype(np.float32))
    y = _ring_emulate(xq, w, fscale, g, splits, "fs", kw) * sa
    torch.testing.assert_close(y, fg_gemm_float_scale_plain(
        xq, sa, packed, fscale, group_size=g), **FS_TOL)

    cscale = fscale[:1]
    p = _ring_emulate(xq, w, cscale, K, splits, "defer", kw).to(torch.int32)
    y = (p.float() * cscale) * sa
    assert torch.equal(y, fg_gemm_float_scale_plain(
        xq, sa, packed, cscale, group_size=-1))


def _expert_operands(seed, E, K, N, g):
    """Per-expert W4 RTN weights through the reference quantizer (a
    magnitude spread so the heuristic amplifiers differ): packed codes,
    their unpacked int8 values, integer and f32 group scales, alphas, and
    one per-channel scale row an expert for the coarse scheme."""
    rng = np.random.default_rng(seed)
    packed, codes, iscale, fscale, alphas = [], [], [], [], []
    for e in range(E):
        w = rng.normal(size=(K, N)).astype(np.float32) * 0.05 * 4.0 ** (e % 3)
        qw = jquant.quantize_weight(jnp.asarray(w), 4, g)
        isw = jisc.integerize(qw, "heuristic+6")
        packed.append(np.asarray(jpacking.pack_int4(qw.qvalue)))
        codes.append(np.asarray(qw.qvalue))
        iscale.append(np.asarray(isw.int_scale))
        fscale.append(np.asarray(qw.scale))
        alphas.append(float(isw.alpha))
    return (_t(np.stack(packed)), _t(np.stack(codes)), _t(np.stack(iscale)),
            _t(np.stack(fscale)), torch.tensor(alphas, dtype=torch.float32))


@pytest.mark.parametrize("C", [8, 24])
@pytest.mark.parametrize("g,splits", [(128, 1), (128, 6), (256, 4),
                                      (384, 5), (64, 3)])
def test_grouped_w4a8_ring_emulation_matches_ragged_plain(g, splits, C):
    """The grouped launch of csrc/w4a8_ring.cuh in plain arithmetic: the
    routed rows quantized once (``act_quant_routed_plain``: codes and
    ``sa``), then per expert the loop's accumulation
    (``_ring_emulate``, two warps along k at the decode tile C = 8, one at
    the prefill tile) over its routed rows only, the splits added in order
    (also where a split cuts a group), the epilogue (its factor ``sa /
    alpha[e]`` for Integer Scale, ``sa`` for float scale), and +0.0 at
    every row at or past its count, whatever the buffer holds there.
    Integer Scale and coarse float scale bit-exact against
    ``fg_grouped_gemm_*_ragged_plain``, fine float scale within rtol 1e-5
    / atol 1e-4."""
    from repro_torch.kernels.w4a8_gemm import pick_tile_m

    E, K, N = 4, 768, 32
    kw = 2 if pick_tile_m(C) == 16 else 1
    counts = torch.tensor([-1, C, 5, 100], dtype=torch.int32)
    rc = counts.clamp(0, C).tolist()
    packed, codes, iscale, fscale, alphas = _expert_operands(40 + g, E, K,
                                                             N, g)
    rng = np.random.default_rng(g + C)
    x = torch.from_numpy(rng.normal(size=(E, C, K)).astype(np.float32))
    x[0, 1, 3] = float("nan")  # past the counts: data, NaN and inf
    x[2, C - 1] = float("inf")
    cscale = fscale[:, :1]

    def emulate(mode, scale, gs, alpha):
        xq, sa = act_quant_routed_plain(x, counts)
        fac = sa[..., 0] if alpha is None else sa[..., 0] / alpha[:, None]
        y = torch.zeros((E, C, N))
        for e, r in enumerate(rc):
            if r == 0:
                continue
            acc = _ring_emulate(xq[e, :r], codes[e], scale[e], gs, splits,
                                mode, kw)
            if mode == "is":
                y[e, :r] = acc.to(torch.int32).float() * fac[e, :r, None]
            elif mode == "fs":
                y[e, :r] = acc * fac[e, :r, None]
            else:
                y[e, :r] = (acc.to(torch.int32).float() * scale[e]) \
                    * fac[e, :r, None]
        return y

    got = {
        "is": emulate("is", iscale, g, alphas),
        "fs": emulate("fs", fscale, g, None),
        "coarse": emulate("defer", cscale, K, None),
    }
    want = {
        "is": mg.fg_grouped_gemm_integer_scale_ragged_plain(
            x, counts, packed, iscale, group_size=g, alpha=alphas),
        "fs": mg.fg_grouped_gemm_float_scale_ragged_plain(
            x, counts, packed, fscale, group_size=g),
        "coarse": mg.fg_grouped_gemm_float_scale_ragged_plain(
            x, counts, packed, cscale, group_size=-1),
    }
    for mode in ("is", "coarse"):
        assert torch.equal(got[mode], want[mode]), mode
    torch.testing.assert_close(got["fs"], want["fs"], **FS_TOL)
    for y in (*got.values(), *want.values()):
        for e, r in enumerate(rc):
            assert not y[e, r:].any() and not torch.signbit(y[e, r:]).any()
        assert y[1].any() and torch.isfinite(y).all()


def _linears(specs):
    """Param-less ``Linear`` modules under ``specs`` (None: bf16)."""
    from repro_torch.models.common import Linear

    return [Linear(None if s is None else QuantRecipe(rules=(("*", s),)),
                   "l", {}) for s in specs]


SHARED_SPECS = {  # case -> (the specs of the linears reading x, a_bits or
    # None where each linear quantizes its own)
    "q/k/v IS": ([QuantSpec()] * 3, 8),
    "IS and FS": ([QuantSpec(), QuantSpec(scale_mode="float")], 8),
    "IS and coarse": ([QuantSpec(), QuantSpec(group_size=-1)], 8),
    "W4A4": ([QuantSpec(a_bits=4)] * 2, 4),
    "one in bf16": ([QuantSpec(), None], None),
    "one weight-only": ([QuantSpec(), QuantSpec(a_bits=16)], None),
    "other a_bits": ([QuantSpec(), QuantSpec(a_bits=4)], None),
}


@pytest.mark.parametrize("case", sorted(SHARED_SPECS))
@pytest.mark.parametrize("grouped", [False, True])
def test_quantize_for_shares_only_alike_specs(case, grouped):
    """``ops.quantize_for`` quantizes once where every linear quantizes
    its activation alike (the same ``a_bits``; IS, FS and coarse alike),
    with exactly the codes and scales of ``act_quant`` (dense, over the
    rows of a (B, S, K) activation) or of its routed entry (grouped, zero
    past the counts); None where one linear is bf16, weight-only or reads
    other bits."""
    specs, bits = SHARED_SPECS[case]
    rng = np.random.default_rng(51)
    x = torch.from_numpy(rng.normal(size=(3, 5, 256)).astype(np.float32))
    counts = torch.tensor([0, 5, 2], dtype=torch.int32)
    got = (ops.quantize_for(x, _linears(specs), grouped=True,
                            row_counts=counts)
           if grouped else ops.quantize_for(x, _linears(specs)))
    if bits is None:
        assert got is None
        return
    want = (act_quant_routed_plain(x, counts, bits) if grouped
            else act_quant_plain(x.reshape(15, 256), bits))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scheme", ["is", "fs", "coarse", "w8a8-is"])
def test_qgemm_takes_shared_codes_bit_for_bit(scheme):
    """``qgemm`` and ``qgemm_grouped`` on the codes ``quantize_for`` made
    equal the same calls quantizing their own, bit for bit (the stored
    alphas divided in the epilogue either way); codes of another shape
    than x raise."""
    spec = {"is": QuantSpec(), "fs": QuantSpec(scale_mode="float"),
            "coarse": QuantSpec(group_size=-1),
            "w8a8-is": QuantSpec(w_bits=8, amplifier="heuristic+6")}[scheme]
    rng = np.random.default_rng(52)
    w = torch.from_numpy((rng.normal(size=(3, 256, 64)) * 0.05)
                         .astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(3, 8, 256)).astype(np.float32))
    counts = torch.tensor([8, 0, 5], dtype=torch.int32)
    dense = tqlinear.quantize_linear(w[0], spec)
    xq = ops.quantize_for(x[0], _linears([spec, spec]))
    assert torch.equal(ops.qgemm(x[0], dense, spec, xq=xq),
                       ops.qgemm(x[0], dense, spec))
    stack = tqlinear.quantize_experts(w, spec)
    gq = ops.quantize_for(x, _linears([spec]), grouped=True,
                          row_counts=counts)
    assert torch.equal(
        ops.qgemm_grouped(x, stack, spec, row_counts=counts, xq=gq),
        ops.qgemm_grouped(x, stack, spec, row_counts=counts))
    with pytest.raises(ValueError, match="do not match"):
        ops.qgemm(x[0, :4], dense, spec, xq=xq)
