"""The Hopper kernels against their plain PyTorch versions, on a GPU.

Every test here needs a CUDA device (``cuda`` marker) and skips without
one: a CUDA kernel has no CPU mode. The file imports no JAX, so it runs on
a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances: ``act_quant`` and the IS GEMM (W4 and W8, every row tile) are
bit-exact to their plain versions; so is the coarse float-scale GEMM (one
int32 sum, then the same two multiplies). The fine float-scale GEMM sums
its f32 group terms in another order than ``torch.sum``: rtol 1e-5, atol
1e-4. W4A16 dequantizes bit-identically and differs only in the f32 sum
order: max abs diff <= ``w4a16_gemm.REL_TOLERANCE`` x max|plain|, with TF32
off. Flash attention in bf16 is held to ``flash_attention.TOLERANCE``.
The grouped (MoE) kernels keep the same bounds against their plain
versions, and the ragged entry points equal the dense-grouped ones bit for
bit on a buffer zero-filled past the counts. The CPU side of the same
wrappers is tested against the JAX reference in
``tests/test_torch_kernels.py`` and ``tests/test_torch_moe.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import integer_scale as isc
from repro_torch.core import packing, qlinear, quant
from repro_torch.core.recipe import QuantSpec
from repro_torch.kernels import _build, moe_gemm, ops
from repro_torch.kernels.act_quant import act_quant, act_quant_plain
from repro_torch.kernels.flash_attention import (TOLERANCE, flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.w4a16_gemm import (REL_TOLERANCE, w4a16_gemm,
                                            w4a16_gemm_plain)
from repro_torch.kernels.w4a8_gemm import (fg_gemm_integer_scale,
                                           fg_gemm_integer_scale_plain)
from repro_torch.kernels.w4a8_gemm_fscale import (fg_gemm_float_scale,
                                                  fg_gemm_float_scale_plain)

SHAPES = [  # (M, K, N, group): tests/test_kernels.py, plus a LLaMA-2-7B layer
    (1, 256, 128, 128),
    (7, 512, 256, 128),
    (48, 1024, 512, 128),
    (16, 512, 384, 256),
    (128, 384, 128, 128),
    (4, 4096, 11008, 128),
]


@pytest.fixture
def cuda():
    """Decided per test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _normal(seed, shape, scale=1.0, device="cpu"):
    a = np.random.default_rng(seed).normal(size=shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(1, 128), (5, 384), (128, 4096),
                                 (4, 11008)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quant_kernel_bit_exact(cuda, M, K, dtype):
    x = (_normal(M * K, (M, K), 3.0, cuda)).to(dtype)
    before = _build.LAUNCHES["act_quant"]
    q, s = act_quant(x)
    q_p, s_p = act_quant_plain(x)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    assert _build.LAUNCHES["act_quant"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,g", SHAPES)
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("bm", [0, 16, 64])
def test_is_gemm_kernel_bit_exact(cuda, M, K, N, g, w_bits, bm):
    qw = quant.quantize_weight(_normal(0, (K, N), 0.05, cuda), w_bits, g)
    xq, sa = quant.quantize_activation(_normal(1, (M, K), 1.0, cuda))
    isw = isc.integerize(qw, 1024 if w_bits == 4 else "heuristic+6")
    w = packing.pack_int4(qw.qvalue) if w_bits == 4 else qw.qvalue
    y = fg_gemm_integer_scale(xq, sa, w, isw.int_scale, group_size=g,
                              alpha=float(isw.alpha), w_bits=w_bits, bm=bm)
    y_p = fg_gemm_integer_scale_plain(xq, sa, w, isw.int_scale,
                                      group_size=g, alpha=float(isw.alpha),
                                      w_bits=w_bits)
    assert torch.equal(y, y_p)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,g", SHAPES + [(3, 512, 256, -1),
                                              (128, 11008, 4096, -1)])
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("bm", [0, 16, 64])
def test_fs_gemm_kernel_vs_plain(cuda, M, K, N, g, w_bits, bm):
    qw = quant.quantize_weight(_normal(0, (K, N), 0.05, cuda), w_bits, g)
    xq, sa = quant.quantize_activation(_normal(1, (M, K), 1.0, cuda))
    w = packing.pack_int4(qw.qvalue) if w_bits == 4 else qw.qvalue
    scale = qw.scale if g > 0 else qw.scale[None, :]
    before = _build.LAUNCHES["w4a8_gemm_fs"]
    y = fg_gemm_float_scale(xq, sa, w, scale, group_size=g, w_bits=w_bits,
                            bm=bm)
    y_p = fg_gemm_float_scale_plain(xq, sa, w, scale, group_size=g,
                                    w_bits=w_bits)
    assert _build.LAUNCHES["w4a8_gemm_fs"] == before + 1
    if g < 0:
        assert torch.equal(y, y_p)  # coarse: the plain arithmetic exactly
    else:
        torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,g", SHAPES + [(2, 256, 64, 64)])
@pytest.mark.parametrize("bm", [0, 16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w4a16_kernel_vs_plain(cuda, M, K, N, g, bm, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 product
    qw = quant.quantize_weight(_normal(0, (K, N), 0.05, cuda), 4, g)
    x = _normal(1, (M, K), 1.0, cuda).to(dtype)
    w = packing.pack_int4(qw.qvalue)
    y = w4a16_gemm(x, w, qw.scale, group_size=g, bm=bm)
    y_p = w4a16_gemm_plain(x, w, qw.scale, group_size=g)
    assert y.dtype == torch.float32 and y.shape == (M, N)
    err = (y - y_p).abs().max().item()
    assert err <= REL_TOLERANCE * y_p.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("spec,kernel", [
    (QuantSpec(), "w4a8_gemm_is"),
    (QuantSpec(scale_mode="float"), "w4a8_gemm_fs"),
    (QuantSpec(group_size=-1), "w4a8_gemm_fs"),
    (QuantSpec(w_bits=8, scale_mode="float"), "w4a8_gemm_fs"),
    (QuantSpec(a_bits=16), "w4a16_gemm"),
])
def test_qgemm_launches_the_scheme_kernel(cuda, spec, kernel):
    params = qlinear.quantize_linear(_normal(2, (256, 128), 0.05, cuda), spec)
    x = _normal(3, (4, 256), 1.0, cuda).to(torch.bfloat16)
    _build.reset_launches()
    y = ops.qgemm(x, params, spec)
    want = {kernel: 1} if spec.weight_only else {kernel: 1, "act_quant": 1}
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == want
    cpu = {k: v.cpu() for k, v in params.items()}
    y_p = ops.qgemm(x.cpu(), cpu, spec)
    torch.testing.assert_close(y.cpu(), y_p, rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_w8a16_raises_on_the_card(cuda):
    spec = QuantSpec(w_bits=8, a_bits=16)
    params = qlinear.quantize_linear(_normal(2, (256, 128), 0.05, cuda), spec)
    with pytest.raises(NotImplementedError, match="W4A16"):
        ops.qgemm(torch.ones((2, 256), device=cuda), params, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", [
    (1, 128, 32, 32, 128, None), (2, 200, 8, 2, 128, 64),
    (1, 77, 4, 1, 64, None)])
def test_flash_kernel_vs_plain(cuda, B, S, Hq, Hkv, D, window):
    q, k, v = (_normal(i, (B, S, h, D), 1.0, cuda).to(torch.bfloat16)
               for i, h in enumerate((Hq, Hkv, Hkv)))
    out = flash_attention(q, k, v, window=window)
    ref = flash_attention_plain(q, k, v, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= TOLERANCE


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x8 = torch.zeros((2, 192), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        fg_gemm_integer_scale(
            x8, torch.ones((2, 1), device=cuda),
            torch.zeros((96, 8), dtype=torch.int8, device=cuda),
            torch.ones((3, 8), dtype=torch.int32, device=cuda),
            group_size=64)
    with pytest.raises(ValueError, match="multiple of 128"):
        w4a16_gemm(torch.zeros((2, 192), device=cuda),
                   torch.zeros((96, 8), dtype=torch.int8, device=cuda),
                   torch.ones((3, 8), device=cuda), group_size=64)
    with pytest.raises(ValueError, match="multiple of 32"):
        fg_gemm_float_scale(
            torch.zeros((2, 256), dtype=torch.int8, device=cuda),
            torch.ones((2, 1), device=cuda),
            torch.zeros((128, 8), dtype=torch.int8, device=cuda),
            torch.ones((16, 8), device=cuda), group_size=16)
    q = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        flash_attention(q, q, q)  # head_dim 32 has no instantiation


# -- the grouped (MoE) kernels -------------------------------------------------
# (E, C, K, N, g, counts): an empty expert, counts not a multiple of the row
# tile, every expert at capacity, C below the decode tile (Mixtral's decode
# capacity 8) and not a multiple of the prefill tile (its prefill capacity
# 40), and K = 14336 (Mixtral's down projection: the fused act-quant cannot
# hold the row slab in shared memory)
GROUPED = [
    (3, 24, 256, 128, 128, [0, 13, 24]),
    (3, 24, 256, 128, 128, [5, 13, 21]),
    (3, 24, 512, 256, 128, [24, 24, 24]),
    (8, 8, 512, 192, 128, [0, 8, 1, 3, 0, 2, 4, 7]),
    (4, 40, 384, 128, 128, [40, 0, 17, 39]),
    (2, 40, 14336, 128, 128, [33, 5]),
]


def _grouped_operands(cuda, E, C, K, N, g, counts, w_bits=4,
                      dtype=torch.bfloat16):
    """Per-expert RTN weights (packed codes, f32 and integer scales with
    per-expert alphas) and a raw dispatch buffer zero-filled past counts."""
    packed, fscale, iscale, alphas = [], [], [], []
    for e in range(E):
        w = _normal(100 + e, (K, N), 0.05 * 4.0 ** (e % 3), cuda)
        qw = quant.quantize_weight(w, w_bits, g)
        isw = isc.integerize(qw, "heuristic+6")
        packed.append(packing.pack_int4(qw.qvalue) if w_bits == 4
                      else qw.qvalue)
        fscale.append(qw.scale)
        iscale.append(isw.int_scale)
        alphas.append(float(isw.alpha))
    x = _normal(7, (E, C, K), 1.0, cuda)
    live = torch.arange(C, device=cuda)[None, :] < torch.tensor(
        counts, device=cuda)[:, None]
    x = torch.where(live[..., None], x, 0.0).to(dtype)
    return (x, torch.tensor(counts, dtype=torch.int32, device=cuda),
            torch.stack(packed), torch.stack(fscale), torch.stack(iscale),
            torch.tensor(alphas, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,K,N,g,counts", GROUPED)
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("bm", [0, 16, 64])
def test_grouped_is_kernel_bit_exact_and_ragged_equals_dense(
        cuda, E, C, K, N, g, counts, w_bits, bm):
    x, rc, qv, _, iscale, alpha = _grouped_operands(cuda, E, C, K, N, g,
                                                    counts, w_bits)
    assert len(set(alpha.tolist())) > 1  # per-expert amplifiers
    before = _build.LAUNCHES["moe_w4a8_is"]
    y = moe_gemm.fg_grouped_gemm_integer_scale_ragged(
        x, rc, qv, iscale, group_size=g, alpha=alpha, w_bits=w_bits, bm=bm)
    y_p = moe_gemm.fg_grouped_gemm_integer_scale_ragged_plain(
        x, rc, qv, iscale, group_size=g, alpha=alpha, w_bits=w_bits)
    assert torch.equal(y, y_p)
    xq, sa = act_quant_plain(x.reshape(E * C, K))
    y_d = moe_gemm.fg_grouped_gemm_integer_scale(
        xq.reshape(E, C, K), sa.reshape(E, C, 1), qv, iscale, group_size=g,
        alpha=alpha, w_bits=w_bits, bm=bm)
    assert torch.equal(y, y_d)  # ragged == dense grouped on zero padding
    assert _build.LAUNCHES["moe_w4a8_is"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,K,N,g,counts", GROUPED)
@pytest.mark.parametrize("g_mode", ["fine", "coarse"])
@pytest.mark.parametrize("w_bits", [4, 8])
def test_grouped_fs_kernel_vs_plain_and_ragged_equals_dense(
        cuda, E, C, K, N, g, counts, g_mode, w_bits):
    gs = g if g_mode == "fine" else -1
    x, rc, _, _, _, _ = _grouped_operands(cuda, E, C, K, N, g, counts)
    qs = [quant.quantize_weight(_normal(200 + e, (K, N), 0.05, cuda), w_bits,
                                gs) for e in range(E)]
    qv = torch.stack([packing.pack_int4(q.qvalue) if w_bits == 4
                      else q.qvalue for q in qs])
    scale = torch.stack([q.scale if gs > 0 else q.scale[None, :]
                         for q in qs])
    y = moe_gemm.fg_grouped_gemm_float_scale_ragged(
        x, rc, qv, scale, group_size=gs, w_bits=w_bits)
    y_p = moe_gemm.fg_grouped_gemm_float_scale_ragged_plain(
        x, rc, qv, scale, group_size=gs, w_bits=w_bits)
    if gs < 0:
        assert torch.equal(y, y_p)  # coarse: the plain arithmetic exactly
    else:
        torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-4)
    xq, sa = act_quant_plain(x.reshape(E * C, K))
    y_d = moe_gemm.fg_grouped_gemm_float_scale(
        xq.reshape(E, C, K), sa.reshape(E, C, 1), qv, scale, group_size=gs,
        w_bits=w_bits)
    assert torch.equal(y, y_d)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,K,N,g,counts", GROUPED)
@pytest.mark.parametrize("bm", [0, 16, 64])
def test_grouped_w4a16_kernel_vs_plain_and_ragged_equals_dense(
        cuda, E, C, K, N, g, counts, bm):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 product
    x, rc, qv, fscale, _, _ = _grouped_operands(cuda, E, C, K, N, g, counts)
    y = moe_gemm.grouped_w4a16_gemm_ragged(x, rc, qv, fscale, group_size=g,
                                           bm=bm)
    y_p = moe_gemm.grouped_w4a16_gemm_ragged_plain(x, rc, qv, fscale,
                                                   group_size=g)
    err = (y - y_p).abs().max().item()
    assert err <= REL_TOLERANCE * y_p.abs().max().item(), err
    y_d = moe_gemm.grouped_w4a16_gemm(x, qv, fscale, group_size=g, bm=bm)
    assert torch.equal(y, y_d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_kernels_zero_past_counts_and_clamp(cuda, dtype):
    """Rows past the counts are exact zeros even when the buffer holds
    data there; counts above C act as C, negative ones as 0; None is all
    C (the reference's ragged contracts)."""
    E, C, K, N, g = 3, 24, 256, 128, 128
    x, _, qv, fscale, iscale, alpha = _grouped_operands(
        cuda, E, C, K, N, g, [C] * E, dtype=dtype)
    for fn, w in ((lambda rc: moe_gemm.fg_grouped_gemm_integer_scale_ragged(
                       x, rc, qv, iscale, group_size=g, alpha=alpha), iscale),
                  (lambda rc: moe_gemm.fg_grouped_gemm_float_scale_ragged(
                      x, rc, qv, fscale, group_size=g), fscale),
                  (lambda rc: moe_gemm.grouped_w4a16_gemm_ragged(
                      x, rc, qv, fscale, group_size=g), fscale)):
        counts = torch.tensor([9, 0, 100], dtype=torch.int32, device=cuda)
        y = fn(counts)
        assert not y[0, 9:].any() and not y[1].any() and y[0, :9].any()
        assert torch.equal(y[2], fn(None)[2])
        assert torch.equal(fn(torch.tensor([-3, 24, 24], device=cuda)),
                           fn(torch.tensor([0, 24, 24], device=cuda)))


@pytest.mark.cuda
def test_grouped_kernel_reads_counts_on_the_device(cuda):
    """The wrapper never reads the counts on the host: a CUDA graph captured
    once follows counts written in place before each replay."""
    E, C, K, N, g = 4, 8, 256, 128, 128
    x, _, qv, _, iscale, alpha = _grouped_operands(cuda, E, C, K, N, g,
                                                   [C] * E)
    rc = torch.zeros(E, dtype=torch.int32, device=cuda)
    moe_gemm.fg_grouped_gemm_integer_scale_ragged(  # build + load outside
        x, rc, qv, iscale, group_size=g, alpha=alpha)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = moe_gemm.fg_grouped_gemm_integer_scale_ragged(
            x, rc, qv, iscale, group_size=g, alpha=alpha)
    for counts in ([0, 8, 3, 5], [8, 0, 0, 1]):
        rc.copy_(torch.tensor(counts, dtype=torch.int32))
        graph.replay()
        want = moe_gemm.fg_grouped_gemm_integer_scale_ragged_plain(
            x, rc, qv, iscale, group_size=g, alpha=alpha)
        assert torch.equal(y, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["w4a8-is", "w4a8-fs", "w4a16-fg"])
def test_moe_model_on_the_card_matches_plain_and_captures(cuda, name):
    """The smoke Mixtral on the card: logits within 2e-2 of the largest
    against the same weights on the CPU (plain versions); the grouped
    kernel of the recipe launched; a decode step captured as a CUDA graph
    (no host sync in the MoE layer) replays the eager step's logits."""
    from repro_torch.core import ptq
    from repro_torch.core.recipe import (DEFAULT_RECIPE, FLOAT_SCALE_RECIPE,
                                         WEIGHT_ONLY_RECIPE)
    from repro_torch.models.registry import get_arch, get_model
    from repro_torch.nn import spec as S

    recipe = {r.name: r for r in (DEFAULT_RECIPE, FLOAT_SCALE_RECIPE,
                                  WEIGHT_ONLY_RECIPE)}[name]
    kernel = {"w4a8-is": "moe_w4a8_is", "w4a8-fs": "moe_w4a8_fs",
              "w4a16-fg": "moe_w4a16"}[name]
    cfg = get_arch("mixtral-8x7b", smoke=True)
    api = get_model(cfg)
    params = ptq.quantize_by_layer(api, cfg, recipe, device=cuda)
    model = api.build(cfg, params, recipe)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 16))).to(cuda)
    _build.reset_launches()
    with torch.inference_mode():
        got = model(toks)[0]
    assert _build.LAUNCHES[kernel] == 2 * 3  # 2 MoE layers x 3 linears
    cpu = api.build(cfg, S.tree_map(lambda t: t.cpu(), params), recipe)
    with torch.inference_mode():
        want = cpu(toks.cpu())[0]
    rel = ((got.cpu() - want).abs().max() / want.abs().max()).item()
    assert rel <= 2e-2, rel

    cache = S.materialize(api.cache_specs(cfg, 4, 32), device=cuda)
    last = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (4, 1))).to(cuda)
    pos = torch.tensor([3, 7, 0, 12], device=cuda)
    with torch.inference_mode():
        eager = model(last, mode="decode", cache=cache, pos=pos)[0]
        side = torch.cuda.Stream()  # warm up off the capture stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model(last, mode="decode", cache=cache, pos=pos)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = model(last, mode="decode", cache=cache, pos=pos)[0]
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)
