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
The CPU side of the same wrappers is tested against the JAX reference in
``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import integer_scale as isc
from repro_torch.core import packing, qlinear, quant
from repro_torch.core.recipe import QuantSpec
from repro_torch.kernels import _build, ops
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
