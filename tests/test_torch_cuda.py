"""The Hopper kernels against their plain PyTorch versions, on a GPU.

Every test here needs a CUDA device (``cuda`` marker) and skips without
one: a CUDA kernel has no CPU mode. The file imports no JAX, so it runs on
a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances: ``act_quant`` and the IS GEMM (W4 and W8, every row tile) are
bit-exact to their plain versions; flash attention in bf16 is held to
``flash_attention.TOLERANCE``. The CPU side of the same wrappers is tested
against the JAX reference in ``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import integer_scale as isc
from repro_torch.core import packing, quant
from repro_torch.kernels import _build
from repro_torch.kernels.act_quant import act_quant, act_quant_plain
from repro_torch.kernels.flash_attention import (TOLERANCE, flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.w4a8_gemm import (fg_gemm_integer_scale,
                                           fg_gemm_integer_scale_plain)

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
    q = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        flash_attention(q, q, q)  # head_dim 32 has no instantiation
