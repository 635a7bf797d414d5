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
off. Flash attention (bf16 and f32) is held to
``flash_attention.TOLERANCE``. The IS and coarse FS GEMMs stay bit-exact
at every K split (forced through ``w4a8_gemm.launch_ring``), and the
dense GEMMs, grouped W4A16 and bf16 flash attention give the same bits
on repeated launches. The grouped (MoE)
kernels keep the same bounds against their plain versions, at every
forced K split for W4A8, and the ragged entry points equal the
dense-grouped ones bit for bit on a buffer zero-filled past the counts;
rows past the counts are +0.0 whatever the buffer holds there, and the
counts are read on the device (CUDA-graph replays). The routed-row
quantization the grouped W4A8 kernels launch first is bit-exact to its
plain version. The CPU side of the same
wrappers is tested against the JAX reference in
``tests/test_torch_kernels.py`` and ``tests/test_torch_moe.py``.

The serving engine's captured steps (``serving/graphs.py``), on the smoke
LLaMA-2-7B and Mixtral: its greedy streams equal :func:`eager_greedy`, a
plain eager loop over the same model, bit for bit; each step is captured
once across ticks and slots, and once more after a breaker fallback;
the MoE m-tile counters under replay equal an eager run's; a quarantined
slot reused serves a fresh engine's tokens; and ``_build.LAUNCHES`` after
a served run is each graph's captured launches times its replays plus
one warm-up call each.

qlint's card levels (``repro_torch.analysis``): the PTX of every
registered entry's sources is clean (no accumulator narrowed to 8/16
bits; every integer-scale kernel on the int8 MMA, no float MMA); the
fixtures whose reference rule has a PTX form are flagged from their PTX;
and each fixture's kernel, launched once, equals its plain version bit
for bit with every input, pad and guard unchanged.

Calibration PTQ on the card (``repro_torch.core.algorithms``): GPTQ, AWQ
and QuaRot against the same functions on the CPU, with the tolerances
each test states (their f32 products sum in another order on the card),
and the calibration capture records nothing while a CUDA graph is
captured.

MLA and DeepSeek-V2's widths: flash attention at heads of 32 (bf16 and
f32), and the serving CLI's smoke Qwen2-72B (heads of 32) served on the
card equal to the eager loop; the IS GEMM bit-exact at MiniCPM3's and
DeepSeek-V2's (K, N) (N = 288 and 576 are no multiple of the 64-column
tile; K up to 16384); the ragged IS GEMM at 160 experts with row counts
from a seeded top-6 routing, equal to the dense-grouped entry bit for
bit; ``_dense_weight`` on the card equal to the CPU's; and the captured
engine on both smoke MLA archs equal to the eager loop.

Cross attention (Llama-3.2-Vision's cross layers, Whisper): flash
attention non-causal with Sq != Sk (Sq = 1, Sk = 1500 and 1600, bf16 and
f32); a quantized linear with a bias at the memory's 6000 / 6400 rows
equal to the CPU bit for bit; act_quant at those rows; both smoke models
on the card against the CPU (a prefill with memory, then a decode step;
5e-2 of the largest logit); and their decode replayed as a CUDA graph
equal to the eager loop.

The recurrent families (xLSTM, RecurrentGemma): flash attention at head
dim 256 (bf16 and f32, causal with and without a window) within
``TOLERANCE``; the IS GEMM and act_quant bit-exact at their widths; both
smoke models on the card against the CPU (a prefill, then a decode step;
5e-2 of the largest logit); their decode replayed as a CUDA graph
(``serving.graphs.Step`` restoring the state its warm-up advanced) equal
to the eager loop; and the xLSTM engine, one slot reused, equal to the
eager greedy loop.

Training: the flash-attention backward kernel against its plain version
(head dims 32, 64 and 128; bf16 and f32; causal, windowed, non-causal
with Sq != Sk; S no multiple of the tile; B > 1; GQA and MQA; the
train step's 24 over 8 heads; a grid small enough that the bf16 launch
plan splits the heads) within
``BWD_REL_TOLERANCE`` x max |plain| and bit-repeatable; the forward with
its lse output bit-equal to the forward without it; head dim 256
(RecurrentGemma's: bf16 on the D split, f32 on 32-row tiles; causal,
windowed MQA, non-causal with Sq != Sk; the train shape's window of
2048 on 1 x 4096 tokens) within the same bounds and bit-repeatable;
other head dims refused; autograd on the card launching the backward
kernel once; and a smoke train step (remat on) on the card against the
CPU: loss within 1e-2 and every gradient leaf within 5e-2 (bf16), 1e-5
and 1e-4 (f32), for LLaMA-2-7B's, RecurrentGemma's and xLSTM's smoke
configs.
The MoE family and MLA: the smoke Mixtral (tokens dropped; the int8
dispatch), DeepSeek-V2 at top-6 and MiniCPM3 in f32 against the CPU
(routed counts equal, 1e-5 / 1e-4) and repeated bit for bit; the int8
dispatch transport bit-equal to the CPU's; the engine serving with it,
each step captured once.
"""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.analysis import fixtures as qfixtures
from repro_torch.analysis import qlint
from repro_torch.analysis import registry as qregistry
from repro_torch.analysis.lint import run_ptx_rules
from repro_torch.core import integer_scale as isc
from repro_torch.core import packing, qlinear, quant
from repro_torch.core.recipe import QuantSpec
from repro_torch.kernels import _build, moe_gemm, ops
from repro_torch.kernels.act_quant import (act_quant, act_quant_plain,
                                           act_quant_routed,
                                           act_quant_routed_plain)
from repro_torch.kernels.flash_attention import (TOLERANCE, flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.w4a16_gemm import (REL_TOLERANCE, w4a16_gemm,
                                            w4a16_gemm_plain)
from repro_torch.kernels.w4a8_gemm import (fg_gemm_integer_scale,
                                           fg_gemm_integer_scale_plain)
from repro_torch.kernels.w4a8_gemm_fscale import (fg_gemm_float_scale,
                                                  fg_gemm_float_scale_plain)
from repro_torch.nn import spec as S
from repro_torch.serving.chaos import ChaosConfig, ChaosMonkey, NanFault
from repro_torch.serving.engine import Engine, ServeConfig

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
@pytest.mark.parametrize("C,K", [(8, 4096), (40, 14336), (5, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quant_routed_kernel_bit_exact(cuda, C, K, dtype):
    """The routed rows of a dispatch buffer (act_quant's routed entry, one
    launch counted as act_quant): codes and scales equal to the unfused
    act_quant's bit for bit, zero codes and scale +0.0 past the counts
    (negative and above-C counts clamped) with data, NaN and inf there;
    None routes every row."""
    E = 4
    x = _normal(C * K, (E, C, K), 3.0, cuda)
    x[0] = float("nan")  # count 0 (negative)
    x[2, 3:, ::7] = float("inf")
    x = x.to(dtype)
    counts = torch.tensor([-2, C, 3, 100], dtype=torch.int32, device=cuda)
    before = _build.LAUNCHES["act_quant"]
    q, sa = act_quant_routed(x, counts)
    assert _build.LAUNCHES["act_quant"] == before + 1
    q_p, sa_p = act_quant_routed_plain(x, counts)
    assert torch.equal(q, q_p) and torch.equal(sa, sa_p)
    assert sa.shape == (E, C, 1)
    assert not q[0].any() and not q[2, 3:].any()
    assert not sa[0].any() and not torch.signbit(sa).any()
    q_u, s_u = act_quant_plain(x[1])
    assert torch.equal(q[1], q_u) and torch.equal(sa[1], s_u)
    q, sa = act_quant_routed(x[1:2].contiguous(), None)
    assert torch.equal(q[0], act_quant_plain(x[1])[0])


def _equal_nan(a, b) -> bool:
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [4096, 11008, 14336, 16400, 32800, 24, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quant_single_pass_bit_exact(cuda, K, dtype):
    """Both entries of the single-pass kernel against the plain version,
    bit for bit: rows held in registers (K up to 32768 bf16, 16384 f32),
    rows that take the re-reading loop (f32 K = 16400, both at 32800),
    short rows that share a block (K = 24, 100), the element-wise path
    (K = 100 bf16 is no multiple of 8; an unaligned base), a row with a
    NaN (NaN scale, zero codes), one with an inf (inf scale) and an
    all-zero row (the 1e-8 floor)."""
    M = 7
    x = _normal(K, (M, K), 3.0, cuda)
    x[1, K // 3] = float("nan")
    x[3, K - 1] = float("-inf")
    x[5] = 0.0
    x = x.to(dtype)
    before = _build.LAUNCHES["act_quant"]
    q, s = act_quant(x)
    q_p, s_p = act_quant_plain(x)
    assert torch.equal(q, q_p) and _equal_nan(s, s_p)
    assert torch.isnan(s[1]).all() and torch.isinf(s[3]).all()
    # an unaligned base: the same rows one element into a buffer
    buf = torch.empty(M * K + 1, dtype=dtype, device=cuda)
    xu = buf[1:].view(M, K)
    xu.copy_(x)
    assert xu.data_ptr() % 16
    q_u, s_u = act_quant(xu)
    assert torch.equal(q_u, q_p) and _equal_nan(s_u, s_p)
    # the routed entry: 2 experts of capacity 4 over the same rows
    xr = torch.cat([x, x[:1]]).reshape(2, 4, K)
    counts = torch.tensor([4, 2], dtype=torch.int32, device=cuda)
    q_r, s_r = act_quant_routed(xr, counts)
    q_rp, s_rp = act_quant_routed_plain(xr, counts)
    assert torch.equal(q_r, q_rp) and _equal_nan(s_r, s_rp)
    assert _build.LAUNCHES["act_quant"] == before + 3


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
@pytest.mark.parametrize("M,K,N,g", SHAPES + [(2, 256, 64, 64),
                                              (3, 384, 80, 48),
                                              (5, 256, 72, 128),
                                              (3, 512, 37, 64)])
@pytest.mark.parametrize("bm", [0, 16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w4a16_kernel_vs_plain(cuda, M, K, N, g, bm, dtype):
    """Every row tile (``bm``; 0 picks by M) over shapes whose K splits
    differ (one split up to 86), a group of 64 and one of 48 (a packing
    unit spans three scale rows), N = 80 (a partial column tile), and
    N = 72 and 37 (rows not 16-byte aligned: the plain-load path; at 37
    also an odd number of outputs for the split reduction)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 product
    qw = quant.quantize_weight(_normal(0, (K, N), 0.05, cuda), 4, g)
    x = _normal(1, (M, K), 1.0, cuda).to(dtype)
    w = packing.pack_int4(qw.qvalue)
    y = w4a16_gemm(x, w, qw.scale, group_size=g, bm=bm)
    y_p = w4a16_gemm_plain(x, w, qw.scale, group_size=g)
    assert y.dtype == torch.float32 and y.shape == (M, N)
    err = (y - y_p).abs().max().item()
    assert err <= REL_TOLERANCE * y_p.abs().max().item(), err


LLAMA_KN = [(4096, 4096), (4096, 11008), (11008, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", LLAMA_KN)
@pytest.mark.parametrize("M", [1, 4, 17, 128, 200])
def test_w4a16_kernel_at_llama_shapes(cuda, K, N, M):
    """LLaMA-2-7B's three linear shapes at decode, mid and prefill row
    counts (the splits of ``launch_plan``; M = 200 takes four row tiles
    of 64)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    qw = quant.quantize_weight(_normal(K, (K, N), 0.05, cuda), 4, 128)
    x = _normal(M, (M, K), 1.0, cuda).to(torch.bfloat16)
    w = packing.pack_int4(qw.qvalue)
    before = _build.LAUNCHES["w4a16_gemm"]
    y = w4a16_gemm(x, w, qw.scale)
    assert _build.LAUNCHES["w4a16_gemm"] == before + 1
    y_p = w4a16_gemm_plain(x, w, qw.scale, group_size=128)
    err = (y - y_p).abs().max().item()
    assert err <= REL_TOLERANCE * y_p.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(4, 11008, 4096), (128, 4096, 4096),
                                   (4, 4096, 11008)])
def test_w4a16_kernel_is_deterministic(cuda, M, K, N):
    """Two launches on the same inputs give the same bits: the K splits
    are added in a fixed order, with no atomics."""
    qw = quant.quantize_weight(_normal(5, (K, N), 0.05, cuda), 4, 128)
    x = _normal(6, (M, K), 1.0, cuda).to(torch.bfloat16)
    w = packing.pack_int4(qw.qvalue)
    assert torch.equal(w4a16_gemm(x, w, qw.scale), w4a16_gemm(x, w, qw.scale))


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


FLASH_SHAPES = [  # (B, S, Hq, Hkv, D, window)
    (1, 128, 32, 32, 128, None), (2, 200, 8, 2, 128, 64),
    (1, 77, 4, 1, 64, None),
    (1, 128, 32, 8, 128, None),   # Mixtral-8x7B's GQA at the prefill
    (1, 45, 4, 2, 128, 16),       # S no multiple of the query tile, window
    (3, 300, 2, 1, 64, 100),      # several key tiles, window across them
    (1, 128, 8, 2, 32, None),     # Qwen2-72B's smoke heads of 32
    (2, 77, 4, 4, 32, 16)]        # heads of 32, ragged length, window


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", FLASH_SHAPES)
def test_flash_kernel_vs_plain(cuda, B, S, Hq, Hkv, D, window):
    q, k, v = (_normal(i, (B, S, h, D), 1.0, cuda).to(torch.bfloat16)
               for i, h in enumerate((Hq, Hkv, Hkv)))
    out = flash_attention(q, k, v, window=window)
    ref = flash_attention_plain(q, k, v, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= TOLERANCE


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", FLASH_SHAPES[:4])
def test_flash_kernel_f32_vs_plain(cuda, B, S, Hq, Hkv, D, window):
    """f32 inputs take the scalar f32 kernel, held to the same bound."""
    q, k, v = (_normal(i, (B, S, h, D), 1.0, cuda)
               for i, h in enumerate((Hq, Hkv, Hkv)))
    before = _build.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, window=window)
    assert _build.LAUNCHES["flash_attention"] == before + 1
    ref = flash_attention_plain(q, k, v, window=window)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert (out - ref).abs().max().item() <= TOLERANCE


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_is_deterministic(cuda, dtype):
    q, k, v = (_normal(i, (1, 128, h, 128), 1.0, cuda).to(dtype)
               for i, h in enumerate((32, 8, 8)))
    assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v))


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
    q = torch.zeros((1, 8, 2, 48), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        flash_attention(q, q, q)  # head_dim 48 has no instantiation


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

    # data, NaN and inf past the counts: exact +0.0 there, and the same
    # bits as the zero-filled buffer; the W4A8 kernels also through a
    # forced K split (the split reduction knows the counts)
    counts = torch.tensor([9, 0, 100], dtype=torch.int32, device=cuda)
    bad = x.clone()
    bad[0, 9:, ::3] = float("nan")
    bad[0, 9:, 1::3] = float("inf")
    bad[1] = -float("inf")
    bad[1, ::2, ::5] = float("nan")
    clean = x.clone()
    clean[0, 9:] = 0
    clean[1] = 0
    runs = [lambda b: moe_gemm.grouped_w4a16_gemm_ragged(
        b, counts, qv, fscale, group_size=g)]
    for sp in (0, 2):
        runs += [lambda b, sp=sp: moe_gemm.fg_grouped_gemm_integer_scale_ragged(
                     b, counts, qv, iscale, group_size=g, alpha=alpha,
                     splits=sp),
                 lambda b, sp=sp: moe_gemm.fg_grouped_gemm_float_scale_ragged(
                     b, counts, qv, fscale, group_size=g, splits=sp)]
    for run in runs:
        y = run(bad)
        assert torch.equal(y, run(clean))
        assert not y[0, 9:].any() and not y[1].any()
        assert not torch.signbit(y[0, 9:]).any()
        assert not torch.signbit(y[1]).any()


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


# -- the second designs: split K, the cp.async rings -----------------------


def _w4a8_split(name, xq, sa, w, scale, g, w_bits, splits, alpha=None):
    """The dense W4A8 kernel ``name`` at a forced K split (IS with the
    amplifier ``alpha``, an f32 tensor of one value)."""
    from repro_torch.kernels.w4a8_gemm import launch_ring, pick_tile_m

    M, N = xq.shape[0], w.shape[1]
    plan = {"bm": pick_tile_m(M), "splits": splits,
            "workspace": splits * M * N if splits > 1 else 0}
    return launch_ring(name, xq, sa.reshape(M).contiguous(), alpha, w,
                       scale, g, w_bits, plan)


def _w4a8_operands(cuda, M, K, N, g, w_bits, seed=0):
    qw = quant.quantize_weight(_normal(seed, (K, N), 0.05, cuda), w_bits, g)
    xq, sa = quant.quantize_activation(_normal(seed + 1, (M, K), 1.0, cuda))
    w = packing.pack_int4(qw.qvalue) if w_bits == 4 else qw.qvalue
    return qw, xq, sa, w


# (M, K, N, g, splits): every split of a short K, a group of 32 and one of
# 256 and 384 that splits cut, and LLaMA-2-7B's K = 11008 (86 units) with
# its planned split (0) and forced ones
SPLITS = ([(4, 1024, 256, 128, s) for s in range(1, 9)]
          + [(3, 768, 128, 32, 5), (4, 1536, 128, 256, 5),
             (70, 1536, 192, 384, 4), (4, 11008, 4096, 128, 0),
             (4, 11008, 4096, 128, 1), (128, 11008, 4096, 128, 0),
             (2, 11008, 256, 128, 86)])


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,g,splits", SPLITS)
@pytest.mark.parametrize("w_bits", [4, 8])
def test_is_gemm_bit_exact_at_every_split(cuda, M, K, N, g, splits, w_bits):
    """Integer sums are exact in any order mod 2^32, so the IS kernel is
    bit-exact at every K split, also where a split cuts a group."""
    qw, xq, sa, w = _w4a8_operands(cuda, M, K, N, g, w_bits)
    isw = isc.integerize(qw, 1024 if w_bits == 4 else "heuristic+6")
    if splits:
        y = _w4a8_split("w4a8_gemm_is", xq, sa, w, isw.int_scale, g,
                        w_bits, splits, alpha=torch.full(
                            (1,), float(isw.alpha), device=cuda))
    else:
        y = fg_gemm_integer_scale(xq, sa, w, isw.int_scale, group_size=g,
                                  alpha=float(isw.alpha), w_bits=w_bits)
    y_p = fg_gemm_integer_scale_plain(xq, sa, w, isw.int_scale,
                                      group_size=g, alpha=float(isw.alpha),
                                      w_bits=w_bits)
    assert torch.equal(y, y_p)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,g,splits", SPLITS)
@pytest.mark.parametrize("w_bits", [4, 8])
def test_fs_gemm_at_every_split(cuda, M, K, N, g, splits, w_bits):
    """Coarse float scale sums its int32 partials over the k-halves and the
    splits before its one float step: bit-exact at every split. Fine float
    scale adds its splits' f32 sums in split order: rtol 1e-5 / atol
    1e-4."""
    for gs in (g, -1):
        qw, xq, sa, w = _w4a8_operands(cuda, M, K, N, gs, w_bits, seed=3)
        scale = qw.scale if gs > 0 else qw.scale[None, :]
        if splits:
            y = _w4a8_split("w4a8_gemm_fs", xq, sa, w, scale,
                            gs if gs > 0 else K, w_bits, splits)
        else:
            y = fg_gemm_float_scale(xq, sa, w, scale, group_size=gs,
                                    w_bits=w_bits)
        y_p = fg_gemm_float_scale_plain(xq, sa, w, scale, group_size=gs,
                                        w_bits=w_bits)
        if gs < 0:
            assert torch.equal(y, y_p)
        else:
            torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(4, 4096, 4096), (4, 11008, 4096),
                                   (128, 4096, 11008), (5, 512, 72)])
def test_dense_w4a8_kernels_are_deterministic(cuda, M, K, N):
    """Two launches give the same bits (IS, fine and coarse FS; W8 too):
    the K splits are added in a fixed order, with no atomics. N = 72
    takes the plain-load path (rows not 16-byte aligned)."""
    for w_bits in (4, 8):
        qw, xq, sa, w = _w4a8_operands(cuda, M, K, N, 128, w_bits, seed=5)
        isw = isc.integerize(qw, 1024 if w_bits == 4 else "heuristic+6")
        qc = quant.quantize_weight(_normal(5, (K, N), 0.05, cuda), w_bits, -1)
        wc = packing.pack_int4(qc.qvalue) if w_bits == 4 else qc.qvalue
        for run in (
                lambda: fg_gemm_integer_scale(
                    xq, sa, w, isw.int_scale, alpha=float(isw.alpha),
                    w_bits=w_bits),
                lambda: fg_gemm_float_scale(xq, sa, w, qw.scale,
                                            w_bits=w_bits),
                lambda: fg_gemm_float_scale(xq, sa, wc, qc.scale[None, :],
                                            group_size=-1, w_bits=w_bits)):
            assert torch.equal(run(), run())


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [[0, 0, 0], [24, 24, 24], [24, 0, 9],
                                    [-3, 17, 100]])
@pytest.mark.parametrize("K", [1024, 14336])
def test_grouped_w4a16_splits_and_counts(cuda, counts, K):
    """The grouped W4A16 kernel on a split launch (3 experts of 128
    columns split K; the skipped m-tiles' zeros go through the workspace
    and the reduction): counts 0, C, partial, negative and above C;
    ragged == dense grouped bit for bit on zero padding, within the
    bound of the plain version, and the same bits on a second launch."""
    from repro_torch.kernels.w4a8_gemm import launch_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    E, C, N, g = 3, 24, 128, 128
    assert launch_plan(C, N, K, sms=132, experts=E)["splits"] > 1
    clamp = [min(max(c, 0), C) for c in counts]
    x, _, qv, fscale, _, _ = _grouped_operands(cuda, E, C, K, N, g, clamp)
    rc = torch.tensor(counts, dtype=torch.int32, device=cuda)
    y = moe_gemm.grouped_w4a16_gemm_ragged(x, rc, qv, fscale, group_size=g)
    y_p = moe_gemm.grouped_w4a16_gemm_ragged_plain(x, rc, qv, fscale,
                                                   group_size=g)
    err = (y - y_p).abs().max().item()
    assert err <= REL_TOLERANCE * max(y_p.abs().max().item(), 1e-30), err
    for e, c in enumerate(clamp):
        assert not y[e, c:].any()
    assert torch.equal(y, moe_gemm.grouped_w4a16_gemm(x, qv, fscale,
                                                      group_size=g))
    assert torch.equal(y, moe_gemm.grouped_w4a16_gemm_ragged(
        x, rc, qv, fscale, group_size=g))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 14336])
def test_grouped_w4a16_reads_counts_on_the_device(cuda, K):
    """A CUDA graph of the grouped W4A16 kernel, captured once, follows
    counts written in place before each replay (no host read), with its K
    split in 2 (K = 256) and in 16 (K = 14336)."""
    E, C, N, g = 4, 8, 128, 128
    x, _, qv, fscale, _, _ = _grouped_operands(cuda, E, C, K, N, g, [C] * E)
    rc = torch.zeros(E, dtype=torch.int32, device=cuda)
    moe_gemm.grouped_w4a16_gemm_ragged(x, rc, qv, fscale, group_size=g)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = moe_gemm.grouped_w4a16_gemm_ragged(x, rc, qv, fscale,
                                               group_size=g)
    for counts in ([0, 8, 3, 5], [8, 0, 0, 1]):
        rc.copy_(torch.tensor(counts, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = moe_gemm.grouped_w4a16_gemm_ragged(x, rc, qv, fscale,
                                                  group_size=g)
        assert torch.equal(y, want)
        for e, c in enumerate(counts):
            assert not y[e, c:].any() and (c == 0 or y[e, :c].any())


# -- the grouped W4A8 kernels on the ring loop ------------------------------
# (K, g, splits): every split of a short K, groups that splits cut, and
# Mixtral's down projection K = 14336 at the largest planned split
GROUPED_SPLITS = ([(1024, 128, s) for s in range(1, 9)]
                  + [(768, 256, 5), (1536, 384, 4), (14336, 128, 16)])


@pytest.mark.cuda
@pytest.mark.parametrize("K,g,splits", GROUPED_SPLITS)
@pytest.mark.parametrize("C", [8, 24])
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("scheme", ["is", "fs", "coarse"])
def test_grouped_w4a8_at_every_split(cuda, scheme, w_bits, C, K, g, splits):
    """The grouped IS and FS kernels at forced K splits (3 experts: one
    empty, one full, one partial): IS and coarse FS bit-exact against
    their plain versions, fine FS within rtol 1e-5 / atol 1e-4; ragged ==
    dense grouped bit for bit at the same split; a second launch gives the
    same bits; +0.0 past the counts."""
    E, N = 3, 192
    counts = [0, C, 5]
    gs = g if scheme != "coarse" else -1
    x, rc, _, _, _, _ = _grouped_operands(cuda, E, C, K, N, 128, counts)
    qs = [quant.quantize_weight(_normal(300 + e, (K, N), 0.05, cuda),
                                w_bits, gs) for e in range(E)]
    qv = torch.stack([packing.pack_int4(q.qvalue) if w_bits == 4
                      else q.qvalue for q in qs])
    xq, sa = act_quant_plain(x.reshape(E * C, K))
    xq, sa = xq.reshape(E, C, K), sa.reshape(E, C, 1)
    if scheme == "is":
        isws = [isc.integerize(q, "heuristic+6") for q in qs]
        scale = torch.stack([w.int_scale for w in isws])
        alpha = torch.tensor([float(w.alpha) for w in isws], device=cuda)

        def ragged(**kw):
            return moe_gemm.fg_grouped_gemm_integer_scale_ragged(
                x, rc, qv, scale, group_size=g, alpha=alpha, w_bits=w_bits,
                **kw)

        y_p = moe_gemm.fg_grouped_gemm_integer_scale_ragged_plain(
            x, rc, qv, scale, group_size=g, alpha=alpha, w_bits=w_bits)
        y_d = moe_gemm.fg_grouped_gemm_integer_scale(
            xq, sa, qv, scale, group_size=g, alpha=alpha, w_bits=w_bits,
            splits=splits)
    else:
        scale = torch.stack([q.scale if gs > 0 else q.scale[None, :]
                             for q in qs])

        def ragged(**kw):
            return moe_gemm.fg_grouped_gemm_float_scale_ragged(
                x, rc, qv, scale, group_size=gs, w_bits=w_bits, **kw)

        y_p = moe_gemm.fg_grouped_gemm_float_scale_ragged_plain(
            x, rc, qv, scale, group_size=gs, w_bits=w_bits)
        y_d = moe_gemm.fg_grouped_gemm_float_scale(
            xq, sa, qv, scale, group_size=gs, w_bits=w_bits, splits=splits)
    before = _build.LAUNCHES["moe_w4a8_is" if scheme == "is"
                             else "moe_w4a8_fs"]
    y = ragged(splits=splits)
    assert _build.LAUNCHES["moe_w4a8_is" if scheme == "is"
                           else "moe_w4a8_fs"] == before + 1
    if scheme == "fs":
        torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-4)
    else:
        assert torch.equal(y, y_p)
    assert torch.equal(y, y_d)
    assert torch.equal(y, ragged(splits=splits))
    assert not y[0].any() and not y[2, 5:].any() and y[1].any()
    assert not torch.signbit(y[0]).any() and not torch.signbit(y[2, 5:]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [0, 3])
@pytest.mark.parametrize("scheme", ["is", "fs"])
def test_grouped_w4a8_reads_counts_on_the_device(cuda, scheme, splits):
    """A CUDA graph of the ragged IS or FS wrapper (the routed
    quantization, the GEMM and, split, its reduction), captured once,
    follows counts written in place before each replay: the wrappers
    never read the counts on the host."""
    E, C, K, N, g = 4, 8, 384, 128, 128
    x, _, qv, fscale, iscale, alpha = _grouped_operands(cuda, E, C, K, N, g,
                                                        [C] * E)
    rc = torch.zeros(E, dtype=torch.int32, device=cuda)
    if scheme == "is":
        def run():
            return moe_gemm.fg_grouped_gemm_integer_scale_ragged(
                x, rc, qv, iscale, group_size=g, alpha=alpha, splits=splits)

        def plain():
            return moe_gemm.fg_grouped_gemm_integer_scale_ragged_plain(
                x, rc, qv, iscale, group_size=g, alpha=alpha)
    else:
        def run():
            return moe_gemm.fg_grouped_gemm_float_scale_ragged(
                x, rc, qv, fscale, group_size=g, splits=splits)

        def plain():
            return moe_gemm.fg_grouped_gemm_float_scale_ragged_plain(
                x, rc, qv, fscale, group_size=g)
    run()  # build + load outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = run()
    for counts in ([0, 8, 3, 5], [8, 0, 0, 1]):
        rc.copy_(torch.tensor(counts, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = plain()
        if scheme == "is":
            assert torch.equal(y, want)
        else:
            torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-4)
        assert torch.equal(y, run())
        for e, c in enumerate(counts):
            assert not y[e, c:].any() and (c == 0 or y[e, :c].any())


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("w_bits", [4, 8])
def test_w4a8_epilogue_divides_by_alpha(cuda, splits, w_bits):
    """The W4A8 epilogues read ``sa`` and the amplifier on the device and
    divide in place (one IEEE division a row, then one multiply): the IS
    GEMMs with the stored alpha tensor (dense (), grouped (E,) with
    per-expert values) equal their plain versions bit for bit at splits 1
    and 4, as the FS GEMMs (no alpha) do for coarse and within rtol 1e-5
    / atol 1e-4 for fine; a static amplifier (a float) gives the same
    bits as its tensor."""
    M, K, N, g = 5, 1024, 192, 128
    qw, xq, sa, w = _w4a8_operands(cuda, M, K, N, g, w_bits, seed=11)
    isw = isc.integerize(qw, "heuristic+6")
    alpha = torch.tensor(float(isw.alpha), device=cuda)  # as qlinear stores
    y_p = fg_gemm_integer_scale_plain(xq, sa, w, isw.int_scale,
                                      group_size=g, alpha=alpha,
                                      w_bits=w_bits)
    assert torch.equal(_w4a8_split("w4a8_gemm_is", xq, sa, w, isw.int_scale,
                                   g, w_bits, splits,
                                   alpha=alpha.reshape(1)), y_p)
    assert torch.equal(fg_gemm_integer_scale(
        xq, sa, w, isw.int_scale, group_size=g, alpha=alpha, w_bits=w_bits),
        fg_gemm_integer_scale(xq, sa, w, isw.int_scale, group_size=g,
                              alpha=float(isw.alpha), w_bits=w_bits))
    for gs, scale in ((g, qw.scale), (-1, None)):
        if gs < 0:
            qc = quant.quantize_weight(_normal(11, (K, N), 0.05, cuda),
                                       w_bits, -1)
            w_, scale = (packing.pack_int4(qc.qvalue) if w_bits == 4
                         else qc.qvalue), qc.scale[None, :]
        else:
            w_ = w
        y = _w4a8_split("w4a8_gemm_fs", xq, sa, w_, scale,
                        gs if gs > 0 else K, w_bits, splits)
        y_fp = fg_gemm_float_scale_plain(xq, sa, w_, scale, group_size=gs,
                                         w_bits=w_bits)
        if gs < 0:
            assert torch.equal(y, y_fp)
        else:
            torch.testing.assert_close(y, y_fp, rtol=1e-5, atol=1e-4)
    E, C = 3, 8
    x, rc, qv, fscale, iscale, alphas = _grouped_operands(
        cuda, E, C, K, N, g, [C, 0, 5], w_bits=w_bits)
    gq, gsa = moe_gemm.quantize_routed(x, rc)
    y = moe_gemm.fg_grouped_gemm_integer_scale(
        gq, gsa, qv, iscale, group_size=g, alpha=alphas, w_bits=w_bits,
        splits=splits, row_counts=rc)
    assert torch.equal(y, moe_gemm.fg_grouped_gemm_integer_scale_ragged_plain(
        x, rc, qv, iscale, group_size=g, alpha=alphas, w_bits=w_bits))


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [0, 4])
def test_grouped_gemms_share_one_routed_quantization(cuda, splits):
    """Gate and up (two expert stacks with different per-expert alphas)
    on ONE routed quantization of the dispatch buffer equal two ragged
    calls that quantize their own, bit for bit, IS and FS; the shared
    path launches act_quant once for both."""
    E, C, K, N, g = 4, 8, 512, 128, 128
    counts = [0, C, 3, 6]
    x, rc, qa, fa, ia, alpha_a = _grouped_operands(cuda, E, C, K, N, g,
                                                   counts)
    qb, fb, ib, alpha_b = [], [], [], []
    for e in range(E):
        qw = quant.quantize_weight(_normal(400 + e, (K, N), 0.3, cuda), 4, g)
        isw = isc.integerize(qw, "heuristic+6")
        qb.append(packing.pack_int4(qw.qvalue))
        fb.append(qw.scale)
        ib.append(isw.int_scale)
        alpha_b.append(float(isw.alpha))
    qb, fb, ib = torch.stack(qb), torch.stack(fb), torch.stack(ib)
    alpha_b = torch.tensor(alpha_b, device=cuda)
    assert not torch.equal(alpha_a, alpha_b)
    before = _build.LAUNCHES["act_quant"]
    gq, gsa = moe_gemm.quantize_routed(x, rc)
    kw = dict(group_size=g, splits=splits, row_counts=rc)
    shared = [moe_gemm.fg_grouped_gemm_integer_scale(gq, gsa, qa, ia,
                                                     alpha=alpha_a, **kw),
              moe_gemm.fg_grouped_gemm_integer_scale(gq, gsa, qb, ib,
                                                     alpha=alpha_b, **kw),
              moe_gemm.fg_grouped_gemm_float_scale(gq, gsa, qa, fa, **kw),
              moe_gemm.fg_grouped_gemm_float_scale(gq, gsa, qb, fb, **kw)]
    assert _build.LAUNCHES["act_quant"] == before + 1
    alone = [moe_gemm.fg_grouped_gemm_integer_scale_ragged(
                 x, rc, qa, ia, group_size=g, alpha=alpha_a, splits=splits),
             moe_gemm.fg_grouped_gemm_integer_scale_ragged(
                 x, rc, qb, ib, group_size=g, alpha=alpha_b, splits=splits),
             moe_gemm.fg_grouped_gemm_float_scale_ragged(
                 x, rc, qa, fa, group_size=g, splits=splits),
             moe_gemm.fg_grouped_gemm_float_scale_ragged(
                 x, rc, qb, fb, group_size=g, splits=splits)]
    for a, b in zip(shared, alone):
        assert torch.equal(a, b)


# -- the serving engine's captured steps ---------------------------------------


def eager_greedy(api, cfg, model, prompts, sc) -> list[list[int]]:
    """Greedy streams of ``prompts`` from a plain eager loop over ``model``
    on the engine's schedule: free slots filled in order, each by a batch-1
    prefill into a fresh cache that is copied into the slot's rows; one
    batched decode a tick, idle slots fed token 0 at position 0; a request
    retires at ``max_new_tokens`` or ``max_seq`` (no eos). No graph and no
    engine: what the engine's captured steps must reproduce."""
    dev = model.embed.device
    B, P = sc.max_slots, sc.prefill_len
    cache = S.materialize(api.cache_specs(cfg, B, sc.max_seq), device=dev)
    queue, slots, outs = list(enumerate(prompts)), [None] * B, {}
    with torch.inference_mode():
        while queue or any(slots):
            for i in range(B):
                if slots[i] is None and queue:
                    rid, p = queue.pop(0)
                    one = S.materialize(api.cache_specs(cfg, 1, sc.max_seq),
                                        device=dev)
                    toks = torch.tensor([p + [0] * (P - len(p))], device=dev)
                    logits = model(toks, mode="train", cache=one, pos=0)[0]
                    for big, c in zip(cache["blocks"], one["blocks"]):
                        for k, t in big.items():
                            t[i] = c[k][0]
                    slots[i] = (rid, len(p),
                                [int(logits[0, len(p) - 1].argmax())])
            last = torch.tensor([[s[2][-1] if s else 0] for s in slots],
                                device=dev)
            pos = torch.tensor([s[1] if s else 0 for s in slots], device=dev)
            nxt = model(last, mode="decode", cache=cache, pos=pos)[0][:, 0]
            for i, tok in enumerate(nxt.argmax(-1).tolist()):
                if slots[i] is None:
                    continue
                rid, n, gen = slots[i]
                gen.append(tok)
                if len(gen) >= sc.max_new_tokens or n + 2 >= sc.max_seq:
                    outs[rid], slots[i] = gen, None
                else:
                    slots[i] = (rid, n + 1, gen)
    return [outs[r] for r in range(len(prompts))]


def poison_quarantined_rows(eng):
    """Decode wrapper: fill every cache row of a slot whose logits came out
    non-finite with NaN, the stale rows a poisoned step would leave."""
    def wrap(fn):
        def decode(*args):
            logits = fn(*args)
            bad = (~torch.isfinite(logits).all(-1)).nonzero().flatten()
            for c in eng.cache["blocks"]:
                for t in c.values():
                    t[bad] = float("nan")
            return logits
        return decode
    return wrap


ENGINE_SC = dict(max_slots=4, max_seq=64, prefill_len=16, max_new_tokens=6)
_SERVED: dict = {}


def _served(arch, name, device):
    """(api, cfg, params, recipe): the smoke ``arch`` quantized under
    recipe ``name`` on ``device``, made once per process."""
    if (arch, name) not in _SERVED:
        from repro_torch.core import ptq
        from repro_torch.core.recipe import (DEFAULT_RECIPE,
                                             FLOAT_SCALE_RECIPE,
                                             WEIGHT_ONLY_RECIPE)
        from repro_torch.models.registry import get_arch, get_model

        recipe = {r.name: r for r in (DEFAULT_RECIPE, FLOAT_SCALE_RECIPE,
                                      WEIGHT_ONLY_RECIPE)}[name]
        cfg = get_arch(arch, smoke=True)
        api = get_model(cfg)
        _SERVED[arch, name] = (api, cfg, ptq.quantize_by_layer(
            api, cfg, recipe, device=device), recipe)
    return _SERVED[arch, name]


def _engine_prompts(cfg, n=6, seed=21):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(k)).tolist()
            for k in rng.integers(3, 17, n)]


def _serve(api, cfg, params, recipe, prompts, sc, **kw):
    eng = Engine(api, cfg, params, sc, recipe=recipe, **kw)
    rids = [eng.submit(p) for p in prompts]
    outs = eng.run()
    return eng, [outs[r] for r in rids]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama2-7b", "mixtral-8x7b"])
@pytest.mark.parametrize("name", ["w4a8-is", "w4a16-fg"])
def test_engine_streams_equal_an_eager_greedy_loop(cuda, arch, name):
    api, cfg, params, recipe = _served(arch, name, cuda)
    prompts = _engine_prompts(cfg)
    sc = ServeConfig(**ENGINE_SC)
    eng, outs = _serve(api, cfg, params, recipe, prompts, sc)
    eng.close()
    assert eng._decode_step.captured and eng._prefill_step.captured
    assert eng.decode_traces == eng.prefill_traces == 1
    assert outs == eager_greedy(api, cfg, eng.model, prompts, sc)


@pytest.mark.cuda
def test_engine_captures_each_step_once_across_ticks_and_slots(cuda):
    api, cfg, params, recipe = _served("llama2-7b", "w4a8-is", cuda)
    reg = obs.Registry()
    with obs.use_registry(reg):
        eng, outs = _serve(api, cfg, params, recipe,
                           _engine_prompts(cfg, n=10), ServeConfig(**ENGINE_SC))
    assert eng.ticks >= 5 and all(len(o) == 6 for o in outs)
    admits = [e["slot"] for e in reg.events() if e.get("ev") == "admit"]
    assert len(admits) == 10 and set(admits) == {0, 1, 2, 3}
    assert eng.decode_traces == eng.prefill_traces == 1
    assert reg.counter("engine_traces_total", "", ("fn",)).get(
        fn="decode") == 1
    assert [e["fn"] for e in reg.events() if e.get("ev") == "trace"] == [
        "prefill", "decode"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama2-7b", "mixtral-8x7b"])
def test_breaker_fallback_captures_again_and_serves_fs(cuda, arch):
    api, cfg, params, recipe = _served(arch, "w4a8-is", cuda)
    _, _, fs_params, fs_recipe = _served(arch, "w4a8-fs", cuda)
    sc = ServeConfig(**ENGINE_SC)
    prompts = _engine_prompts(cfg)
    eng, _ = _serve(api, cfg, params, recipe, prompts[:2], sc,
                    fallback_params=fs_params, fallback_recipe=fs_recipe)
    assert eng.decode_traces == 1
    eng.trip_breaker("forced")
    rids = [eng.submit(p) for p in prompts]
    outs = eng.run()
    assert eng.fallbacks == 1
    assert eng.decode_traces == eng.prefill_traces == 2
    assert [outs[r] for r in rids] == eager_greedy(
        api, cfg, api.build(cfg, fs_params, fs_recipe), prompts, sc)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["w4a8-is", "w4a16-fg"])
def test_moe_m_tiles_under_replay_equal_an_eager_run(cuda, name):
    from repro_torch.kernels.moe_gemm import ragged_tile_stats
    from repro_torch.kernels.w4a8_gemm import pick_tile_m
    from repro_torch.models import moe

    api, cfg, params, recipe = _served("mixtral-8x7b", name, cuda)
    prompts = _engine_prompts(cfg)
    sc = ServeConfig(**ENGINE_SC)
    reg = obs.Registry()
    with obs.use_registry(reg):
        eng, _ = _serve(api, cfg, params, recipe, prompts, sc)
        eng.close()
    trace = moe.start_routing_trace()
    try:
        eager_greedy(api, cfg, eng.model, prompts, sc)
    finally:
        moe.stop_routing_trace(trace)
    executed = total = 0
    for rec in trace:
        C = rec["capacity"]
        st = ragged_tile_stats(rec["counts"][0].tolist(), C,
                               bm=pick_tile_m(C))
        executed += st["ragged_m_tiles"]
        total += st["dense_m_tiles"]
    tiles = reg.counter("engine_moe_m_tiles_total", "", ("kind",))
    assert (tiles.get(kind="executed"), tiles.get(kind="total")) == (
        executed, total)
    assert 0 < executed < total


@pytest.mark.cuda
def test_quarantined_slot_reused_serves_a_fresh_engines_tokens(cuda):
    """NaN logits quarantine request 0 in the only slot, whose cache rows
    are then NaN too; request 1 reuses the slot and its tokens equal a
    fresh engine's."""
    api, cfg, params, recipe = _served("llama2-7b", "w4a8-is", cuda)
    prompts = _engine_prompts(cfg, n=2)
    sc = ServeConfig(**dict(ENGINE_SC, max_slots=1))
    eng = Engine(api, cfg, params, sc, recipe=recipe)
    ChaosMonkey(ChaosConfig(nan_logits=(NanFault(tick=0, rid=0),))).install(
        eng)
    eng.add_decode_wrapper(poison_quarantined_rows(eng))
    rids = [eng.submit(p) for p in prompts]
    outs = eng.run()
    assert [eng.outcome(r) for r in rids] == ["nan", "ok"]
    assert eng.decode_traces == eng.prefill_traces == 1
    _, fresh = _serve(api, cfg, params, recipe, prompts[1:], sc)
    assert outs[rids[1]] == fresh[0]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama2-7b", "mixtral-8x7b"])
def test_served_launches_are_replays_of_the_captured_counts(cuda, arch):
    api, cfg, params, recipe = _served(arch, "w4a8-is", cuda)
    prompts = _engine_prompts(cfg)
    eng = Engine(api, cfg, params, ServeConfig(**ENGINE_SC), recipe=recipe)
    for p in prompts:
        eng.submit(p)
    torch.cuda.synchronize()
    _build.reset_launches()
    eng.run()
    torch.cuda.synchronize()
    d, p = eng._decode_step.launches, eng._prefill_step.launches
    assert d["act_quant"] > 0 and p["flash_attention"] > 0
    # each graph replayed once a tick / an admit, after one warm-up call
    assert _build.LAUNCHES == {
        k: d.get(k, 0) * (eng.ticks + 1) + p.get(k, 0) * (len(prompts) + 1)
        for k in _build.LAUNCHES}


# ---------------------------------------------------------------------------
# qlint on the card: the PTX level and the fixtures' launches
# ---------------------------------------------------------------------------

_PTX_RULE = {"broken-fp32-dot": "float-accum-on-is-path",
             "broken-narrowing": "narrowing-convert"}


@pytest.mark.cuda
@pytest.mark.parametrize("entry", qregistry.entries(), ids=lambda e: e.name)
def test_registry_ptx_level_clean(cuda, entry):
    findings, cert, _ = qlint.check_entry(entry, ptx=True)
    assert not findings, [str(f) for f in findings]
    assert cert is None or cert.verdict == "certified"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_PTX_RULE))
def test_fixture_flagged_from_its_ptx(cuda, name):
    entry = next(e for e in qfixtures.entries() if e.name == name)
    found = run_ptx_rules(entry, {s: _build.ptx(s) for s in entry.sources})
    assert _PTX_RULE[name] in {f.rule for f in found if f.level == "ptx"}


@pytest.mark.cuda
@pytest.mark.parametrize("entry", qfixtures.entries(), ids=lambda e: e.name)
def test_fixture_launch_equals_plain_pad_untouched(cuda, entry):
    name = entry.sources[0]
    before = _build.LAUNCHES.get(name, 0)
    assert qfixtures.run_on_card(entry.op, seed=3) == 0.0
    assert _build.LAUNCHES[name] == before + 1


# -- calibration PTQ on the card --------------------------------------------


def _calib_layer(K, N, n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    x = (rng.standard_normal((n, K)) * rng.uniform(0.2, 4.0, K)
         ).astype(np.float32)
    return torch.from_numpy(w), torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,n", [(512, 384, 256), (4096, 1024, 512)])
@pytest.mark.parametrize("algo", ["gptq", "awq", "quarot"])
def test_calibration_on_card_matches_cpu(cuda, algo, K, N, n):
    """GPTQ, AWQ and QuaRot on the card against the same function on the
    CPU (held to the reference there, ``tests/test_torch_calib.py``).
    AWQ: pre_scale and codes bit-equal (the scale vector is formed as on
    the CPU; only the MSE products run in another order). QuaRot: the
    rotation equal as bf16 bits; codes of ``rot.T @ w`` (an f32 product
    summed in another order) equal but for at most 1e-4 of them, each by
    one step. GPTQ: its Hessian is an f32 Gram product, summed in another
    order, and an error moves every later row's compensation: at least
    99 % of the codes equal and the calibration output MSE within 1 % of
    the CPU's."""
    from repro_torch.core.algorithms import awq, gptq, quarot

    w, x = _calib_layer(K, N, n, seed=K + n)
    if algo == "gptq":
        cpu = gptq.gptq_quantize(w, x, 4, 128)
        dev = gptq.gptq_quantize(w.to(cuda), x.to(cuda), 4, 128)
    elif algo == "awq":
        cpu = awq.awq_quantize(w, x, 4, 128)
        dev = awq.awq_quantize(w.to(cuda), x.to(cuda), 4, 128)
    else:
        cpu = quarot.quarot_quantize(w, 4, 128, seed=n)
        dev = quarot.quarot_quantize(w.to(cuda), 4, 128, seed=n)
    dev = [t.cpu() for t in dev]
    diff = (dev[0].int() - cpu[0].int()).abs()
    if algo == "awq":
        assert torch.equal(dev[2], cpu[2])
        assert torch.equal(dev[0], cpu[0])
        torch.testing.assert_close(dev[1], cpu[1], rtol=1e-6, atol=0)
    elif algo == "quarot":
        assert torch.equal(dev[2].to(torch.bfloat16).view(torch.int16),
                           cpu[2].to(torch.bfloat16).view(torch.int16))
        assert int(diff.max()) <= 1
        assert int((diff > 0).sum()) <= 1e-4 * diff.numel()
    else:
        assert float((diff == 0).float().mean()) >= 0.99
        ref = x @ w
        mse = [awq.output_mse(x, ref, *o) for o in (cpu, dev)]
        assert abs(mse[1] - mse[0]) <= 0.01 * mse[0], mse


@pytest.mark.cuda
def test_capture_records_nothing_while_a_graph_is_captured(cuda):
    """The calibration hook records eager calls and skips a CUDA graph's
    capture (its tensors hold no values yet)."""
    from repro_torch.models import common as MC

    lin = MC.Linear(None, "p", {"w": _normal(60, (64, 32), device=cuda)})
    x = _normal(61, (3, 64), device=cuda)
    MC.start_capture()
    try:
        lin(x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            lin(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            lin(x)
        graph.replay()
    finally:
        rec = MC.end_capture()
    assert len(rec["p"]) == 2
    assert torch.equal(rec["p"][0], x)


@pytest.mark.cuda
def test_gptq_captured_group_loop_equals_eager_when_reused(cuda):
    """GPTQ's group loop replayed from a captured graph, kept in a cache
    across calls of other shapes, gives the codes and scales of the same
    loop run eagerly on the card, bit for bit (a graph reads the memory
    its tensors had at capture, which must stay theirs)."""
    from repro_torch.core.algorithms import gptq

    def eager(w, x):
        K, N = w.shape
        f64 = torch.float64
        H = 2.0 * (x.T @ x).to(f64)
        d = torch.diagonal(H)
        d += 0.01 * torch.mean(d)
        w = w.to(f64).clone()
        hinv = torch.linalg.cholesky(torch.linalg.inv(H), upper=True)
        codes = torch.empty((K, N), dtype=torch.int8, device=cuda)
        scales = torch.empty((K // 128, N), device=cuda)
        s = torch.empty((N,), dtype=f64, device=cuda)
        err = torch.empty((128, N), dtype=f64, device=cuda)
        qmt = torch.full((), 7.0, dtype=f64, device=cuda)
        for g in range(K // 128):
            i0, i1 = g * 128, (g + 1) * 128
            gptq._group_rows(w[i0:i1], s, hinv[i0:i1, i0:i1], codes[i0:i1],
                             err, 7, qmt)
            scales[g] = s.float()
            w[i1:] -= hinv[i0:i1, i1:].T @ err
        return codes, scales

    cache = {}
    for K, N, seed in ((512, 256, 70), (384, 128, 71), (768, 256, 72)):
        w, x = _calib_layer(K, N, 256, seed)
        w, x = w.to(cuda), x.to(cuda)
        got = gptq.gptq_quantize(w, x, 4, 128, cache=cache)
        want = eager(w, x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(cache) == 2


# ---------------------------------------------------------------------------
# The int8 KV cache and the widths of Qwen2-72B, Granite-34B and Phi-3.5-MoE
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_kv_on_the_card_equals_the_cpu(cuda, dtype):
    from repro_torch.models.attention import quantize_kv

    x = _normal(8, (4, 128, 32, 128), 2.0).to(dtype)
    x[0, 0] = 0.0  # the 1e-8 floor
    q, s = quantize_kv(x.to(cuda))
    q_c, s_c = quantize_kv(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(q.cpu(), q_c) and torch.equal(s.cpu(), s_c)


# (K, N) of the new configs' linears: Qwen2-72B's q/o, k/v, gate/up, down;
# Granite-34B's q/o, single-head k/v, gate/up, down
NEW_WIDTHS = [(8192, 8192), (8192, 1024), (8192, 29568), (29568, 8192),
              (6144, 6144), (6144, 128), (6144, 24576), (24576, 6144)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", NEW_WIDTHS)
@pytest.mark.parametrize("M", [4, 128])
def test_is_gemm_bit_exact_at_new_widths(cuda, M, K, N):
    """The launch plan splits K at these widths (N = 128 takes 16
    splits over 2 column tiles); the amplifier is the certified one."""
    from repro_torch.analysis.certify import resolve_amplifier

    qw = quant.quantize_weight(_normal(K + N, (K, N), K ** -0.5, cuda), 4,
                               128)
    xq, sa = quant.quantize_activation(_normal(M, (M, K), 1.0, cuda))
    cert = resolve_amplifier(qw.scale.cpu().numpy(), alpha=1024,
                             group_size=128, w_bits=4)
    assert cert.ok
    isw = isc.integerize(qw, cert.resolved_alpha)
    w = packing.pack_int4(qw.qvalue)
    y = fg_gemm_integer_scale(xq, sa, w, isw.int_scale, group_size=128,
                              alpha=float(isw.alpha))
    y_p = fg_gemm_integer_scale_plain(xq, sa, w, isw.int_scale,
                                      group_size=128, alpha=float(isw.alpha))
    assert torch.equal(y, y_p)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8192, 29568, 6144, 24576, 6400])
@pytest.mark.parametrize("M", [4, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quant_bit_exact_at_new_widths(cuda, M, K, dtype):
    """f32 rows of 29568 and 24576 values take the re-reading loop (beyond
    16384), bf16 ones stay in registers (up to 32768)."""
    x = _normal(K, (M, K), 3.0, cuda).to(dtype)
    q, s = act_quant(x)
    q_p, s_p = act_quant_plain(x)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(4096, 6400), (6400, 4096)])
@pytest.mark.parametrize("C", [8, 24])
def test_ragged_is_bit_exact_at_phi_widths(cuda, K, N, C):
    """Phi-3.5-MoE's experts: 16 of them, capacities of a 4-slot decode
    (8) and a 128-token prefill (24), an empty and a full expert."""
    E = 16
    counts = [0, C] + np.random.default_rng(C).integers(1, C, E - 2).tolist()
    x, rc, qv, _, iscale, alpha = _grouped_operands(cuda, E, C, K, N, 128,
                                                    counts)
    y = moe_gemm.fg_grouped_gemm_integer_scale_ragged(
        x, rc, qv, iscale, group_size=128, alpha=alpha)
    y_p = moe_gemm.fg_grouped_gemm_integer_scale_ragged_plain(
        x, rc, qv, iscale, group_size=128, alpha=alpha)
    assert torch.equal(y, y_p)


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv", [(64, 8), (48, 1)])
def test_flash_kernel_at_new_head_layouts(cuda, Hq, Hkv):
    """Qwen2-72B's 64 query heads over 8 and Granite-34B's 48 over one
    (MQA), heads of 128, at the 128-token prefill."""
    q, k, v = (_normal(i, (1, 128, h, 128), 1.0, cuda).to(torch.bfloat16)
               for i, h in enumerate((Hq, Hkv, Hkv)))
    out = flash_attention(q, k, v)
    ref = flash_attention_plain(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= TOLERANCE


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama2-7b", "granite-34b"])
def test_engine_with_int8_cache_equals_an_eager_greedy_loop(cuda, arch):
    """The captured steps over an int8 KV cache (the prefill graph splices
    the scales with the codes): streams equal the eager loop's, one
    capture per step."""
    import dataclasses

    api, cfg, params, recipe = _served(arch, "w4a8-is", cuda)
    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    prompts = _engine_prompts(cfg)
    sc = ServeConfig(**ENGINE_SC)
    eng, outs = _serve(api, cfg, params, recipe, prompts, sc)
    eng.close()
    assert eng.cache["blocks"][0]["k"].dtype == torch.int8
    assert eng.decode_traces == eng.prefill_traces == 1
    assert outs == eager_greedy(api, cfg, eng.model, prompts, sc)


# ---------------------------------------------------------------------------
# MLA: MiniCPM3 and DeepSeek-V2, and flash at heads of 32
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,Hq,Hkv,window", [(1, 128, 8, 2, None),
                                               (2, 77, 4, 4, 16)])
def test_flash_kernel_at_head_dim_32(cuda, dtype, B, S, Hq, Hkv, window):
    """Both paths of the kernel (bf16 on the tensor cores, f32 scalar)
    instantiated at D = 32, each launched once and held to the bound."""
    q, k, v = (_normal(i, (B, S, h, 32), 1.0, cuda).to(dtype)
               for i, h in enumerate((Hq, Hkv, Hkv)))
    before = _build.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, window=window)
    assert _build.LAUNCHES["flash_attention"] == before + 1
    ref = flash_attention_plain(q, k, v, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= TOLERANCE
    assert torch.equal(out, flash_attention(q, k, v, window=window))


@pytest.mark.cuda
def test_serve_cli_smoke_qwen2_serves_on_the_card(cuda):
    """``launch/serve.py --arch qwen2-72b --smoke``'s model (heads of 32,
    W4A8-IS) served on the card: one capture per step, prefill through
    the flash kernel, streams equal to the eager loop."""
    from repro_torch.core.recipe import DEFAULT_RECIPE
    from repro_torch.launch import serve

    api, cfg, params, _ = serve._load_model("qwen2-72b", True, "cuda",
                                            DEFAULT_RECIPE)
    assert cfg.head_dim == 32
    prompts = _engine_prompts(cfg)
    sc = ServeConfig(**ENGINE_SC)
    torch.cuda.synchronize()
    _build.reset_launches()
    eng, outs = _serve(api, cfg, params, DEFAULT_RECIPE, prompts, sc)
    eng.close()
    assert _build.LAUNCHES["flash_attention"] > 0
    assert eng.decode_traces == eng.prefill_traces == 1
    assert all(eng.outcome(r) == "ok" for r in range(len(prompts)))
    assert outs == eager_greedy(api, cfg, eng.model, prompts, sc)


# (K, N) of MiniCPM3's and DeepSeek-V2's linears: kv_down (N = 288, 576),
# q_up, o (K = 16384), k_up / v_up
MLA_WIDTHS = [(2560, 288), (5120, 576), (1536, 24576), (16384, 5120),
              (256, 2560), (512, 16384)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", MLA_WIDTHS)
@pytest.mark.parametrize("M", [4, 128])
def test_is_gemm_bit_exact_at_mla_widths(cuda, M, K, N):
    """N = 288 is 4.5 column tiles of 64 (the ring's 16-column guards)."""
    from repro_torch.analysis.certify import resolve_amplifier

    qw = quant.quantize_weight(_normal(K + N, (K, N), K ** -0.5, cuda), 4,
                               128)
    xq, sa = quant.quantize_activation(_normal(M, (M, K), 1.0, cuda))
    cert = resolve_amplifier(qw.scale.cpu().numpy(), alpha=1024,
                             group_size=128, w_bits=4)
    assert cert.ok
    isw = isc.integerize(qw, cert.resolved_alpha)
    w = packing.pack_int4(qw.qvalue)
    y = fg_gemm_integer_scale(xq, sa, w, isw.int_scale, group_size=128,
                              alpha=float(isw.alpha))
    y_p = fg_gemm_integer_scale_plain(xq, sa, w, isw.int_scale,
                                      group_size=128, alpha=float(isw.alpha))
    assert y.shape == (M, N) and torch.equal(y, y_p)


def _top6_counts(tokens, E=160, k=6, C=8, seed=0):
    """Routed rows per expert from a seeded top-6 routing of ``tokens``
    tokens over E experts, clipped at capacity C."""
    logits = np.random.default_rng(seed).normal(size=(tokens, E))
    top = np.argsort(-logits, axis=1)[:, :k]
    return np.minimum(np.bincount(top.ravel(), minlength=E), C).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [4, 128])
@pytest.mark.parametrize("K,N", [(5120, 1536), (1536, 5120)])
def test_ragged_is_at_160_experts(cuda, tokens, K, N):
    """DeepSeek-V2's routed experts: 160 of them at capacity 8 (a 4-slot
    decode routes 24 rows, most experts empty; a 128-token prefill fills
    many to capacity); bit-exact to the plain version and equal to the
    dense-grouped entry on the same buffer."""
    E, C = 160, 8
    counts = _top6_counts(tokens)
    x, rc, qv, _, iscale, alpha = _grouped_operands(cuda, E, C, K, N, 128,
                                                    counts)
    y = moe_gemm.fg_grouped_gemm_integer_scale_ragged(
        x, rc, qv, iscale, group_size=128, alpha=alpha)
    y_p = moe_gemm.fg_grouped_gemm_integer_scale_ragged_plain(
        x, rc, qv, iscale, group_size=128, alpha=alpha)
    xq, sa = act_quant_plain(x.reshape(E * C, K))
    y_d = moe_gemm.fg_grouped_gemm_integer_scale(
        xq.reshape(E, C, K), sa.reshape(E, C, 1), qv, iscale,
        group_size=128, alpha=alpha)
    assert torch.equal(y, y_p) and torch.equal(y, y_d)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["is", "fs", "w8-is"])
def test_dense_weight_on_the_card_equals_the_cpu(cuda, name):
    """MLA decode's dequantized weight: the scale / alpha division is a
    tensor division (IEEE on the card too), the product f32, then bf16."""
    from repro_torch.models.attention import _dense_weight

    spec = QuantSpec(**{"is": {}, "fs": dict(scale_mode="float"),
                        "w8-is": dict(w_bits=8, amplifier="heuristic+6")}[
                            name])
    K, N = 512, 16384
    params = qlinear.quantize_linear(_normal(3, (K, N), 0.05), spec)
    got = _dense_weight({k: v.to(cuda) for k, v in params.items()}, spec, K,
                        torch.bfloat16)
    assert torch.equal(got.cpu(), _dense_weight(params, spec, K,
                                                torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-236b"])
def test_mla_engine_streams_equal_an_eager_greedy_loop(cuda, arch):
    """The captured steps over the latent cache (the absorbed decode and
    its dequantized k_up / v_up inside the decode graph; DeepSeek-V2's
    dense first layer and shared experts), W4A8-IS."""
    api, cfg, params, recipe = _served(arch, "w4a8-is", cuda)
    prompts = _engine_prompts(cfg)
    sc = ServeConfig(**ENGINE_SC)
    eng, outs = _serve(api, cfg, params, recipe, prompts, sc)
    eng.close()
    assert sorted(eng.cache["blocks"][0]) == ["c_kv", "k_rope"]
    assert eng.decode_traces == eng.prefill_traces == 1
    assert outs == eager_greedy(api, cfg, eng.model, prompts, sc)


# -- cross attention: Llama-3.2-Vision's cross layers, Whisper ----------------

XATTN_FLASH = [  # (B, Sq, Sk, Hq, Hkv, D)
    (1, 128, 1600, 64, 8, 128),  # the VLM's cross prefill
    (4, 1, 1600, 64, 8, 128),    # its cross decode
    (1, 1500, 1500, 6, 6, 64),   # Whisper's encoder
    (4, 1, 1500, 6, 6, 64),      # its cross decode
    (2, 10, 24, 4, 4, 32),       # Whisper's smoke cross prefill
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", XATTN_FLASH)
def test_flash_kernel_non_causal_sq_ne_sk(cuda, dtype, B, Sq, Sk, Hq, Hkv,
                                          D):
    """``causal=False`` with Sq != Sk: every key tile visited, the last
    one ragged (1500 and 1600 are no multiple of 64), Sq = 1 one row of a
    query tile; bf16 repeated bit for bit."""
    q = _normal(Sq + 1, (B, Sq, Hq, D), 1.0, cuda).to(dtype)
    k = _normal(Sk + 2, (B, Sk, Hkv, D), 1.0, cuda).to(dtype)
    v = _normal(Sk + 3, (B, Sk, Hkv, D), 1.0, cuda).to(dtype)
    out = flash_attention(q, k, v, causal=False)
    ref = flash_attention_plain(q, k, v, causal=False)
    assert (out.float() - ref.float()).abs().max().item() <= TOLERANCE
    assert torch.equal(out, flash_attention(q, k, v, causal=False))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(6400, 8192, 1024), (6000, 384, 384),
                                   (6000, 384, 1536), (6000, 1536, 384)])
def test_is_linear_at_thousands_of_rows_equals_the_cpu(cuda, M, K, N):
    """The memory's rows (4 x 1600 image tokens, 4 x 1500 frames) through
    a quantized linear with a bias (Whisper's q/v/o): act_quant, the IS
    GEMM (100 and 94 row tiles of 64) and the bias add on the card equal
    the CPU's plain versions bit for bit; the GEMM equals its plain
    version on the card too."""
    from repro_torch.core.recipe import QuantSpec as Spec

    spec = Spec()
    params = qlinear.quantize_linear(_normal(K, (K, N), K ** -0.5), spec,
                                     bias=_normal(N, (N,), 0.1))
    x = _normal(M, (M, K), 1.0).to(torch.bfloat16)
    got = qlinear.linear_apply({k: v.to(cuda) for k, v in params.items()},
                               x.to(cuda), spec)
    assert torch.equal(got.cpu(), qlinear.linear_apply(params, x, spec))
    xq, sa = act_quant(x.to(cuda))
    alpha = float(params["alpha"])
    y = fg_gemm_integer_scale(xq, sa, params["qvalue"].to(cuda),
                              params["scale"].to(cuda), group_size=128,
                              alpha=alpha)
    assert torch.equal(y, fg_gemm_integer_scale_plain(
        xq, sa, params["qvalue"].to(cuda), params["scale"].to(cuda),
        group_size=128, alpha=alpha))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(6400, 8192), (6000, 384), (4, 28672)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_act_quant_bit_exact_at_the_memorys_rows(cuda, M, K, dtype):
    x = _normal(M + K, (M, K), 3.0, cuda).to(dtype)
    q, s = act_quant(x)
    q_p, s_p = act_quant_plain(x)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)


_XATTN = {}


def _xattn_model(arch, device):
    """The smoke ``arch`` under W4A8-IS, built on the CPU from seed 0 (a
    VLM block by block, Whisper whole), its cross gates drawn nonzero:
    (api, cfg, params on ``device``)."""
    if arch not in _XATTN:
        from repro_torch.core import ptq
        from repro_torch.core.recipe import DEFAULT_RECIPE
        from repro_torch.models.registry import get_arch, get_model
        from repro_torch.nn import spec as S

        cfg = get_arch(arch, smoke=True)
        api = get_model(cfg)
        if cfg.family == "vlm":
            qp = ptq.quantize_by_layer(api, cfg, DEFAULT_RECIPE, device="cpu")
        else:
            qp = ptq.post_training_quantize(api, cfg, S.materialize(
                api.param_specs(cfg), torch.Generator().manual_seed(0),
                device="cpu"), DEFAULT_RECIPE)
        rng = np.random.default_rng(17)
        for blk in qp.get("blocks", []):
            if "gate_attn" in blk:
                for g in ("gate_attn", "gate_mlp"):
                    blk[g] = torch.tensor(rng.uniform(0.5, 1.5),
                                          dtype=torch.float32)
        _XATTN[arch] = (api, cfg, qp)
    api, cfg, qp = _XATTN[arch]
    from repro_torch.nn import spec as S
    return api, cfg, S.tree_map(lambda t: t.to(device), qp)


def _xattn_inputs(cfg, B, P, device):
    Sm = cfg.num_image_tokens or cfg.encoder_seq
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P))).to(device)
    mem = (_normal(4, (B, Sm, cfg.d_model), 0.1)).to(torch.bfloat16)
    return toks, mem.to(device)


def _xattn_pos(cfg, B, p, device):
    if cfg.family == "vlm":
        return torch.full((B,), p, dtype=torch.int64, device=device)
    return torch.tensor(p, dtype=torch.int64, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-tiny"])
def test_xattn_smoke_model_on_the_card_matches_the_cpu(cuda, arch):
    """The smoke VLM (its cross layer 4 gated open) and the smoke Whisper
    whole under W4A8-IS: a prefill with memory, then a decode step over
    the caches, the card's logits within 5e-2 of the largest CPU logit
    (an activation code can move by one where flash and the plain softmax
    differ by a bf16 ulp)."""
    from repro_torch.nn import spec as S
    from repro_torch.core.recipe import DEFAULT_RECIPE

    outs = []
    for dev in (cuda, torch.device("cpu")):
        api, cfg, qp = _xattn_model(arch, dev)
        model = api.build(cfg, qp, DEFAULT_RECIPE)
        cache = S.materialize(api.cache_specs(cfg, 2, 32), device=dev)
        toks, mem = _xattn_inputs(cfg, 2, 12, dev)
        with torch.inference_mode():
            pre = model(toks, mode="prefill", cache=cache, pos=0,
                        memory=mem)[0]
            dec = model(toks[:, :1], mode="decode", cache=cache,
                        pos=_xattn_pos(cfg, 2, 12, dev))[0]
        outs.append((pre.cpu(), dec.cpu()))
    for a, b in zip(*outs):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-tiny"])
def test_xattn_graph_replayed_decode_equals_the_eager_loop(cuda, arch):
    """Greedy decode over the caches after a prefill with memory: the
    decode step captured once as a CUDA graph (static token and position
    buffers; Whisper's position a 0-d tensor) and replayed gives the eager
    loop's tokens, and launches no kernel on a replay outside the graph."""
    from repro_torch.nn import spec as S
    from repro_torch.core.recipe import DEFAULT_RECIPE

    api, cfg, qp = _xattn_model(arch, cuda)
    model = api.build(cfg, qp, DEFAULT_RECIPE)
    B, P, steps = 2, 12, 6
    runs = []
    for graph in (False, True):
        cache = S.materialize(api.cache_specs(cfg, B, 32), device=cuda)
        toks, mem = _xattn_inputs(cfg, B, P, cuda)
        with torch.inference_mode():
            first = model(toks, mode="prefill", cache=cache, pos=0,
                          memory=mem)[0][:, -1].argmax(-1)
            tok, pos = first[:, None].clone(), _xattn_pos(cfg, B, P, cuda)

            def step():
                return model(tok, mode="decode", cache=cache,
                             pos=pos)[0][:, 0].argmax(-1)

            seq = [first]
            if graph:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    step()
                torch.cuda.current_stream().wait_stream(side)
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    nxt = step()
                before = dict(_build.LAUNCHES)
            for _ in range(steps):
                if graph:
                    g.replay()
                else:
                    nxt = step()
                seq.append(nxt.clone())
                tok.copy_(nxt[:, None])
                pos.add_(1)
            if graph:
                assert dict(_build.LAUNCHES) == before
        runs.append(torch.stack(seq, 1).cpu())
    assert torch.equal(runs[0], runs[1])


# ---------------------------------------------------------------------------
# the recurrent families
# ---------------------------------------------------------------------------

RECURRENT_FLASH = [  # (B, S, Hq, Hkv, window): RecurrentGemma's heads of 256
    (1, 128, 16, 1, None), (1, 300, 16, 1, 64), (2, 77, 4, 1, 16),
    (1, 200, 4, 2, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,Hq,Hkv,window", RECURRENT_FLASH)
def test_flash_kernel_at_head_dim_256(cuda, dtype, B, S, Hq, Hkv, window):
    """bf16 reloads Q's fragments from shared memory for each key tile
    (they stay in registers up to 128); f32 takes the scalar kernel."""
    q, k, v = (_normal(i, (B, S, h, 256), 1.0, cuda).to(dtype)
               for i, h in enumerate((Hq, Hkv, Hkv)))
    before = _build.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, window=window)
    assert _build.LAUNCHES["flash_attention"] == before + 1
    ref = flash_attention_plain(q, k, v, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= TOLERANCE
    assert torch.equal(out, flash_attention(q, k, v, window=window))


# (K, N) of the recurrent families' linears: RecurrentGemma's
# gate_proj / x_proj / out_proj / q / o, gate / up, down, single-head k / v;
# xLSTM's up and wx, down, the sLSTM's ff_gate / ff_up and ff_down
RECURRENT_WIDTHS = [(4096, 4096), (4096, 12288), (12288, 4096), (4096, 256),
                    (2048, 8192), (4096, 2048), (2048, 2816), (2816, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", RECURRENT_WIDTHS)
@pytest.mark.parametrize("M", [4, 128])
def test_is_gemm_bit_exact_at_recurrent_widths(cuda, M, K, N):
    """K = 2816 is 22 groups of 128: the launch plan's K split must divide
    them."""
    test_is_gemm_bit_exact_at_new_widths(cuda, M, K, N)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2048, 2816, 4096, 12288])
@pytest.mark.parametrize("M", [4, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quant_bit_exact_at_recurrent_widths(cuda, M, K, dtype):
    x = _normal(K, (M, K), 3.0, cuda).to(dtype)
    q, s = act_quant(x)
    q_p, s_p = act_quant_plain(x)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)


_RECURRENT = {}


def _recurrent_model(arch, device):
    """The smoke ``arch`` under W4A8-IS, built block by block on the CPU
    from seed 0: (api, cfg, params on ``device``)."""
    if arch not in _RECURRENT:
        from repro_torch.core import ptq
        from repro_torch.core.recipe import DEFAULT_RECIPE
        from repro_torch.models.registry import get_arch, get_model

        cfg = get_arch(arch, smoke=True)
        api = get_model(cfg)
        _RECURRENT[arch] = (api, cfg, ptq.quantize_by_layer(
            api, cfg, DEFAULT_RECIPE, device="cpu"))
    api, cfg, qp = _RECURRENT[arch]
    return api, cfg, S.tree_map(lambda t: t.to(device), qp)


def _recurrent_tokens(cfg, B, P, device):
    return torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P))).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "recurrentgemma-9b"])
def test_recurrent_smoke_model_on_the_card_matches_the_cpu(cuda, arch):
    """A prefill of 40 tokens (past Griffin's window of 16) into the
    state, then two decode steps at a 0-d position: the card's logits
    within 5e-2 of the largest CPU logit."""
    from repro_torch.core.recipe import DEFAULT_RECIPE

    outs = []
    for dev in (cuda, torch.device("cpu")):
        api, cfg, qp = _recurrent_model(arch, dev)
        model = api.build(cfg, qp, DEFAULT_RECIPE)
        cache = S.materialize(api.cache_specs(cfg, 2, 64), device=dev)
        toks = _recurrent_tokens(cfg, 2, 40, dev)
        with torch.inference_mode():
            got = [model(toks, mode="prefill", cache=cache, pos=0)[0]]
            for p in (40, 41):
                got.append(model(toks[:, p - 40:p - 39], mode="decode",
                                 cache=cache,
                                 pos=torch.tensor(p, device=dev))[0])
        outs.append([g.cpu() for g in got])
    for a, b in zip(*outs):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "recurrentgemma-9b"])
def test_recurrent_graph_replayed_decode_equals_the_eager_loop(cuda, arch):
    """Greedy decode after a prefill: the decode step as a
    ``serving.graphs.Step`` (a warm-up whose advance of the state is
    undone, one capture, then replays) gives the eager loop's tokens."""
    from repro_torch.core.recipe import DEFAULT_RECIPE
    from repro_torch.serving.graphs import Step

    api, cfg, qp = _recurrent_model(arch, cuda)
    model = api.build(cfg, qp, DEFAULT_RECIPE)
    B, P, steps = 2, 20, 8
    runs = []
    for graph in (False, True):
        cache = S.materialize(api.cache_specs(cfg, B, 64), device=cuda)
        toks = _recurrent_tokens(cfg, B, P, cuda)
        with torch.inference_mode():
            first = model(toks, mode="prefill", cache=cache,
                          pos=0)[0][:, -1].argmax(-1)
            tok = first[:, None].clone()
            pos = torch.tensor(P, device=cuda)

            def step():
                return model(tok, mode="decode", cache=cache,
                             pos=pos)[0][:, 0].argmax(-1)

            run = Step(step, cuda, state=S.leaves(cache)) if graph else step
            seq = [first]
            for _ in range(steps):
                nxt = run()
                seq.append(nxt.clone())
                tok.copy_(nxt[:, None])
                pos.add_(1)
            if graph:
                assert run.captured
        runs.append(torch.stack(seq, 1).cpu())
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_xlstm_engine_reusing_one_slot_equals_the_eager_loop(cuda):
    """One slot reused by prompts shorter than ``prefill_len``: each
    prefill starts from a zero state inside the captured step, and the
    decode graph's warm-up leaves the state where it found it."""
    from repro_torch.core.recipe import DEFAULT_RECIPE

    api, cfg, qp = _recurrent_model("xlstm-1.3b", cuda)
    prompts = _engine_prompts(cfg, n=3)
    sc = ServeConfig(max_slots=1, max_seq=64, prefill_len=16,
                     max_new_tokens=6)
    eng, outs = _serve(api, cfg, qp, DEFAULT_RECIPE, prompts, sc)
    assert eng.decode_traces == eng.prefill_traces == 1
    assert outs == eager_greedy(api, cfg, eng.model, prompts, sc)



# ---------------------------------------------------------------------------
# Training: the flash-attention backward kernel and a train step
# ---------------------------------------------------------------------------

BWD_SHAPES = [  # (B, Sq, Sk, Hq, Hkv, D, causal, window)
    (2, 128, 128, 8, 2, 128, True, None),    # GQA, B > 1
    (1, 77, 77, 4, 4, 64, True, None),       # S no multiple of the tile
    (3, 300, 300, 4, 2, 64, True, 100),      # window across key tiles
    (2, 45, 45, 4, 1, 32, True, 16),         # heads of 32, MQA, window
    (2, 33, 150, 8, 2, 128, False, None),    # non-causal, Sq != Sk
    (1, 200, 200, 4, 4, 128, False, None),   # non-causal, square
    # the train step's heads, S no multiple of the bf16 tiles (64); 288
    # dK/dV blocks, so the launch plan splits no heads
    (2, 1100, 1100, 24, 8, 128, True, None),
    # 34 dK/dV blocks: the bf16 plan splits each group's 4 heads over 4
    # blocks (f32 partials in the workspace, summed in order)
    (1, 520, 1030, 8, 2, 128, False, None)]


def _bwd_inputs(cuda, dtype, B, Sq, Sk, Hq, Hkv, D):
    return [_normal(i, s, 1.0, cuda).to(dtype) for i, s in enumerate(
        ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D), (B, Sq, Hq, D)))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", BWD_SHAPES)
def test_flash_bwd_kernel_vs_plain(cuda, dtype, B, Sq, Sk, Hq, Hkv, D,
                                   causal, window):
    """dq, dk, dv within ``BWD_REL_TOLERANCE`` x max |plain| of the plain
    version on the same inputs and the same lse, and the same bits from
    a second call (no atomics)."""
    from repro_torch.kernels.flash_attention import (
        BWD_REL_TOLERANCE, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_fwd)

    q, k, v, do = _bwd_inputs(cuda, dtype, B, Sq, Sk, Hq, Hkv, D)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    before = _build.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    assert _build.LAUNCHES["flash_attention_bwd"] == before + 1
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                     window=window)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                window=window)
    for g, w, a, t in zip(got, want, again, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        bound = BWD_REL_TOLERANCE[dtype] * w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= bound
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", BWD_SHAPES)
def test_flash_forward_lse_changes_no_output_bit(cuda, dtype, B, Sq, Sk, Hq,
                                                 Hkv, D, causal, window):
    """The forward with its lse output gives the bits of the forward
    without it; the lse is the plain version's within 1e-5 (f32 sums in
    another order)."""
    from repro_torch.kernels.flash_attention import _plain, flash_attention_fwd

    q, k, v, _ = _bwd_inputs(cuda, dtype, B, Sq, Sk, Hq, Hkv, D)
    with torch.no_grad():
        plain_out = flash_attention(q, k, v, causal=causal, window=window)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert torch.equal(o, plain_out)
    want = _plain(q, k, v, causal, window, None, True)[1]
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    assert (lse - want).abs().max().item() <= 1e-5 * max(
        1.0, want.abs().max().item())


BWD_SHAPES_256 = [  # (B, Sq, Sk, Hq, Hkv, causal, window): heads of 256
    (2, 512, 512, 16, 1, True, None),     # causal MQA, no window
    (2, 77, 77, 4, 2, True, 16),          # window, S no multiple of a tile
    (2, 33, 150, 8, 2, False, None),      # non-causal, Sq != Sk
    (1, 4096, 4096, 16, 1, True, 2048)]   # RecurrentGemma's train shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal,window", BWD_SHAPES_256)
def test_flash_bwd_kernel_vs_plain_at_head_dim_256(cuda, dtype, B, Sq, Sk,
                                                   Hq, Hkv, causal, window):
    """RecurrentGemma's head dim: ``test_flash_bwd_kernel_vs_plain``'s
    bounds and bits (bf16 two warps a 16-key row, each half of D, and the
    head split the launch plan picks; f32 the scalar kernels on 32-row
    tiles)."""
    test_flash_bwd_kernel_vs_plain(cuda, dtype, B, Sq, Sk, Hq, Hkv, 256,
                                   causal, window)


@pytest.mark.cuda
def test_flash_bwd_kernel_refuses_other_head_dims(cuda):
    from repro_torch.kernels.flash_attention import (BWD_HEAD_DIMS,
                                                     flash_attention_bwd)

    assert BWD_HEAD_DIMS == (32, 64, 128, 256)
    q, k, v, do = _bwd_inputs(cuda, torch.bfloat16, 1, 64, 64, 2, 1, 96)
    lse = torch.zeros((1, 2, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="flash_attention_bwd"):
        flash_attention_bwd(q, k, v, q, lse, do)


@pytest.mark.cuda
def test_flash_autograd_on_the_card_launches_the_backward_kernel(cuda):
    q, k, v, do = _bwd_inputs(cuda, torch.bfloat16, 2, 128, 128, 8, 2, 64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(_build.LAUNCHES)
    out = flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    assert _build.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert (_build.LAUNCHES["flash_attention_bwd"]
            == before["flash_attention_bwd"] + 1)
    assert all(g.isfinite().all() for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama2-7b", "recurrentgemma-9b",
                                  "xlstm-1.3b", "llama-3.2-vision-90b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("dtype,loss_rel,grad_rel", [
    ("bfloat16", 1e-2, 5e-2), ("float32", 1e-5, 1e-4)])
def test_train_step_on_the_card_matches_the_cpu(cuda, dtype, loss_rel,
                                                grad_rel, arch):
    """The smoke LLaMA-2-7B (4 layers, heads of 64), RecurrentGemma (5
    layers, one local attention of 64 over a window of 16), xLSTM (4
    layers, no attention), Llama-3.2-Vision (4 self layers and one gated
    cross layer over 16 image tokens, gates drawn nonzero) and Whisper (2
    encoder and 2 decoder layers over 24 frames), remat on: loss and every
    gradient leaf on the card (flash forward and backward kernels, cuBLAS
    products) against the CPU's plain versions on the same params, batch
    and memory (bf16: rounding in other places, 1e-2 / 5e-2; f32: sums in
    other orders, TF32 off), then one AdamW step on each, finite and
    counted (one backward launch an attention: self or cross)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import shapes
    from repro_torch.core import ptq
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.registry import get_arch, get_model
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as T

    cfg = dataclasses.replace(get_arch(arch, smoke=True), dtype=dtype)
    assert cfg.remat
    n_attn = {"llama2-7b": cfg.num_layers, "xlstm-1.3b": 0,
              "recurrentgemma-9b": cfg.num_layers // 3,
              "llama-3.2-vision-90b": cfg.num_layers,
              "whisper-tiny": cfg.num_encoder_layers + 2 * cfg.num_layers
              }[arch]
    api = get_model(cfg)
    batch = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=96, batch_size=2)
                              ).global_batch(0)
    spec = shapes.input_specs(cfg, shapes.Shape("t", "train", 96, 2))
    for key in ("image_embeds", "frames"):
        if key in spec:
            batch[key] = np.random.default_rng(3).normal(
                size=spec[key].shape).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        if cfg.is_encoder_decoder:  # no top-level blocks: drawn whole
            params = S.materialize(api.param_specs(cfg),
                                   torch.Generator().manual_seed(1),
                                   device="cpu")
        else:
            params = ptq.materialize_by_layer(api, cfg, seed=1, device="cpu")
        rng = np.random.default_rng(17)
        for blk in params.get("blocks", []):
            if "gate_attn" in blk:  # 0 at init: the cross layer is live
                for g in ("gate_attn", "gate_mlp"):
                    blk[g] = torch.tensor(float(rng.uniform(0.5, 1.5)))
        params = S.tree_map(lambda t: t.to(dev), params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        for key in ("image_embeds", "frames"):
            if key in b:
                b[key] = b[key].to(cfg.activation_dtype)
        leaves = S.leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = T.make_loss_fn(api, cfg)(params, b)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        before = _build.LAUNCHES["flash_attention_bwd"]
        opt = S.materialize(O.state_specs(api.param_specs(cfg)), device=dev)
        _, _, m = T.make_train_step(api, cfg, O.AdamWConfig())(params, opt, b)
        launched = _build.LAUNCHES["flash_attention_bwd"] - before
        assert launched == (n_attn if dev == cuda else 0)
        assert all(bool(v.isfinite()) for v in m.values())
        out[str(dev)] = (float(loss.detach()), [g.float().cpu() for g in grads])
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= loss_rel * abs(lc)
    for a, b in zip(gg, gc):
        assert (a - b).norm().item() <= grad_rel * b.norm().item()


# the backward at the cross-attention families' train shapes
# (B, Sq, Sk, Hq, Hkv, D, causal): Whisper's encoder (1500 keys: no
# multiple of the 64-key tile), its decoder (causal 448) and cross
# attention (448 over 1500), the VLM's cross layer (1024 over 1600, G =
# 8); and a ragged Sk = 1500 at G = 8 with one kv head, 24 key tiles, so
# the bf16 plan splits each group's 8 heads over 8 blocks (the f32
# workspace, summed in order)
BWD_CROSS_SHAPES = [
    (2, 1500, 1500, 6, 6, 64, False),
    (2, 448, 448, 6, 6, 64, True),
    (2, 448, 1500, 6, 6, 64, False),
    (1, 1024, 1600, 64, 8, 128, False),
    (1, 300, 1500, 8, 1, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", BWD_CROSS_SHAPES)
def test_flash_bwd_kernel_vs_plain_at_cross_shapes(cuda, dtype, B, Sq, Sk,
                                                   Hq, Hkv, D, causal):
    """The cross-attention families' shapes: ``test_flash_bwd_kernel_vs_
    plain``'s bounds and bits, and at the split shape the plan's head
    split."""
    from repro_torch.kernels.flash_attention import bwd_launch_plan
    from repro_torch.kernels.w4a8_gemm import _sm_count

    if (B, Sq, Sk, Hq, Hkv, D, causal) == BWD_CROSS_SHAPES[-1]:
        plan = bwd_launch_plan(B, Sq, Sk, Hq, Hkv, D, dtype,
                               _sm_count(torch.cuda.current_device()))
        assert plan["splits"] == (8 if dtype == torch.bfloat16 else 1)
    test_flash_bwd_kernel_vs_plain(cuda, dtype, B, Sq, Sk, Hq, Hkv, D,
                                   causal, None)


# ---------------------------------------------------------------------------
# Training the MoE family and MLA; the int8 dispatch
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_transport_on_the_card_equals_the_cpu(cuda, dtype):
    """``models.moe.Int8Transport`` on the card: the same bits as on the
    CPU (a true division by the f32 scale; a division by the python 127
    would be a multiply by its reciprocal there), with capacity padding,
    a row under the amax floor and rows of .5 ties; the gradient passes
    straight through."""
    from repro_torch.models import moe

    buf = _normal(40, (64, 256), 3.0)
    buf[5:9] = 0.0
    buf[9] *= 1e-10
    buf[10] = torch.round(_normal(41, (256,), 20.0)) + 0.5
    buf[10, 0] = 127.0
    buf = buf.to(dtype)
    want = moe.Int8Transport.apply(buf)
    x = buf.to(cuda).requires_grad_()
    got = moe.Int8Transport.apply(x)
    assert got.dtype == dtype and torch.equal(got.detach().cpu(), want)
    w = _normal(42, (64, 256)).to(dtype).to(cuda)
    (g,) = torch.autograd.grad((got * w).sum(), x)
    assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [
    ("mixtral-8x7b", dict(capacity_factor=1.25)),
    ("mixtral-8x7b", dict(moe_int8_dispatch=True)),
    ("deepseek-v2-236b", dict(top_k=6)),
    ("minicpm3-4b", dict(num_layers=2))])
def test_moe_and_mla_train_step_on_the_card_matches_the_cpu(cuda, arch, kw):
    """The smoke Mixtral (tokens dropped at capacity factor 1.25; the int8
    dispatch), DeepSeek-V2 at top-6 and MiniCPM3, f32, remat on: the
    routed counts equal, then the loss within 1e-5 and every gradient leaf
    within 1e-4 of the CPU's on the same params and batch (the f32 bounds
    of the dense train step's card test); Mixtral launches one flash
    backward a layer, the MLA models none; two runs on the card give the
    same bits."""
    import dataclasses

    from repro_torch.core import ptq
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models import moe
    from repro_torch.models.registry import get_arch, get_model
    from repro_torch.training import train_step as T

    cfg = dataclasses.replace(get_arch(arch, smoke=True), dtype="float32",
                              remat=True, **kw)
    api = get_model(cfg)
    batch = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=48, batch_size=2)
                              ).global_batch(0)
    out = {}
    for dev in ("cpu", cuda, cuda):
        params = ptq.materialize_by_layer(api, cfg, seed=1, device="cpu")
        params = S.tree_map(lambda t: t.to(dev), params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        leaves = S.leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        before = _build.LAUNCHES["flash_attention_bwd"]
        recs = moe.start_routing_trace()
        loss, _ = T.make_loss_fn(api, cfg)(params, b)
        grads = torch.autograd.grad(loss, leaves)
        moe.stop_routing_trace(recs)
        for t in leaves:
            t.requires_grad_(False)
        launched = _build.LAUNCHES["flash_attention_bwd"] - before
        gqa = cfg.attention == "gqa" and dev == cuda
        assert launched == (cfg.num_layers if gqa else 0)
        out.setdefault(str(dev), []).append((
            float(loss.detach()), [g.cpu() for g in grads],
            [r["counts"].cpu() for r in recs]))
    (lc, gc, rc), = out["cpu"]
    (lg, gg, rg), again = out[str(cuda)]
    assert all(torch.equal(x, y) for x, y in zip(rg, rc, strict=True))
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(gg, gc, strict=True):
        assert (a - b).norm().item() <= 1e-4 * b.norm().item()
    assert again[0] == lg
    assert all(torch.equal(x, y) for x, y in zip(again[1], gg))


@pytest.mark.cuda
def test_engine_with_int8_dispatch_captures_once(cuda):
    """The smoke Mixtral under W4A8 IS with ``moe_int8_dispatch``: the
    captured prefill and decode round the dispatch buffer through int8
    (as the reference does in every mode), each step captured once, the
    streams equal the eager loop's."""
    import dataclasses

    api, cfg, params, recipe = _served("mixtral-8x7b", "w4a8-is", cuda)
    cfg = dataclasses.replace(cfg, moe_int8_dispatch=True)
    prompts = _engine_prompts(cfg)
    sc = ServeConfig(**ENGINE_SC)
    eng, outs = _serve(api, cfg, params, recipe, prompts, sc)
    eng.close()
    assert eng._decode_step.captured and eng._prefill_step.captured
    assert eng.decode_traces == eng.prefill_traces == 1
    assert outs == eager_greedy(api, cfg, eng.model, prompts, sc)
