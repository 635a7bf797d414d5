"""Fine-grained W4A16 weight-only GEMM (the Marlin analog): the wrapper
around ``csrc/w4a16_gemm.cu`` and its plain PyTorch version.

Port of ``repro/kernels/w4a16_gemm.py::w4a16_gemm``. Same operands:
activations (M, K) (cast to bf16, as the TPU kernel casts them),
nibble-packed int4 weights (K/2, N), f32 group scales (K/g, N); f32 out.

Tolerance against :func:`w4a16_gemm_plain`: the kernel's dequantized bf16
weights are bit-identical to the plain version's (both round
``float(w) * s`` to nearest even), and bf16 x bf16 products are exact in
f32, so only the order of the f32 sum differs: max abs diff <=
:data:`REL_TOLERANCE` x max|y_plain|. That holds when the plain f32
product is itself full f32 (``torch.backends.cuda.matmul.allow_tf32``
off): TF32 would round the bf16 operands' products and dominate the
difference.

The kernel (``csrc/w4a16_gemm.cu`` on the loop ``csrc/w4a16_ring.cuh``,
which the grouped W4A16 kernel shares) splits K on packing-unit
boundaries (:func:`~repro_torch.kernels.w4a8_gemm.launch_plan`, the plan
of every GEMM kernel) so that every shape fills the card; the splits'
partial sums go to an f32 workspace and are added in a fixed order, so a
launch is deterministic. It takes any N (rows of packed bytes that are
not 16-byte aligned are staged by plain loads).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import LAYOUT_UNIT, unpack_int4

from . import _build
from .w4a8_gemm import aligned as _aligned
from .w4a8_gemm import launch_plan_on

#: max |kernel - plain| as a fraction of max |plain| (f32 sum order)
REL_TOLERANCE = 1e-4

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def w4a16_gemm_plain(
    x: torch.Tensor,       # bf16/f32 (M, K)
    qvalue: torch.Tensor,  # int8 (K/2, N) packed
    scale: torch.Tensor,   # f32 (K/g, N)
    *,
    group_size: int,
) -> torch.Tensor:
    """Dequantize to bf16, then a GEMM with f32 accumulation (the f32
    product of the bf16-rounded operands)."""
    K = x.shape[1]
    w = unpack_int4(qvalue)
    N = w.shape[1]
    G = K // group_size
    wd = (w.reshape(G, group_size, N).float() * scale[:, None, :]).reshape(K, N)
    return x.to(torch.bfloat16).float() @ wd.to(torch.bfloat16).float()


def w4a16_gemm(
    x: torch.Tensor,
    qvalue: torch.Tensor,
    scale: torch.Tensor,
    *,
    group_size: int = 128,
    bm: int = 0,
) -> torch.Tensor:
    """W4A16 GEMM; returns f32 (M, N). CPU tensors take the plain version;
    CUDA tensors launch the kernel (``bm`` forces its row tile, 0 = by M;
    the K split follows from the shape,
    :func:`~repro_torch.kernels.w4a8_gemm.launch_plan`)."""
    if x.device.type == "cpu":
        return w4a16_gemm_plain(x, qvalue, scale, group_size=group_size)
    _build.require_cuda("w4a16_gemm", x, qvalue, scale)
    M, K = x.shape
    N = qvalue.shape[1]
    gs = group_size
    if K % LAYOUT_UNIT:
        raise ValueError(f"w4a16_gemm: K={K} is not a multiple of "
                         f"{LAYOUT_UNIT}; only the plain version takes it")
    if gs <= 0 or K % gs or gs % 16:
        raise ValueError(f"w4a16_gemm: group_size={gs} must divide K={K} "
                         "and be a multiple of 16")
    if (qvalue.dtype != torch.int8 or scale.dtype != torch.float32
            or tuple(qvalue.shape) != (K // 2, N)
            or tuple(scale.shape) != (K // gs, N)):
        raise ValueError("w4a16_gemm: operands do not match the contract")
    x, qvalue, scale = (_aligned(t) for t in
                        (x.to(torch.bfloat16), qvalue, scale))
    plan = launch_plan_on(x.device, M, N, K, bm)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    ws = (torch.empty(plan["workspace"], dtype=torch.float32,
                      device=x.device) if plan["workspace"] else None)
    fn = _build.function("w4a16_gemm", "w4a16_gemm_launch", _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), qvalue.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(),
                 M, N, K, gs, plan["bm"], plan["splits"],
                 _build.stream_of(x))
    _build.check(err, "w4a16_gemm")
    _build.count("w4a16_gemm")
    return out

