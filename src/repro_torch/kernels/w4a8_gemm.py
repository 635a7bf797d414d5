"""Fine-grained W4A8 / W8A8 GEMM with Integer Scale (paper Eq. 2): the
wrapper around ``csrc/w4a8_gemm_is.cu`` and its plain PyTorch version.

Port of ``repro/kernels/w4a8_gemm.py::fg_gemm_integer_scale``. Same
operands: int8 activations (M, K), per-token ``sa`` (M, 1), nibble-packed
int4 weights (K/2, N) (or int8 (K, N) with ``w_bits=8``), int32 group
scales (K/g, N). The kernel receives the per-row factor ``sa / alpha``
already divided (exact for the power-of-two amplifiers Integer Scale
uses), so its epilogue is one convert and one multiply; the output is
bit-identical to :func:`fg_gemm_integer_scale_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import LAYOUT_UNIT, unpack_int4
from repro_torch.core.quant import group_partials

from . import _build

TILE_M = (16, 64)  # the kernel's row tiles: decode, prefill
TILE_N = 64        # its column tile (BN in csrc/w4a8_gemm_is.cu)

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def fg_gemm_integer_scale_plain(
    xq: torch.Tensor,        # int8 (M, K)
    sa: torch.Tensor,        # f32 (M, 1)
    qvalue: torch.Tensor,    # int8 (K/2, N) packed (w4) or (K, N) (w8)
    int_scale: torch.Tensor, # int32 (K/g, N)
    *,
    group_size: int,
    alpha: float,
    w_bits: int = 4,
) -> torch.Tensor:
    """Eq. 2: int32 group accumulation, single final convert.

    Group partials are formed in float64 (exact, see
    ``core.quant.group_partials``) because CUDA has no int32 matmul, then
    summed in int32 like the reference's accumulator.
    """
    w = unpack_int4(qvalue) if w_bits == 4 else qvalue
    part = group_partials(xq, w, group_size)  # (G, M, N) int32
    acc = torch.sum(part * int_scale[:, None, :], dim=0, dtype=torch.int32)
    return acc.float() * (sa / alpha)


def pick_tile_m(M: int, bm: int = 0) -> int:
    """Row tile: 16 for decode-sized M, 64 above; ``bm`` forces one."""
    if bm:
        if bm not in TILE_M:
            raise ValueError(f"bm={bm}: the kernel has row tiles {TILE_M}")
        return bm
    return 16 if M <= 16 else 64


def fg_gemm_integer_scale(
    xq: torch.Tensor,
    sa: torch.Tensor,
    qvalue: torch.Tensor,
    int_scale: torch.Tensor,
    *,
    group_size: int = 128,
    alpha: float = 1024.0,
    w_bits: int = 4,
    bm: int = 0,
) -> torch.Tensor:
    """Eq. 2 GEMM; returns f32 (M, N). CPU tensors take the plain version;
    CUDA tensors launch the kernel (``bm`` picks its row tile, 0 = by M)."""
    if xq.device.type == "cpu":
        return fg_gemm_integer_scale_plain(
            xq, sa, qvalue, int_scale, group_size=group_size, alpha=alpha,
            w_bits=w_bits)
    _build.require_cuda("w4a8_gemm_is", xq, sa, qvalue, int_scale)
    M, K = xq.shape
    N = qvalue.shape[1]
    gs = group_size
    if K % LAYOUT_UNIT:
        raise ValueError(f"w4a8_gemm_is: K={K} is not a multiple of "
                         f"{LAYOUT_UNIT}; only the plain version takes it")
    if gs <= 0 or K % gs or gs % 32:
        raise ValueError(f"w4a8_gemm_is: group_size={gs} must divide K={K} "
                         "and be a multiple of 32")
    rows = K // 2 if w_bits == 4 else K
    if (xq.dtype != torch.int8 or qvalue.dtype != torch.int8
            or int_scale.dtype != torch.int32 or w_bits not in (4, 8)
            or tuple(qvalue.shape) != (rows, N)
            or tuple(int_scale.shape) != (K // gs, N) or sa.numel() != M):
        raise ValueError("w4a8_gemm_is: operands do not match the contract")
    xq = xq.contiguous()
    if xq.data_ptr() % 16:
        xq = xq.clone()
    fac = (sa.reshape(M).float() / alpha).contiguous()
    qvalue, int_scale = qvalue.contiguous(), int_scale.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    fn = _build.function("w4a8_gemm_is", "w4a8_gemm_is_launch", _ARGS)
    with torch.cuda.device(xq.device):
        err = fn(xq.data_ptr(), fac.data_ptr(), qvalue.data_ptr(),
                 int_scale.data_ptr(), out.data_ptr(), M, N, K, gs, w_bits,
                 pick_tile_m(M, bm), _build.stream_of(xq))
    _build.check(err, "w4a8_gemm_is")
    _build.count("w4a8_gemm_is")
    return out
