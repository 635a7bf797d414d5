"""Plain PyTorch oracles with the operand contracts of
``repro/kernels/ref.py``.

Every oracle takes the same packed/quantized operands as its kernel. The
two with a Hopper kernel in this package are the kernels' plain versions,
defined beside their wrappers and re-exported here under the reference's
names; the float-scale and W4A16 oracles wait for their kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import unpack_int4
from repro_torch.core.quant import group_partials

from .act_quant import act_quant_plain as act_quant_ref
from .w4a8_gemm import fg_gemm_integer_scale_plain as fg_gemm_is_ref

__all__ = ["act_quant_ref", "fg_gemm_fs_ref", "fg_gemm_is_ref",
           "w4a16_gemm_ref"]


def fg_gemm_fs_ref(
    xq: torch.Tensor,      # int8 (M, K)
    sa: torch.Tensor,      # f32 (M, 1)
    qvalue: torch.Tensor,  # int8 (K/2, N) packed (w4) or (K, N) (w8)
    scale: torch.Tensor,   # f32 (K/g, N) fine or (1, N) coarse
    *,
    group_size: int,       # -1 => coarse
    w_bits: int = 4,
) -> torch.Tensor:
    """Eq. 1 oracle: per-group I32->F32 convert + float-scale accumulate."""
    K = xq.shape[1]
    gs = group_size if group_size > 0 else K
    w = unpack_int4(qvalue) if w_bits == 4 else qvalue
    part = group_partials(xq, w, gs)  # (G, M, N) int32
    return torch.sum(part.float() * scale[:, None, :], dim=0) * sa


def w4a16_gemm_ref(
    x: torch.Tensor,       # bf16/f32 (M, K)
    qvalue: torch.Tensor,  # int8 (K/2, N) packed
    scale: torch.Tensor,   # f32 (K/g, N)
    *,
    group_size: int,
) -> torch.Tensor:
    """Marlin-analog oracle: dequantize to bf16, then a bf16 GEMM with f32
    accumulation (f32 product of the bf16-rounded operands)."""
    K = x.shape[1]
    w = unpack_int4(qvalue)
    N = w.shape[1]
    G = K // group_size
    wd = (w.reshape(G, group_size, N).float() * scale[:, None, :]).reshape(K, N)
    return x.to(torch.bfloat16).float() @ wd.to(torch.bfloat16).float()
