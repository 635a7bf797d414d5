"""Fine-grained and coarse W4A8 / W8A8 GEMM with FLOAT scales (paper
Eq. 1, the baseline Integer Scale replaces): the wrapper around
``csrc/w4a8_gemm_fs.cu`` and its plain PyTorch version.

Port of ``repro/kernels/w4a8_gemm_fscale.py::fg_gemm_float_scale``. Same
operands: int8 activations (M, K), per-token ``sa`` (M, 1), nibble-packed
int4 weights (K/2, N) (or int8 (K, N) with ``w_bits=8``), f32 group scales
(K/g, N), or one row (1, N) with ``group_size=-1`` (coarse, per channel).

Tolerances against :func:`fg_gemm_float_scale_plain`: coarse is
bit-exact (one int32 sum over all of K, its K splits included, then
``* scale * sa`` in the same order); fine sums its f32 group terms in
another order than ``torch.sum``, so it agrees within rtol 1e-5, atol
1e-4 (f32 outputs). The kernel is the IS kernel's loop
(``csrc/w4a8_ring.cuh``) with the float-scale group step, launched by the
same plan (:func:`~repro_torch.kernels.w4a8_gemm.launch_plan`).
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import unpack_int4
from repro_torch.core.quant import group_partials

from . import _build
from .w4a8_gemm import _FS_ARGS as _ARGS  # noqa: F401  (its entry point's)
from .w4a8_gemm import aligned, check_group, launch_plan_on, launch_ring


def fg_gemm_float_scale_plain(
    xq: torch.Tensor,      # int8 (M, K)
    sa: torch.Tensor,      # f32 (M, 1)
    qvalue: torch.Tensor,  # int8 (K/2, N) packed (w4) or (K, N) (w8)
    scale: torch.Tensor,   # f32 (K/g, N) fine or (1, N) coarse
    *,
    group_size: int,       # -1 => coarse
    w_bits: int = 4,
) -> torch.Tensor:
    """Eq. 1: per-group I32 -> F32 convert + float-scale accumulate."""
    K = xq.shape[1]
    gs = group_size if group_size > 0 else K
    w = unpack_int4(qvalue) if w_bits == 4 else qvalue
    part = group_partials(xq, w, gs)  # (G, M, N) int32
    return torch.sum(part.float() * scale[:, None, :], dim=0) * sa


def fg_gemm_float_scale(
    xq: torch.Tensor,
    sa: torch.Tensor,
    qvalue: torch.Tensor,
    scale: torch.Tensor,
    *,
    group_size: int = 128,
    w_bits: int = 4,
    bm: int = 0,
) -> torch.Tensor:
    """Eq. 1 GEMM; returns f32 (M, N). CPU tensors take the plain version;
    CUDA tensors launch the kernel (``bm`` picks its row tile, 0 = by M;
    the K split follows from the shape)."""
    if xq.device.type == "cpu":
        return fg_gemm_float_scale_plain(xq, sa, qvalue, scale,
                                         group_size=group_size, w_bits=w_bits)
    _build.require_cuda("w4a8_gemm_fs", xq, sa, qvalue, scale)
    M, K = xq.shape
    N = qvalue.shape[1]
    # coarse: one group over all of K
    gs = group_size if group_size > 0 else K
    check_group("w4a8_gemm_fs", K, gs)
    rows = K // 2 if w_bits == 4 else K
    if (xq.dtype != torch.int8 or qvalue.dtype != torch.int8
            or scale.dtype != torch.float32 or w_bits not in (4, 8)
            or tuple(qvalue.shape) != (rows, N)
            or tuple(scale.shape) != (K // gs, N) or sa.numel() != M):
        raise ValueError("w4a8_gemm_fs: operands do not match the contract")
    sa = sa.reshape(M).float().contiguous()
    return launch_ring("w4a8_gemm_fs", aligned(xq), sa, None, aligned(qvalue),
                       aligned(scale), gs, w_bits,
                       launch_plan_on(xq.device, M, N, K, bm))
