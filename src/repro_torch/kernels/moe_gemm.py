"""Grouped (batched-expert) quantized GEMMs for MoE FFNs (paper §5.5):
the wrappers around ``csrc/moe_w4a8_is.cu``, ``csrc/moe_w4a8_fs.cu`` and
``csrc/moe_w4a16.cu``, and their plain PyTorch versions.

Port of ``repro/kernels/moe_gemm.py``. One launch runs every expert of a
MoE linear over the ``(E, C, K)`` dispatch buffer (C = per-expert
capacity) against stacked weights ``(E, K/2, N)`` (or ``(E, K, N)`` W8)
and scales ``(E, K/g, N)``:

* ``fg_grouped_gemm_integer_scale`` / ``fg_grouped_gemm_float_scale`` /
  ``grouped_w4a16_gemm``: the dense capacity-padded entry points. The
  W4A8 ones take pre-quantized codes ``xq`` and per-token scales ``sa``
  (integer scale: per-expert ``alpha``, divided as ``sa / alpha[e]``).
  Given ``row_counts`` they are the ragged GEMM on codes that
  :func:`quantize_routed` made: the serving path (``ops.qgemm_grouped``,
  where gate and up share one quantization).
* ``*_ragged``: the reference's ragged entry points. They take the RAW
  dispatch buffer and ``row_counts`` (int32 ``(E,)``, routed rows per
  expert, clamped to ``[0, C]``; ``None`` = all C); the W4A8 ones quantize
  the routed rows first (:func:`quantize_routed`), then run the GEMM on
  the codes. With counts, m-tiles wholly past an expert's count are
  skipped and, with every other unrouted row, written as exact +0.0.

On the card each W4A8 scheme is one GEMM kernel (the loop of the dense
W4A8 GEMMs, ``csrc/w4a8_ring.cuh``, with the expert in the grid) that
every entry point launches on codes and scales, dividing ``sa /
alpha[e]`` in its epilogue. So ragged == dense grouped bit for bit on
zero-filled padding, which is the reference's central MoE invariant;
grouped W4A16 is likewise one kernel. The counts are read on the device:
no wrapper copies them to the host, so a decode step stays free of host
syncs and capturable as a CUDA graph. ``splits=`` forces the W4A8
kernels' K split (0: the launch plan's, unsplit at Mixtral's shapes).

Tolerances against the plain versions: integer scale and coarse float
scale are bit-exact (integer sums; the same final multiplies); fine float
scale sums its f32 group terms in another order than ``torch.sum``: rtol
1e-5, atol 1e-4; W4A16 differs only in the f32 sum order: max abs diff <=
``w4a16_gemm.REL_TOLERANCE`` x max|y_plain| (TF32 off).

A wrapper takes its plain version only for CPU tensors; CUDA tensors
launch the kernel (or raise).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import LAYOUT_UNIT, layout_unit_for, unpack_int4
from repro_torch.core.quant import group_partials

from . import _build
from .act_quant import act_quant_plain, act_quant_routed
from .w4a16_gemm import w4a16_gemm_plain
from .w4a8_gemm import aligned as _aligned
from .w4a8_gemm import amplifiers, check_group, launch_plan_on
from .w4a8_gemm_fscale import fg_gemm_float_scale_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_IS_ARGS = [_P] * 8 + [_I] * 8 + [_P]
_FS_ARGS = [_P] * 7 + [_I] * 8 + [_P]  # no alpha
_WO_ARGS = [_P] * 6 + [_I] * 7 + [_P]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _mask_rows(y: torch.Tensor, row_counts) -> torch.Tensor:
    """Zero every row at or past ``min(row_counts[e], C)`` of (E, C, N)."""
    if row_counts is None:
        return y
    E, C, _ = y.shape
    rc = torch.as_tensor(row_counts, device=y.device).reshape(E, 1)
    keep = torch.arange(C, device=y.device)[None, :] < rc.clamp(0, C)
    return torch.where(keep[..., None], y, torch.zeros((), device=y.device))


def fg_grouped_gemm_integer_scale_plain(
    xq: torch.Tensor,         # int8 (E, C, K)
    sa: torch.Tensor,         # f32 (E, C, 1)
    qvalue: torch.Tensor,     # int8 (E, K/2, N) packed (w4) | (E, K, N) (w8)
    int_scale: torch.Tensor,  # int32 (E, K/g, N)
    *,
    group_size: int,
    alpha,                    # python float, or f32 (E,) per expert
    w_bits: int = 4,
) -> torch.Tensor:
    """Batched-expert Eq. 2, every expert in one int32 contraction: the
    dense plain GEMM's arithmetic with an expert axis (so one int32 ->
    f32 convert), 1/alpha folded into sa first (``sa / alpha[e]``, the
    reference's op order)."""
    E, C, K = xq.shape
    N = qvalue.shape[-1]
    w = (unpack_int4(qvalue.reshape(-1, N), layout_unit_for(K)).reshape(
        E, K, N) if w_bits == 4 else qvalue)
    part = group_partials(xq, w, group_size)  # (E, G, C, N) int32
    acc = torch.sum(part * int_scale[:, :, None, :], dim=1,
                    dtype=torch.int32)
    return acc.float() * (sa / amplifiers(alpha, E, sa.device).reshape(
        E, 1, 1))


def fg_grouped_gemm_float_scale_plain(
    xq: torch.Tensor,      # int8 (E, C, K)
    sa: torch.Tensor,      # f32 (E, C, 1)
    qvalue: torch.Tensor,  # int8 (E, K/2, N) packed (w4) | (E, K, N) (w8)
    scale: torch.Tensor,   # f32 (E, K/g, N) fine | (E, 1, N) coarse
    *,
    group_size: int,       # -1 => coarse
    w_bits: int = 4,
) -> torch.Tensor:
    """Batched-expert Eq. 1: each expert's dense plain GEMM."""
    return torch.stack([
        fg_gemm_float_scale_plain(xq[e], sa[e], qvalue[e], scale[e],
                                  group_size=group_size, w_bits=w_bits)
        for e in range(xq.shape[0])])


def grouped_w4a16_gemm_plain(
    x: torch.Tensor,       # bf16/f32 (E, C, K)
    qvalue: torch.Tensor,  # int8 (E, K/2, N) packed
    scale: torch.Tensor,   # f32 (E, K/g, N)
    *,
    group_size: int,
) -> torch.Tensor:
    """Batched-expert W4A16: each expert's dense plain GEMM."""
    return torch.stack([
        w4a16_gemm_plain(x[e], qvalue[e], scale[e], group_size=group_size)
        for e in range(x.shape[0])])


def _quantize_buffer(x: torch.Tensor, a_bits: int):
    """Per-token codes of the raw (E, C, K) buffer, as the unfused
    ``act_quant`` over (E*C, K)."""
    E, C, K = x.shape
    xq, sa = act_quant_plain(x.reshape(E * C, K), a_bits)
    return xq.reshape(E, C, K), sa.reshape(E, C, 1)


def fg_grouped_gemm_integer_scale_ragged_plain(
    x, row_counts, qvalue, int_scale, *, group_size: int, alpha,
    a_bits: int = 8, w_bits: int = 4,
) -> torch.Tensor:
    """Ragged Eq. 2: quantize the raw buffer, the dense grouped GEMM, then
    zeros at or past each expert's count."""
    xq, sa = _quantize_buffer(x, a_bits)
    return _mask_rows(fg_grouped_gemm_integer_scale_plain(
        xq, sa, qvalue, int_scale, group_size=group_size, alpha=alpha,
        w_bits=w_bits), row_counts)


def fg_grouped_gemm_float_scale_ragged_plain(
    x, row_counts, qvalue, scale, *, group_size: int, a_bits: int = 8,
    w_bits: int = 4,
) -> torch.Tensor:
    """Ragged Eq. 1 (fine or coarse), as the integer-scale one."""
    xq, sa = _quantize_buffer(x, a_bits)
    return _mask_rows(fg_grouped_gemm_float_scale_plain(
        xq, sa, qvalue, scale, group_size=group_size, w_bits=w_bits),
        row_counts)


def grouped_w4a16_gemm_ragged_plain(x, row_counts, qvalue, scale, *,
                                    group_size: int) -> torch.Tensor:
    """Ragged W4A16: the dense grouped GEMM, then zeros past the counts."""
    return _mask_rows(grouped_w4a16_gemm_plain(x, qvalue, scale,
                                               group_size=group_size),
                      row_counts)


def ragged_tile_stats(row_counts, C: int, bm: int = 128) -> dict:
    """Executed-m-tile accounting of a ragged launch (python ints, host).

    ``dense_m_tiles`` is what the capacity-padded launch runs,
    ``ragged_m_tiles`` what the ragged one runs: ``sum_e ceil(c_e / bm)``
    over the counts clamped to C. As the reference's, with ``bm`` clamped
    to C rounded up to 8 (which changes no count). The serving engine
    passes the grouped kernels' own row tile, ``pick_tile_m(C)``: they
    tile rows as the dense kernels do.
    """
    bm = min(bm, -(-C // 8) * 8)
    counts = [min(int(c), C) for c in row_counts]
    return {"bm": bm, "dense_m_tiles": len(counts) * -(-C // bm),
            "ragged_m_tiles": sum(-(-c // bm) for c in counts)}


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _counts_arg(row_counts, device):
    """int32 (E,) counts on the device, or None (every row routed)."""
    if row_counts is None:
        return None
    return torch.as_tensor(row_counts, device=device).to(
        torch.int32).contiguous()


def quantize_routed(x: torch.Tensor, row_counts=None, bits: int = 8):
    """The grouped W4A8 GEMMs' input from the raw (E, C, K) dispatch
    buffer: (codes int8 (E, C, K), scales f32 (E, C, 1)), zero at or past
    each expert's count (``act_quant``'s routed entry, one launch). Every
    grouped GEMM that reads the buffer can take the same pair."""
    return act_quant_routed(x, _counts_arg(row_counts, x.device), bits=bits)


def _a8_launch(name: str, xq, sa, row_counts, qvalue, scale, alpha, *,
               group_size: int, w_bits: int, bm: int, splits: int):
    """Launch ``moe_w4a8_is`` (alpha given: the epilogue divides ``sa /
    alpha[e]``) or ``moe_w4a8_fs`` (alpha None) on int8 codes with their
    scales ``sa``; rows at or past ``row_counts`` come out +0.0 (None:
    every row computed)."""
    _build.require_cuda(name, xq, sa, qvalue, scale,
                        *(t for t in (row_counts, alpha)
                          if isinstance(t, torch.Tensor)))
    E, C, K = xq.shape
    N = qvalue.shape[2]
    gs = group_size if group_size > 0 else K  # coarse: one group over K
    check_group(name, K, gs)
    rows = K // 2 if w_bits == 4 else K
    if (xq.dtype != torch.int8 or qvalue.dtype != torch.int8
            or w_bits not in (4, 8)
            or scale.dtype != (torch.float32 if alpha is None
                               else torch.int32)
            or tuple(qvalue.shape) != (E, rows, N)
            or tuple(scale.shape) != (E, K // gs, N) or sa.numel() != E * C):
        raise ValueError(f"{name}: operands do not match the contract")
    head = [_aligned(xq), sa.reshape(E * C).float().contiguous()]
    if alpha is not None:
        head.append(amplifiers(alpha, E, xq.device))
    counts = _counts_arg(row_counts, xq.device)
    qvalue, scale = _aligned(qvalue), _aligned(scale)
    plan = launch_plan_on(xq.device, C, N, K, bm, experts=E, splits=splits)
    out = torch.empty((E, C, N), dtype=torch.float32, device=xq.device)
    ws = (torch.empty(plan["workspace"], dtype=torch.float32,
                      device=xq.device) if plan["workspace"] else None)
    fn = _build.function(name, f"{name}_launch",
                         _FS_ARGS if alpha is None else _IS_ARGS)
    with torch.cuda.device(xq.device):
        err = fn(*(t.data_ptr() for t in head),
                 None if counts is None else counts.data_ptr(),
                 qvalue.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), E, C, N, K, gs,
                 w_bits, plan["bm"], plan["splits"], _build.stream_of(xq))
    _build.check(err, name)
    _build.count(name)
    return out


def fg_grouped_gemm_integer_scale(
    xq: torch.Tensor, sa: torch.Tensor, qvalue: torch.Tensor,
    int_scale: torch.Tensor, *, group_size: int = 128, alpha=1024.0,
    w_bits: int = 4, bm: int = 0, splits: int = 0, row_counts=None,
) -> torch.Tensor:
    """Batched-expert Eq. 2 on pre-quantized (E, C, K) codes; returns f32
    (E, C, N), +0.0 at or past ``row_counts`` (None: the dense grouped
    GEMM, every row). ``alpha``: a python float, or f32 (E,) per expert,
    read on the device. CPU tensors take the plain version."""
    if _build.takes_plain("moe_w4a8_is", xq):
        return _mask_rows(fg_grouped_gemm_integer_scale_plain(
            xq, sa, qvalue, int_scale, group_size=group_size, alpha=alpha,
            w_bits=w_bits), row_counts)
    return _a8_launch("moe_w4a8_is", xq, sa, row_counts, qvalue, int_scale,
                      alpha, group_size=group_size, w_bits=w_bits, bm=bm,
                      splits=splits)


def fg_grouped_gemm_float_scale(
    xq: torch.Tensor, sa: torch.Tensor, qvalue: torch.Tensor,
    scale: torch.Tensor, *, group_size: int = 128, w_bits: int = 4,
    bm: int = 0, splits: int = 0, row_counts=None,
) -> torch.Tensor:
    """Batched-expert Eq. 1 (``group_size=-1``: coarse) on pre-quantized
    codes; returns f32 (E, C, N), +0.0 at or past ``row_counts``."""
    if _build.takes_plain("moe_w4a8_fs", xq):
        return _mask_rows(fg_grouped_gemm_float_scale_plain(
            xq, sa, qvalue, scale, group_size=group_size, w_bits=w_bits),
            row_counts)
    return _a8_launch("moe_w4a8_fs", xq, sa, row_counts, qvalue, scale, None,
                      group_size=group_size, w_bits=w_bits, bm=bm,
                      splits=splits)


def fg_grouped_gemm_integer_scale_ragged(
    x: torch.Tensor, row_counts, qvalue: torch.Tensor,
    int_scale: torch.Tensor, *, group_size: int = 128, alpha=1024.0,
    a_bits: int = 8, w_bits: int = 4, bm: int = 0, splits: int = 0,
) -> torch.Tensor:
    """Ragged batched-expert Eq. 2 over the raw (E, C, K) buffer (its
    routed rows quantized, then the GEMM); returns f32 (E, C, N), +0.0
    past the counts."""
    if _build.takes_plain("moe_w4a8_is", x):
        return fg_grouped_gemm_integer_scale_ragged_plain(
            x, row_counts, qvalue, int_scale, group_size=group_size,
            alpha=alpha, a_bits=a_bits, w_bits=w_bits)
    return fg_grouped_gemm_integer_scale(
        *quantize_routed(x, row_counts, a_bits), qvalue, int_scale,
        group_size=group_size, alpha=alpha, w_bits=w_bits, bm=bm,
        splits=splits, row_counts=row_counts)


def fg_grouped_gemm_float_scale_ragged(
    x: torch.Tensor, row_counts, qvalue: torch.Tensor, scale: torch.Tensor,
    *, group_size: int = 128, a_bits: int = 8, w_bits: int = 4, bm: int = 0,
    splits: int = 0,
) -> torch.Tensor:
    """Ragged batched-expert Eq. 1 (fine or coarse), as the integer-scale
    one."""
    if _build.takes_plain("moe_w4a8_fs", x):
        return fg_grouped_gemm_float_scale_ragged_plain(
            x, row_counts, qvalue, scale, group_size=group_size,
            a_bits=a_bits, w_bits=w_bits)
    return fg_grouped_gemm_float_scale(
        *quantize_routed(x, row_counts, a_bits), qvalue, scale,
        group_size=group_size, w_bits=w_bits, bm=bm, splits=splits,
        row_counts=row_counts)


def _wo_launch(x, row_counts, qvalue, scale, *, group_size: int, bm: int):
    name = "moe_w4a16"
    _build.require_cuda(name, x, qvalue, scale,
                        *([row_counts] if isinstance(row_counts, torch.Tensor)
                          else []))
    E, C, K = x.shape
    N = qvalue.shape[2]
    gs = group_size
    if K % LAYOUT_UNIT:
        raise ValueError(f"{name}: K={K} is not a multiple of {LAYOUT_UNIT}; "
                         "only the plain version takes it")
    if gs <= 0 or K % gs or gs % 16:
        raise ValueError(f"{name}: group_size={gs} must divide K={K} and be "
                         "a multiple of 16")
    if (qvalue.dtype != torch.int8 or scale.dtype != torch.float32
            or tuple(qvalue.shape) != (E, K // 2, N)
            or tuple(scale.shape) != (E, K // gs, N)):
        raise ValueError(f"{name}: operands do not match the contract")
    x = _aligned(x.to(torch.bfloat16))
    counts = _counts_arg(row_counts, x.device)
    qvalue, scale = _aligned(qvalue), _aligned(scale)
    plan = launch_plan_on(x.device, C, N, K, bm, experts=E)
    out = torch.empty((E, C, N), dtype=torch.float32, device=x.device)
    ws = (torch.empty(plan["workspace"], dtype=torch.float32,
                      device=x.device) if plan["workspace"] else None)
    fn = _build.function(name, f"{name}_launch", _WO_ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), None if counts is None else counts.data_ptr(),
                 qvalue.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), E, C, N, K, gs,
                 plan["bm"], plan["splits"], _build.stream_of(x))
    _build.check(err, name)
    _build.count(name)
    return out


def grouped_w4a16_gemm(
    x: torch.Tensor, qvalue: torch.Tensor, scale: torch.Tensor, *,
    group_size: int = 128, bm: int = 0,
) -> torch.Tensor:
    """Dense batched-expert W4A16 (activations cast to bf16); returns f32
    (E, C, N)."""
    if _build.takes_plain("moe_w4a16", x):
        return grouped_w4a16_gemm_plain(x, qvalue, scale,
                                        group_size=group_size)
    return _wo_launch(x, None, qvalue, scale, group_size=group_size, bm=bm)


def grouped_w4a16_gemm_ragged(
    x: torch.Tensor, row_counts, qvalue: torch.Tensor, scale: torch.Tensor,
    *, group_size: int = 128, bm: int = 0,
) -> torch.Tensor:
    """Ragged batched-expert W4A16: zeros past the counts."""
    if _build.takes_plain("moe_w4a16", x):
        return grouped_w4a16_gemm_ragged_plain(x, row_counts, qvalue, scale,
                                               group_size=group_size)
    return _wo_launch(x, row_counts, qvalue, scale, group_size=group_size,
                      bm=bm)
