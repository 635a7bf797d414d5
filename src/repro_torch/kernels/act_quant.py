"""Per-token activation quantization: the wrappers around
``csrc/act_quant.cu`` and their plain PyTorch versions.

Port of ``repro/kernels/act_quant.py`` (the producer for the quantized
GEMMs). The kernel is bit-exact to :func:`act_quant_plain`, which is in
turn bit-exact to the reference's ``act_quant_ref`` oracle.

:func:`act_quant_routed` quantizes the routed rows of a MoE dispatch
buffer before the grouped W4A8 GEMMs (``kernels/moe_gemm.py``): the same
codes and scales, and zero codes and scales past each expert's count. It
is the same kernel, counted as an ``act_quant`` launch. Neither entry
folds an amplifier: the W4A8 GEMMs divide ``sa / alpha`` in their
epilogue, so one quantization serves every GEMM that reads the same
activation (``kernels/ops.quantize_for``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import quantize_activation

from . import _build

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_ROUTED_ARGS = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + \
    [ctypes.c_int] * 4 + [ctypes.c_void_p]


def act_quant_plain(x: torch.Tensor, bits: int = 8):
    """Per-token symmetric absmax quantization of the last axis:
    (q int8, scale f32 (..., 1)) — ``scale = max(amax, 1e-8) / qmax`` and
    ``q = clip(round(x / scale))``, both true divisions."""
    return quantize_activation(x, bits)


def _check_dtype(x: torch.Tensor, ndim: int, what: str) -> None:
    if x.ndim != ndim or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"act_quant: expected {what} bf16/f32, got "
                         f"{tuple(x.shape)} {x.dtype}")


def _launch(symbol: str, argtypes, x: torch.Tensor, ptrs, dims,
            bits: int) -> None:
    """One launch of the entry point ``symbol``: x, its dtype flag, the
    other pointers, the sizes, qmax, the stream."""
    fn = _build.function("act_quant", symbol, argtypes)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), *ptrs, *dims,
                 2 ** (bits - 1) - 1, _build.stream_of(x))
    _build.check(err, "act_quant")
    _build.count("act_quant")


def act_quant(x: torch.Tensor, *, bits: int = 8):
    """(M, K) bf16/f32 -> (q int8 (M, K), scale f32 (M, 1))."""
    if _build.takes_plain("act_quant", x):
        return act_quant_plain(x, bits)
    _build.require_cuda("act_quant", x)
    _check_dtype(x, 2, "(M, K)")
    x = x.contiguous()
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    _launch("act_quant_launch", _ARGS, x, (q.data_ptr(), scale.data_ptr()),
            (M, K), bits)
    return q, scale


def act_quant_routed_plain(x: torch.Tensor, row_counts=None, bits: int = 8):
    """(E, C, K) dispatch buffer -> (codes int8 (E, C, K), scales f32
    (E, C, 1)): per-row :func:`act_quant_plain`, with zero codes and
    scales at rows at or past ``min(row_counts[e], C)`` (None: every row
    routed)."""
    E, C, K = x.shape
    q, sa = act_quant_plain(x.reshape(E * C, K), bits)
    q, sa = q.reshape(E, C, K), sa.reshape(E, C, 1)
    if row_counts is not None:
        rc = torch.as_tensor(row_counts, device=x.device).reshape(E, 1)
        keep = (torch.arange(C, device=x.device)[None, :]
                < rc.clamp(0, C))[..., None]
        q = torch.where(keep, q, torch.zeros((), dtype=q.dtype,
                                             device=x.device))
        sa = torch.where(keep, sa, torch.zeros((), device=x.device))
    return q, sa


def act_quant_routed(x: torch.Tensor, row_counts=None, *, bits: int = 8):
    """(E, C, K) bf16/f32 -> (codes int8 (E, C, K), scales f32 (E, C, 1)),
    as :func:`act_quant_routed_plain`. On the card ``row_counts`` is int32
    (E,), read on the device (or None)."""
    if _build.takes_plain("act_quant", x):
        return act_quant_routed_plain(x, row_counts, bits)
    extra = [] if row_counts is None else [row_counts]
    _build.require_cuda("act_quant", x, *extra)
    _check_dtype(x, 3, "(E, C, K)")
    E, C, K = x.shape
    if row_counts is not None and (
            row_counts.dtype != torch.int32 or tuple(row_counts.shape) != (E,)
            or not row_counts.is_contiguous()):
        raise ValueError("act_quant: counts must be int32 (E,), contiguous")
    x = x.contiguous()
    q = torch.empty((E, C, K), dtype=torch.int8, device=x.device)
    sa = torch.empty((E, C, 1), dtype=torch.float32, device=x.device)
    counts = None if row_counts is None else row_counts.data_ptr()
    _launch("act_quant_routed_launch", _ROUTED_ARGS, x,
            (counts, q.data_ptr(), sa.data_ptr()), (E, C, K), bits)
    return q, sa
