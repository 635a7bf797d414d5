"""Per-token activation quantization: the wrappers around
``csrc/act_quant.cu`` and their plain PyTorch versions.

Port of ``repro/kernels/act_quant.py`` (the producer for the quantized
GEMMs). The kernel is bit-exact to :func:`act_quant_plain`, which is in
turn bit-exact to the reference's ``act_quant_ref`` oracle.

:func:`act_quant_routed` quantizes the routed rows of a MoE dispatch
buffer once before a grouped W4A8 GEMM (``kernels/moe_gemm.py``): the
same codes, with the per-row factor ``sa / alpha[e]`` that the
reference's ragged kernel folds in its epilogue, and zero codes and
factors past each expert's count. It counts as an ``act_quant`` launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import quantize_activation

from . import _build
from .w4a8_gemm import aligned

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_ROUTED_ARGS = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + \
    [ctypes.c_int] * 4 + [ctypes.c_void_p]


def act_quant_plain(x: torch.Tensor, bits: int = 8):
    """Per-token symmetric absmax quantization of the last axis:
    (q int8, scale f32 (..., 1)) — ``scale = max(amax, 1e-8) / qmax`` and
    ``q = clip(round(x / scale))``, both true divisions."""
    return quantize_activation(x, bits)


def act_quant(x: torch.Tensor, *, bits: int = 8):
    """(M, K) bf16/f32 -> (q int8 (M, K), scale f32 (M, 1))."""
    if x.device.type == "cpu":
        return act_quant_plain(x, bits)
    _build.require_cuda("act_quant", x)
    if x.ndim != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"act_quant: expected (M, K) bf16/f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    fn = _build.function("act_quant", "act_quant_launch", _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
                 scale.data_ptr(), M, K, 2 ** (bits - 1) - 1,
                 _build.stream_of(x))
    _build.check(err, "act_quant")
    _build.count("act_quant")
    return q, scale


def act_quant_routed_plain(x: torch.Tensor, row_counts=None, alpha=None,
                           bits: int = 8):
    """(E, C, K) dispatch buffer -> (codes int8 (E, C, K), factor f32
    (E, C)): per-row :func:`act_quant_plain`, the factor ``sa / alpha[e]``
    (``alpha`` (E,) f32; None: ``sa``), and zero codes and factor at rows
    at or past ``min(row_counts[e], C)`` (None: every row routed)."""
    E, C, K = x.shape
    q, sa = act_quant_plain(x.reshape(E * C, K), bits)
    q, fac = q.reshape(E, C, K), sa.reshape(E, C)
    if alpha is not None:
        fac = fac / alpha.reshape(E, 1)
    if row_counts is not None:
        rc = torch.as_tensor(row_counts, device=x.device).reshape(E, 1)
        keep = torch.arange(C, device=x.device)[None, :] < rc.clamp(0, C)
        q = torch.where(keep[..., None], q, torch.zeros((), dtype=q.dtype,
                                                        device=x.device))
        fac = torch.where(keep, fac, torch.zeros((), device=x.device))
    return q, fac


def act_quant_routed(x: torch.Tensor, row_counts=None, alpha=None, *,
                     bits: int = 8):
    """(E, C, K) bf16/f32 -> (codes int8 (E, C, K), factor f32 (E, C)), as
    :func:`act_quant_routed_plain`. On the card ``row_counts`` is int32 (E,)
    and ``alpha`` f32 (E,), both read on the device (or None)."""
    if x.device.type == "cpu":
        return act_quant_routed_plain(x, row_counts, alpha, bits)
    extra = [t for t in (row_counts, alpha) if t is not None]
    _build.require_cuda("act_quant", x, *extra)
    if x.ndim != 3 or x.dtype not in (torch.bfloat16, torch.float32) \
            or x.shape[2] % 16:
        raise ValueError(f"act_quant: expected (E, C, K) bf16/f32 with "
                         f"K % 16 == 0, got {tuple(x.shape)} {x.dtype}")
    E, C, K = x.shape
    for t, dtype in ((row_counts, torch.int32), (alpha, torch.float32)):
        if t is not None and (t.dtype != dtype or tuple(t.shape) != (E,)
                              or not t.is_contiguous()):
            raise ValueError("act_quant: counts must be int32 (E,) and "
                             "alpha f32 (E,), contiguous")
    x = aligned(x)
    q = torch.empty((E, C, K), dtype=torch.int8, device=x.device)
    fac = torch.empty((E, C), dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _build.function("act_quant", "act_quant_routed_launch", _ROUTED_ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 ptr(row_counts), ptr(alpha), q.data_ptr(), fac.data_ptr(),
                 E, C, K, 2 ** (bits - 1) - 1, _build.stream_of(x))
    _build.check(err, "act_quant")
    _build.count("act_quant")
    return q, fac
