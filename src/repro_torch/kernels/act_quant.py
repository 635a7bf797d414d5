"""Per-token activation quantization: the wrapper around
``csrc/act_quant.cu`` and its plain PyTorch version.

Port of ``repro/kernels/act_quant.py`` (the producer for the quantized
GEMMs). The kernel is bit-exact to :func:`act_quant_plain`, which is in
turn bit-exact to the reference's ``act_quant_ref`` oracle.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import quantize_activation

from . import _build

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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
