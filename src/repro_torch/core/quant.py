"""Quantization primitives (paper Appendix A). Port of ``repro/core/quant.py``.

Conventions
-----------
* Weights are ``(K, N)`` = (in_features, out_features); quantization axes:
  - per-channel: one scale per output channel N  -> scales ``(N,)``
  - group-wise : K split into groups of ``group_size`` -> scales ``(K/g, N)``
* Activations are ``(..., K)``; per-token quantization gives one scale per
  row -> scales ``(..., 1)``.
* Symmetric int range for b bits: ``[-(2^{b-1}-1), 2^{b-1}-1]``.

Codes and scales are bit-identical to the reference: amax in f32, a true
division ``max(amax, 1e-8) / qmax``, ``torch.round`` (half to even, like
``jnp.round``) of a true division ``x / scale``, then a clamp.

Integer products: ``torch.matmul`` has no int32 kernel on CUDA, and
the CPU's int32 ``bmm`` has no BLAS behind it, so :func:`group_partials`
forms each group's int8 x int8 partial in float64 and casts it to int32.
That is exact: a partial is at most ``group_size * 127 * 127`` in
absolute value, far below 2^53. Inside :func:`int32_partials` (the
analysis's traces, on CPU tensors) it forms the partial as an int32
``bmm`` instead, so a traced plain version is the integer contraction the
kernels run; the two agree bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch import obs


def qmax(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def qmin(bits: int, sym: bool = True) -> int:
    return -(2 ** (bits - 1) - 1) if sym else 0


# ---------------------------------------------------------------------------
# Scalar scale computation (Eq. 3 / Eq. 5)
# ---------------------------------------------------------------------------


def symmetric_scale(x: torch.Tensor, dim, bits: int, keepdim=True,
                    eps=1e-8, where: str | None = None) -> torch.Tensor:
    """``where`` labels amax-floor telemetry: rows whose absmax fell below
    ``eps`` are counted in ``amax_floor_hits_total{where}``. The count
    reads the device, so only the offline weight path passes ``where``;
    the serving path's activation scales are not counted."""
    amax = torch.amax(torch.abs(x), dim=dim, keepdim=keepdim)
    if where is not None:
        obs.current_registry().counter(
            "amax_floor_hits_total",
            "quantization scales hitting the eps amax floor", ("where",),
        ).inc(int((amax < eps).sum()), where=where)
    # divide by a tensor: PyTorch's CUDA division by a python scalar is a
    # multiply by its reciprocal, which is not the reference's true division.
    # A fill (not a host copy) makes it, so a CUDA graph can capture it.
    qm = torch.full((), float(qmax(bits)), device=amax.device)
    return torch.clamp_min(amax, eps) / qm


def quantize(x, scale, bits: int, sym: bool = True, zp=None):
    """Round-to-nearest quantize with clamping (Eq. 4 / Eq. 6)."""
    if sym:
        return torch.clamp(torch.round(x / scale), qmin(bits), qmax(bits))
    return torch.clamp(torch.round(x / scale) + zp, 0, 2**bits - 1)


# ---------------------------------------------------------------------------
# Weight quantization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QWeight:
    """Quantized weight bundle (symmetric, per the paper's main setup).

    ``qvalue`` is int8 storage regardless of logical bit-width.
    ``scale``: per-channel -> (N,), group-wise -> (K/g, N). float32.
    """

    qvalue: torch.Tensor  # int8, (K, N)
    scale: torch.Tensor  # f32, (N,) or (K/g, N)
    bits: int
    group_size: int  # -1 => per-channel (coarse)

    @property
    def fine_grained(self) -> bool:
        return self.group_size > 0


def quantize_weight(w: torch.Tensor, bits: int, group_size: int = -1,
                    clip_ratio: float = 1.0) -> QWeight:
    """Symmetric RTN weight quantization, coarse (per-channel) or fine
    (group). ``clip_ratio`` < 1 shrinks the absmax before the scale."""
    if w.ndim != 2:
        raise ValueError(f"weights must be (K, N), got {tuple(w.shape)}")
    K, N = w.shape
    w = w.float()
    if group_size <= 0:
        scale = symmetric_scale(w * clip_ratio, dim=0, bits=bits,
                                keepdim=False, where="weight")
        q = quantize(w, scale[None, :], bits)
        return QWeight(q.to(torch.int8), scale, bits, -1)
    if K % group_size != 0:
        raise ValueError(f"K={K} not divisible by group_size={group_size}")
    wg = w.reshape(K // group_size, group_size, N)
    scale = symmetric_scale(wg * clip_ratio, dim=1, bits=bits, keepdim=False,
                            where="weight")
    q = quantize(wg, scale[:, None, :], bits)
    return QWeight(q.reshape(K, N).to(torch.int8), scale, bits, group_size)


# ---------------------------------------------------------------------------
# Activation quantization (per-token, symmetric — paper default)
# ---------------------------------------------------------------------------


def quantize_activation(x: torch.Tensor, bits: int = 8):
    """Per-token symmetric quantization of the last axis.

    Returns (q int8, scale f32 broadcastable over last axis).
    """
    xf = x.float()
    scale = symmetric_scale(xf, dim=-1, bits=bits)
    return quantize(xf, scale, bits).to(torch.int8), scale


# ---------------------------------------------------------------------------
# Integer group partials shared by every fine-grained GEMM reference
# ---------------------------------------------------------------------------


_INT32_PARTIALS = [False]


@contextlib.contextmanager
def int32_partials():
    """Within: :func:`group_partials` forms its partials as an int32
    ``bmm`` (CPU tensors only), the contraction the analysis traces."""
    prev = _INT32_PARTIALS[0]
    _INT32_PARTIALS[0] = True
    try:
        yield
    finally:
        _INT32_PARTIALS[0] = prev


def group_partials(xq: torch.Tensor, wq: torch.Tensor,
                   group_size: int) -> torch.Tensor:
    """(..., M, K) int8 x (..., K, N) int8 -> (..., G, M, N) int32
    per-group partials (leading dims, such as experts, batch), formed as
    the module docstring says."""
    *lead, M, K = xq.shape
    N = wq.shape[-1]
    G = K // group_size
    x3 = xq.reshape(*lead, M, G, group_size).transpose(-3, -2).reshape(
        -1, M, group_size)                                   # (.. G, M, g)
    w3 = wq.reshape(-1, group_size, N)                       # (.. G, g, N)
    if _INT32_PARTIALS[0]:
        part = torch.bmm(x3.to(torch.int32), w3.to(torch.int32))
    else:
        part = torch.bmm(x3.double(), w3.double()).to(torch.int32)
    return part.reshape(*lead, G, M, N)


# ---------------------------------------------------------------------------
# Fine-grained GEMM reference semantics (Eq. 1) — float scale
# ---------------------------------------------------------------------------


def fg_gemm_float_scale(
    xq: torch.Tensor,  # int8 (..., K)
    sa: torch.Tensor,  # f32  (..., 1) per-token
    qw: QWeight,
) -> torch.Tensor:
    """Eq. 1: per-group integer matmul, each partial converted to f32 and
    scaled by the group's float scale, then accumulated in f32."""
    K, N = qw.qvalue.shape
    g = qw.group_size if qw.fine_grained else K
    lead = xq.shape[:-1]
    part = group_partials(xq.reshape(-1, K), qw.qvalue, g)  # (G, M, N)
    scale = qw.scale if qw.fine_grained else qw.scale.reshape(1, N)
    acc = torch.sum(part.float() * scale[:, None, :], dim=0)
    return acc.reshape(*lead, N) * sa
