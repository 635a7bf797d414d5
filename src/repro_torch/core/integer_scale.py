"""Integer Scale (the paper's core contribution, §4). Port of
``repro/core/integer_scale.py``.

Converts the per-group float scales of a fine-grained quantized weight to
integers via an *adaptive scale amplifier* alpha = 2^n (paper Listing 1),
so the group accumulation of Eq. 2 stays entirely in INT32 with a single
final I32->F32 conversion:

    O_i = s_a_i * FLOAT( sum_g (X_g_i x W_g_i^T) * INT(s_g_i * alpha) ) / alpha
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch import obs

from .quant import QWeight, group_partials, qmax

# Largest legal amplifier exponent. alpha = 2^30 keeps int_scale =
# round(scale * alpha) representable in int32 for any scale < 2 and leaves
# one bit of headroom before the 2^31 accumulator limit; every clamp on the
# amplifier path uses this single bound.
MAX_AMPLIFIER_EXP = 30


# ---------------------------------------------------------------------------
# Adaptive scale amplifier (paper Listing 1)
# ---------------------------------------------------------------------------


def heuristic_amplifier_exp(scales: torch.Tensor,
                            max_exp: int = MAX_AMPLIFIER_EXP) -> int:
    """Paper Listing 1:

        n, tmp = 0, scale_min
        while tmp < 1: tmp = scale_min * 2**n; n += 1
        amplifier = 2**(n-1)

    The amplifier exponent is the first n with ``smin * 2^n >= 1``, i.e.
    ``ceil(-log2(smin))`` clipped to [0, max_exp]. It is computed exactly
    from the f32 exponent (``smin = m * 2^e`` with m in [0.5, 1) gives
    ``1 - e``), so it is an exact integer with no log2 rounding.
    """
    smin = torch.clamp_min(torch.min(scales), 1e-30).float()
    _, e = torch.frexp(smin)
    return min(max(1 - int(e), 0), max_exp)


# ---------------------------------------------------------------------------
# Integer-scale weight bundle
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ISWeight:
    """A fine-grained QWeight whose group scales were integerized.

    ``int_scale``: int32 (K/g, N) = round(float_scale * alpha), >= 1.
    ``alpha``: the amplifier (python int; folded into the epilogue as 1/alpha).
    ``qvalue``: same int8 codes as the parent QWeight.
    """

    qvalue: torch.Tensor  # int8 (K, N)
    int_scale: torch.Tensor  # int32 (K/g, N)
    alpha: int
    bits: int
    group_size: int


def integerize(
    qw: QWeight,
    amplifier: int | Literal["heuristic"] = 1024,
) -> ISWeight:
    """Convert float group scales -> integer scales (offline, free).

    ``"heuristic"`` is Listing 1 exactly; ``"heuristic+k"`` adds k margin
    bits beyond it.
    """
    if not qw.fine_grained:
        raise ValueError("Integer Scale targets fine-grained (group) scales; "
                         "use group_size>0")
    if isinstance(amplifier, str) and amplifier.startswith("heuristic"):
        margin = int(amplifier.split("+")[1]) if "+" in amplifier else 0
        exp = heuristic_amplifier_exp(qw.scale) + margin
        alpha = 2 ** min(exp, MAX_AMPLIFIER_EXP)
    else:
        alpha = int(amplifier)
        if alpha < 1 or (alpha & (alpha - 1)) != 0:
            raise ValueError(f"amplifier must be a power of two, got {alpha}")
        if alpha > 2**MAX_AMPLIFIER_EXP:
            raise ValueError(
                f"amplifier {alpha} exceeds 2^{MAX_AMPLIFIER_EXP}; larger "
                "amplifiers are not int32-representable")
    int_scale = _int_scales(qw.scale, alpha)
    obs.current_registry().counter(
        "int_scale_floor_hits_total",
        "group scales clipped up to int_scale=1 during integerization",
    ).inc(int((torch.round(qw.scale.double() * alpha) < 1).sum()))
    return ISWeight(qw.qvalue, int_scale, alpha, qw.bits, qw.group_size)


def _int_scales(scale: torch.Tensor, alpha: int) -> torch.Tensor:
    return torch.clamp(torch.round(scale.float() * alpha),
                       1, 2**31 - 1).to(torch.int32)


# ---------------------------------------------------------------------------
# Eq. 2 reference GEMM — integer scale, one final convert
# ---------------------------------------------------------------------------


def _is_accumulate(xq: torch.Tensor, isw: ISWeight) -> torch.Tensor:
    """(..., K) int8 -> (M, N) int32 Eq. 2 accumulator."""
    K = isw.qvalue.shape[0]
    part = group_partials(xq.reshape(-1, K), isw.qvalue, isw.group_size)
    return torch.sum(part * isw.int_scale[:, None, :], dim=0,
                     dtype=torch.int32)


def fg_gemm_integer_scale(
    xq: torch.Tensor,  # int8 (..., K)
    sa: torch.Tensor,  # f32 (..., 1) per-token scales
    isw: ISWeight,
) -> torch.Tensor:
    """Eq. 2: group partials stay int32, multiplied by int32 scales and
    accumulated in int32; ONE final convert + /alpha (folded into sa)."""
    N = isw.qvalue.shape[1]
    acc = _is_accumulate(xq, isw).reshape(*xq.shape[:-1], N)
    return acc.float() * (sa / float(isw.alpha))


# ---------------------------------------------------------------------------
# Overflow audit (paper §B.4 / Fig. 8)
# ---------------------------------------------------------------------------


def overflow_bound(isw: ISWeight, a_bits: int = 8) -> int:
    """Worst-case |int32 accumulator|: sum_g g_size*|x|max*|w|max*max_n s_int.

    A static bound — if < 2^31 the layer can never overflow regardless of
    input. Summed in int64 (exact) so an unsafe bound is reported as such.
    """
    return _bound(isw.int_scale, isw.group_size, isw.bits, a_bits)


def _bound(int_scale, group_size: int, w_bits: int, a_bits: int) -> int:
    per_group = int(group_size) * qmax(a_bits) * qmax(w_bits)
    smax = torch.amax(int_scale, dim=1).to(torch.int64)
    return int(torch.sum(smax * per_group))


def empirical_max_accum(xq, isw: ISWeight) -> int:
    """Max |int32 accumulator| actually reached for a given batch (Fig. 8):
    the running group sum of Eq. 2 in int64, so an overflow shows as a
    value past 2^31 instead of wrapping."""
    K, N = isw.qvalue.shape
    g = isw.group_size
    G = K // g
    x3 = torch.as_tensor(xq).reshape(-1, G, g).to(torch.int64)
    w3 = torch.as_tensor(isw.qvalue).reshape(G, g, N).to(torch.int64)
    part = torch.einsum("tgk,gkn->tgn", x3, w3)
    acc = torch.cumsum(part * isw.int_scale.to(torch.int64)[None], dim=1)
    return int(acc.abs().max())


def would_overflow(isw: ISWeight, a_bits: int = 8) -> bool:
    return overflow_bound(isw, a_bits) >= 2**31


# ---------------------------------------------------------------------------
# §B.4 fallback: per-group de-amplification ("degraded" GEMM)
# ---------------------------------------------------------------------------


def fg_gemm_integer_scale_safe(xq, sa, isw: ISWeight):
    """Paper §B.4: each group partial is scaled in int32 then immediately
    de-amplified into an f32 accumulator — trades the single-convert
    property for guaranteed no-overflow."""
    K, N = isw.qvalue.shape
    part = group_partials(xq.reshape(-1, K), isw.qvalue, isw.group_size)
    scaled = (part * isw.int_scale[:, None, :]).float() / float(isw.alpha)
    out = torch.sum(scaled, dim=0).reshape(*xq.shape[:-1], N)
    return out * sa
