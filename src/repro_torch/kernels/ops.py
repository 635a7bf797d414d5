"""Scheme dispatch over the quantized GEMM kernels. Port of
``repro/kernels/ops.py``.

``qgemm(x, params, qspec, launch=...)`` takes the qlinear param dict
(``{"qvalue", "scale", "alpha"?}``) and dispatches on the qspec as the
reference does: weight-only W4A16 runs ``w4a16_gemm`` (no act-quant);
fine-grained integer scale runs ``act_quant`` then the Eq. 2 GEMM;
everything else (fine float scale, and coarse of either scale mode) runs
``act_quant`` then the Eq. 1 GEMM. Weight-only with other than 4-bit
weights raises ``NotImplementedError``, as in the reference. On CUDA
tensors the wrappers launch the Hopper kernels; on CPU tensors they take
their plain versions. ``qgemm_grouped(x, params, qspec, row_counts=,
launch=)`` is the batched-expert (MoE) counterpart over an ``(E, C, K)``
dispatch buffer and stacked per-expert params, with the same scheme
dispatch onto the ragged grouped kernels of ``kernels/moe_gemm.py``
(activation quantization fused; m-tiles past ``row_counts`` skipped).

``params["alpha"]`` (the integer-scale amplifier) is resolved as in the
reference: the stored per-layer value wins and, being a tensor, is folded
into the per-token activation scale (exact for power-of-two amplifiers);
without it a static integer ``qspec.amplifier`` is the fallback, and a
heuristic amplifier raises (it only exists per layer).

Telemetry: every call increments ``qgemm_calls_total{scheme,kind,shape,
block}``. The port runs eagerly, so these count executions. The
reference also counts ragged m-tiles here when ``row_counts`` is concrete;
in the port the counts stay on the device (reading them would be a host
sync), so the serving engine counts m-tiles at its tick boundary instead.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.core.recipe import QuantSpec

from .act_quant import act_quant
from .moe_gemm import (fg_grouped_gemm_float_scale_ragged,
                       fg_grouped_gemm_integer_scale_ragged,
                       grouped_w4a16_gemm_ragged)
from .w4a16_gemm import w4a16_gemm
from .w4a8_gemm import TILE_M, TILE_N, fg_gemm_integer_scale, pick_tile_m
from .w4a8_gemm_fscale import fg_gemm_float_scale


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """Launch configuration of the Hopper GEMMs: their row tile ``bm``
    (16 for decode, 64 for prefill; 0 picks by M). Validated at
    construction, like the reference's ``BlockConfig``."""

    bm: int = 0

    def __post_init__(self):
        if self.bm not in (0, *TILE_M):
            raise ValueError(f"LaunchConfig.bm={self.bm!r}: must be 0 (by M) "
                             f"or one of {TILE_M}")


def _resolve_alpha(alpha, qspec: QuantSpec):
    """Amplifier for the integer-scale epilogue.

    The stored per-layer ``params["alpha"]`` always wins — it is the
    value the overflow cap covers (possibly below the qspec's request).
    Without it, a static integer ``qspec.amplifier`` is an exact fallback;
    heuristic amplifiers resolve per layer at quantization time, so
    substituting a constant would rescale the output — raise.
    """
    if alpha is not None:
        return alpha
    if isinstance(qspec.amplifier, int):
        return float(qspec.amplifier)
    raise ValueError(
        f"qspec.amplifier={qspec.amplifier!r} is resolved per layer at "
        "quantization time; pass the stored per-layer alpha "
        "(params['alpha']) — no static fallback exists for heuristic "
        "amplifiers")


def _scheme_of(qspec: QuantSpec) -> str:
    if qspec.weight_only:
        return f"w{qspec.w_bits}a16"
    s = "is" if (qspec.scale_mode == "integer" and qspec.fine_grained) \
        else "fs"
    return f"w{qspec.w_bits}a{qspec.a_bits}-{s}"


def qgemm(
    x: torch.Tensor,        # (M, K) bf16/f32 activations
    params: dict,           # qlinear param dict: qvalue, scale, alpha?
    qspec: QuantSpec,
    *,
    launch: LaunchConfig | None = None,
) -> torch.Tensor:
    """Quantized GEMM honoring ``qspec``; returns f32 (M, N)."""
    if not isinstance(params, dict):
        raise TypeError("qgemm takes the qlinear param dict as its second "
                        "argument")
    launch = launch or LaunchConfig()
    M = x.shape[0]
    N = params["qvalue"].shape[-1]
    scheme = _scheme_of(qspec)
    obs.current_registry().counter(
        "qgemm_calls_total", "kernels.ops wrapper calls",
        ("scheme", "kind", "shape", "block"),
    ).inc(scheme=scheme, kind="dense", shape=f"{M}x{x.shape[1]}x{N}",
          block=f"{pick_tile_m(M, launch.bm)}x{TILE_N}")

    if qspec.weight_only:
        if qspec.w_bits != 4:
            raise NotImplementedError("weight-only kernel is W4A16")
        return w4a16_gemm(x, params["qvalue"], params["scale"],
                          group_size=qspec.group_size, bm=launch.bm)

    xq, sa = act_quant(x, bits=qspec.a_bits)
    if not (qspec.scale_mode == "integer" and qspec.fine_grained):
        return fg_gemm_float_scale(
            xq, sa, params["qvalue"], params["scale"],
            group_size=qspec.group_size, w_bits=qspec.w_bits, bm=launch.bm)
    a = _resolve_alpha(params.get("alpha"), qspec)
    if isinstance(a, torch.Tensor):
        # stored per-layer amplifier: fold 1/alpha into sa (exact for the
        # power-of-two alphas Integer Scale emits)
        sa = sa / a
        a = 1.0
    return fg_gemm_integer_scale(
        xq, sa, params["qvalue"], params["scale"],
        group_size=qspec.group_size, alpha=float(a), w_bits=qspec.w_bits,
        bm=launch.bm)


def qgemm_grouped(
    x: torch.Tensor,        # (E, C, K) bf16/f32 dispatch buffer
    params: dict,           # stacked per-expert param dict
    qspec: QuantSpec,
    *,
    row_counts=None,        # int32 (E,) routed rows per expert | None = all C
    launch: LaunchConfig | None = None,
) -> torch.Tensor:
    """Batched-expert quantized GEMM; returns f32 (E, C, N).

    Always routes through the ragged grouped kernels
    (``kernels.moe_gemm``): activation quantization happens inside the
    kernel, and m-tiles wholly past an expert's ``row_counts`` are skipped
    (their rows, and every row at or past the count, come out as zeros;
    the MoE dispatch zero-fills them anyway). ``row_counts`` stays a
    device tensor; ``None`` treats every capacity slot as routed.
    """
    if not isinstance(params, dict):
        raise TypeError("qgemm_grouped takes the stacked qlinear param dict "
                        "as its second argument")
    launch = launch or LaunchConfig()
    E, C, K = x.shape
    N = params["qvalue"].shape[-1]
    obs.current_registry().counter(
        "qgemm_calls_total", "kernels.ops wrapper calls",
        ("scheme", "kind", "shape", "block"),
    ).inc(scheme=_scheme_of(qspec), kind="grouped",
          shape=f"{E}x{C}x{K}x{N}", block=f"{pick_tile_m(C, launch.bm)}x{TILE_N}")

    if qspec.weight_only:
        if qspec.w_bits != 4:
            raise NotImplementedError("weight-only kernel is W4A16")
        return grouped_w4a16_gemm_ragged(
            x, row_counts, params["qvalue"], params["scale"],
            group_size=qspec.group_size, bm=launch.bm)
    if qspec.scale_mode == "integer" and qspec.fine_grained:
        a = _resolve_alpha(params.get("alpha"), qspec)
        return fg_grouped_gemm_integer_scale_ragged(
            x, row_counts, params["qvalue"], params["scale"],
            group_size=qspec.group_size, alpha=a, a_bits=qspec.a_bits,
            w_bits=qspec.w_bits, bm=launch.bm)
    return fg_grouped_gemm_float_scale_ragged(
        x, row_counts, params["qvalue"], params["scale"],
        group_size=qspec.group_size, a_bits=qspec.a_bits,
        w_bits=qspec.w_bits, bm=launch.bm)
