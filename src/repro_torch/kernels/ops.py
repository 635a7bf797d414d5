"""Scheme dispatch over the quantized GEMM kernels. Port of
``repro/kernels/ops.py``.

``qgemm(x, params, qspec, launch=...)`` takes the qlinear param dict
(``{"qvalue", "scale", "alpha"?}``) and dispatches on the qspec: the
fine-grained integer-scale scheme runs ``act_quant`` then the Eq. 2 GEMM.
On CUDA tensors both are the Hopper kernels; on CPU tensors the wrappers
take their plain versions. The float-scale (Eq. 1) and W4A16 schemes have
no Hopper kernel yet: on CUDA they raise ``NotImplementedError`` (their
kernels come with the second port slice, the paper's baselines); on the
CPU they run the plain oracles. ``qgemm_grouped`` (MoE) waits for the MoE
slice.

``params["alpha"]`` (the integer-scale amplifier) is resolved as in the
reference: the stored per-layer value wins and, being a tensor, is folded
into the per-token activation scale (exact for power-of-two amplifiers);
without it a static integer ``qspec.amplifier`` is the fallback, and a
heuristic amplifier raises (it only exists per layer).

Telemetry: every call increments ``qgemm_calls_total{scheme,kind,shape,
block}``. The port runs eagerly, so these count executions.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.core.recipe import QuantSpec

from . import ref
from .act_quant import act_quant
from .w4a8_gemm import TILE_M, TILE_N, fg_gemm_integer_scale, pick_tile_m


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """Launch configuration of the Hopper IS GEMM: its row tile ``bm``
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

    if not (qspec.scale_mode == "integer" and qspec.fine_grained
            and not qspec.weight_only):
        if x.device.type != "cpu":
            raise NotImplementedError(
                f"qgemm: scheme {scheme} has no Hopper kernel yet; the "
                "float-scale and W4A16 kernels come with the second port "
                "slice (the paper's baselines)")
        if qspec.weight_only:
            return ref.w4a16_gemm_ref(x, params["qvalue"], params["scale"],
                                      group_size=qspec.group_size)
        xq, sa = act_quant(x, bits=qspec.a_bits)
        return ref.fg_gemm_fs_ref(xq, sa, params["qvalue"], params["scale"],
                                  group_size=qspec.group_size,
                                  w_bits=qspec.w_bits)

    xq, sa = act_quant(x, bits=qspec.a_bits)
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
