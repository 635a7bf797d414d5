"""Quantized linear layer: spec declaration, offline quantization, apply.
Port of ``repro/core/qlinear.py``.

A linear layer is declared through :func:`linear_specs` (a MoE layer's
expert-stacked linears through :func:`expert_linear_specs`); depending on the
:class:`~repro_torch.core.recipe.QuantSpec` attached to its path it is

  * an FP (bf16) linear                        (spec is None)
  * fine/coarse W{4,8}A{4,8,16} quantized      (storage: packed int4 / int8)

Apply runs every quantized scheme through ``kernels.ops.qgemm``
(:func:`grouped_linear_apply`: ``kernels.ops.qgemm_grouped``). The
tensor's device is the only switch: on CUDA tensors the wrappers launch
the Hopper kernels (or raise), on CPU tensors they take their plain
PyTorch versions. There is no kernel mode to thread.

Overflow safety: :func:`finish_quant` certifies each integer-scale
layer's amplifier with ``analysis.certify.resolve_amplifier`` (the interval
interpreter over the port's traced int32 Eq. 2 contraction, the
reference's certificate field for field) and caps it to the largest
statically safe power of two.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import ops as kops
from repro_torch.nn import spec as S
from . import packing
from .integer_scale import integerize
from .quant import QWeight, quantize_weight
from .recipe import QuantSpec


def _num_groups(K: int, group_size: int) -> int:
    return 1 if group_size <= 0 else K // group_size


def linear_specs(K: int, N: int, qspec: QuantSpec | None, *,
                 bias: bool = False, dtype=torch.bfloat16) -> dict:
    """Parameter specs for one (possibly quantized) linear of shape (K, N)."""
    out: dict[str, S.ParamSpec] = {}
    if qspec is None:
        out["w"] = S.w((K, N), dtype=dtype)
    else:
        G = _num_groups(K, qspec.group_size)
        if qspec.w_bits == 4:
            out["qvalue"] = S.zeros((K // 2, N), dtype=torch.int8)
        elif qspec.w_bits == 8:
            out["qvalue"] = S.zeros((K, N), dtype=torch.int8)
        else:
            raise ValueError(f"unsupported w_bits={qspec.w_bits}")
        if (qspec.scale_mode == "integer" and not qspec.weight_only
                and qspec.fine_grained):
            out["scale"] = S.ones((G, N), dtype=torch.int32)
            out["alpha"] = S.ones((), dtype=torch.float32)
        else:
            out["scale"] = S.ones((G, N), dtype=torch.float32)
        if qspec.algo in ("awq", "smoothquant"):
            # per-in-channel activation compensation (x / pre_scale)
            out["pre_scale"] = S.ones((K,), dtype=torch.float32)
        if qspec.rotate:
            # QuaRot-style orthogonal rotation applied online to x
            out["rot"] = S.w((K, K), dtype=dtype)
    if bias:
        out["b"] = S.zeros((N,), dtype=dtype)
    return out


def expert_linear_specs(E: int, K: int, N: int, qspec: QuantSpec | None, *,
                        dtype=torch.bfloat16) -> dict:
    """Specs of E stacked linears (K, N): every leaf of
    :func:`linear_specs` with a leading expert axis, so a quantized
    expert stack carries one amplifier per expert (``alpha`` (E,)), and
    ``pre_scale`` (E, K) / ``rot`` (E, K, K) where its spec asks."""
    return S.tree_map(
        lambda s: S.ParamSpec((E, *s.shape), s.dtype, s.init, s.init_scale),
        linear_specs(K, N, qspec, dtype=dtype))


# ---------------------------------------------------------------------------
# Offline quantization of a trained fp weight -> param tensors
# ---------------------------------------------------------------------------


def finish_quant(
    codes: torch.Tensor,   # int8 (K, N) quantized codes
    scales: torch.Tensor,  # f32 (G, N) (G=1 for coarse)
    qspec: QuantSpec,
    *,
    bias: torch.Tensor | None = None,
    pre_scale: torch.Tensor | None = None,
    rot: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Shared finishing step of every algorithm: pack int4, integerize the
    scales (the paper's free lunch), assemble the param dict (with AWQ's
    and SmoothQuant's ``pre_scale`` as f32, QuaRot's ``rot`` as given).
    Every integer-scale layer's amplifier is certified
    (``analysis.certify.resolve_amplifier``, logged with the enclosing
    ``certify.context``) and, where the certificate caps it, integerized
    again at the certified power of two.

    Telemetry: one ``quantized_layers_total{scheme}`` tick per layer, and
    ``alpha_cap_events_total`` whenever the certificate forces the
    amplifier below the requested value (created unconditionally, so
    snapshots show 0).
    """
    from repro_torch.analysis import certify

    reg = obs.current_registry()
    caps = reg.counter(
        "alpha_cap_events_total",
        "layers whose amplifier was capped below request by the "
        "INT32-overflow certificate")
    caps.inc(0)
    qvalue = packing.pack_int4(codes) if qspec.w_bits == 4 else codes
    out: dict[str, torch.Tensor] = {"qvalue": qvalue}
    if (qspec.scale_mode == "integer" and not qspec.weight_only
            and qspec.fine_grained):
        qw = QWeight(codes, scales, qspec.w_bits, qspec.group_size)
        isw = integerize(qw, qspec.amplifier)
        cert = certify.resolve_amplifier(
            scales.detach().cpu().numpy(), alpha=isw.alpha,
            group_size=qspec.group_size, w_bits=qspec.w_bits,
            a_bits=qspec.a_bits)
        if cert.resolved_alpha != isw.alpha:
            caps.inc()
            isw = integerize(qw, cert.resolved_alpha)
        scheme = f"w{qspec.w_bits}a{qspec.a_bits}-is"
        out["scale"] = isw.int_scale
        out["alpha"] = torch.tensor(float(isw.alpha), dtype=torch.float32,
                                    device=codes.device)
    else:
        scheme = (f"w{qspec.w_bits}a16" if qspec.weight_only
                  else f"w{qspec.w_bits}a{qspec.a_bits}-fs")
        out["scale"] = scales
    reg.counter("quantized_layers_total",
                "linear layers finished by finish_quant",
                ("scheme",)).inc(scheme=scheme)
    if bias is not None:
        out["b"] = bias
    if pre_scale is not None:
        out["pre_scale"] = pre_scale.float()
    if rot is not None:
        out["rot"] = rot
    return out


def quantize_linear(w: torch.Tensor, qspec: QuantSpec, *,
                    bias: torch.Tensor | None = None) -> dict:
    """RTN path (``core.algorithms`` provide GPTQ/AWQ/... on top of
    :func:`finish_quant`, through ``core.ptq.quantize_one``)."""
    qw = quantize_weight(w, qspec.w_bits, qspec.group_size, qspec.clip_ratio)
    scales = qw.scale if qspec.fine_grained else qw.scale[None, :]
    return finish_quant(qw.qvalue, scales, qspec, bias=bias)


def quantize_experts(w: torch.Tensor, qspec: QuantSpec, *,
                     bias: torch.Tensor | None = None) -> dict:
    """An expert stack (E, K, N): each expert's slice quantized on its own
    (its own scales and its own certified alpha), then stacked, as
    the reference's PTQ quantizes expert slices."""
    outs = [quantize_linear(w[e], qspec,
                            bias=None if bias is None else bias[e])
            for e in range(w.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def linear_apply(params: dict, x: torch.Tensor,
                 qspec: QuantSpec | None, *, xq=None) -> torch.Tensor:
    """y = x @ W (+ b), honoring the quantization spec.

    x: (..., K) activation (bf16/f32). Returns the same float dtype as x.
    AWQ's and SmoothQuant's ``pre_scale`` divides x, and QuaRot's ``rot``
    rotates it, in x's dtype, before the quantized GEMM.
    ``xq``: x's codes and scales when several linears share x
    (``kernels.ops.quantize_for``, which makes none for a linear that
    transforms x first); None quantizes x for this one.
    """
    if qspec is None:
        y = x @ params["w"].to(x.dtype)
        if "b" in params:
            y = y + params["b"].to(y.dtype)
        return y

    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if "pre_scale" in params:  # AWQ/SmoothQuant activation compensation
        x2 = x2 / params["pre_scale"].to(x2.dtype)
    if "rot" in params:  # QuaRot-style online rotation
        x2 = x2 @ params["rot"].to(x2.dtype)
    y2 = kops.qgemm(x2, params, qspec, xq=xq)
    y = y2.reshape(*lead, -1).to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def grouped_linear_apply(params: dict, x: torch.Tensor,
                         qspec: QuantSpec | None, *,
                         row_counts: torch.Tensor | None = None,
                         xq=None) -> torch.Tensor:
    """Batched-expert linear: x (E, C, K) -> (E, C, N), params stacked
    with a leading expert axis (the MoE dispatch-buffer path).

    Quantized experts run in ONE grouped ragged kernel per call
    (``kernels.ops.qgemm_grouped``), after the routed rows' quantization
    (or on ``xq``, the codes and scales ``kernels.ops.quantize_for`` made
    once for every expert linear over x); the kernel divides by the
    per-expert ``alpha`` in its epilogue. ``row_counts`` (int32 (E,), on
    the device; rows past it are zero-filled by the dispatch) lets the
    kernel skip capacity-padding m-tiles; ``None`` treats every slot as
    routed. Per-expert ``pre_scale`` (E, K) and ``rot`` (E, K, K) apply
    to x first, as in :func:`linear_apply` (rows past the counts stay
    zero). Returns x's dtype.
    """
    if qspec is None:
        y = torch.bmm(x, params["w"].to(x.dtype))
        if "b" in params:
            y = y + params["b"][:, None, :].to(y.dtype)
        return y
    x2 = x
    if "pre_scale" in params:  # (E, K) per-expert compensation
        x2 = x2 / params["pre_scale"][:, None, :].to(x2.dtype)
    if "rot" in params:  # (E, K, K) per-expert rotation
        x2 = torch.bmm(x2, params["rot"].to(x2.dtype))
    core = {k: v for k, v in params.items()
            if k in ("qvalue", "scale", "alpha")}
    y = kops.qgemm_grouped(x2, core, qspec, row_counts=row_counts,
                           xq=xq).to(x.dtype)
    if "b" in params:
        y = y + params["b"][:, None, :].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Whole-tree quantization: fp params -> quantized params per recipe
# ---------------------------------------------------------------------------


def quantize_tree(fp_params, recipe, path: str = ""):
    """Walk a param tree; each dict node shaped like a linear ({"w": (K,N)})
    whose path matches the recipe is replaced by quantized tensors."""
    if isinstance(fp_params, dict) and isinstance(fp_params.get("w"),
                                                  torch.Tensor):
        w = fp_params["w"]
        qspec = recipe.spec_for(path) if w.ndim == 2 else None
        if qspec is None:
            return fp_params
        return quantize_linear(w.float(), qspec, bias=fp_params.get("b"))
    if isinstance(fp_params, dict):
        return {k: quantize_tree(v, recipe, f"{path}/{k}")
                for k, v in fp_params.items()}
    if isinstance(fp_params, list):
        return [quantize_tree(v, recipe, f"{path}/{i}")
                for i, v in enumerate(fp_params)]
    return fp_params
