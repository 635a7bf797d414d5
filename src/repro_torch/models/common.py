"""Shared model-building helpers: recipe-aware linears, norms and the
calibration capture. Port of ``repro/models/common.py`` (scan stacking is
not ported: the port keeps one module per layer)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import qlinear
from repro_torch.core.recipe import QuantRecipe
from repro_torch.nn import spec as S


# Calibration capture: while on (``start_capture`` .. ``end_capture``),
# every :class:`Linear` records a sample of its input per path, in call
# order: GPTQ/AWQ/SmoothQuant/OmniQuant read these (core/ptq.py). The
# sample is the reference's: every ``step``-th row, at most 256, in f32.
_CAPTURE: dict | None = None
_CAPTURE_SAMPLES = 256


def start_capture() -> None:
    global _CAPTURE
    _CAPTURE = {}


def end_capture() -> dict:
    global _CAPTURE
    out, _CAPTURE = _CAPTURE, None
    return out or {}


def _record(path: str, x: torch.Tensor) -> None:
    """Record x's sample under ``path``, unless a CUDA graph is being
    captured (its tensors hold no values yet)."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    x2 = x.detach().reshape(-1, x.shape[-1])
    step = max(1, x2.shape[0] // _CAPTURE_SAMPLES)
    _CAPTURE.setdefault(path, []).append(
        x2[::step][:_CAPTURE_SAMPLES].float().clone())


def linear(recipe: QuantRecipe | None, path: str, K: int, N: int, *,
           bias: bool = False, dtype=torch.bfloat16) -> dict:
    """Param specs of the linear at ``path`` (quantized per the recipe)."""
    qspec = recipe.spec_for(path) if recipe is not None else None
    return qlinear.linear_specs(K, N, qspec, bias=bias, dtype=dtype)


class Linear(nn.Module):
    """A recipe-aware linear holding its param dict (``w``, or ``qvalue``/
    ``scale``/``alpha``, and ``pre_scale``/``rot`` where its algorithm
    made them; ``b``) as buffers: the same tensor objects as the param
    tree's leaves. Training (``training/train_step.py``) sets
    ``requires_grad_()`` on those leaves and differentiates with respect
    to them, so nothing here becomes an ``nn.Parameter`` and serving is
    untouched. ``qspec`` is the recipe's spec for its path (None: bf16);
    while the calibration capture is on, its input is recorded under
    ``path``."""

    def __init__(self, recipe: QuantRecipe | None, path: str, params: dict):
        super().__init__()
        self.path = path
        self.qspec = recipe.spec_for(path) if recipe is not None else None
        for name, t in params.items():
            self.register_buffer(name, t)

    def forward(self, x: torch.Tensor, xq=None) -> torch.Tensor:
        """``xq``: x's codes and scales from ``kernels.ops.quantize_for``,
        when several linears read x."""
        if _CAPTURE is not None:
            _record(self.path, x)
        return qlinear.linear_apply(dict(self.named_buffers(recurse=False)),
                                    x, self.qspec, xq=xq)


def rmsnorm_spec(d: int) -> dict:
    return {"g": S.ones((d,))}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["g"].float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, params: dict, eps: float):
        super().__init__()
        self.eps = eps
        self.register_buffer("g", params["g"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm({"g": self.g}, x, self.eps)


def layernorm_spec(d: int) -> dict:
    return {"g": S.ones((d,)), "b": S.zeros((d,))}


def layernorm(params: dict, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """The reference's ``layernorm`` op for op: f32 mean and biased
    variance (as ``jnp.var``), ``rsqrt(var + eps)``, ``g`` and ``b``
    applied in f32, then cast to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    d = xf - mu
    var = torch.mean(d * d, dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + eps)
    return (y * params["g"].float() + params["b"].float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, params: dict, eps: float):
        super().__init__()
        self.eps = eps
        self.register_buffer("g", params["g"])
        self.register_buffer("b", params["b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm({"g": self.g, "b": self.b}, x, self.eps)
