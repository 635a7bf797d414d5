"""Shared model-building helpers: recipe-aware linears and norms. Port of
``repro/models/common.py`` (calibration capture and scan stacking are not
ported: the port keeps one module per layer)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import qlinear
from repro_torch.core.recipe import QuantRecipe
from repro_torch.nn import spec as S


def linear(recipe: QuantRecipe | None, path: str, K: int, N: int, *,
           bias: bool = False, dtype=torch.bfloat16) -> dict:
    """Param specs of the linear at ``path`` (quantized per the recipe)."""
    qspec = recipe.spec_for(path) if recipe is not None else None
    return qlinear.linear_specs(K, N, qspec, bias=bias, dtype=dtype)


class Linear(nn.Module):
    """A recipe-aware linear holding its param dict (``w``, or ``qvalue``/
    ``scale``/``alpha``; ``b``) as buffers: the port serves, it does not
    train, so nothing here needs a gradient. ``qspec`` is the recipe's
    spec for its path (None: bf16)."""

    def __init__(self, recipe: QuantRecipe | None, path: str, params: dict):
        super().__init__()
        self.qspec = recipe.spec_for(path) if recipe is not None else None
        for name, t in params.items():
            self.register_buffer(name, t)

    def forward(self, x: torch.Tensor, xq=None) -> torch.Tensor:
        """``xq``: x's codes and scales from ``kernels.ops.quantize_for``,
        when several linears read x."""
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
