"""Gated MLP (SwiGLU) with recipe-aware quantized linears. Port of
``repro/models/mlp.py``."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels import ops as kops

from .common import Linear, linear
from .config import ModelConfig


def mlp_specs(cfg: ModelConfig, recipe, base: str,
              d_ff: int | None = None) -> dict:
    """``d_ff`` overrides the config's (DeepSeek-V2's shared experts:
    ``num_shared_experts * moe_d_ff``)."""
    d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.activation_dtype
    return {
        "gate": linear(recipe, f"{base}/gate", d, f, dtype=dt),
        "up": linear(recipe, f"{base}/up", d, f, dtype=dt),
        "down": linear(recipe, f"{base}/down", f, d, dtype=dt),
    }


class MLP(nn.Module):
    def __init__(self, params: dict, recipe, base: str):
        super().__init__()
        self.gate = Linear(recipe, f"{base}/gate", params["gate"])
        self.up = Linear(recipe, f"{base}/up", params["up"])
        self.down = Linear(recipe, f"{base}/down", params["down"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq = kops.quantize_for(x, (self.gate, self.up))
        g = self.gate(x, xq)
        u = self.up(x, xq)
        h = F.silu(g.float()).to(x.dtype) * u
        return self.down(h)
