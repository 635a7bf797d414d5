"""Omniquant-lite (Shao et al., arXiv:2308.13137): weight clipping search.
Port of ``repro/core/algorithms/omniquant.py``.

The full Omniquant learns clipping + smoothing by gradient descent; this
lite version grid-searches the clip ratio per layer against the calibrated
output MSE, on the weight's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import qmax
from .awq import div, output_mse


def omniquant_quantize(
    w: torch.Tensor,   # (K, N) f32
    x: torch.Tensor,   # (n, K) f32
    bits: int,
    group_size: int,
    grid=(1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7),
) -> tuple[torch.Tensor, torch.Tensor]:
    K, N = w.shape
    gs = group_size if group_size > 0 else K
    qm = qmax(bits)
    x = x.float()
    ref = x @ w
    w3 = w.reshape(K // gs, gs, N)
    amax = w3.abs().amax(dim=1)
    best = (None, None, np.inf)
    for clip in grid:
        # the ratio rounded to f32 and multiplied in f32, as numpy does
        c = torch.full((), clip, dtype=torch.float32, device=w.device)
        s = div(torch.clamp_min(amax * c, 1e-8), qm)
        q = torch.clamp(torch.round(w3 / s[:, None, :]), -qm, qm)
        codes = q.reshape(K, N).to(torch.int8)
        mse = output_mse(x, ref, codes, s)
        if mse < best[2]:
            best = (codes, s, mse)
    return best[0], best[1]
