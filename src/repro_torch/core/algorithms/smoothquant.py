"""SmoothQuant (Xiao et al., arXiv:2211.10438): outlier migration. Port of
``repro/core/algorithms/smoothquant.py``.

s_j = max|x_j|^alpha / max|w_j|^(1-alpha): activations divided by s,
weights multiplied by s (realized as qlinear ``pre_scale``). alpha=0.5
default. The two column maxima come from the device; s is formed from
them on the host with numpy, as the reference forms it.
"""
from __future__ import annotations

import numpy as np
import torch

from .awq import _rtn


def smoothquant_quantize(
    w: torch.Tensor,   # (K, N) f32
    x: torch.Tensor,   # (n, K) f32
    bits: int,
    group_size: int,
    alpha: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    K, N = w.shape
    gs = group_size if group_size > 0 else K
    x_max = np.maximum(x.float().abs().amax(dim=0).cpu().numpy(), 1e-5)
    w_max = np.maximum(w.abs().amax(dim=1).cpu().numpy(), 1e-5)
    s = (x_max ** alpha) / (w_max ** (1 - alpha))
    s = torch.from_numpy(np.maximum(s, 1e-4).astype(np.float32)).to(w.device)
    codes, scales = _rtn(w * s[:, None], bits, gs)
    return codes, scales, s
