"""AWQ (Lin et al., arXiv:2306.00978): activation-aware weight scaling.
Port of ``repro/core/algorithms/awq.py``.

Salient input channels (large mean |x|) get their weights scaled UP before
quantization (finer effective resolution) and the activations scaled DOWN
correspondingly at runtime (the ``pre_scale`` in qlinear). The exponent
alpha is grid-searched per layer to minimize the quantized output MSE.

The search runs on the weight's device: every candidate's RTN codes and
its output MSE over the calibration rows. The per-channel scale vector is
formed on the host with numpy, exactly as the reference forms it (a
sequential f32 column mean, numpy's power and square root): its K values
set every code, so they must be the reference's bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import qmax


def div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as a true division (PyTorch's CUDA division by a python
    number multiplies by its reciprocal)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _rtn(w: torch.Tensor, bits: int, gs: int):
    """Group-wise RTN of a (K, N) f32 weight: (codes int8, scales f32
    (K/gs, N))."""
    K, N = w.shape
    qm = qmax(bits)
    w3 = w.reshape(K // gs, gs, N)
    s = div(torch.clamp_min(w3.abs().amax(dim=1), 1e-8), qm)
    q = torch.clamp(torch.round(w3 / s[:, None, :]), -qm, qm)
    return q.reshape(K, N).to(torch.int8), s


def column_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over rows, summed row after row in f32 (numpy's order for a
    reduction over the leading axis), then divided by the row count."""
    acc = x[0].clone()
    for row in x[1:]:
        acc += row
    return div(acc, x.shape[0])


def output_mse(x: torch.Tensor, ref: torch.Tensor, codes: torch.Tensor,
               scales: torch.Tensor, pre_scale: torch.Tensor | None = None
               ) -> float:
    """Mean squared error of ``(x / pre_scale) @ deq`` against ``ref``
    (``x @ w``), where ``deq`` dequantizes group-wise ``codes`` by
    ``scales``: the searches' objective."""
    K, N = codes.shape
    G = scales.shape[0]
    deq = (codes.float().reshape(G, K // G, N) * scales[:, None, :]
           ).reshape(K, N)
    xs = x if pre_scale is None else x / pre_scale[None, :]
    return float(((ref - xs @ deq) ** 2).mean())


def awq_quantize(
    w: torch.Tensor,   # (K, N) f32
    x: torch.Tensor,   # (n, K) f32
    bits: int,
    group_size: int,
    grid: int = 8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (codes, scales, pre_scale (K,))."""
    K, N = w.shape
    gs = group_size if group_size > 0 else K
    x = x.float()
    act_mag = np.maximum(column_mean(x.abs()).cpu().numpy(), 1e-6)  # (K,)
    ref = x @ w
    best = (None, None, None, np.inf)
    for j in range(grid + 1):
        alpha = j / grid
        s = act_mag ** alpha
        s = s / (np.sqrt(s.max() * s.min()) + 1e-12)  # normalize (AWQ)
        s = torch.from_numpy(np.maximum(s, 1e-4)).to(w.device)
        codes, scales = _rtn(w * s[:, None], bits, gs)
        mse = output_mse(x, ref, codes, scales, s)
        if mse < best[3]:
            best = (codes, scales, s, mse)
    return best[0], best[1], best[2]
