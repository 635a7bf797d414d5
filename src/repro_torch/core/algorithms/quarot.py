"""QuaRot-lite (Ashkboos et al., arXiv:2404.00456): rotation-based PTQ.
Port of ``repro/core/algorithms/quarot.py``.

Computation-invariant orthogonal rotation: W' = Q^T W with x rotated
online (x' = x Q), so x'W' = xW exactly while the rotated weight (and
activation) distributions are incoherent. Q is a seeded random orthogonal
matrix: the QR of a Gaussian drawn with numpy's ``default_rng(seed)``,
the reference's draw, so both packages rotate by the same matrix; the QR
runs in f64 on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from .awq import _rtn


def random_orthogonal(K: int, seed: int = 0, device=None) -> torch.Tensor:
    """(K, K) f32 orthogonal matrix on ``device`` (default CPU)."""
    a = np.random.default_rng(seed).standard_normal((K, K))
    q, r = torch.linalg.qr(torch.from_numpy(a).to(device))
    # fix signs for determinism
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q.float()


def quarot_quantize(
    w: torch.Tensor,   # (K, N) f32
    bits: int,
    group_size: int,
    seed: int = 0,
    rot: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (codes, scales, rot (K, K) f32) for W' = rot.T @ W. ``rot``:
    ``random_orthogonal(K, seed)`` when the caller already holds it."""
    K, N = w.shape
    gs = group_size if group_size > 0 else K
    if rot is None:
        rot = random_orthogonal(K, seed, w.device)
    codes, scales = _rtn(_rotate(rot, w), bits, gs)
    return codes, scales, rot


def _rotate(rot: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rot.T @ w in f32. On the CPU it is numpy's product, the reference's:
    PyTorch's CPU matmul (MKL) and numpy's (OpenBLAS) sum in other orders
    at some K (384 among them), which moves codes at rounding ties. On the
    card, the device's matmul."""
    if w.device.type == "cpu":
        return torch.from_numpy(rot.detach().numpy().T @ w.detach().numpy())
    return rot.T @ w
