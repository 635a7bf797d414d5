"""GPTQ (Frantar et al., arXiv:2210.17323): approximate second-order PTQ.
Port of ``repro/core/algorithms/gptq.py``.

Per layer: Hessian H = 2 X^T X from calibration activations; iterate over
input dims in order, quantize each weight row, and distribute the induced
error onto not-yet-quantized rows via the Cholesky factor of H^{-1}.
Group-wise scales are (re)computed at each group boundary from the
*current* (error-compensated) weights: the standard fine-grained GPTQ.

Lazy batches: within a group the error is applied row by row to the
group's remaining rows; the group's errors reach the rows after it once,
as one matrix product at the group's end. That is the reference's
arithmetic (each later row receives the same sum of rank-1 terms) with the
sum formed in another order, in f64, so the codes are the reference's;
the K-row loop touches a (group, N) slice per row instead of the whole
(K, N) tail. Everything runs in f64 on the weight's device.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import qmax


def _group_rows(wg, s, hg, codes, err, qm: int, qmt):
    """Quantize one group's rows in order. ``wg`` (gs, N) f64, the group's
    current weights, is compensated in place; ``hg`` (gs, gs) is the
    group's block of the Cholesky factor; ``s`` (N,) gets the group's
    scales, ``codes`` (gs, N) int8 its codes and ``err`` (gs, N) its
    scaled errors (for the rows after the group)."""
    # group scale from current (compensated) weights
    torch.div(torch.clamp_min(wg.abs().amax(dim=0), 1e-8), qmt, out=s)
    for r in range(wg.shape[0]):
        q = torch.clamp(torch.round(wg[r] / s), -qm, qm)
        codes[r] = q.to(torch.int8)
        torch.div(wg[r] - q * s, hg[r, r], out=err[r])
        # compensate the group's remaining rows
        if r + 1 < wg.shape[0]:
            wg[r + 1:] -= torch.outer(hg[r, r + 1:], err[r])


class _CapturedGroup:
    """:func:`_group_rows` over static buffers, captured once as a CUDA
    graph and replayed for every group of that shape: a group is 128
    dependent steps of a few small kernels each, whose launches, not
    their work, set its time when run eagerly."""

    def __init__(self, gs: int, N: int, qm: int, device):
        f64 = torch.float64
        self.wg = torch.zeros((gs, N), dtype=f64, device=device)
        self.hg = torch.eye(gs, dtype=f64, device=device)
        self.s = torch.zeros((N,), dtype=f64, device=device)
        self.codes = torch.zeros((gs, N), dtype=torch.int8, device=device)
        self.err = torch.zeros((gs, N), dtype=f64, device=device)
        # every tensor the graph reads stays referenced here: a freed one's
        # memory would be handed to other tensors under the graph
        self.qmt = torch.full((), float(qm), dtype=f64, device=device)
        args = (self.wg, self.s, self.hg, self.codes, self.err, qm, self.qmt)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # warm up outside the capture
            _group_rows(*args)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            _group_rows(*args)

    def __call__(self, w_rows, h_block):
        self.wg.copy_(w_rows)
        self.hg.copy_(h_block)
        self.graph.replay()
        return self.s, self.codes, self.err


def gptq_quantize(
    w: torch.Tensor,       # (K, N) f32: rows are input features
    x: torch.Tensor,       # (n, K) f32 calibration inputs
    bits: int,
    group_size: int,
    percdamp: float = 0.01,
    *,
    cache: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (codes int8 (K, N), scales f32 (G, N)). On the card each
    group's row loop replays a captured CUDA graph; ``cache`` keeps the
    graphs by shape for later calls."""
    K, N = w.shape
    gs = group_size if group_size > 0 else K
    G = K // gs
    qm = qmax(bits)
    dev = w.device
    f64 = torch.float64

    x = x.float()
    H = 2.0 * (x.T @ x).to(f64)  # the Gram product in f32, as the reference
    # dead inputs: keep numerically sane
    diag = torch.diagonal(H)
    dead = diag == 0
    diag[dead] = 1.0
    w = w.to(f64).clone()
    w[dead, :] = 0.0
    damp = percdamp * torch.mean(diag)
    diag += damp

    # Cholesky of H^{-1}, upper-triangular (GPTQ's preferred form)
    hinv = torch.linalg.cholesky(torch.linalg.inv(H), upper=True)
    del H
    codes = torch.empty((K, N), dtype=torch.int8, device=dev)
    scales = torch.empty((G, N), dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        key = ("gptq", gs, N, qm)
        step = (cache or {}).get(key) or _CapturedGroup(gs, N, qm, dev)
        if cache is not None:
            cache[key] = step
    else:
        s = torch.empty((N,), dtype=f64)
        err = torch.empty((gs, N), dtype=f64)
        qmt = torch.full((), float(qm), dtype=f64)

    for g in range(G):
        i0, i1 = g * gs, (g + 1) * gs
        if dev.type == "cuda":
            s, group_codes, err = step(w[i0:i1], hinv[i0:i1, i0:i1])
            codes[i0:i1] = group_codes
        else:
            _group_rows(w[i0:i1], s, hinv[i0:i1, i0:i1], codes[i0:i1], err,
                        qm, qmt)
        scales[g] = s.float()
        # the group's errors reach every row after it, once
        if i1 < K:
            w[i1:] -= hinv[i0:i1, i1:].T @ err
    return codes, scales
