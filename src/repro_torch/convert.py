"""Carry parameter trees between the reference's layout and the port's
(no JAX counterpart).

The reference scans its layers over stacked leaves: a dense model's
blocks sit under ``blocks/s0/...`` with a leading layer axis
(``repro/models/transformer.py`` ``param_specs``); the port keeps one tree
per layer in ``params["blocks"]``. :func:`from_reference` takes the
reference tree as numpy arrays — fp or quantized — and unstacks it;
:func:`to_reference` stacks a port tree back. Values are carried bit for
bit (``qvalue``, ``scale`` and ``alpha`` included); bf16 arrays (numpy
dtype ``bfloat16`` from ml_dtypes) are reinterpreted through their 16-bit
patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.nn import spec as S


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()  # exact: every bf16 value is an f32 value
    return t.numpy()


def from_reference(tree: dict, *, device=None) -> dict:
    """Reference dense-model param tree (numpy leaves) -> port tree
    (tensors on ``device``, default the GPU)."""
    dev = S.resolve_device(device)
    if set(tree.get("blocks", {})) != {"s0"} or "prefix" in tree:
        raise NotImplementedError(
            "only the dense layout (one scanned block, blocks/s0) is ported")
    stacked = tree["blocks"]["s0"]
    layers = len(S.leaves(stacked)[0])
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [S.tree_map(lambda a: a[r], stacked)
                     for r in range(layers)]
    return S.tree_map(lambda a: _to_tensor(a, dev), out)


def to_reference(params: dict) -> dict:
    """Port tree -> the reference's dense layout as numpy (bf16 leaves as
    f32 arrays holding the same values)."""
    out = {k: S.tree_map(_to_numpy, v)
           for k, v in params.items() if k != "blocks"}
    stack = S.tree_map(lambda *xs: np.stack([_to_numpy(x) for x in xs]),
                       *params["blocks"])
    out["blocks"] = {"s0": stack}
    return out
