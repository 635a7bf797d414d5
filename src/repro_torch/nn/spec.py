"""Parameter-spec system. Port of ``repro/nn/spec.py``.

A model is described by a tree (nested dicts and lists) of
:class:`ParamSpec` leaves. From that one tree the port derives real
tensors (:func:`materialize`, from an explicit ``torch.Generator`` on an
explicit device) and their size in bytes (:func:`param_bytes`).
Sharding (logical axes -> mesh axes) waits for the multi-GPU slice.

:func:`resolve_device` is the port's device rule for entry points that
create tensors: ``cuda`` unless the caller asks for another device, and
an error — not a silent CPU run — when there is no GPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Tree = Any


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the GPU, which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU unless the caller "
            "passes device='cpu'")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones | embed
    init_scale: float = 1.0  # multiplier on the default fan-in scale

    def materialize(self, generator: torch.Generator | None,
                    device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        if self.init == "embed":
            std = 1.0 * self.init_scale
        else:
            # fan-in scaled normal: fan_in = product of all but the last dim
            fan_in = (math.prod(self.shape[:-1]) if len(self.shape) >= 2
                      else (self.shape[0] if self.shape else 1))
            std = self.init_scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * std).to(self.dtype)


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Map ``fn`` over the leaves of dict/list trees of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves(tree: Tree) -> list:
    """Leaves in deterministic (insertion, then list) order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def materialize(tree: Tree, generator: torch.Generator | None = None,
                device=None) -> Tree:
    """Real tensors for a spec tree, drawn leaf by leaf (in :func:`leaves`
    order) from ``generator`` on ``device`` (default: the GPU)."""
    dev = resolve_device(device)
    return tree_map(lambda s: s.materialize(generator, dev), tree)


def param_bytes(tree: Tree) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize for s in leaves(tree))


# ---------------------------------------------------------------------------
# Convenience constructors
# ---------------------------------------------------------------------------


def w(shape, dtype=torch.float32, init="normal", scale=1.0) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, init, scale)


def zeros(shape, dtype=torch.float32) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, "zeros")


def ones(shape, dtype=torch.float32) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, "ones")
