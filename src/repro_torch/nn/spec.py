"""Parameter-spec system. Port of ``repro/nn/spec.py``.

A model is described by a tree (nested dicts and lists) of
:class:`ParamSpec` leaves. From that one tree the port derives
  * real tensors       (:func:`materialize`, from an explicit
    ``torch.Generator`` on an explicit device),
  * ``meta`` tensors   (:func:`abstract`: the dry-run's, no allocation),
  * partition specs    (:func:`partition_specs`: logical -> mesh axes),
    and from those a ``DeviceMesh``'s placements (:func:`placements`) and
    each device's shard shape (:func:`local_shape`).
The port keeps one tree per layer, so a leaf's ``logical_axes`` are the
reference's without the leading ``"layers"`` axis its scanned stacks
carry; both rule tables map ``"layers"`` to None, so the partition specs
agree too.

:func:`resolve_device` is the port's device rule for entry points that
create tensors: ``cuda`` unless the caller asks for another device, and
an error — not a silent CPU run — when there is no GPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

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
    """Declaration of one parameter tensor. ``logical_axes`` names each
    dim with a logical axis ("embed", "mlp", "heads_q", ...), which the
    rule tables (``distributed/sharding.py``) map to mesh axes."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones | embed
    logical_axes: tuple[str | None, ...] = ()
    init_scale: float = 1.0  # multiplier on the default fan-in scale

    def __post_init__(self):
        if self.logical_axes and len(self.logical_axes) != len(self.shape):
            raise ValueError(
                f"logical_axes {self.logical_axes} rank != shape {self.shape}")

    def abstract(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")

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


def abstract(tree: Tree) -> Tree:
    """``meta`` tensors of the specs' shapes and dtypes: no allocation."""
    return tree_map(lambda s: s.abstract(), tree)


def param_bytes(tree: Tree) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize for s in leaves(tree))


# ---------------------------------------------------------------------------
# Logical -> physical sharding rules
# ---------------------------------------------------------------------------

# A rule maps a logical axis name to a mesh axis name (or tuple of them, or
# None for replication). First matching rule wins; unlisted logical axes are
# replicated.
Rules = Sequence[tuple[str, str | tuple[str, ...] | None]]


class PartitionSpec:
    """One entry per tensor dim: a mesh axis name, a tuple of them (the
    dim split over their product, the first outermost), or None
    (replicated); :func:`logical_to_pspec` drops trailing Nones, as the
    reference's does. ``PartitionSpec()`` is replicated. Immutable, equal
    to the tuple of its entries, and a leaf to :func:`tree_map` (not a
    tuple)."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        object.__setattr__(self, "_entries", tuple(entries))

    def __setattr__(self, name, value):
        raise AttributeError("PartitionSpec is immutable")

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, (PartitionSpec, tuple)):
            return self._entries == tuple(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


def logical_to_pspec(
    logical_axes: Sequence[str | None],
    rules: Rules,
    mesh_axis_sizes: Mapping[str, int] | None = None,
    shape: Sequence[int] | None = None,
) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec via ``rules``.

    If ``mesh_axis_sizes`` and ``shape`` are given, a mapping whose
    mesh-axis product does not divide the dim size is dropped (replicated
    instead): one rule table serves full and smoke configs.
    """
    rule_map = dict(rules)
    used: set[str] = set()
    entries: list[Any] = []
    for i, name in enumerate(logical_axes):
        target = rule_map.get(name) if name is not None else None
        if target is None:
            entries.append(None)
            continue
        axes = (target,) if isinstance(target, str) else tuple(target)
        # drop already-used mesh axes (a mesh axis may appear only once)
        axes = tuple(a for a in axes if a not in used)
        if not axes:
            entries.append(None)
            continue
        if mesh_axis_sizes is not None and shape is not None:
            prod = math.prod(mesh_axis_sizes.get(a, 1) for a in axes)
            if prod == 0 or shape[i] % max(prod, 1) != 0:
                entries.append(None)
                continue
        used.update(axes)
        entries.append(axes[0] if len(axes) == 1 else axes)
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def partition_specs(tree: Tree, rules: Rules,
                    mesh_axis_sizes: Mapping[str, int] | None = None) -> Tree:
    """A PartitionSpec per leaf (``mesh_axis_sizes`` None: no divisibility
    check)."""
    return tree_map(lambda s: logical_to_pspec(
        s.logical_axes, rules, mesh_axis_sizes, s.shape), tree)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(pspec: Sequence, mesh) -> list:
    """The DTensor placements of ``pspec`` on a ``DeviceMesh``: one per
    mesh dim, ``Shard(i)`` where tensor dim i is split over it, else
    ``Replicate()``. A dim over ("pod", "data") is ``Shard(i)`` on both
    mesh dims; DTensor splits it in mesh-dim order, pod-major, as JAX
    lays it out."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for i, entry in enumerate(pspec):
        for a in _entry_axes(entry):
            if a not in names:
                raise ValueError(f"mesh axis {a!r} is not in {names}")
            out[names.index(a)] = Shard(i)
    return out


def local_shape(shape: Sequence[int], pspec: Sequence,
                mesh_axis_sizes: Mapping[str, int]) -> tuple[int, ...]:
    """The shape of one device's shard (the largest, where a split is
    uneven: the padded shard)."""
    out = list(shape)
    for i, entry in enumerate(pspec):
        ways = math.prod(mesh_axis_sizes[a] for a in _entry_axes(entry))
        out[i] = -(-out[i] // ways)
    return tuple(out)


# ---------------------------------------------------------------------------
# Convenience constructors
# ---------------------------------------------------------------------------


def w(shape, axes, dtype=torch.float32, init="normal",
      scale=1.0) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, init, tuple(axes), scale)


def zeros(shape, axes, dtype=torch.float32) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, "zeros", tuple(axes))


def ones(shape, axes, dtype=torch.float32) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, "ones", tuple(axes))
