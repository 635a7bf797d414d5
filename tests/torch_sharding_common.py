"""Shared by ``tests/test_torch_sharding.py`` and
``tests/test_torch_dryrun.py``: the reference's spec trees (ParamSpec,
cache and AdamW state) read in the port's layout, and per-device bytes
computed from the reference's own partition specs.

The reference stacks its scanned layers (``blocks/s<j>`` with a leading
"layers" axis, an unrolled ``prefix/<i>``; Whisper's ``enc``/``dec``
blocks and its cache stacked with period 1); the port keeps one tree per
layer, port layer ``len(prefix) + r * P + j`` being ``blocks/s<j>`` at
repeat r (``repro_torch.convert``).
"""
import math
import re

import numpy as np

from repro.nn import spec as JS

SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}


def dtype_name(d) -> str:
    """"bfloat16", "int8", ... of a torch or a numpy / JAX dtype."""
    s = str(d)
    return s[len("torch."):] if s.startswith("torch.") else np.dtype(d).name


def _leaf_count(tree) -> int:
    import jax

    return jax.tree.leaves(tree, is_leaf=JS.is_spec)[0].shape[0]


def ref_flat(tree, path: str = "") -> dict:
    """{port path: (reference ParamSpec, stacked)} of a reference spec
    tree, its stacked layers unstacked into the port's ``blocks/<i>``."""
    out: dict = {}
    if JS.is_spec(tree):
        out[path] = (tree, False)
        return out
    pre = f"{path}/" if path else ""
    for k, v in tree.items():
        if k == "prefix":
            continue
        if k != "blocks":
            out.update(ref_flat(v, f"{pre}{k}"))
            continue
        prefix = tree.get("prefix", {})
        n = len(prefix)
        for i in range(n):
            out.update(ref_flat(prefix[str(i)], f"{pre}blocks/{i}"))
        if all(re.fullmatch(r"s\d+", s) for s in v):
            pattern = [v[f"s{j}"] for j in range(len(v))]
        else:  # one block kind stacked with period 1 (Whisper)
            pattern = [v]
        R, P = _leaf_count(pattern[0]), len(pattern)
        for r in range(R):
            for j in range(P):
                sub = ref_flat(pattern[j], f"{pre}blocks/{n + r * P + j}")
                out.update({p: (s, True) for p, (s, _) in sub.items()})
    return out


def port_flat(tree, path: str = "") -> dict:
    """{path: ParamSpec} of a port spec tree (dicts, lists of blocks)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    out: dict = {}
    for k, v in items:
        out.update(port_flat(v, f"{path}/{k}" if path else str(k)))
    return out


def ref_leaf(spec, stacked: bool) -> tuple:
    """(shape, dtype name, logical axes) of one port layer's leaf."""
    if stacked:
        assert spec.logical_axes[0] == "layers", spec
        return (tuple(spec.shape[1:]), dtype_name(spec.dtype),
                tuple(spec.logical_axes[1:]))
    return (tuple(spec.shape), dtype_name(spec.dtype),
            tuple(spec.logical_axes))


def port_leaf(spec) -> tuple:
    return (tuple(spec.shape), dtype_name(spec.dtype),
            tuple(spec.logical_axes))


def ref_pspec(spec, stacked: bool, rules, sizes) -> tuple:
    """The reference's partition spec of the leaf, its leading "layers"
    entry (None under both rule tables) dropped where it is stacked."""
    p = tuple(JS.logical_to_pspec(spec.logical_axes, rules, sizes,
                                  spec.shape))
    if stacked:
        assert not p or p[0] is None, p
        return p[1:]
    return p


def _ways(entry, sizes) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    return math.prod(sizes[a] for a in names)


def ref_shard_bytes(shape, dtype, pspec, sizes) -> int:
    """One device's bytes of a (shape, dtype) array under a JAX
    PartitionSpec on a mesh of ``sizes``: the local shard's shape times
    the item size (the reference's shardings divide every dim)."""
    local = list(shape)
    for i, e in enumerate(tuple(pspec)):
        w = _ways(e, sizes)
        assert local[i] % w == 0, (shape, pspec)
        local[i] //= w
    return math.prod(local) * np.dtype(dtype).itemsize


def ref_tree_bytes(tree, rules, sizes) -> int:
    import jax

    return sum(ref_shard_bytes(s.shape, s.dtype, JS.logical_to_pspec(
        s.logical_axes, rules, sizes, s.shape), sizes)
        for s in jax.tree.leaves(tree, is_leaf=JS.is_spec))
