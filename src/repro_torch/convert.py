"""Carry parameter trees between the reference's layout and the port's
(no JAX counterpart).

The reference lays its layers out as an unrolled prefix ``prefix/<i>``
and a pattern of P block kinds scanned R times over stacked leaves,
``blocks/s0 .. s{P-1}`` with a leading repeat axis
(``repro/models/transformer.py`` ``split_layers``: a dense or MoE model is
``blocks/s0`` x L; DeepSeek-V2 ``blocks/s0..s{L-1}`` x 1 up to 8 layers,
its 3-layer smoke config included, and ``prefix/0`` plus ``blocks/s0`` x
(L - 1) from 9 layers on, as its full 60).
A MoE leaf there is (R, E, ...), its router (R, d, E). The port keeps one
tree per layer in ``params["blocks"]``, with (E, ...) expert stacks: port
layer ``len(prefix) + r * P + j`` is ``blocks/s{j}`` at repeat r. A VLM
is ``blocks/s0..s4`` x 20 (four self layers, then a cross one). The
encoder-decoder (Whisper) keeps ``enc/blocks`` and ``dec/blocks``, each
stacked with period 1, beside ``enc/final_ln`` and ``dec/{embed, pos,
final_ln}``; the port holds each as a list of per-layer trees. The
recurrent families take their layouts from their own ``_split``
(:func:`reference_split`): xLSTM's is ``split_layers`` (xlstm-1.3b
``blocks/s0..s7`` x 6); Griffin's puts the first ``num_layers % 3``
layers in the prefix and scans whole (rec, rec, attn) patterns after it
(recurrentgemma-9b ``prefix/0..1`` + ``blocks/s0..s2`` x 12, its 5-layer
smoke config ``prefix/0..1`` + ``blocks/s0..s2`` x 1, where
``split_layers`` alone would give ``blocks/s0..s4`` x 1).
:func:`from_reference` takes the reference tree as numpy arrays — fp or
quantized — and unstacks it; :func:`to_reference` stacks a port tree back
into the reference's layout for its layer kinds (a Griffin tree needs its
config).
Values are carried bit for bit (``qvalue``, ``scale`` and ``alpha`` included); bf16 arrays (numpy
dtype ``bfloat16`` from ml_dtypes) are reinterpreted through their 16-bit
patterns. :func:`opt_from_reference` and :func:`opt_to_reference` carry
an AdamW state (``training/optimizer.py``): its ``mu`` and ``nu`` trees
through the param converters, its ``step`` as an int32 scalar.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import split_layers
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


def _kind(b: dict) -> str:
    if "gate_attn" in b:
        return "cross"
    if "wx" in b:
        return "slstm"
    if "if_gate" in b:
        return "mlstm"
    if "mix" in b:
        return "rec" if "lru" in b["mix"] else "attn"
    return "moe" if "router" in b["mlp"] else "self"


def layer_kinds_of(blocks: list) -> list[str]:
    """The layer kinds of a port param or spec tree's ``blocks``: "cross"
    where the block has a gate, "moe" where its MLP has a router, "self"
    for another transformer block; "mlstm" / "slstm" (xLSTM) and "rec" /
    "attn" (Griffin's RG-LRU and local attention), as the reference's
    ``layer_kinds`` name them."""
    return [_kind(b) for b in blocks]


def reference_split(kinds: list[str], cfg=None):
    """(prefix kinds, pattern kinds, repeats) of the reference's layout for
    these layer kinds: Griffin's own split for a hybrid ``cfg`` (which a
    Griffin tree needs), else ``split_layers`` (xLSTM's ``_split`` is
    ``split_layers`` too)."""
    griffin = {"rec", "attn"} & set(kinds)
    if cfg is not None and cfg.family == "hybrid":
        from repro_torch.models import griffin as G

        if kinds != G.layer_kinds(cfg):
            raise ValueError(f"{cfg.name}: layer kinds {kinds} are not the "
                             "config's")
        return G.split(cfg)
    if griffin:
        raise ValueError("Griffin's layout depends on its block pattern: "
                         "pass its config")
    return split_layers(kinds)


def scan_repeats(kinds: list[str], cfg=None) -> list[int]:
    """Each layer's repeat index in the reference's layout (0 for a prefix
    layer): the seed the reference's PTQ gives a stacked linear."""
    prefix, pattern, R = reference_split(kinds, cfg)
    return [0] * len(prefix) + [r for r in range(R) for _ in pattern]


def _unstack(stacked) -> list:
    """Leaves with a leading layer axis -> one tree per layer."""
    return [S.tree_map(lambda a, i=i: a[i], stacked)
            for i in range(len(S.leaves(stacked)[0]))]


def from_reference(tree: dict, *, device=None) -> dict:
    """Reference param tree (numpy leaves) -> port tree (tensors on
    ``device``, default the GPU)."""
    dev = S.resolve_device(device)
    if "enc" in tree:  # encoder-decoder: both stacks with period 1
        out = {part: dict(sub, blocks=_unstack(sub["blocks"]))
               for part, sub in tree.items()}
        return S.tree_map(lambda a: _to_tensor(a, dev), out)
    prefix = tree.get("prefix", {})
    pattern = tree.get("blocks", {})
    if (sorted(prefix, key=int) != [str(i) for i in range(len(prefix))]
            or sorted(pattern) != sorted(f"s{j}"
                                         for j in range(len(pattern)))):
        raise ValueError(f"not the reference's layout: prefix "
                         f"{sorted(prefix)}, blocks {sorted(pattern)}")
    repeats = {len(S.leaves(b)[0]) for b in pattern.values()}
    if len(repeats) > 1:
        raise ValueError(f"blocks/s<j> with different repeats {repeats}")
    R = repeats.pop() if repeats else 0
    out = {k: v for k, v in tree.items() if k not in ("blocks", "prefix")}
    stacks = [_unstack(pattern[f"s{j}"]) for j in range(len(pattern))]
    out["blocks"] = [prefix[str(i)] for i in range(len(prefix))] + [
        stacks[j][r] for r in range(R) for j in range(len(pattern))]
    return S.tree_map(lambda a: _to_tensor(a, dev), out)


def _stack(blocks: list):
    return S.tree_map(lambda *xs: np.stack([_to_numpy(x) for x in xs]),
                      *blocks)


def to_reference(params: dict, cfg=None) -> dict:
    """Port tree -> the reference's layout as numpy (bf16 leaves as f32
    arrays holding the same values). ``cfg``: the model's config, which
    a Griffin tree needs (:func:`reference_split`)."""
    if "enc" in params:
        return {part: {k: _stack(v) if k == "blocks" else
                       S.tree_map(_to_numpy, v) for k, v in sub.items()}
                for part, sub in params.items()}
    out = {k: S.tree_map(_to_numpy, v)
           for k, v in params.items() if k != "blocks"}
    blocks = params["blocks"]
    prefix, pattern, R = reference_split(layer_kinds_of(blocks), cfg)
    n, P = len(prefix), len(pattern)
    if prefix:
        out["prefix"] = {str(i): S.tree_map(_to_numpy, blocks[i])
                         for i in range(n)}
    if R:
        out["blocks"] = {
            f"s{j}": _stack([blocks[n + r * P + j] for r in range(R)])
            for j in range(P)}
    return out


def opt_from_reference(state: dict, *, device=None) -> dict:
    """The reference's AdamW state (numpy leaves) -> the port's, on
    ``device`` (default the GPU)."""
    dev = S.resolve_device(device)
    return {"mu": from_reference(state["mu"], device=dev),
            "nu": from_reference(state["nu"], device=dev),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}


def opt_to_reference(state: dict, cfg=None) -> dict:
    """The port's AdamW state -> the reference's layout as numpy."""
    return {"mu": to_reference(state["mu"], cfg),
            "nu": to_reference(state["nu"], cfg),
            "step": np.asarray(int(state["step"]), dtype=np.int32)}
