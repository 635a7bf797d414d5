"""Logical-axis -> mesh-axis sharding rules per execution mode. Port of
``repro/distributed/sharding.py``.

One rule table per mode; :func:`repro_torch.nn.spec.partition_specs`
applies them with divisibility checks (a mapping that does not divide the
dim is dropped to replication: this is what lets Granite's one KV head and
MiniCPM3's odd vocab coexist with a 16-way model axis). A partition spec
becomes a ``DeviceMesh``'s DTensor placements through
:func:`repro_torch.nn.spec.placements`.

Axes vocabulary (see models/*):
  embed, mlp, mlp2, moe_mlp, heads_q, heads_kv, q_lora, kv_lora, vocab,
  experts, layers, cache_batch, cache_seq, batch, seq
"""
from __future__ import annotations

from repro_torch.launch.mesh import axis_sizes
from repro_torch.nn import spec as S

# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

# Training: FSDP over data (weights sharded on embed/mlp-in), TP over model
# (heads / ffn-out), EP over model for experts. `pod` composes as outer DP.


def train_rules(multi_pod: bool) -> S.Rules:
    data = ("pod", "data") if multi_pod else ("data",)
    return (
        ("embed", data),
        ("mlp", "model"),
        ("mlp2", None),
        ("moe_mlp", "model"),
        ("heads_q", "model"),
        ("heads_kv", "model"),
        ("q_lora", None),
        ("kv_lora", None),
        ("vocab", "model"),
        ("experts", "model"),
        ("layers", None),
        ("cache_batch", data),
        ("cache_seq", "model"),
    )


# Serving: weights TP-only on model (replicated across data rows so each
# row serves its batch slice with no weight collectives); batch over
# (pod,)data; KV sequence over model (flash-decoding style partial softmax).


def serve_rules(multi_pod: bool) -> S.Rules:
    data = ("pod", "data") if multi_pod else ("data",)
    return (
        ("embed", None),
        ("mlp", "model"),
        ("mlp2", None),
        ("moe_mlp", None),
        ("heads_q", "model"),
        ("heads_kv", "model"),
        ("q_lora", None),
        ("kv_lora", None),
        ("vocab", "model"),
        ("experts", "model"),
        ("layers", None),
        ("cache_batch", data),
        ("cache_seq", "model"),
    )


def rules_for(mode: str, multi_pod: bool = False) -> S.Rules:
    return train_rules(multi_pod) if mode == "train" else serve_rules(multi_pod)


# ---------------------------------------------------------------------------
# Activation / input shardings
# ---------------------------------------------------------------------------


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


def input_pspecs(mesh, inputs: dict, multi_pod: bool = False) -> dict:
    """tokens/labels and the modality stubs: the batch over (pod,)data
    where it divides, else replicated; a 0-d input is replicated."""
    b = batch_axes(multi_pod)
    sizes = axis_sizes(mesh)
    bsz = (sizes.get("pod", 1) * sizes["data"]) if multi_pod else sizes["data"]

    def one(v):
        if v.shape and v.shape[0] % bsz == 0:
            return S.PartitionSpec(b, *([None] * (len(v.shape) - 1)))
        return S.PartitionSpec()

    return {k: one(v) for k, v in inputs.items()}


def input_shardings(mesh, inputs: dict, multi_pod: bool = False) -> dict:
    """Each input's DTensor placements on ``mesh`` (:func:`input_pspecs`)."""
    return {k: S.placements(p, mesh)
            for k, p in input_pspecs(mesh, inputs, multi_pod).items()}


def named_tree(mesh, spec_tree, rules: S.Rules):
    """The placements of every leaf of a ParamSpec tree on ``mesh``."""
    pspecs = S.partition_specs(spec_tree, rules, axis_sizes(mesh))
    return S.tree_map(lambda p: S.placements(p, mesh), pspecs)


def replicated(mesh) -> list:
    return S.placements(S.PartitionSpec(), mesh)
