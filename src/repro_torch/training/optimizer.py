"""AdamW, its learning-rate schedule and global-norm clipping. Port of
``repro/training/optimizer.py``.

The optimizer state is declared from the same ParamSpec tree as the
params (``mu`` and ``nu`` in f32, an int32 ``step``) and lives on the
params' device. The reference returns new trees; the port updates the
params and the state in place under ``torch.no_grad()`` (the params are
the tensors the model's modules hold), in the reference's op order. To
keep the peak down at full width it takes the global norm first and
makes each leaf's clipped f32 gradient inside that leaf's update: the
same elementwise math as the reference's whole-tree clip, one leaf's
temporaries at a time. Weight decay follows the reference's rule as the
reference's layout holds the leaf (:func:`decay_mask`; a Griffin tree's
layout needs the model's config, ``model_cfg``). Every scalar (the
norm, the clip scale, the learning rate, the bias corrections) is an f32
tensor on the device, so a step makes no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import convert
from repro_torch.nn import spec as S


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def state_specs(param_specs: Any) -> dict:
    """mu/nu in f32 with the params' shapes; an int32 scalar step."""

    def f32(s: S.ParamSpec) -> S.ParamSpec:
        return S.ParamSpec(s.shape, torch.float32, "zeros")

    return {"mu": S.tree_map(f32, param_specs),
            "nu": S.tree_map(f32, param_specs),
            "step": S.ParamSpec((), torch.int32, "zeros")}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio (f32, on step's
    device)."""
    step = step.float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every leaf, leaf sums added in
    leaf order (the reference's python ``sum``)."""
    total = None
    for x in S.leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


def clip_by_global_norm(grads: Any, max_norm: float):
    """(the f32 clipped gradient tree, the norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return S.tree_map(lambda g: g.float() * scale, grads), norm


def decay_mask(params: Any, cfg=None) -> Any:
    """Which leaves take weight decay: the reference's ``ndim >= 2`` rule
    as the reference's layout holds each leaf. There the layers after its
    prefix lie stacked on a leading repeat axis (``convert.py``), so a
    port layer's (d,) norm gain is (R, d) and decays; a prefix layer is
    unstacked, and a tree with no ``blocks`` list is its own layout.
    ``cfg``: the model's config, which a Griffin tree needs (its prefix
    is its first ``num_layers % 3`` layers: ``convert.reference_split``)."""

    def plain(tree, extra=0):
        return S.tree_map(lambda p: p.ndim + extra >= 2, tree)

    def model(tree, n_prefix):
        out = {k: plain(v) for k, v in tree.items() if k != "blocks"}
        out["blocks"] = [plain(b, int(i >= n_prefix))
                         for i, b in enumerate(tree["blocks"])]
        return out

    if isinstance(params, dict) and "enc" in params:  # both stacked whole
        return {k: model(v, 0) for k, v in params.items()}
    if isinstance(params, dict) and isinstance(params.get("blocks"), list):
        prefix, _, _ = convert.reference_split(
            convert.layer_kinds_of(params["blocks"]), cfg)
        return model(params, len(prefix))
    return plain(params)


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                  model_cfg=None):
    """One AdamW step, in place. Returns (params, state, metrics): the
    same trees, updated, and {"grad_norm", "lr"}. ``model_cfg``: the
    model's config, for :func:`decay_mask` (a Griffin tree needs it)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    state["step"].add_(1)
    lr = schedule(cfg, state["step"])
    b1, b2 = cfg.b1, cfg.b2
    stepf = state["step"].float()
    bc1 = 1 - torch.pow(torch.full_like(stepf, b1), stepf)
    bc2 = 1 - torch.pow(torch.full_like(stepf, b2), stepf)

    def upd(p, g, mu, nu, decay):
        g = g.float() * scale
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        del g
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        pf = p.float()
        # decoupled weight decay on matrices only (ndim >= 2 in the
        # reference's layout)
        if decay:
            delta = delta + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))

    # paired by key and index, not by leaf order: a tree converted from the
    # reference's may order its keys differently from the state's
    S.tree_map(upd, params, grads, state["mu"], state["nu"],
               decay_mask(params, model_cfg))
    return params, state, {"grad_norm": gnorm, "lr": lr}
