"""Decoder-only transformer LM, dense and MoE families. Port of
``repro/models/transformer.py``.

The reference scans a stacked block over layers; the port keeps one
``nn.Module`` per layer in a ``ModuleList`` (``params["blocks"]`` is a list
of per-layer trees; ``repro_torch.convert`` unstacks the reference's
``blocks/s0`` leaves into it). Layer paths for recipe matching are
``blocks/<i>/attn/q`` and the like. A MoE config's blocks are all ``moe``
(:func:`layer_kinds`; the leading dense layers of DeepSeek-V2 come with
its slice): the gated MLP is replaced by ``models.moe.MoE``, and the
forward's aux output is the sum of the layers' load-balancing losses.
VLM cross attention and MLA come with their slices.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.nn import spec as S
from . import attention as A
from .common import RMSNorm, rmsnorm_spec
from .config import ModelConfig
from .mlp import MLP, mlp_specs
from .moe import MoE, moe_specs


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe") or cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense and MoE GQA families only")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """"moe" for every layer of a MoE config, else "self" (the dense
    block)."""
    return ["moe" if cfg.num_experts else "self"] * cfg.num_layers


def _block_specs(cfg: ModelConfig, recipe, kind: str, base: str) -> dict:
    d = cfg.d_model
    mlp = moe_specs if kind == "moe" else mlp_specs
    return {"ln1": rmsnorm_spec(d), "ln2": rmsnorm_spec(d),
            "attn": A.gqa_specs(cfg, recipe, f"{base}/attn"),
            "mlp": mlp(cfg, recipe, f"{base}/mlp")}


def param_specs(cfg: ModelConfig, recipe=None) -> dict:
    _check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    dt = cfg.activation_dtype
    specs: dict = {
        "embed": S.w((V, d), dtype=dt, init="embed"),
        "final_norm": rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        specs["head"] = {"w": S.w((d, V), dtype=dt)}
    specs["blocks"] = [_block_specs(cfg, recipe, kind, f"blocks/{i}")
                       for i, kind in enumerate(layer_kinds(cfg))]
    return specs


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    return {"blocks": [A.gqa_cache_specs(cfg, batch, max_seq)
                       for _ in range(cfg.num_layers)]}


class Block(nn.Module):
    """``forward(x, mode=, cache=, pos=) -> (x, cache, aux)``; aux is the
    MoE load-balancing loss (zero for a dense block)."""

    def __init__(self, cfg: ModelConfig, params: dict, recipe, kind: str,
                 base: str):
        super().__init__()
        self.ln1 = RMSNorm(params["ln1"], cfg.norm_eps)
        self.ln2 = RMSNorm(params["ln2"], cfg.norm_eps)
        self.attn = A.GQAttention(cfg, params["attn"], recipe, f"{base}/attn")
        self.moe = kind == "moe"
        self.mlp = (MoE(cfg, params["mlp"], recipe, f"{base}/mlp")
                    if self.moe else MLP(params["mlp"], recipe, f"{base}/mlp"))

    def forward(self, x, *, mode, cache, pos):
        h, cache = self.attn(self.ln1(x), mode=mode, cache=cache, pos=pos)
        x = x + h
        if self.moe:
            h, aux = self.mlp(self.ln2(x))
        else:
            h, aux = self.mlp(self.ln2(x)), None
        return x + h, cache, aux


class Transformer(nn.Module):
    """``forward(tokens, mode=, cache=, pos=) -> (logits f32, cache, aux)``.

    ``mode``: "train" (full-sequence logits), "prefill" (last position's
    logits only) or "decode" (one token per row at per-row positions
    ``pos``). A given ``cache`` is written in place. On CUDA tensors the
    quantized linears and prefill attention launch the Hopper kernels; on
    CPU tensors they take the kernels' plain versions.
    """

    def __init__(self, cfg: ModelConfig, params: dict, recipe=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg, self.recipe = cfg, recipe
        self.register_buffer("embed", params["embed"])
        self.final_norm = RMSNorm(params["final_norm"], cfg.norm_eps)
        if not cfg.tie_embeddings:
            self.register_buffer("head", params["head"]["w"])
        self.blocks = nn.ModuleList(
            Block(cfg, p, recipe, kind, f"blocks/{i}")
            for i, (p, kind) in enumerate(zip(params["blocks"],
                                              layer_kinds(cfg))))

    def forward(self, tokens: torch.Tensor, *, mode: str = "train",
                cache: dict | None = None, pos=0):
        cfg = self.cfg
        x = F.embedding(tokens.long(), self.embed).to(cfg.activation_dtype)
        aux = torch.zeros((), device=x.device)
        for i, blk in enumerate(self.blocks):
            c = cache["blocks"][i] if cache is not None else None
            x, _, a = blk(x, mode=mode, cache=c, pos=pos)
            if a is not None:
                aux = aux + a
        if mode == "prefill":
            # serving semantics: only the last position's logits
            x = x[:, -1:]
        x = self.final_norm(x)
        w = self.embed.T if cfg.tie_embeddings else self.head
        logits = x.float() @ w.float()
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        return logits, cache, aux


def build(cfg: ModelConfig, params: dict, recipe=None) -> Transformer:
    return Transformer(cfg, params, recipe)
