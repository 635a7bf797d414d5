"""Decoder-only transformer LM, dense family. Port of
``repro/models/transformer.py``.

The reference scans a stacked block over layers; the port keeps one
``nn.Module`` per layer in a ``ModuleList`` (``params["blocks"]`` is a list
of per-layer trees; ``repro_torch.convert`` unstacks the reference's
``blocks/s0`` leaves into it). Layer paths for recipe matching are
``blocks/<i>/attn/q`` and the like. MoE, VLM cross attention and MLA come
with their slices.
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


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: this port slice runs the dense GQA family only")


def _block_specs(cfg: ModelConfig, recipe, base: str) -> dict:
    d = cfg.d_model
    return {"ln1": rmsnorm_spec(d), "ln2": rmsnorm_spec(d),
            "attn": A.gqa_specs(cfg, recipe, f"{base}/attn"),
            "mlp": mlp_specs(cfg, recipe, f"{base}/mlp")}


def param_specs(cfg: ModelConfig, recipe=None) -> dict:
    _check_dense(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    dt = cfg.activation_dtype
    specs: dict = {
        "embed": S.w((V, d), dtype=dt, init="embed"),
        "final_norm": rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        specs["head"] = {"w": S.w((d, V), dtype=dt)}
    specs["blocks"] = [_block_specs(cfg, recipe, f"blocks/{i}")
                       for i in range(cfg.num_layers)]
    return specs


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    return {"blocks": [A.gqa_cache_specs(cfg, batch, max_seq)
                       for _ in range(cfg.num_layers)]}


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, params: dict, recipe, base: str):
        super().__init__()
        self.ln1 = RMSNorm(params["ln1"], cfg.norm_eps)
        self.ln2 = RMSNorm(params["ln2"], cfg.norm_eps)
        self.attn = A.GQAttention(cfg, params["attn"], recipe, f"{base}/attn")
        self.mlp = MLP(params["mlp"], recipe, f"{base}/mlp")

    def forward(self, x, *, mode, cache, pos):
        h, cache = self.attn(self.ln1(x), mode=mode, cache=cache, pos=pos)
        x = x + h
        x = x + self.mlp(self.ln2(x))
        return x, cache


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
        _check_dense(cfg)
        self.cfg, self.recipe = cfg, recipe
        self.register_buffer("embed", params["embed"])
        self.final_norm = RMSNorm(params["final_norm"], cfg.norm_eps)
        if not cfg.tie_embeddings:
            self.register_buffer("head", params["head"]["w"])
        self.blocks = nn.ModuleList(
            Block(cfg, p, recipe, f"blocks/{i}")
            for i, p in enumerate(params["blocks"]))

    def forward(self, tokens: torch.Tensor, *, mode: str = "train",
                cache: dict | None = None, pos=0):
        cfg = self.cfg
        x = F.embedding(tokens.long(), self.embed).to(cfg.activation_dtype)
        for i, blk in enumerate(self.blocks):
            c = cache["blocks"][i] if cache is not None else None
            x, _ = blk(x, mode=mode, cache=c, pos=pos)
        if mode == "prefill":
            # serving semantics: only the last position's logits
            x = x[:, -1:]
        x = self.final_norm(x)
        w = self.embed.T if cfg.tie_embeddings else self.head
        logits = x.float() @ w.float()
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        return logits, cache, torch.zeros((), device=logits.device)


def build(cfg: ModelConfig, params: dict, recipe=None) -> Transformer:
    return Transformer(cfg, params, recipe)
