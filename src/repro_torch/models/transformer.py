"""Decoder-only transformer LM, dense, MoE and VLM families, with GQA or
MLA attention (``cfg.attention``). Port of ``repro/models/transformer.py``.

The reference lays its layers out as an unrolled prefix plus a pattern
scanned over stacked leaves (:func:`split_layers`); the port keeps one
``nn.Module`` per layer in a ``ModuleList`` (``params["blocks"]`` is a list
of per-layer trees; ``repro_torch.convert`` carries the reference's
``prefix/<i>`` and ``blocks/s<j>`` leaves into it). Layer paths for recipe
matching are ``blocks/<i>/attn/q`` and the like. A MoE config's blocks
are ``moe`` after ``first_dense_layers`` dense ones (:func:`layer_kinds`):
the gated MLP is replaced by ``models.moe.MoE``, and the forward's aux
output is the sum of the layers' load-balancing losses. A VLM config's
every ``cross_attn_every``-th layer is ``cross``: gated cross attention
to ``memory`` (the image embeddings; no vision tower, as the reference),
``x + tanh(gate_attn) * attn`` then ``x + tanh(gate_mlp) * mlp``, its
linears at ``blocks/<i>/xattn/{q,k,v,o}`` as the reference names them,
and a cross cache of (B, ``num_image_tokens``, Hkv, D).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.nn import spec as S
from . import attention as A
from .common import RMSNorm, rmsnorm_spec
from .config import ModelConfig
from .mlp import MLP, mlp_specs
from .moe import MoE, moe_specs


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm") or cfg.attention not in (
            "gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: the transformer runs the dense, MoE and VLM "
            "families with GQA or MLA attention only")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """"self" (the dense block), "moe" or "cross", one per layer: a VLM
    config's layer i is cross where ``(i + 1) % cross_attn_every == 0``;
    a MoE config's first ``first_dense_layers`` layers are dense, the
    rest MoE."""
    L = cfg.num_layers
    if cfg.family == "vlm" and cfg.cross_attn_every:
        return ["cross" if (i + 1) % cfg.cross_attn_every == 0 else "self"
                for i in range(L)]
    if cfg.num_experts:
        return ["self"] * cfg.first_dense_layers + \
               ["moe"] * (L - cfg.first_dense_layers)
    return ["self"] * L


def split_layers(kinds: list[str], max_period: int = 8):
    """-> (prefix_kinds, pattern_kinds, repeats), the reference's layout:
    the shortest prefix, then the shortest period, whose pattern repeated
    gives the rest (the reference scans the pattern over stacked
    leaves)."""
    n = len(kinds)
    for p in range(0, n):
        rest = kinds[p:]
        for period in range(1, max_period + 1):
            if len(rest) % period:
                continue
            pat = rest[:period]
            if pat * (len(rest) // period) == rest:
                return kinds[:p], pat, len(rest) // period
    return kinds, [], 0


def _block_specs(cfg: ModelConfig, recipe, kind: str, base: str) -> dict:
    d = cfg.d_model
    if kind == "cross":
        return {"ln1": rmsnorm_spec(d), "ln2": rmsnorm_spec(d),
                "attn": A.cross_attn_specs(cfg, recipe, f"{base}/xattn"),
                "mlp": mlp_specs(cfg, recipe, f"{base}/mlp"),
                "gate_attn": S.zeros((), ()), "gate_mlp": S.zeros((), ())}
    mlp = moe_specs if kind == "moe" else mlp_specs
    attn = A.mla_specs if cfg.attention == "mla" else A.gqa_specs
    return {"ln1": rmsnorm_spec(d), "ln2": rmsnorm_spec(d),
            "attn": attn(cfg, recipe, f"{base}/attn"),
            "mlp": mlp(cfg, recipe, f"{base}/mlp")}


def param_specs(cfg: ModelConfig, recipe=None) -> dict:
    _check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    dt = cfg.activation_dtype
    specs: dict = {
        "embed": S.w((V, d), ("vocab", "embed"), dtype=dt, init="embed"),
        "final_norm": rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        specs["head"] = {"w": S.w((d, V), ("embed", "vocab"), dtype=dt)}
    specs["blocks"] = [_block_specs(cfg, recipe, kind, f"blocks/{i}")
                       for i, kind in enumerate(layer_kinds(cfg))]
    return specs


def _block_cache_specs(cfg: ModelConfig, kind: str, batch: int,
                       max_seq: int) -> dict:
    if kind == "cross":
        return A.cross_attn_cache_specs(
            cfg, batch, cfg.num_image_tokens or cfg.encoder_seq)
    if cfg.attention == "mla":
        return A.mla_cache_specs(cfg, batch, max_seq)
    return A.gqa_cache_specs(cfg, batch, max_seq)


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    return {"blocks": [_block_cache_specs(cfg, kind, batch, max_seq)
                       for kind in layer_kinds(cfg)]}


class Block(nn.Module):
    """``forward(x, mode=, cache=, pos=, memory=) -> (x, cache, aux)``; aux
    is the MoE load-balancing loss (None for a dense or cross block). A
    self block ignores ``memory``; a cross block ignores ``pos``."""

    def __init__(self, cfg: ModelConfig, params: dict, recipe, kind: str,
                 base: str):
        super().__init__()
        self.ln1 = RMSNorm(params["ln1"], cfg.norm_eps)
        self.ln2 = RMSNorm(params["ln2"], cfg.norm_eps)
        self.cross = kind == "cross"
        self.moe = kind == "moe"
        if self.cross:
            self.attn = A.CrossAttention(cfg, params["attn"], recipe,
                                         f"{base}/xattn")
            self.register_buffer("gate_attn", params["gate_attn"])
            self.register_buffer("gate_mlp", params["gate_mlp"])
        else:
            attn = A.MLAttention if cfg.attention == "mla" else \
                A.GQAttention
            self.attn = attn(cfg, params["attn"], recipe, f"{base}/attn")
        self.mlp = (MoE(cfg, params["mlp"], recipe, f"{base}/mlp")
                    if self.moe else MLP(params["mlp"], recipe, f"{base}/mlp"))

    def forward(self, x, *, mode, cache, pos, memory=None):
        if self.cross:
            h, cache = self.attn(self.ln1(x), memory=memory, cache=cache,
                                 mode=mode)
            x = x + torch.tanh(self.gate_attn).to(x.dtype) * h
            h = self.mlp(self.ln2(x))
            return x + torch.tanh(self.gate_mlp).to(x.dtype) * h, cache, None
        h, cache = self.attn(self.ln1(x), mode=mode, cache=cache, pos=pos)
        x = x + h
        if self.moe:
            h, aux = self.mlp(self.ln2(x))
        else:
            h, aux = self.mlp(self.ln2(x)), None
        return x + h, cache, aux


class Transformer(nn.Module):
    """``forward(tokens, mode=, cache=, pos=, memory=) -> (logits f32, cache,
    aux)``.

    ``mode``: "train" (full-sequence logits), "prefill" (last position's
    logits only) or "decode" (one token per row at per-row positions
    ``pos``). ``memory`` (B, Sm, d): a VLM's image embeddings, read by
    its cross layers in train and prefill (decode reads their cache). A
    given ``cache`` is written in place. On CUDA tensors the
    quantized linears and prefill attention launch the Hopper kernels; on
    CPU tensors they take the kernels' plain versions. In "train" mode
    with grad enabled and ``cfg.remat``, each block runs under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference's
    ``jax.checkpoint``: its activations are recomputed in the backward.
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
                cache: dict | None = None, pos=0, memory=None):
        cfg = self.cfg
        x = F.embedding(tokens.long(), self.embed).to(cfg.activation_dtype)
        aux = torch.zeros((), device=x.device)
        # the reference's remat: each block's activations recomputed in the
        # backward (training only; serving runs without grad)
        remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            c = cache["blocks"][i] if cache is not None else None
            if remat:
                x, _, a = checkpoint(blk, x, mode=mode, cache=c, pos=pos,
                                     memory=memory, use_reentrant=False)
            else:
                x, _, a = blk(x, mode=mode, cache=c, pos=pos, memory=memory)
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
