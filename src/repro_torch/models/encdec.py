"""Whisper-style encoder-decoder (the audio family). Port of
``repro/models/encdec.py``.

As in the reference, the mel-spectrogram conv stem is a stub: the caller
gives frame embeddings (B, S_enc, d). The backbone is the reference's:
LayerNorm blocks, a bidirectional encoder with sinusoidal positions, and
a decoder with learned positions, causal self attention, cross attention
to the encoder output and GELU MLPs (tanh approximation, as
``jax.nn.gelu``'s default), logits tied to the embedding in f32. The
attention linears are q/v/o with a bias and k without; the MLP's up and
down have biases.

On CUDA tensors the encoder's self attention, the decoder's prefill self
attention (causal) and every cross attention (non-causal, over the
encoder's S_enc keys; in decode, over the cross cache) launch the flash
kernel; decode self attention is :func:`attention.decode_attention` over
the self cache. The decoder's caches are written in place and always
hold the activation dtype (the reference ignores ``kv_cache_dtype``
here). ``pos`` is a scalar, as the reference's: an int, or a 0-d tensor
on the device, which a captured decode step reads without baking it in.

Module paths for the recipe: ``enc/blocks/<i>/attn/{q,k,v,o}``,
``enc/blocks/<i>/mlp/{up,down}``, ``dec/blocks/<i>/{self,cross}/...`` and
``dec/blocks/<i>/mlp/...``.

In "train" mode with grad enabled and ``cfg.remat``, each decoder block
runs under ``torch.utils.checkpoint`` (non-reentrant), as the reference's
``jax.checkpoint`` on its decoder body: its activations are recomputed
in the backward. The encoder's blocks are not rematted, as in the
reference.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.nn import spec as S
from .attention import attend_memory, decode_attention
from .common import LayerNorm, Linear, layernorm_spec, linear
from .config import ModelConfig


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _attn_specs(cfg: ModelConfig, recipe, base: str) -> dict:
    d, hd, H = cfg.d_model, cfg.head_dim, cfg.num_heads
    dt = cfg.activation_dtype
    return {
        "q": linear(recipe, f"{base}/q", d, H * hd, ("embed", "heads_q"),
                    bias=True, dtype=dt),
        "k": linear(recipe, f"{base}/k", d, H * hd, ("embed", "heads_kv"),
                    dtype=dt),
        "v": linear(recipe, f"{base}/v", d, H * hd, ("embed", "heads_kv"),
                    bias=True, dtype=dt),
        "o": linear(recipe, f"{base}/o", H * hd, d, ("heads_q", "embed"),
                    bias=True, dtype=dt),
    }


def _mlp_specs(cfg: ModelConfig, recipe, base: str) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.activation_dtype
    return {"up": linear(recipe, f"{base}/up", d, f, ("embed", "mlp"),
                         bias=True, dtype=dt),
            "down": linear(recipe, f"{base}/down", f, d, ("mlp", "embed"),
                           bias=True, dtype=dt)}


def _enc_block_specs(cfg: ModelConfig, recipe, base: str) -> dict:
    d = cfg.d_model
    return {"ln1": layernorm_spec(d),
            "attn": _attn_specs(cfg, recipe, f"{base}/attn"),
            "ln2": layernorm_spec(d),
            "mlp": _mlp_specs(cfg, recipe, f"{base}/mlp")}


def _dec_block_specs(cfg: ModelConfig, recipe, base: str) -> dict:
    d = cfg.d_model
    return {"ln1": layernorm_spec(d),
            "self": _attn_specs(cfg, recipe, f"{base}/self"),
            "ln_x": layernorm_spec(d),
            "cross": _attn_specs(cfg, recipe, f"{base}/cross"),
            "ln2": layernorm_spec(d),
            "mlp": _mlp_specs(cfg, recipe, f"{base}/mlp")}


def param_specs(cfg: ModelConfig, recipe=None) -> dict:
    d, V, dt = cfg.d_model, cfg.vocab_size, cfg.activation_dtype
    ne = cfg.num_encoder_layers or cfg.num_layers
    return {
        "enc": {"blocks": [_enc_block_specs(cfg, recipe, f"enc/blocks/{i}")
                           for i in range(ne)],
                "final_ln": layernorm_spec(d)},
        "dec": {"embed": S.w((V, d), ("vocab", "embed"), dtype=dt,
                             init="embed"),
                "pos": S.w((cfg.max_positions, d), (None, "embed"), dtype=dt,
                           scale=0.02),
                "blocks": [_dec_block_specs(cfg, recipe, f"dec/blocks/{i}")
                           for i in range(cfg.num_layers)],
                "final_ln": layernorm_spec(d)},
    }


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Per decoder layer: the self cache (B, max_seq, H, D) and the cross
    cache (B, encoder_seq, H, D), both in the activation dtype."""
    dt = cfg.activation_dtype
    self_shape = (batch, max_seq, cfg.num_heads, cfg.head_dim)
    cross_shape = (batch, cfg.encoder_seq, cfg.num_heads, cfg.head_dim)
    ax = ("cache_batch", "cache_seq", "heads_kv", None)
    axm = ("cache_batch", None, "heads_kv", None)
    return {"blocks": [
        {"self": {"k": S.zeros(self_shape, ax, dtype=dt),
                  "v": S.zeros(self_shape, ax, dtype=dt)},
         "cross": {"k": S.zeros(cross_shape, axm, dtype=dt),
                   "v": S.zeros(cross_shape, axm, dtype=dt)}}
        for _ in range(cfg.num_layers)]}


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def sinusoid(S_: int, d: int, device=None) -> torch.Tensor:
    """The encoder's (S_, d) f32 position table, the reference's f32
    ``pos / 10000 ** (2 dim / d)`` with sin on the first half and cos on
    the second. ``10000 ** y`` and sin / cos are taken in f64 and rounded
    to f32: PyTorch's f32 ``pow`` misses XLA's by an ulp at one exponent
    of d = 384, and the f64-rounded values match it (so the angles are
    the reference's bit for bit); XLA's f32 sin and cos are not correctly
    rounded, so the table is within 2^-24 of the reference's, and equal
    to it once cast to bf16 at whisper-tiny's and the smoke config's
    shapes."""
    f32, f64 = torch.float32, torch.float64
    pos = torch.arange(S_, dtype=f32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=f32, device=device)[None, :]
    # a true division on every device (CUDA divides by a python scalar by
    # multiplying with its reciprocal)
    y = 2 * dim / torch.full((), d, dtype=f32, device=device)
    ang = pos / torch.pow(torch.tensor(10000.0, dtype=f64, device=device),
                          y.to(f64)).to(f32)
    ang = ang.to(f64)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(f32)


def _check_pos(pos) -> None:
    if isinstance(pos, torch.Tensor) and pos.ndim:
        raise ValueError(f"the encoder-decoder takes one scalar position, "
                         f"as the reference, not a {tuple(pos.shape)} tensor")


def _write_at(cache_arr: torch.Tensor, val: torch.Tensor, pos) -> None:
    """Write (B, S_new, ...) into the cache at scalar offset ``pos`` (an
    int, or a 0-d device tensor: no host sync), in place."""
    if isinstance(pos, torch.Tensor):
        idx = pos + torch.arange(val.shape[1], device=val.device)
        cache_arr.index_copy_(1, idx, val.to(cache_arr.dtype))
    else:
        cache_arr[:, pos:pos + val.shape[1]] = val.to(cache_arr.dtype)


class Attention(nn.Module):
    """One of the reference's ``_attend`` calls: self attention (the
    encoder's, non-causal; the decoder's, causal, with a cache written at
    ``pos``) or, with ``cross=True``, attention to the encoder output
    (its k/v written to the cross cache in prefill, read back in
    decode)."""

    def __init__(self, cfg: ModelConfig, params: dict, recipe, base: str,
                 *, causal: bool, cross: bool = False):
        super().__init__()
        self.cfg, self.causal, self.cross = cfg, causal, cross
        for name in ("q", "k", "v", "o"):
            setattr(self, name, Linear(recipe, f"{base}/{name}",
                                       params[name]))

    def forward(self, x, xkv=None, *, cache=None, pos=0, mode="train"):
        cfg = self.cfg
        B, Sq, _ = x.shape
        H, hd = cfg.num_heads, cfg.head_dim
        if self.cross:
            q = self.q(x).reshape(B, Sq, H, hd)
            if mode == "decode":
                k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
            else:
                # k and v read the encoder output: quantized once for both
                Sk = xkv.shape[1]
                mq = kops.quantize_for(xkv, (self.k, self.v))
                k = self.k(xkv, mq).reshape(B, Sk, H, hd)
                v = self.v(xkv, mq).reshape(B, Sk, H, hd)
                if cache is not None:
                    cache["k"].copy_(k)
                    cache["v"].copy_(v)
            out = attend_memory(q, k, v, x.dtype)
        else:
            # q, k and v read x: quantized once for all three
            xq = kops.quantize_for(x, (self.q, self.k, self.v))
            q = self.q(x, xq).reshape(B, Sq, H, hd)
            k = self.k(x, xq).reshape(B, Sq, H, hd)
            v = self.v(x, xq).reshape(B, Sq, H, hd)
            if cache is not None:
                _write_at(cache["k"], k, pos)
                _write_at(cache["v"], v, pos)
            if mode == "decode":
                out = decode_attention(q, cache["k"], cache["v"], pos + Sq)
            else:
                out = flash_attention(q, k, v, causal=self.causal)
            out = out.to(x.dtype)
        return self.o(out.reshape(B, Sq, H * hd))


class MLP(nn.Module):
    def __init__(self, params: dict, recipe, base: str):
        super().__init__()
        self.up = Linear(recipe, f"{base}/up", params["up"])
        self.down = Linear(recipe, f"{base}/down", params["down"])

    def forward(self, x):
        h = F.gelu(self.up(x).float(), approximate="tanh").to(x.dtype)
        return self.down(h)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, params: dict, recipe, base: str):
        super().__init__()
        self.ln1 = LayerNorm(params["ln1"], cfg.norm_eps)
        self.attn = Attention(cfg, params["attn"], recipe, f"{base}/attn",
                              causal=False)
        self.ln2 = LayerNorm(params["ln2"], cfg.norm_eps)
        self.mlp = MLP(params["mlp"], recipe, f"{base}/mlp")

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, params: dict, recipe, base: str):
        super().__init__()
        self.ln1 = LayerNorm(params["ln1"], cfg.norm_eps)
        self.self_attn = Attention(cfg, params["self"], recipe,
                                   f"{base}/self", causal=True)
        self.ln_x = LayerNorm(params["ln_x"], cfg.norm_eps)
        self.cross_attn = Attention(cfg, params["cross"], recipe,
                                    f"{base}/cross", causal=False,
                                    cross=True)
        self.ln2 = LayerNorm(params["ln2"], cfg.norm_eps)
        self.mlp = MLP(params["mlp"], recipe, f"{base}/mlp")

    def forward(self, x, enc_out, *, cache, pos, mode):
        c_self, c_cross = (None, None) if cache is None else (
            cache["self"], cache["cross"])
        x = x + self.self_attn(self.ln1(x), cache=c_self, pos=pos, mode=mode)
        x = x + self.cross_attn(self.ln_x(x), enc_out, cache=c_cross,
                                mode=mode)
        return x + self.mlp(self.ln2(x))


class EncDec(nn.Module):
    """``forward(tokens, mode=, cache=, pos=, memory=) -> (logits f32,
    cache, aux)``: ``memory`` is the frame embeddings (B, S_enc, d), run
    through the encoder in train and prefill (decode reads the cross
    cache and takes no memory); aux is zero. ``mode`` as the
    transformer's; the given ``cache`` is written in place."""

    def __init__(self, cfg: ModelConfig, params: dict, recipe=None):
        super().__init__()
        self.cfg, self.recipe = cfg, recipe
        enc, dec = params["enc"], params["dec"]
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(cfg, p, recipe, f"enc/blocks/{i}")
            for i, p in enumerate(enc["blocks"]))
        self.enc_final_ln = LayerNorm(enc["final_ln"], cfg.norm_eps)
        self.register_buffer("embed", dec["embed"])
        self.register_buffer("pos", dec["pos"])
        self.blocks = nn.ModuleList(
            DecoderBlock(cfg, p, recipe, f"dec/blocks/{i}")
            for i, p in enumerate(dec["blocks"]))
        self.final_ln = LayerNorm(dec["final_ln"], cfg.norm_eps)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, S_enc, d) frame embeddings -> the encoder output."""
        x = frames.to(self.cfg.activation_dtype)
        x = x + sinusoid(x.shape[1], x.shape[2], x.device).to(x.dtype)[None]
        for blk in self.enc_blocks:
            x = blk(x)
        return self.enc_final_ln(x)

    def forward(self, tokens: torch.Tensor, *, mode: str = "train",
                cache: dict | None = None, pos=0, memory=None):
        _check_pos(pos)
        Sq = tokens.shape[1]
        enc_out = None if mode == "decode" else self.encode(memory)
        x = F.embedding(tokens.long(), self.embed).to(
            self.cfg.activation_dtype)
        posn = pos + torch.arange(Sq, device=x.device)
        x = x + self.pos[posn].to(x.dtype)[None]
        # the reference's remat of the decoder body (training only)
        remat = self.cfg.remat and mode == "train" and \
            torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            c = cache["blocks"][i] if cache is not None else None
            if remat:
                x = checkpoint(blk, x, enc_out, cache=c, pos=pos, mode=mode,
                               use_reentrant=False)
            else:
                x = blk(x, enc_out, cache=c, pos=pos, mode=mode)
        if mode == "prefill":
            x = x[:, -1:]
        x = self.final_ln(x)
        logits = x.float() @ self.embed.float().T
        return logits, cache, torch.zeros((), device=x.device)


def build(cfg: ModelConfig, params: dict, recipe=None) -> EncDec:
    return EncDec(cfg, params, recipe)
