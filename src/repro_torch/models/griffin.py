"""RecurrentGemma / Griffin ("hybrid" family): RG-LRU recurrent blocks and
local attention, each followed by a GeGLU MLP block. Port of
``repro/models/griffin.py``.

The temporal-mixing blocks cycle ``block_pattern`` (rec, rec, attn: one
local attention to two recurrences, arXiv:2402.19427).

RG-LRU:  r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
         a_t = exp(-c * softplus(Lambda) * r_t)
         h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a linear recurrence, which :func:`_lru_scan` runs as a log-depth scan in
f32 (the reference's ``associative_scan``; the same sums within f32
rounding), the starting state folded into step 0 as the reference does.
``W_a`` and ``W_x`` (``lru/wa``, ``lru/wi``) are f32 and stay unquantized,
as in the reference, as do the conv and Lambda.

Local attention keeps a ring buffer of exactly ``window`` key/value slots
(in the activation dtype, whatever ``kv_cache_dtype`` says, as the
reference): decode writes slot ``pos % window`` and attends over the
slots whose absolute position ``pos - ((pos - s) mod window)`` is >= 0;
prefill attends causally within the window with the flash kernel on CUDA
tensors (its plain version on the CPU) and keeps the last ``min(window,
S)`` tokens in ring order. ``pos`` is one scalar, as the reference's: an
int, or a 0-d device tensor that a captured decode step reads without a
host sync; a per-row position vector raises, as it does in the reference
(the engine passes one, so the engine refuses this family). Caches are
written in place.

The embedding is scaled by sqrt(d_model) in the activation dtype, and the
logits are computed in f32 over the tied embedding, then soft-capped at
``logit_softcap``. Training (``mode="train"`` with grad enabled) under
``cfg.remat`` runs each block through ``torch.utils.checkpoint``
(non-reentrant), as the reference's ``jax.checkpoint`` of its scanned
body: the block's activations are recomputed in the backward. The
RG-LRU's gradient is autograd's through :func:`_lru_scan`'s log-depth
products; the local attention's is the flash backward kernel on CUDA
tensors (head dim 256 with the window), its plain version on the CPU.
The reference's layout takes the first ``num_layers %
len(block_pattern)`` kinds as the unrolled prefix and scans whole patterns
after it (:func:`split`). Linear paths are the reference's recipe paths:
``blocks/<i>/rglru/{gate_proj,x_proj,out_proj}``,
``blocks/<i>/lattn/attn/{q,k,v,o}`` and ``blocks/<i>/mlp/{gate,up,down}``
(the param tree holds them under ``mix`` and ``mlp``, as the reference's).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.nn import spec as S
from .attention import NEG_INF, apply_rope, gqa_specs, rope_cos_sin
from .common import Linear, RMSNorm, linear, rmsnorm_spec
from .config import ModelConfig
from .xlstm import CausalConv, conv_specs

DEFAULT_PATTERN = ("rec", "rec", "attn")


# ---------------------------------------------------------------------------
# RG-LRU recurrent block
# ---------------------------------------------------------------------------


def rglru_specs(cfg: ModelConfig, recipe, base: str) -> dict:
    d = dr = cfg.d_model  # d_rnn = d_model (Griffin)
    dt = cfg.activation_dtype
    return {
        "ln": rmsnorm_spec(d),
        "gate_proj": linear(recipe, f"{base}/gate_proj", d, dr,
                            ("embed", "mlp"), dtype=dt),
        "x_proj": linear(recipe, f"{base}/x_proj", d, dr, ("embed", "mlp"),
                         dtype=dt),
        "conv": conv_specs(dr, cfg.conv_width),
        "lru": {
            # softplus(lam): the decay rate
            "lam": S.w((dr,), ("mlp",), init="ones"),
            "wa": S.w((dr, dr), ("mlp", "mlp2"), scale=0.5),
            "ba": S.zeros((dr,), ("mlp",)),
            "wi": S.w((dr, dr), ("mlp", "mlp2"), scale=0.5),
            "bi": S.zeros((dr,), ("mlp",)),
        },
        "out_proj": linear(recipe, f"{base}/out_proj", dr, d,
                           ("mlp", "embed"), dtype=dt),
    }


def rglru_state_specs(cfg: ModelConfig, batch: int) -> dict:
    dr = cfg.d_model
    return {"h": S.zeros((batch, dr), ("cache_batch", "mlp"),
                         dtype=torch.float32),
            "conv": S.zeros((batch, cfg.conv_width - 1, dr),
                            ("cache_batch", None, "mlp"),
                            dtype=cfg.activation_dtype)}


def _lru_scan(a: torch.Tensor, b: torch.Tensor,
              h0: torch.Tensor | None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 (f32), h_{-1} = ``h0`` (None:
    zero), folded into step 0 as ``b_0 + a_0 h0``. A log-depth inclusive
    scan: at offset o = 1, 2, 4, ... every element takes on the one o
    before it, (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2)."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S_ = a.shape[1]
    o = 1
    while o < S_:
        b = torch.cat([b[:, :o], a[:, o:] * b[:, :-o] + b[:, o:]], dim=1)
        a = torch.cat([a[:, :o], a[:, :-o] * a[:, o:]], dim=1)
        o *= 2
    return b


def _rglru(lru: dict, xf: torch.Tensor, h0: torch.Tensor | None,
           lru_c: float) -> torch.Tensor:
    """The RG-LRU over xf (B, S, d_rnn) f32 from state ``h0`` (None:
    zero): the recurrence and input gates (f32 products with ``wa`` and
    ``wi``), the decay a = exp(-c softplus(lam) r), the input normalized
    by sqrt(1 - a^2), then :func:`_lru_scan`. Returns h (B, S, d_rnn)."""
    r = torch.sigmoid(xf @ lru["wa"].float() + lru["ba"].float())
    i = torch.sigmoid(xf @ lru["wi"].float() + lru["bi"].float())
    lam = lru["lam"].float()
    # softplus with no threshold, as jax.nn.softplus: logaddexp(x, 0)
    log_a = -lru_c * torch.logaddexp(
        lam, torch.zeros((), device=lam.device)) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) input normalization (Griffin eq. 5)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xf)
    return _lru_scan(a, b, h0)


class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, params: dict, recipe, base: str):
        super().__init__()
        self.cfg = cfg
        self.ln = RMSNorm(params["ln"], cfg.norm_eps)
        for name in ("gate_proj", "x_proj", "out_proj"):
            setattr(self, name, Linear(recipe, f"{base}/{name}",
                                       params[name]))
        self.conv = CausalConv(params["conv"])
        for name, t in params["lru"].items():
            self.register_buffer(name, t)

    def forward(self, x, state=None):
        xi = self.ln(x)
        # gate_proj and x_proj read xi: quantized once for both
        xq = kops.quantize_for(xi, (self.gate_proj, self.x_proj))
        gate = F.gelu(self.gate_proj(xi, xq).float(), approximate="tanh")
        xr = self.x_proj(xi, xq)
        xr, conv_new = self.conv(xr, None if state is None
                                 else state["conv"])
        h = _rglru(dict(self.named_buffers(recurse=False)), xr.float(),
                   None if state is None else state["h"].float(),
                   self.cfg.lru_c)
        y = self.out_proj((h * gate).to(x.dtype))
        if state is not None:
            state["h"].copy_(h[:, -1])
            state["conv"].copy_(conv_new)
        return x + y


# ---------------------------------------------------------------------------
# Local attention with a ring-buffer KV cache
# ---------------------------------------------------------------------------


def local_attn_specs(cfg: ModelConfig, recipe, base: str) -> dict:
    return {"ln": rmsnorm_spec(cfg.d_model),
            "attn": gqa_specs(cfg, recipe, f"{base}/attn")}


def local_attn_state_specs(cfg: ModelConfig, batch: int) -> dict:
    shape = (batch, cfg.window, cfg.num_kv_heads, cfg.head_dim)
    ax = ("cache_batch", "cache_seq", "heads_kv", None)
    dt = cfg.activation_dtype
    return {"k": S.zeros(shape, ax, dtype=dt),
            "v": S.zeros(shape, ax, dtype=dt)}


def _check_pos(pos) -> None:
    if isinstance(pos, torch.Tensor) and pos.ndim:
        raise ValueError(
            f"Griffin takes one scalar position, as the reference (its "
            f"ring-buffer write takes one slot), not a {tuple(pos.shape)} "
            "tensor")


def _ring_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                    pos) -> torch.Tensor:
    """One decode step's attention over the ring of W slots, in f32: q (B,
    1, Hq, hd), kc / vc (B, W, Hkv, hd) holding position ``pos`` at slot
    ``pos % W``. Slot s holds absolute position pos - ((pos - s) mod W);
    the slots whose position is below 0 are masked. Returns (B, 1, Hq,
    hd) f32."""
    B, _, Hq, hd = q.shape
    W, Hkv = kc.shape[1], kc.shape[2]
    s_idx = torch.arange(W, device=q.device)
    valid = (pos - torch.remainder(pos - s_idx, W)) >= 0
    qg = q.reshape(B, Hkv, Hq // Hkv, hd).float()
    # f32 sqrt(hd) as a device fill, not a host copy (a captured step)
    qg = qg / torch.sqrt(torch.full((), float(hd), device=q.device))
    s = torch.einsum("bhgd,bshd->bhgs", qg, kc.float())
    s = torch.where(valid[None, None, None], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", pr, vc.float())
    return out.reshape(B, 1, Hq, hd)


class LocalAttention(nn.Module):
    def __init__(self, cfg: ModelConfig, params: dict, recipe, base: str):
        super().__init__()
        self.cfg = cfg
        self.ln = RMSNorm(params["ln"], cfg.norm_eps)
        p, ab = params["attn"], f"{base}/attn"
        for name in ("q", "k", "v", "o"):
            setattr(self, name, Linear(recipe, f"{ab}/{name}", p[name]))

    def forward(self, x, state=None, *, pos=0, mode="train"):
        cfg = self.cfg
        B, Sq, _ = x.shape
        hd, Hq, Hkv, W = (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads,
                          cfg.window)
        xi = self.ln(x)
        # q, k and v read xi: quantized once for all three
        xq = kops.quantize_for(xi, (self.q, self.k, self.v))
        q = self.q(xi, xq).reshape(B, Sq, Hq, hd)
        k = self.k(xi, xq).reshape(B, Sq, Hkv, hd)
        v = self.v(xi, xq).reshape(B, Sq, Hkv, hd)
        positions = pos + torch.arange(Sq, device=x.device)
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if mode == "decode":
            # ring-buffer write at slot pos % W (Sq == 1)
            kc, vc = state["k"], state["v"]
            if isinstance(pos, torch.Tensor):
                slot = torch.remainder(pos, W).reshape(1)
                kc.index_copy_(1, slot, k.to(kc.dtype))
                vc.index_copy_(1, slot, v.to(vc.dtype))
            else:
                kc[:, pos % W] = k[:, 0].to(kc.dtype)
                vc[:, pos % W] = v[:, 0].to(vc.dtype)
            out = _ring_attention(q, kc, vc, pos).to(x.dtype)
        else:
            out = flash_attention(q, k, v, causal=True, window=W).to(x.dtype)
            if state is not None:  # keep the last W tokens, in ring order
                take = min(W, Sq)
                slots = torch.remainder(
                    pos + Sq - take + torch.arange(take, device=x.device), W)
                for name, val in (("k", k), ("v", v)):
                    c = state[name]
                    c.index_copy_(1, slots, val[:, -take:].to(c.dtype))
        return x + self.o(out.reshape(B, Sq, Hq * hd))


# ---------------------------------------------------------------------------
# MLP (GeGLU) block
# ---------------------------------------------------------------------------


def mlp_block_specs(cfg: ModelConfig, recipe, base: str) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.activation_dtype
    return {
        "ln": rmsnorm_spec(d),
        "gate": linear(recipe, f"{base}/gate", d, f, ("embed", "mlp"),
                       dtype=dt),
        "up": linear(recipe, f"{base}/up", d, f, ("embed", "mlp"), dtype=dt),
        "down": linear(recipe, f"{base}/down", f, d, ("mlp", "embed"),
                       dtype=dt),
    }


class GeGLU(nn.Module):
    def __init__(self, cfg: ModelConfig, params: dict, recipe, base: str):
        super().__init__()
        self.ln = RMSNorm(params["ln"], cfg.norm_eps)
        for name in ("gate", "up", "down"):
            setattr(self, name, Linear(recipe, f"{base}/{name}",
                                       params[name]))

    def forward(self, x):
        h = self.ln(x)
        # gate and up read h: quantized once for both
        hq = kops.quantize_for(h, (self.gate, self.up))
        g = self.gate(h, hq)
        u = self.up(h, hq)
        return x + self.down(
            F.gelu(g.float(), approximate="tanh").to(x.dtype) * u)


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


def _pattern(cfg: ModelConfig) -> list[str]:
    return list(cfg.block_pattern) or list(DEFAULT_PATTERN)


def layer_kinds(cfg: ModelConfig) -> list[str]:
    pat = _pattern(cfg)
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def split(cfg: ModelConfig):
    """The reference's layout ``_split``: (prefix kinds, pattern kinds,
    repeats). The first ``num_layers % len(pattern)`` kinds are the
    prefix and whole patterns are scanned after it; with no remainder,
    ``split_layers`` over the kinds with periods up to the pattern's
    length."""
    from .transformer import split_layers

    kinds, P = layer_kinds(cfg), len(_pattern(cfg))
    rem = cfg.num_layers % P
    if rem:
        return kinds[:rem], kinds[rem:rem + P], (cfg.num_layers - rem) // P
    return split_layers(kinds, max_period=P)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(f"{cfg.name}: models.griffin runs the "
                                  "hybrid family")


def _block_specs(cfg, recipe, kind, base):
    mix = (rglru_specs(cfg, recipe, f"{base}/rglru") if kind == "rec"
           else local_attn_specs(cfg, recipe, f"{base}/lattn"))
    return {"mix": mix, "mlp": mlp_block_specs(cfg, recipe, f"{base}/mlp")}


def param_specs(cfg: ModelConfig, recipe=None) -> dict:
    _check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    return {
        # std 1/sqrt(d): the runtime x * sqrt(d) (the Gemma convention)
        # gives unit-RMS streams
        "embed": S.w((V, d), ("vocab", "embed"), dtype=cfg.activation_dtype,
                     init="embed", scale=d ** -0.5),
        "final_norm": rmsnorm_spec(d),
        "blocks": [_block_specs(cfg, recipe, kind, f"blocks/{i}")
                   for i, kind in enumerate(layer_kinds(cfg))],
    }


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Each block's state: the RG-LRU's h and conv window, the local
    attention's ring of ``window`` slots. ``max_seq`` is not read."""
    return {"blocks": [rglru_state_specs(cfg, batch) if kind == "rec"
                       else local_attn_state_specs(cfg, batch)
                       for kind in layer_kinds(cfg)]}


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, params: dict, recipe, kind: str,
                 base: str):
        super().__init__()
        self.rec = kind == "rec"
        self.mix = (RGLRU(cfg, params["mix"], recipe, f"{base}/rglru")
                    if self.rec else
                    LocalAttention(cfg, params["mix"], recipe,
                                   f"{base}/lattn"))
        self.mlp = GeGLU(cfg, params["mlp"], recipe, f"{base}/mlp")

    def forward(self, x, state, *, pos, mode):
        x = (self.mix(x, state) if self.rec
             else self.mix(x, state, pos=pos, mode=mode))
        return self.mlp(x)


class Griffin(nn.Module):
    """``forward(tokens, mode=, cache=, pos=, memory=) -> (logits f32,
    cache, aux)``. ``mode``: "train" (every position's logits), "prefill"
    (the last position's) or "decode" (one token per row at the scalar
    ``pos``); a given ``cache`` is read and written in place. ``memory``
    is not read; aux is zero."""

    def __init__(self, cfg: ModelConfig, params: dict, recipe=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg, self.recipe = cfg, recipe
        self.register_buffer("embed", params["embed"])
        self.final_norm = RMSNorm(params["final_norm"], cfg.norm_eps)
        self.blocks = nn.ModuleList(
            Block(cfg, p, recipe, kind, f"blocks/{i}")
            for i, (p, kind) in enumerate(zip(params["blocks"],
                                              layer_kinds(cfg))))

    def forward(self, tokens: torch.Tensor, *, mode: str = "train",
                cache: dict | None = None, pos=0, memory=None):
        _check_pos(pos)
        cfg = self.cfg
        x = F.embedding(tokens.long(), self.embed).to(cfg.activation_dtype)
        # RecurrentGemma scales the embeddings by sqrt(d), in their dtype
        x = x * torch.sqrt(torch.full((), float(cfg.d_model),
                                      device=x.device)).to(x.dtype)
        # the reference's remat: each block recomputed in the backward
        # (training only; serving runs without grad)
        remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            st = None if cache is None else cache["blocks"][i]
            if remat:
                x = checkpoint(blk, x, st, pos=pos, mode=mode,
                               use_reentrant=False)
            else:
                x = blk(x, st, pos=pos, mode=mode)
        if mode == "prefill":
            x = x[:, -1:]
        return self.logits(x), cache, torch.zeros((), device=x.device)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm, f32 logits over the tied embedding (the
        reference's f32 product with the whole table), then the soft
        cap."""
        logits = self.final_norm(x).float() @ self.embed.float().T
        if self.cfg.logit_softcap:
            c = self.cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        return logits


def build(cfg: ModelConfig, params: dict, recipe=None) -> Griffin:
    return Griffin(cfg, params, recipe)
