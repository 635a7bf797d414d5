"""GQA attention with RoPE and a KV cache in the activation dtype or in
int8. Port of the GQA part of ``repro/models/attention.py`` (MLA and cross
attention come with later slices).

Prefill/train attention runs :func:`flash_attention`, the wrapper in
``kernels/flash_attention.py``: the Hopper kernel on CUDA tensors, its
plain version on CPU tensors. Decode attends one new token per slot over
the cache with :func:`decode_attention`.

With ``kv_cache_dtype="int8"`` the cache holds int8 codes and f32 scales
per token and head (:func:`quantize_kv`), written on every store and
multiplied back on every decode read. Prefill attends over its fresh
k/v, not over the cache, as the reference does.

The KV cache is updated in place (the reference returns a new cache):
it is the largest serving tensor after the weights, and each write is
idempotent for its position, so a retried step rewrites the same values.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core import quant
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.nn import spec as S
from .common import Linear, linear
from .config import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2) f32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (S, D/2) or (B, S, D/2)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    if cos.ndim == 2:  # (S, D/2) -> broadcast over batch/heads
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, D/2)
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def decode_attention(
    q: torch.Tensor,        # (B, 1, Hq, D)
    k_cache: torch.Tensor,  # (B, Smax, Hkv, D)
    v_cache: torch.Tensor,  # (B, Smax, Hkv, Dv)
    length,                 # () or (B,) — valid prefix incl. the new token
    *,
    window: int | None = None,
    softmax_scale: float | None = None,
    k_scale: torch.Tensor | None = None,  # (B, Smax, Hkv, 1) if int8 KV
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Single-step attention over a (possibly int8) KV cache."""
    B, Smax, Hkv, D = k_cache.shape
    Dv = v_cache.shape[-1]
    Hq = q.shape[2]
    G = Hq // Hkv
    scale = softmax_scale or (1.0 / math.sqrt(D))
    kf, vf = k_cache.float(), v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale.float()
    if v_scale is not None:
        vf = vf * v_scale.float()
    qg = q.reshape(B, Hkv, G, D).float() * scale
    s = torch.einsum("bhgd,bshd->bhgs", qg, kf)
    pos = torch.arange(Smax, device=q.device)
    lens = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    mask = pos[None, :] < lens
    if window is not None:
        mask &= pos[None, :] > lens - 1 - window
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, vf)
    return out.reshape(B, 1, Hq, Dv)


# ---------------------------------------------------------------------------
# KV-cache quantization (int8 per-token-per-head absmax)
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor):
    """(B, S, H, D) -> int8 codes + (B, S, H, 1) f32 scales: the
    reference's ``max(amax, 1e-8) / 127`` and round half to even of a true
    f32 division, clipped to +-127 (``core.quant``'s per-token absmax,
    whose division stays true on the card)."""
    xf = x.float()
    scale = quant.symmetric_scale(xf, -1, 8)
    return quant.quantize(xf, scale, 8).to(torch.int8), scale


# ---------------------------------------------------------------------------
# GQA / MQA attention module
# ---------------------------------------------------------------------------


def gqa_specs(cfg: ModelConfig, recipe, base: str) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    dt = cfg.activation_dtype
    return {
        "q": linear(recipe, f"{base}/q", d, Hq * hd, bias=cfg.qkv_bias,
                    dtype=dt),
        "k": linear(recipe, f"{base}/k", d, Hkv * hd, bias=cfg.qkv_bias,
                    dtype=dt),
        "v": linear(recipe, f"{base}/v", d, Hkv * hd, bias=cfg.qkv_bias,
                    dtype=dt),
        "o": linear(recipe, f"{base}/o", Hq * hd, d, dtype=dt),
    }


def gqa_cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        scales = (*shape[:-1], 1)
        return {"k": S.zeros(shape, dtype=torch.int8),
                "v": S.zeros(shape, dtype=torch.int8),
                "k_scale": S.zeros(scales, dtype=torch.float32),
                "v_scale": S.zeros(scales, dtype=torch.float32)}
    dt = cfg.activation_dtype
    return {"k": S.zeros(shape, dtype=dt), "v": S.zeros(shape, dtype=dt)}


def _is_vec_pos(pos) -> bool:
    return isinstance(pos, torch.Tensor) and pos.ndim == 1


def _cache_write(cache_arr: torch.Tensor, val: torch.Tensor, pos) -> None:
    """Write (B, S_new, ...) at offset ``pos`` in place — a scalar offset
    (aligned batch) or a per-slot (B,) vector (S_new must be 1)."""
    if _is_vec_pos(pos):
        b = torch.arange(val.shape[0], device=val.device)
        cache_arr[b, pos] = val[:, 0].to(cache_arr.dtype)
    else:
        p = int(pos)
        cache_arr[:, p:p + val.shape[1]] = val.to(cache_arr.dtype)


def _store_kv(cfg: ModelConfig, cache: dict, k, v, pos) -> dict:
    """Write new k/v (B, S_new, Hkv, D) into the cache at offset pos."""
    if cfg.kv_cache_dtype == "int8":
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        vals = (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))
    else:
        vals = (("k", k), ("v", v))
    for name, val in vals:
        _cache_write(cache[name], val, pos)
    return cache


class GQAttention(nn.Module):
    def __init__(self, cfg: ModelConfig, params: dict, recipe, base: str):
        super().__init__()
        self.cfg = cfg
        for name in ("q", "k", "v", "o"):
            setattr(self, name, Linear(recipe, f"{base}/{name}",
                                       params[name]))

    def forward(self, x: torch.Tensor, *, mode: str = "train",
                cache: dict | None = None, pos=0, window: int | None = None):
        cfg = self.cfg
        B, Sq, _ = x.shape
        hd, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        # q, k and v read x: quantized once for all three where they can
        xq = kops.quantize_for(x, (self.q, self.k, self.v))
        q = self.q(x, xq).reshape(B, Sq, Hq, hd)
        k = self.k(x, xq).reshape(B, Sq, Hkv, hd)
        v = self.v(x, xq).reshape(B, Sq, Hkv, hd)

        steps = torch.arange(Sq, device=x.device)
        positions = pos[:, None] + steps[None, :] if _is_vec_pos(pos) \
            else pos + steps
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        if mode == "decode":
            cache = _store_kv(cfg, cache, k, v, pos)
            out = decode_attention(
                q, cache["k"], cache["v"], pos + Sq, window=window,
                k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            ).to(x.dtype)
        else:
            if cache is not None:  # prefill: also populate the cache
                cache = _store_kv(cfg, cache, k, v, pos)
            out = flash_attention(q, k, v, causal=True,
                                  window=window).to(x.dtype)

        y = self.o(out.reshape(B, Sq, Hq * hd))
        return y, cache
