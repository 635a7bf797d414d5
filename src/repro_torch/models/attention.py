"""GQA, MLA and cross attention, with RoPE and a KV cache. Port of
``repro/models/attention.py``.

GQA: prefill/train attention runs :func:`flash_attention`, the wrapper in
``kernels/flash_attention.py``: the Hopper kernel on CUDA tensors, its
plain version on CPU tensors. Decode attends one new token per slot over
the cache with :func:`decode_attention`. The cache holds k/v in the
activation dtype or in int8.

MLA (MiniCPM3, DeepSeek-V2; :class:`MLAttention`): the cache holds the
latent ``c_kv`` and the shared rope key. Prefill builds per-head K/V from
the latent through the quantized ``k_up``/``v_up`` linears and attends
with :func:`chunked_attention`, the port of the reference's jnp chunked
flash attention (the reference reaches no kernel here: its q/k heads are
``nope + rope`` wide and its v heads narrower). Decode is the absorbed
form: ``k_up`` and ``v_up`` dequantized (:func:`_dense_weight`) and folded
into f32 einsums over the whole latent cache, so per-head K/V are never
built. The two phases compute K/V differently, as the reference does.

With ``kv_cache_dtype="int8"`` the cache holds int8 codes and f32 scales
per token and head (:func:`quantize_kv`), written on every store and
multiplied back on every decode read. Prefill attends over its fresh
k/v, not over the cache, as the reference does.

Cross attention (:class:`CrossAttention`: the VLM's image layers) reads
a ``memory`` of (B, Sm, d) embeddings: prefill computes k/v from it and
writes them to a cross cache that decode only reads. Its attention is
non-causal over all Sm keys, the flash kernel with ``causal=False``.

The KV cache is updated in place (the reference returns a new cache):
it is the largest serving tensor after the weights, and each write is
idempotent for its position, so a retried step rewrites the same values.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core import packing, quant
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.nn import spec as S
from .common import Linear, RMSNorm, linear, rmsnorm_spec
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


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Causal online-softmax attention over KV chunks, one query chunk at a
    time: the reference's jnp ``flash_attention`` op for op as MLA's
    prefill calls it (causal from position 0, no window; f32 scores,
    NEG_INF masking, padding to chunk multiples masked as keys past Sk,
    the denominator floored at 1e-30). Plain PyTorch on every device, with
    fixed shapes and no host sync (a captured step can hold it). D may
    differ from Dv."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    scale = softmax_scale or (1.0 / math.sqrt(D))
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Sk)
    Sqp = -(-Sq // q_chunk) * q_chunk
    Skp = -(-Sk // kv_chunk) * kv_chunk
    if Sqp != Sq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, Sqp - Sq))
    if Skp != Sk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, Skp - Sk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, Skp - Sk))
    qg = q.reshape(B, Sqp, Hkv, G, D)
    dev = q.device
    outs = []
    for qi in range(Sqp // q_chunk):
        qch = qg[:, qi * q_chunk:(qi + 1) * q_chunk].float() * scale
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, Hkv, G, q_chunk), NEG_INF, device=dev)
        den = torch.zeros((B, Hkv, G, q_chunk), device=dev)
        acc = torch.zeros((B, Hkv, G, q_chunk, Dv), device=dev)
        for ki in range(Skp // kv_chunk):
            kch = k[:, ki * kv_chunk:(ki + 1) * kv_chunk].float()
            vch = v[:, ki * kv_chunk:(ki + 1) * kv_chunk].float()
            s = torch.einsum("bqhgd,bkhd->bhgqk", qch, kch)
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = (k_pos[None, :] < Sk) & (k_pos[None, :] <= q_pos[:, None])
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            den = den * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                       p, vch)
            m = m_new
        outs.append(acc / torch.clamp_min(den, 1e-30)[..., None])
    out = torch.stack(outs, dim=3)  # (B, Hkv, G, nq, q_chunk, Dv)
    out = out.reshape(B, Hkv, G, Sqp, Dv).permute(0, 3, 1, 2, 4)
    out = out.reshape(B, Sqp, Hq, Dv)[:, :Sq]
    return out.to(torch.bfloat16 if v.dtype == torch.int8 else v.dtype)


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


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention: DeepSeek-V2 / MiniCPM3)
# ---------------------------------------------------------------------------


def mla_specs(cfg: ModelConfig, recipe, base: str) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    r, nd, vd = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    dt = cfg.activation_dtype
    out: dict = {}
    if cfg.q_lora_rank:
        out["q_down"] = linear(recipe, f"{base}/q_down", d, cfg.q_lora_rank,
                               dtype=dt)
        out["q_norm"] = rmsnorm_spec(cfg.q_lora_rank)
        q_in = cfg.q_lora_rank
    else:
        q_in = d
    out["q_up"] = linear(recipe, f"{base}/q_up", q_in, H * (nd + r),
                         dtype=dt)
    out["kv_down"] = linear(recipe, f"{base}/kv_down", d,
                            cfg.kv_lora_rank + r, dtype=dt)
    out["kv_norm"] = rmsnorm_spec(cfg.kv_lora_rank)
    out["k_up"] = linear(recipe, f"{base}/k_up", cfg.kv_lora_rank, H * nd,
                         dtype=dt)
    out["v_up"] = linear(recipe, f"{base}/v_up", cfg.kv_lora_rank, H * vd,
                         dtype=dt)
    out["o"] = linear(recipe, f"{base}/o", H * vd, d, dtype=dt)
    return out


def mla_cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The latent cache: ``c_kv`` (B, S, kv_lora_rank) and the rope'd
    shared key ``k_rope`` (B, S, qk_rope_dim), both in the activation
    dtype. ``kv_cache_dtype`` does not apply (the reference ignores it
    here too)."""
    dt = cfg.activation_dtype
    return {"c_kv": S.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dt),
            "k_rope": S.zeros((batch, max_seq, cfg.qk_rope_dim), dtype=dt)}


def _dense_weight(params: dict, qspec, K: int, dtype) -> torch.Tensor:
    """The (K, N) weight of a (possibly quantized) linear in ``dtype``, for
    MLA's absorbed decode, as the reference rebuilds it: codes unpacked,
    the scales divided by the amplifier (a tensor division, IEEE on every
    device), multiplied in f32, then cast. AWQ's ``pre_scale`` and
    QuaRot's ``rot`` are not folded in (the reference's rule)."""
    if qspec is None:
        return params["w"]
    wq = (packing.unpack_int4(params["qvalue"]) if qspec.w_bits == 4
          else params["qvalue"])
    N = wq.shape[1]
    gs = qspec.group_size if qspec.group_size > 0 else K
    scale = params["scale"].float()
    if "alpha" in params:
        scale = scale / params["alpha"]
    w = wq.reshape(K // gs, gs, N).float() * scale[:, None, :]
    return w.reshape(K, N).to(dtype)


class MLAttention(nn.Module):
    """``forward(x, mode=, cache=, pos=) -> (y, cache)``; the latent cache
    is written in place (prefill and decode)."""

    def __init__(self, cfg: ModelConfig, params: dict, recipe, base: str):
        super().__init__()
        self.cfg = cfg
        names = ["q_up", "kv_down", "k_up", "v_up", "o"]
        if cfg.q_lora_rank:
            names.insert(0, "q_down")
            self.q_norm = RMSNorm(params["q_norm"], cfg.norm_eps)
        for name in names:
            setattr(self, name, Linear(recipe, f"{base}/{name}",
                                       params[name]))
        self.kv_norm = RMSNorm(params["kv_norm"], cfg.norm_eps)

    def _qkv(self, x, positions):
        """Per-head q (nope, rope) and the latent (c_kv, k_rope)."""
        cfg = self.cfg
        B, Sq, _ = x.shape
        r, nd = cfg.qk_rope_dim, cfg.qk_nope_dim
        # q_down (or q_up) and kv_down read x: quantized once for both
        first = self.q_down if cfg.q_lora_rank else self.q_up
        xq = kops.quantize_for(x, (first, self.kv_down))
        if cfg.q_lora_rank:
            q = self.q_up(self.q_norm(self.q_down(x, xq)))
        else:
            q = self.q_up(x, xq)
        q = q.reshape(B, Sq, cfg.num_heads, nd + r)
        q_nope, q_rope = q[..., :nd], q[..., nd:]
        ckv = self.kv_down(x, xq)
        c_kv = self.kv_norm(ckv[..., :cfg.kv_lora_rank])
        k_rope = ckv[..., cfg.kv_lora_rank:]
        cos, sin = rope_cos_sin(positions, r, cfg.rope_theta)
        q_rope = apply_rope(q_rope, cos, sin)
        k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
        return q_nope, q_rope, c_kv, k_rope

    def _weight(self, name: str, width: int) -> torch.Tensor:
        """``name``'s dequantized weight as (kv_lora_rank, heads, width)."""
        cfg, lin = self.cfg, getattr(self, name)
        w = _dense_weight(dict(lin.named_buffers(recurse=False)), lin.qspec,
                          cfg.kv_lora_rank, cfg.activation_dtype)
        return w.reshape(cfg.kv_lora_rank, cfg.num_heads, width)

    def forward(self, x: torch.Tensor, *, mode: str = "train",
                cache: dict | None = None, pos=0):
        cfg = self.cfg
        B, Sq, _ = x.shape
        H = cfg.num_heads
        r, nd, vd = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
        steps = torch.arange(Sq, device=x.device)
        positions = pos[:, None] + steps[None, :] if _is_vec_pos(pos) \
            else pos + steps
        q_nope, q_rope, c_kv, k_rope = self._qkv(x, positions)

        if cache is not None:  # the LATENT cache
            _cache_write(cache["c_kv"], c_kv, pos)
            _cache_write(cache["k_rope"], k_rope, pos)

        if mode == "decode":
            # absorbed: score = (W_uk^T q_nope) . c_kv + q_rope . k_rope
            k_up = self._weight("k_up", nd).float()
            v_up = self._weight("v_up", vd).float()
            q_eff = torch.einsum("bqhn,chn->bqhc", q_nope.float(), k_up)
            ckv_f = cache["c_kv"].float()
            kr_f = cache["k_rope"].float()
            s = (torch.einsum("bqhc,bsc->bhqs", q_eff, ckv_f)
                 + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), kr_f))
            # an IEEE division on every device (CUDA divides by a python
            # scalar by multiplying with its reciprocal)
            s = s / torch.full((), math.sqrt(nd + r), device=s.device)
            lens = torch.as_tensor(pos + Sq, device=x.device).reshape(-1, 1)
            smax = cache["c_kv"].shape[1]
            mask = torch.arange(smax, device=x.device)[None, :] < lens
            s = torch.where(mask[:, None, None], s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            ctx_c = torch.einsum("bhqs,bsc->bqhc", p, ckv_f)
            out = torch.einsum("bqhc,chv->bqhv", ctx_c, v_up).to(x.dtype)
        else:
            # per-head K/V from the latent; k_up and v_up read c_kv:
            # quantized once for both
            cq = kops.quantize_for(c_kv, (self.k_up, self.v_up))
            k_nope = self.k_up(c_kv, cq).reshape(B, Sq, H, nd)
            v = self.v_up(c_kv, cq).reshape(B, Sq, H, vd)
            k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, Sq, H, r)],
                          dim=-1)
            q = torch.cat([q_nope, q_rope], dim=-1)
            out = chunked_attention(
                q, k, v, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                softmax_scale=1.0 / math.sqrt(nd + r)).to(x.dtype)

        y = self.o(out.reshape(B, Sq, H * vd))
        return y, cache


# ---------------------------------------------------------------------------
# Cross attention (the VLM's image layers; Whisper's decoder has its own in
# models/encdec.py)
# ---------------------------------------------------------------------------


def cross_attn_specs(cfg: ModelConfig, recipe, base: str) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    dt = cfg.activation_dtype
    return {
        "q": linear(recipe, f"{base}/q", d, Hq * hd, dtype=dt),
        "k": linear(recipe, f"{base}/k", d, Hkv * hd, dtype=dt),
        "v": linear(recipe, f"{base}/v", d, Hkv * hd, dtype=dt),
        "o": linear(recipe, f"{base}/o", Hq * hd, d, dtype=dt),
        "q_norm": rmsnorm_spec(d),
    }


def cross_attn_cache_specs(cfg: ModelConfig, batch: int,
                           mem_len: int) -> dict:
    """k/v of the memory, (B, Sm, Hkv, D), always in the activation dtype:
    the reference ignores ``kv_cache_dtype`` here too."""
    shape = (batch, mem_len, cfg.num_kv_heads, cfg.head_dim)
    dt = cfg.activation_dtype
    return {"k": S.zeros(shape, dtype=dt), "v": S.zeros(shape, dtype=dt)}


def attend_memory(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Non-causal attention of q over every key, in ``dtype``. The kernel
    takes one dtype: q, k and v go to the wider of q's and k's (f32 memory
    gives f32 k/v, as the reference's linears return their input's dtype;
    k/v are never cast down)."""
    dt = torch.promote_types(q.dtype, k.dtype)
    out = flash_attention(q.to(dt), k.to(dt), v.to(dt), causal=False)
    return out.to(dtype)


class CrossAttention(nn.Module):
    """``forward(x, memory=, cache=, mode=) -> (y, cache)``. q reads
    ``q_norm(x)`` (x is already the block's ``ln1`` output: both norms
    apply, as in the reference). Prefill / train: k and v from ``memory``
    (quantized once for both), written over the cross cache in place, cast
    to its dtype. Decode: k and v are the cache cast to x's dtype, and no
    k/v linear runs."""

    def __init__(self, cfg: ModelConfig, params: dict, recipe, base: str):
        super().__init__()
        self.cfg = cfg
        self.q_norm = RMSNorm(params["q_norm"], cfg.norm_eps)
        for name in ("q", "k", "v", "o"):
            setattr(self, name, Linear(recipe, f"{base}/{name}",
                                       params[name]))

    def forward(self, x: torch.Tensor, *, memory=None,
                cache: dict | None = None, mode: str = "train"):
        cfg = self.cfg
        B, Sq, _ = x.shape
        hd, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        q = self.q(self.q_norm(x)).reshape(B, Sq, Hq, hd)
        if mode == "decode":
            k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
        else:
            Sm = memory.shape[1]
            mq = kops.quantize_for(memory, (self.k, self.v))
            k = self.k(memory, mq).reshape(B, Sm, Hkv, hd)
            v = self.v(memory, mq).reshape(B, Sm, Hkv, hd)
            if cache is not None:
                cache["k"].copy_(k)
                cache["v"].copy_(v)
        out = attend_memory(q, k, v, x.dtype)
        return self.o(out.reshape(B, Sq, Hq * hd)), cache
