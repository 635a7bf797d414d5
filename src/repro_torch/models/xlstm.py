"""xLSTM (sLSTM + mLSTM blocks), the attention-free recurrent LM ("ssm"
family). Port of ``repro/models/xlstm.py``.

As in the reference, at the block level of arXiv:2405.04517:
  * mLSTM: matrix memory C (dh x dh per head), exponential input gate,
    sigmoid forget gate, stabilizer state m; q/k from a causal-conv path.
  * sLSTM: scalar memory with per-head block-diagonal recurrent weights,
    exponential gating and a stabilizer, then a gated FFN (factor 4/3,
    rounded up to a multiple of 128).
  * every ``slstm_every``-th block is sLSTM (7:1 at xlstm-1.3b).

Temporal mixing runs over time step by step (the reference's
``lax.scan``: the exact recurrence), or, for the mLSTM under
``mlstm_impl="chunked"`` and more than one token, chunkwise in parallel
(:func:`_mlstm_chunked`). Each block's state lives in the cache, O(1) in
the sequence length: {C, n, m, conv} for an mLSTM, {c, n, m, h} for an
sLSTM. A given cache is read as the starting state (zeros: the training
init) and written in place with the final state; ``pos`` is not read.
The recurrences and the causal conv are plain PyTorch on every device, as
the reference's are plain jnp; the quantized linears launch the Hopper
GEMMs on CUDA tensors. Training differentiates them with autograd
(the per-token scan's ops one step at a time: on the card its launch
count is host time); under ``cfg.remat`` (``mode="train"`` with grad
enabled) each block runs through ``torch.utils.checkpoint``
(non-reentrant), as the reference's ``jax.checkpoint`` of its scanned
body.

The reference lays its layers out as ``split_layers`` gives them
(:func:`split`: xlstm-1.3b is ``blocks/s0..s7`` x 6); the port keeps one
module per layer, with linear paths ``blocks/<i>/up`` and the like.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.nn import spec as S
from .common import Linear, RMSNorm, linear, rmsnorm_spec
from .config import ModelConfig


def _d_inner(cfg: ModelConfig) -> int:
    return int(cfg.d_model * cfg.mlstm_proj_factor)


def _dh(cfg: ModelConfig) -> int:
    return _d_inner(cfg) // cfg.num_heads


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------


def conv_specs(d: int, width: int) -> dict:
    return {"w": S.w((width, d)), "b": S.zeros((d,))}


def causal_conv(params: dict, x: torch.Tensor, *,
                state: torch.Tensor | None = None):
    """x (B, S, d); ``state`` (B, width - 1, d) holds the previous inputs
    (None: zeros). The reference's f32 sum over the taps in order, then
    the bias. Returns (y in x's dtype, new state in x's dtype)."""
    w = params["w"].float()
    width, d = w.shape
    xf = x.float()
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, d), dtype=torch.float32,
                          device=x.device)
    else:
        pad = state.float()
    xp = torch.cat([pad, xf], dim=1)  # (B, S + width - 1, d)
    Sq = x.shape[1]
    y = sum(xp[:, i:i + Sq, :] * w[i] for i in range(width))
    y = y + params["b"].float()
    new_state = xp[:, -(width - 1):, :]
    return y.to(x.dtype), new_state.to(x.dtype)


class CausalConv(nn.Module):
    def __init__(self, params: dict):
        super().__init__()
        self.register_buffer("w", params["w"])
        self.register_buffer("b", params["b"])

    def forward(self, x, state=None):
        return causal_conv({"w": self.w, "b": self.b}, x, state=state)


def _store(state: dict | None, new: dict) -> None:
    """Write a block's final state into its cache, in place."""
    if state is not None:
        for k, v in new.items():
            state[k].copy_(v)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def mlstm_specs(cfg: ModelConfig, recipe, base: str) -> dict:
    d, di, H = cfg.d_model, _d_inner(cfg), cfg.num_heads
    dt = cfg.activation_dtype
    return {
        "ln": rmsnorm_spec(d),
        "up": linear(recipe, f"{base}/up", d, 2 * di, dtype=dt),
        "conv": conv_specs(di, cfg.conv_width),
        "q": linear(recipe, f"{base}/q", di, di, dtype=dt),
        "k": linear(recipe, f"{base}/k", di, di, dtype=dt),
        "v": linear(recipe, f"{base}/v", di, di, dtype=dt),
        "if_gate": {"w": S.w((di, 2 * H), scale=0.3),
                    "b": S.zeros((2 * H,))},
        "out_norm": rmsnorm_spec(di),
        "down": linear(recipe, f"{base}/down", di, d, dtype=dt),
    }


def mlstm_state_specs(cfg: ModelConfig, batch: int) -> dict:
    H, dh, di = cfg.num_heads, _dh(cfg), _d_inner(cfg)
    f32 = torch.float32
    return {
        "C": S.zeros((batch, H, dh, dh), dtype=f32),
        "n": S.zeros((batch, H, dh), dtype=f32),
        "m": S.zeros((batch, H), dtype=f32),
        "conv": S.zeros((batch, cfg.conv_width - 1, di),
                        dtype=cfg.activation_dtype),
    }


def _mlstm_cell(state, qkvif):
    """One step of the stabilized mLSTM recurrence, the reference's op for
    op. state: C (B, H, dh, dh), n (B, H, dh), m (B, H); qkvif: q, k, v
    (B, H, dh) and i_raw, f_raw (B, H), all f32. Returns (state, h)."""
    C, n, m = state
    q, k, v, i_raw, f_raw = qkvif
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i_p = torch.exp(i_raw - m_new)
    f_p = torch.exp(log_f + m - m_new)
    C_new = f_p[..., None, None] * C + i_p[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n_new = f_p[..., None] * n + i_p[..., None] * k
    num = torch.einsum("bhvk,bhk->bhv", C_new, q)
    den = torch.abs(torch.einsum("bhk,bhk->bh", n_new, q))
    # max(|n.q|, exp(-m)): a zero decode state is the training init
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return (C_new, n_new, m_new), h


def _mlstm_chunked(q, k, v, i_raw, f_raw, C0, n0, m0, chunk: int):
    """The reference's chunkwise-parallel mLSTM: the same recurrence as
    :func:`_mlstm_cell` scanned over time, within f32 rounding. With F_t
    the cumulative sum of log sigmoid(f_raw), the stabilizer is
    m_t = F_t + max(m_0, cummax_{s<=t}(li_s - F_s)); each chunk is a
    decay-masked attention product plus its carried state, and only the
    chunks are visited in order. The decay's exponent is masked before
    the exponential (the same values): the reference masks after it, so
    where a masked (future) entry's exponent passes f32's range (a long
    chunk of strong forget gates) its gradient is 0 x inf = NaN.

    q, k, v (B, S, H, dh) f32; i_raw, f_raw (B, S, H) f32. Returns
    (h (B, S, H, dh), (C, n, m) the final state)."""
    B, Sq, H, dh = q.shape
    c = min(chunk, Sq)
    nc = Sq // c
    if Sq % c:
        raise ValueError(f"chunked mLSTM: {Sq} tokens in chunks of {c}")

    def chunks(t):
        return t.reshape(B, nc, c, *t.shape[2:]).movedim(1, 0)

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    lf = F.logsigmoid(chunks(f_raw))                # (nc, B, c, H)
    li = chunks(i_raw)
    Fc = torch.cumsum(lf, dim=2)
    run_max = torch.cummax(li - Fc, dim=2).values
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    C_in, n_in, m_in = C0, n0, m0
    hs = []
    for j in range(nc):
        qb, kb, vb, Fb, lib, rmb = (qc[j], kc[j], vc[j], Fc[j], li[j],
                                    run_max[j])
        m_t = Fb + torch.maximum(m_in[:, None, :], rmb)        # (B, c, H)
        g_in = torch.exp(Fb + m_in[:, None, :] - m_t)
        num_in = torch.einsum("bhvk,bchk->bchv", C_in, qb)
        den_in = torch.einsum("bhk,bchk->bch", n_in, qb)
        logD = (Fb[:, :, None, :] - Fb[:, None, :, :]
                + lib[:, None, :, :] - m_t[:, :, None, :])     # (B, t, s, H)
        D = torch.exp(torch.where(mask[None, :, :, None], logD,
                                  torch.full((), -math.inf,
                                             device=q.device)))
        scores = torch.einsum("bthk,bshk->btsh", qb, kb) * D
        num = torch.einsum("btsh,bshv->bthv", scores, vb) \
            + g_in[..., None] * num_in
        den = torch.sum(scores, dim=2) + g_in * den_in
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_t))[..., None])
        m_c = m_t[:, -1, :]
        decay_s = torch.exp(Fb[:, -1, None, :] - Fb + lib - m_c[:, None, :])
        carry_g = torch.exp(Fb[:, -1, :] + m_in - m_c)
        C_in = (carry_g[..., None, None] * C_in
                + torch.einsum("bsh,bshv,bshk->bhvk", decay_s, vb, kb))
        n_in = (carry_g[..., None] * n_in
                + torch.einsum("bsh,bshk->bhk", decay_s, kb))
        m_in = m_c
    h = torch.stack(hs, 0).movedim(0, 1).reshape(B, Sq, H, dh)
    return h, (C_in, n_in, m_in)


class MLSTMBlock(nn.Module):
    """``forward(x, state) -> x + y``; ``state`` (the block's cache, or
    None: zeros) is read, then overwritten with the final state."""

    def __init__(self, cfg: ModelConfig, params: dict, recipe, base: str):
        super().__init__()
        self.cfg = cfg
        self.ln = RMSNorm(params["ln"], cfg.norm_eps)
        for name in ("up", "q", "k", "v", "down"):
            setattr(self, name, Linear(recipe, f"{base}/{name}",
                                       params[name]))
        self.conv = CausalConv(params["conv"])
        self.register_buffer("if_w", params["if_gate"]["w"])
        self.register_buffer("if_b", params["if_gate"]["b"])
        self.out_norm = RMSNorm(params["out_norm"], cfg.norm_eps)

    def forward(self, x, state=None):
        cfg = self.cfg
        B, Sq, _ = x.shape
        H, dh, di = cfg.num_heads, _dh(cfg), _d_inner(cfg)
        up = self.up(self.ln(x))
        xm, z = up[..., :di], up[..., di:]
        xc, conv_new = self.conv(xm, None if state is None
                                 else state["conv"])
        xc = F.silu(xc.float()).to(x.dtype)
        # q and k read xc: quantized once for both
        xq = kops.quantize_for(xc, (self.q, self.k))
        q = self.q(xc, xq)
        k = self.k(xc, xq) / math.sqrt(dh)
        v = self.v(xm)
        gates = xm.float() @ self.if_w.float() + self.if_b.float()
        i_raw, f_raw = gates[..., :H], gates[..., H:]
        q, k, v = (t.reshape(B, Sq, H, dh).float() for t in (q, k, v))
        if state is None:
            dev = x.device
            C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
            n = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
            m = torch.zeros((B, H), dtype=torch.float32, device=dev)
        else:
            C, n, m = (state[k_].float() for k_ in ("C", "n", "m"))
        if cfg.mlstm_impl == "chunked" and Sq > 1:
            h, (C, n, m) = _mlstm_chunked(q, k, v, i_raw.float(),
                                          f_raw.float(), C, n, m,
                                          cfg.chunk_size)
        else:
            hs = []
            for t in range(Sq):
                (C, n, m), h_t = _mlstm_cell(
                    (C, n, m), (q[:, t], k[:, t], v[:, t], i_raw[:, t],
                                f_raw[:, t]))
                hs.append(h_t)
            h = torch.stack(hs, 1)
        h = self.out_norm(h.reshape(B, Sq, di).to(x.dtype))
        h = h * F.silu(z.float()).to(x.dtype)
        y = self.down(h)
        _store(state, {"C": C, "n": n, "m": m, "conv": conv_new})
        return x + y


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------


def _ff_width(d: int) -> int:
    ff = int(d * 4 / 3)
    return -(-ff // 128) * 128  # a multiple of 128: group-128 quant applies


def slstm_specs(cfg: ModelConfig, recipe, base: str) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    dh, dt, ff = d // H, cfg.activation_dtype, _ff_width(cfg.d_model)
    return {
        "ln": rmsnorm_spec(d),
        "wx": linear(recipe, f"{base}/wx", d, 4 * d, dtype=dt),
        # block-diagonal recurrent weights: (H, dh, 4 dh)
        "r": S.w((H, dh, 4 * dh), scale=1.0),
        "out_norm": rmsnorm_spec(d),
        "ff_gate": linear(recipe, f"{base}/ff_gate", d, ff, dtype=dt),
        "ff_up": linear(recipe, f"{base}/ff_up", d, ff, dtype=dt),
        "ff_down": linear(recipe, f"{base}/ff_down", ff, d, dtype=dt),
    }


def slstm_state_specs(cfg: ModelConfig, batch: int) -> dict:
    H = cfg.num_heads
    shape = (batch, H, cfg.d_model // H)
    return {k: S.zeros(shape, dtype=torch.float32) for k in "cnmh"}


def _slstm_scan(pre: torch.Tensor, r: torch.Tensor, state):
    """The sLSTM recurrence over time, the reference's step op for op:
    ``pre`` (B, S, H, 4 dh) the input projection, ``r`` (H, dh, 4 dh) the
    block-diagonal recurrent weights (f32), ``state`` (c, n, m, h), each
    (B, H, dh) f32. Gates z, i, f, o in that order. Returns (h (B, S, H,
    dh), the final state)."""
    c, n, m, h = state
    dh = r.shape[1]
    hs = []
    for t in range(pre.shape[1]):
        g = pre[:, t] + torch.einsum("bhd,hdk->bhk", h, r)
        zt, it, ft, ot = torch.split(g, dh, dim=-1)
        zt = torch.tanh(zt)
        log_f = F.logsigmoid(ft)
        m_new = torch.maximum(log_f + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(log_f + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = torch.sigmoid(ot) * c / torch.maximum(n, torch.exp(-m_new))
        m = m_new
        hs.append(h)
    return torch.stack(hs, 1), (c, n, m, h)


class SLSTMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, params: dict, recipe, base: str):
        super().__init__()
        self.cfg = cfg
        self.ln = RMSNorm(params["ln"], cfg.norm_eps)
        for name in ("wx", "ff_gate", "ff_up", "ff_down"):
            setattr(self, name, Linear(recipe, f"{base}/{name}",
                                       params[name]))
        self.register_buffer("r", params["r"])
        self.out_norm = RMSNorm(params["out_norm"], cfg.norm_eps)

    def forward(self, x, state=None):
        B, Sq, d = x.shape
        H = self.cfg.num_heads
        dh = d // H
        pre = self.wx(self.ln(x)).reshape(B, Sq, H, 4 * dh).float()
        if state is None:
            z = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
            c, n, m, h = z, z, z, z
        else:
            c, n, m, h = (state[k].float() for k in "cnmh")
        hs, (c, n, m, h) = _slstm_scan(pre, self.r.float(), (c, n, m, h))
        hseq = hs.reshape(B, Sq, d).to(x.dtype)
        x = x + self.out_norm(hseq)
        # gated FFN: ff_gate and ff_up read x, quantized once for both
        xq = kops.quantize_for(x, (self.ff_gate, self.ff_up))
        g = self.ff_gate(x, xq)
        u = self.ff_up(x, xq)
        ff = self.ff_down(F.silu(g.float()).to(x.dtype) * u)
        _store(state, {"c": c, "n": n, "m": m, "h": h})
        return x + ff


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


def layer_kinds(cfg: ModelConfig) -> list[str]:
    return ["slstm" if (i + 1) % cfg.slstm_every == 0 else "mlstm"
            for i in range(cfg.num_layers)]


def split(cfg: ModelConfig):
    """The reference's layout ``_split``: (prefix kinds, pattern kinds,
    repeats) of ``split_layers``."""
    from .transformer import split_layers

    return split_layers(layer_kinds(cfg))


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(f"{cfg.name}: models.xlstm runs the ssm "
                                  "family")
    if cfg.mlstm_impl not in ("scan", "chunked"):
        raise ValueError(f"{cfg.name}: mlstm_impl {cfg.mlstm_impl!r}")


def param_specs(cfg: ModelConfig, recipe=None) -> dict:
    _check_supported(cfg)
    d, V, dt = cfg.d_model, cfg.vocab_size, cfg.activation_dtype
    block = {"slstm": slstm_specs, "mlstm": mlstm_specs}
    return {
        "embed": S.w((V, d), dtype=dt, init="embed"),
        "final_norm": rmsnorm_spec(d),
        "head": {"w": S.w((d, V), dtype=dt)},
        "blocks": [block[kind](cfg, recipe, f"blocks/{i}")
                   for i, kind in enumerate(layer_kinds(cfg))],
    }


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Each block's recurrent state; ``max_seq`` is not read (the state is
    O(1) in the sequence length), kept for the API."""
    state = {"slstm": slstm_state_specs, "mlstm": mlstm_state_specs}
    return {"blocks": [state[kind](cfg, batch) for kind in layer_kinds(cfg)]}


class XLSTM(nn.Module):
    """``forward(tokens, mode=, cache=, pos=, memory=) -> (logits f32,
    cache, aux)``. ``mode``: "train" and "decode" give every position's
    logits, "prefill" the last one's; a given ``cache`` is the starting
    state and is written in place with the final one (None: zeros, not
    kept). ``pos`` and ``memory`` are not read; aux is zero."""

    def __init__(self, cfg: ModelConfig, params: dict, recipe=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg, self.recipe = cfg, recipe
        self.register_buffer("embed", params["embed"])
        self.register_buffer("head", params["head"]["w"])
        self.final_norm = RMSNorm(params["final_norm"], cfg.norm_eps)
        block = {"slstm": SLSTMBlock, "mlstm": MLSTMBlock}
        self.blocks = nn.ModuleList(
            block[kind](cfg, p, recipe, f"blocks/{i}")
            for i, (p, kind) in enumerate(zip(params["blocks"],
                                              layer_kinds(cfg))))

    def forward(self, tokens: torch.Tensor, *, mode: str = "train",
                cache: dict | None = None, pos=0, memory=None):
        x = F.embedding(tokens.long(), self.embed).to(
            self.cfg.activation_dtype)
        # the reference's remat: each block recomputed in the backward
        # (training only; serving runs without grad)
        remat = self.cfg.remat and mode == "train" and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            st = None if cache is None else cache["blocks"][i]
            x = (checkpoint(blk, x, st, use_reentrant=False) if remat
                 else blk(x, st))
        if mode == "prefill":
            x = x[:, -1:]
        return self.logits(x), cache, torch.zeros((), device=x.device)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm, then f32 logits over the head."""
        return self.final_norm(x).float() @ self.head.float()


def build(cfg: ModelConfig, params: dict, recipe=None) -> XLSTM:
    return XLSTM(cfg, params, recipe)
