"""Mixture-of-Experts with sort-based capacity dispatch. Port of
``repro/models/moe.py``.

  router (fp32) -> top-k -> stable sort by expert -> gather into a dense
  (G, E, C, d) dispatch buffer -> one batched expert GEMM per linear ->
  weighted scatter-combine. Tokens beyond capacity are dropped (GShard).

Expert FFN weights may be quantized (paper §5.5, Mixtral): each expert
linear is ONE grouped ragged kernel launch over all experts
(``core.qlinear.grouped_linear_apply`` -> ``kernels.ops.qgemm_grouped``),
fed the per-expert routed row counts so capacity-padding m-tiles are
skipped.

No host syncs: the dispatch runs on the device end to end, so a decode
step with MoE layers can be captured as a CUDA graph. The counts come
from a ``scatter_add_`` (``torch.bincount`` on CUDA reads its maximum on
the host), the sort is ``torch.argsort(stable=True)``, and nothing indexes
with a boolean mask or repeats by a tensor. The routed counts stay device
tensors, also for the routing sinks below.

Shared experts (DeepSeek-V2) are a plain always-on MLP
(``models.mlp.MLP``, ``num_shared_experts * moe_d_ff`` wide) over the
same x as the router, added after the combine as the reference adds it.

``cfg.moe_int8_dispatch`` rounds the dispatch buffer through int8 per
row and back before the expert FFN (:class:`Int8Transport`), in every
mode, as the reference does on one device: there it is the wire format of
the expert all-to-all; here it is the same extra rounding, with a
straight-through gradient.

Expert parallelism (the reference shards the expert axis and lets GSPMD
insert the all-to-all) comes with the multi-GPU slice; ``dispatch_groups``
> 1 keeps the reference's grouped dispatch and its dense fallback (no
``row_counts``: a group's padding interleaves with the next group's rows
in the (E, G*C, d) slab).
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core import qlinear, quant
from repro_torch.kernels import ops as kops
from repro_torch.nn import spec as S
from .config import ModelConfig
from .mlp import MLP, mlp_specs

# -- routing sinks ------------------------------------------------------------
# Observability hook for the serving engine and benchmarks: while any sink
# is registered, every MoE layer call delivers a record
# {"counts": int32 (G, E) device tensor of routed (capacity-clipped) rows
# per expert, "capacity": C}. The counts are not copied to the host here
# (that would be a sync in the middle of the forward); a consumer copies
# them when it needs them, as the engine does once per tick. Sinks may be
# plain callables or ``weakref.WeakMethod``s (dead ones are pruned on
# delivery, so the engine hooks in without keeping itself alive).
# Inside :func:`hold_routing` the records go to a list instead of the sinks:
# a CUDA graph capture computes nothing, so its counts hold data only once
# the graph replays (the serving engine hands them on after each replay).

_ROUTING_SINKS: list = []
_HELD: list | None = None


def add_routing_sink(sink) -> None:
    """Register ``sink(record: dict)`` (or a weakref to one)."""
    _ROUTING_SINKS.append(sink)


def remove_routing_sink(sink) -> None:
    if sink in _ROUTING_SINKS:
        _ROUTING_SINKS.remove(sink)


def routing_sinks_active() -> bool:
    return bool(_ROUTING_SINKS)


def start_routing_trace() -> list:
    """Begin recording {"counts", "capacity"} per MoE call; returns the
    live list records append to (pass it to :func:`stop_routing_trace`)."""
    records: list = []
    add_routing_sink(records.append)
    return records


def stop_routing_trace(records: list | None = None) -> list:
    """Detach the list sink :func:`start_routing_trace` installed. With no
    argument every list-append sink is detached."""
    if records is not None:
        remove_routing_sink(records.append)
        return records
    out: list = []
    for s in list(_ROUTING_SINKS):
        if getattr(s, "__self__", None).__class__ is list:
            out = s.__self__
            remove_routing_sink(s)
    return out


@contextlib.contextmanager
def hold_routing():
    """Keep the records made inside the block from the sinks; yields the
    list they are appended to instead."""
    global _HELD
    prev, _HELD = _HELD, []
    try:
        yield _HELD
    finally:
        _HELD = prev


def _record_routing(counts: torch.Tensor, *, capacity: int) -> None:
    """Fan one record out to every live sink (or to the held list)."""
    rec = {"counts": counts, "capacity": capacity}
    if _HELD is not None:
        _HELD.append(rec)
        return
    for s in list(_ROUTING_SINKS):
        if isinstance(s, weakref.ref):
            live = s()
            if live is None:
                remove_routing_sink(s)
                continue
            live(rec)
        else:
            s(rec)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def moe_specs(cfg: ModelConfig, recipe, base: str) -> dict:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    dt = cfg.activation_dtype

    def spec(name):
        return recipe.spec_for(f"{base}/{name}") if recipe else None

    out = {
        "router": S.w((d, E), ("embed", None), dtype=torch.float32),
        "gate": qlinear.expert_linear_specs(
            E, d, f, spec("gate"), ("experts", "embed", "moe_mlp"), dtype=dt),
        "up": qlinear.expert_linear_specs(
            E, d, f, spec("up"), ("experts", "embed", "moe_mlp"), dtype=dt),
        "down": qlinear.expert_linear_specs(
            E, f, d, spec("down"), ("experts", "moe_mlp", "embed"), dtype=dt),
    }
    if cfg.num_shared_experts:
        out["shared"] = mlp_specs(cfg, recipe, f"{base}/shared",
                                  d_ff=cfg.num_shared_experts * f)
    return out


class Int8Transport(torch.autograd.Function):
    """The reference's ``_int8_transport``: each row of the buffer (its
    last axis) as int8 codes times an f32 scale, ``max(amax, 1e-8) / 127``
    and round half to even of a true f32 division (``core.quant``: on the
    card a division by a python scalar would be a multiply by its
    reciprocal), back in the buffer's dtype. The gradient passes straight
    through."""

    @staticmethod
    def forward(ctx, buf: torch.Tensor) -> torch.Tensor:
        xf = buf.float()
        scl = quant.symmetric_scale(xf, -1, 8)
        q8 = quant.quantize(xf, scl, 8).to(torch.int8)
        return (q8.float() * scl).to(buf.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return g


def capacity(tokens: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Per-expert capacity (8-aligned), as the reference computes it."""
    c = int(tokens * top_k * capacity_factor / max(num_experts, 1))
    return max(8, -(-c // 8) * 8)


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


class ExpertLinear(nn.Module):
    """E stacked linears, applied in one grouped call; holds the stacked
    param dict (``w``, or ``qvalue``/``scale``/``alpha``, and ``rot``
    under QuaRot) as buffers."""

    def __init__(self, recipe, path: str, params: dict):
        super().__init__()
        self.qspec = recipe.spec_for(path) if recipe is not None else None
        for name, t in params.items():
            self.register_buffer(name, t)

    def forward(self, x: torch.Tensor, row_counts=None,
                xq=None) -> torch.Tensor:
        """``xq``: the routed rows' codes and scales from
        ``kernels.ops.quantize_for``, when several stacks read x."""
        return qlinear.grouped_linear_apply(
            dict(self.named_buffers(recurse=False)), x, self.qspec,
            row_counts=row_counts, xq=xq)


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, recipe,
              base: str):
    """x: (B, S, d). Returns (y, aux_loss). Functional form of :class:`MoE`
    over a param dict."""
    return MoE(cfg, params, recipe, base)(x)


class MoE(nn.Module):
    """``forward(x (B, S, d)) -> (y (B, S, d), aux_loss ())``."""

    def __init__(self, cfg: ModelConfig, params: dict, recipe, base: str):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("router", params["router"])
        for name in ("gate", "up", "down"):
            setattr(self, name,
                    ExpertLinear(recipe, f"{base}/{name}", params[name]))
        self.shared = (MLP(params["shared"], recipe, f"{base}/shared")
                       if cfg.num_shared_experts else None)

    def forward(self, x: torch.Tensor):
        cfg = self.cfg
        B, Sq, d = x.shape
        E, k = cfg.num_experts, cfg.top_k
        G = max(1, cfg.dispatch_groups)
        if (B * Sq) % G:
            G = 1
        T = B * Sq // G
        C = capacity(T, k, E, cfg.capacity_factor)
        dev = x.device
        xf = x.reshape(G, T, d)

        # --- router (fp32, never quantized) --------------------------------
        logits = xf.float() @ self.router.float()  # (G, T, E)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_idx = torch.topk(probs, k, dim=-1)  # (G, T, k)
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)

        # --- load-balancing aux loss (GShard/Switch) -----------------------
        me = probs.mean(dim=1)                                # (G, E)
        top1 = torch.zeros((G, E), device=dev).scatter_add_(
            1, expert_idx[..., 0], torch.ones((G, T), device=dev))
        ce = top1 / T  # the mean of the top-1 one-hots: dispatch fraction
        aux = cfg.router_aux_coef * E * torch.mean(torch.sum(me * ce, -1))

        # --- dispatch: stable sort by expert, capacity slots ---------------
        Tk = T * k
        e_flat = expert_idx.reshape(G, Tk)
        g_flat = gate_vals.reshape(G, Tk)
        order = torch.argsort(e_flat, dim=-1, stable=True)
        e_s = torch.gather(e_flat, 1, order)                  # (G, Tk)
        g_s = torch.gather(g_flat, 1, order)
        counts = torch.zeros((G, E), dtype=torch.int64, device=dev)
        counts.scatter_add_(1, e_s, torch.ones_like(e_s))
        starts = torch.cumsum(counts, dim=1) - counts
        pos = torch.arange(Tk, device=dev)[None, :] - torch.gather(starts, 1,
                                                                   e_s)
        keep = pos < C
        # flat slot in the (G*E*C, d) buffer; dropped tokens add zeros to
        # their expert's slot 0 (kept slots are unique, so add == set)
        grp = torch.arange(G, device=dev)[:, None]
        slot = (grp * E + e_s) * C + torch.where(keep, pos, 0)
        # each sorted choice's token row: the rows repeated k times, then
        # permuted. The backward sums a token's k gradients by a reduction
        # over k, in one order on every device (an indexed gather's backward
        # accumulates them in a thread-dependent order on the CPU)
        rows = torch.gather(
            xf[:, :, None].expand(G, T, k, d).reshape(G, Tk, d), 1,
            order[..., None].expand(G, Tk, d))                # (G, Tk, d)
        vals = torch.where(keep[..., None], rows, torch.zeros((), dtype=x.dtype,
                                                              device=dev))
        buf = torch.zeros((G * E * C, d), dtype=x.dtype, device=dev)
        buf.index_add_(0, slot.reshape(-1), vals.reshape(-1, d))
        routed = torch.clamp_max(counts, C).to(torch.int32)  # (G, E)
        # One dispatch group: expert e's slab rows [0, routed[0, e]) are
        # its routed tokens and the rest zeros, the ragged kernels'
        # row_counts contract. With G > 1 the (E, G*C, d) slab interleaves
        # each group's padding, so the experts run densely (exactly).
        row_counts = routed[0] if G == 1 else None
        if cfg.moe_int8_dispatch:
            buf = Int8Transport.apply(buf)
        if _ROUTING_SINKS:
            _record_routing(routed, capacity=C)

        # --- expert FFN: one grouped GEMM per linear -----------------------
        be = buf.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
        # gate and up read be: its routed rows quantized once for both
        xq = kops.quantize_for(be, (self.gate, self.up), grouped=True,
                               row_counts=row_counts)
        g = self.gate(be, row_counts, xq)
        u = self.up(be, row_counts, xq)
        h = F.silu(g.float()).to(be.dtype) * u
        y = self.down(h, row_counts)
        yb = y.reshape(E, G, C, d).transpose(0, 1).reshape(G * E * C, d)

        # --- combine ---------------------------------------------------------
        # The reference scatter-adds the (Tk, d) terms in sorted-slot order
        # onto zeros, rounding to the buffer's dtype after each add. Each
        # token's terms come in that order (its experts ascending, a dropped
        # choice a zero term) and are summed one add at a time from zeros:
        # the same bits on every device, whatever top_k.
        out_vals = torch.where(keep[..., None], yb[slot], torch.zeros(
            (), dtype=yb.dtype, device=dev)) * g_s[..., None].to(yb.dtype)
        at = torch.empty_like(order)  # each (token, choice)'s sorted slot
        at.scatter_(1, order, torch.arange(Tk, device=dev).expand(G, Tk))
        at = torch.sort(at.reshape(G, T, k), dim=-1).values
        terms = torch.gather(out_vals, 1, at.reshape(G, Tk, 1).expand(
            G, Tk, d)).reshape(G, T, k, d)
        y = torch.zeros((G, T, d), dtype=yb.dtype, device=dev)
        for j in range(k):
            y = y + terms[:, :, j]
        y = y.reshape(B, Sq, d)
        if self.shared is not None:
            y = y + self.shared(x)
        return y.to(x.dtype), aux
