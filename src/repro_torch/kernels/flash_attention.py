"""Flash-attention forward, causal (optional window) or not, with GQA: the
wrapper around ``csrc/flash_attention.cu`` and its plain PyTorch version;
and its backward, the wrapper around ``csrc/flash_attention_bwd.cu``.

Port of ``repro/kernels/flash_attention.py::flash_attention_tpu``, with the
same layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D); query head r reads kv
head r // G; f32 softmax; output in q's dtype. Causal attention starts at
position 0 (prefill); ``causal=False`` attends every query to all Sk keys,
with Sq != Sk (cross attention over a memory, Sq = 1 in decode). The kernel's online softmax
visits keys in 64-key tiles and the plain version takes one softmax over
all keys; for bf16 inputs the kernel feeds the probabilities to the P V
product on the tensor cores as two bf16 parts (hi and the rest), which
keeps them to about f32 precision. :data:`TOLERANCE` is the max-abs bound
a bf16 output is held to on the card (one bf16 ulp at |x| ~ 2 is 1.6e-2).

Training: when grad is enabled and an input requires grad,
:func:`flash_attention` goes through a ``torch.autograd.Function`` whose
forward also writes each row's log-sum-exp and whose backward is
:func:`flash_attention_bwd` (the backward kernel on CUDA tensors, at every
head dim of the forward, RecurrentGemma's 256 included;
:func:`flash_attention_bwd_plain` on CPU tensors). The reference's train
step differentiates its jnp attention (``repro/models/attention.py``
``flash_attention``) with ``jax.value_and_grad``; the backward computes
the same gradients. Otherwise (``inference_mode``, ``no_grad``) the
forward launches exactly what it launches for serving.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .w4a8_gemm import _sm_count

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)  # head_dims the kernel is instantiated for
BWD_HEAD_DIMS = HEAD_DIMS       # and the backward's
#: max |kernel - plain| for bf16 outputs (one bf16 ulp at |x|~2 is 1.6e-2)
TOLERANCE = 2e-2
#: the backward's bound on the card: max |kernel - plain| <= this times
#: max |plain|, per gradient (bf16: one bf16 ulp of the largest gradient,
#: 2^-7 relative, since each gradient is rounded to bf16 once from f32
#: sums taken in another order; f32: sums in another order only)
BWD_REL_TOLERANCE = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
_BWD_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
#: the bf16 backward's tiles (``TKV`` and ``TQD`` of
#: csrc/flash_attention_bwd.cu): key rows of a dK/dV block, query rows of
#: a dQ block; at head dim 256 a dK/dV block holds ``TKV_256`` keys (two
#: warps share 16 key rows, each accumulating half of D)
BWD_KV_TILE = BWD_Q_TILE = 64
BWD_KV_TILE_256 = 32


def _mask(Sq: int, Sk: int, causal: bool, window: int | None, device):
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _plain(q, k, v, causal, window, softmax_scale, with_lse: bool):
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale or (1.0 / math.sqrt(D))
    qf = q.float() * scale
    kf = k.float().repeat_interleave(G, dim=2)  # query head r -> kv r // G
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    s = torch.where(_mask(Sq, Sk, causal, window, q.device), s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / den, vf).to(q.dtype)
    lse = (m + torch.log(den))[..., 0] if with_lse else None
    return out, lse


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          softmax_scale: float | None = None) -> torch.Tensor:
    """Masked softmax attention in f32 with the TPU kernel's semantics
    (q scaled before the dot, NEG_INF masking, denominator floored at
    1e-30)."""
    return _plain(q, k, v, causal, window, softmax_scale, False)[0]


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int | None = None,
                              softmax_scale: float | None = None):
    """(dq, dk, dv) of :func:`flash_attention_plain` given its output ``o``,
    the log-sum-exp ``lse`` (f32 (B, Hq, Sq)) and the output's gradient
    ``do``: the backward kernel's formulas in f32 (P = exp(S - lse), 0
    where masked; dS = P (dO V^T - rowsum(dO o O))), written out, not
    autograd. Gradients in the inputs' dtypes."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale or (1.0 / math.sqrt(D))
    qf = q.float() * scale
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    dof = do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    mask = _mask(Sq, Sk, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = torch.sum(dof * o.float(), dim=-1).transpose(1, 2)  # (B, Hq, Sq)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dk = dk.reshape(B, Sk, Hkv, G, D).sum(3)  # a kv head sums its group
    dv = dv.reshape(B, Sk, Hkv, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_operands(name, q, k, v, window, head_dims):
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if (q.dtype not in (torch.bfloat16, torch.float32)
            or k.dtype != q.dtype or v.dtype != q.dtype or D not in head_dims
            or tuple(k.shape) != (B, Sk, Hkv, D) or v.shape != k.shape
            or Hq % Hkv or (window is not None and window < 1)):
        raise ValueError(
            f"{name}: unsupported operands q{tuple(q.shape)} "
            f"k{tuple(k.shape)} v{tuple(v.shape)} {q.dtype} window={window}")


def _forward(q, k, v, causal, window, softmax_scale, with_lse: bool):
    """(out, lse or None): the plain version on CPU tensors, the kernel on
    CUDA tensors (writing lse only when asked)."""
    if _build.takes_plain("flash_attention", q):
        return _plain(q, k, v, causal, window, softmax_scale, with_lse)
    _build.require_cuda("flash_attention", q, k, v)
    _check_operands("flash_attention", q, k, v, window, HEAD_DIMS)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    scale = softmax_scale or (1.0 / math.sqrt(D))
    fn = _build.function("flash_attention", "flash_attention_launch", _ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 int(q.dtype == torch.bfloat16), B, Sq, Sk, Hq, Hkv, D,
                 scale, int(causal), -1 if window is None else window,
                 _build.stream_of(q), None if lse is None else lse.data_ptr())
    _build.check(err, "flash_attention")
    _build.count("flash_attention")
    return out, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: int | None = None,
                        softmax_scale: float | None = None):
    """(out, lse): the forward with each row's log-sum-exp of its scaled,
    masked scores (natural log, f32 (B, Hq, Sq)), which the backward
    reads. CPU tensors take the plain version; CUDA tensors launch the
    kernel with its lse output."""
    return _forward(q, k, v, causal, window, softmax_scale, True)


def bwd_launch_plan(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
                    dtype: torch.dtype, sms: int) -> dict:
    """The backward's launch on a card with ``sms`` SMs: its dK/dV and dQ
    blocks, the ``splits`` of each kv head's G query heads over dK/dV
    blocks, and the f32 ``workspace`` elements of their partials (0
    without a split). bf16 splits the heads, by the smallest divisor of G
    that gives at least one dK/dV block an SM (or by G), where key tiles x
    B Hkv blocks are fewer than the SMs; f32 (the scalar kernels, 64-row
    tiles, 32 at D = 256) never does."""
    G = Hq // Hkv
    kv_tile = BWD_KV_TILE_256 if D == 256 else BWD_KV_TILE
    # f32's tiles are square and as long as bf16's key tiles (``BT``,
    # ``BT_256`` of the .cu)
    q_tile = kv_tile if dtype == torch.float32 else BWD_Q_TILE
    base = -(-Sk // kv_tile) * B * Hkv
    splits = 1
    if dtype == torch.bfloat16:
        while base * splits < sms and splits < G:
            splits = next(s for s in range(splits + 1, G + 1) if G % s == 0)
    return {"kv_blocks": base * splits, "q_blocks": -(-Sq // q_tile)
            * B * Hq, "splits": splits,
            "workspace": 2 * splits * B * Sk * Hkv * D if splits > 1 else 0}


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int | None = None,
                        softmax_scale: float | None = None):
    """(dq, dk, dv) of the forward given its output ``o``, its log-sum-exp
    ``lse`` (f32 (B, Hq, Sq)) and the output's gradient ``do``. CPU
    tensors take :func:`flash_attention_bwd_plain`; CUDA tensors launch
    the backward kernel (head dims :data:`BWD_HEAD_DIMS`; another raises
    ``ValueError``) as :func:`bwd_launch_plan` lays it out on the card,
    with the f32 workspace a head split needs."""
    if _build.takes_plain("flash_attention_bwd", q):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window,
                                         softmax_scale=softmax_scale)
    _build.require_cuda("flash_attention_bwd", q, k, v, o, lse, do)
    _check_operands("flash_attention_bwd", q, k, v, window, BWD_HEAD_DIMS)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if (o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype
            or do.dtype != q.dtype or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, Hq, Sq)):
        raise ValueError(
            f"flash_attention_bwd: o{tuple(o.shape)} {o.dtype}, "
            f"do{tuple(do.shape)} {do.dtype}, lse{tuple(lse.shape)} "
            f"{lse.dtype} for q{tuple(q.shape)} {q.dtype}")
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    plan = bwd_launch_plan(B, Sq, Sk, Hq, Hkv, D, q.dtype,
                           _sm_count(q.device.index))
    ws = (torch.empty(plan["workspace"], dtype=torch.float32,
                      device=q.device) if plan["workspace"] else None)
    scale = softmax_scale or (1.0 / math.sqrt(D))
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd_launch",
                         _BWD_ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 int(q.dtype == torch.bfloat16), B, Sq, Sk, Hq, Hkv, D,
                 scale, int(causal), -1 if window is None else window,
                 plan["splits"], None if ws is None else ws.data_ptr(),
                 _build.stream_of(q))
    _build.check(err, "flash_attention_bwd")
    _build.count("flash_attention_bwd")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward with its log-sum-exp, and :func:`flash_attention_bwd`.
    Under ``torch.utils.checkpoint`` the forward runs again in the
    backward pass, and the lse and output it saves then are the ones the
    backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softmax_scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       softmax_scale=softmax_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window,
                        softmax_scale=softmax_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    softmax_scale: float | None = None) -> torch.Tensor:
    """Attention output (B, Sq, Hq, D) in q's dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel. With grad enabled and
    an input that requires grad, through the autograd Function (the
    backward kernel, or its plain version on the CPU)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, softmax_scale)
    return _forward(q, k, v, causal, window, softmax_scale, False)[0]
