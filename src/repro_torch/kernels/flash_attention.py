"""Flash-attention forward, causal (optional window) or not, with GQA: the
wrapper around ``csrc/flash_attention.cu`` and its plain PyTorch version.

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
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)  # head_dims the kernel is instantiated for
#: max |kernel - plain| for bf16 outputs (one bf16 ulp at |x|~2 is 1.6e-2)
TOLERANCE = 2e-2

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          softmax_scale: float | None = None) -> torch.Tensor:
    """Masked softmax attention in f32 with the TPU kernel's semantics
    (q scaled before the dot, NEG_INF masking, denominator floored at
    1e-30)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale or (1.0 / math.sqrt(D))
    qf = q.float() * scale
    kf = k.float().repeat_interleave(G, dim=2)  # query head r -> kv r // G
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    den = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / den, vf)
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    softmax_scale: float | None = None) -> torch.Tensor:
    """Attention output (B, Sq, Hq, D) in q's dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softmax_scale=softmax_scale)
    _build.require_cuda("flash_attention", q, k, v)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if (q.dtype not in (torch.bfloat16, torch.float32)
            or k.dtype != q.dtype or v.dtype != q.dtype or D not in HEAD_DIMS
            or tuple(k.shape) != (B, Sk, Hkv, D) or v.shape != k.shape
            or Hq % Hkv or (window is not None and window < 1)):
        raise ValueError(
            f"flash_attention: unsupported operands q{tuple(q.shape)} "
            f"k{tuple(k.shape)} v{tuple(v.shape)} {q.dtype} window={window}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    scale = softmax_scale or (1.0 / math.sqrt(D))
    fn = _build.function("flash_attention", "flash_attention_launch", _ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 int(q.dtype == torch.bfloat16), B, Sq, Sk, Hq, Hkv, D,
                 scale, int(causal), -1 if window is None else window,
                 _build.stream_of(q))
    _build.check(err, "flash_attention")
    _build.count("flash_attention")
    return out
