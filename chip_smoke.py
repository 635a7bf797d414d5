#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build every kernel from ``src/repro_torch/csrc`` (one nvcc per source,
   started together) and print the build time and ptxas register counts.
3. Hold each kernel against its plain PyTorch version on the card at the
   main-path shapes of LLaMA-2-7B (g128: decode M 1..4 and prefill M 128
   for (K, N) in (4096, 4096), (4096, 11008), (11008, 4096); flash
   attention at 128 tokens, 32 heads of 128) and time kernel, plain
   version, a single PyTorch library call where one computes the same
   function, and one bf16 ``torch.matmul`` of x by a bf16 (K, N) weight
   (the FP16 baseline the paper's speedups are measured against). Each
   is timed as a CUDA graph of back-to-back calls, replayed between CUDA
   events, so the host cannot pace a microsecond kernel; GEMM weights
   rotate over copies past 128 MB, so each launch reads them from device
   memory. act_quant, the IS GEMM (W4 and W8) and the coarse FS GEMM must
   be bit-exact; the fine FS GEMM (W4 at every shape, W8 at one decode
   shape) within rtol 1e-5 / atol 1e-4; W4A16 within ``REL_TOLERANCE`` x
   max|y|; flash attention within ``TOLERANCE`` (bf16 output), also at
   Mixtral's 32 query heads over 8 KV heads. Then the grouped (MoE)
   kernels at Mixtral-8x7B's expert shapes, 8 experts, (4096 -> 14336) and
   (14336 -> 4096) at capacity 8 (4-slot decode) and 40 (128-token
   prefill), with seeded routed counts that include an empty expert, a
   full one and counts that are no multiple of the row tile: IS (W4, and
   W8 at one decode shape) and coarse FS bit-exact, fine FS within rtol
   1e-5 / atol 1e-4, W4A16 within ``REL_TOLERANCE`` x max|y|; each ragged
   entry point must equal its dense-grouped one (pre-quantized codes, no
   counts) bit for bit on the same zero-padded buffer. Beside each: the
   plain version, one bf16 ``torch.bmm`` over the same (E, C, K) buffer
   (the FP16 baseline; for W4A16 also the library call) and the bound
   (the routed experts' weight and scale bytes, or the routed rows'
   operations).
4. Build ``llama2-7b`` at its full published widths (32 layers) in bf16
   from a seeded generator on the card, and RTN-quantize it under four
   recipes: W4A8 IS g128 alpha=1024 (the paper's), W4A8 FS g128 (Eq. 1),
   W4A8 per-channel (coarse, the OdysseyLLM baseline) and W4A16 g128 (the
   Marlin analog). Then free the fp weights.
5. Serve 8 seeded prompts (lengths 16..128) with each recipe through
   ``Engine.submit`` / ``Engine.run`` with 4 slots, prefill_len 128,
   max_seq 256 and 32 new tokens. For each: every outcome ``ok``; the
   kernels the recipe runs launched (> 0) and the others did not (== 0),
   counted from 0 just before the run; the engine's first token for
   prompt 0 is the argmax of that model's logits. For IS the first
   layers, copied to the CPU where every wrapper takes its plain version,
   must also agree with the same layers on the card within a stated
   bound. One 4-slot decode step is timed eagerly and as a replayed CUDA
   graph (the difference is the host's share of a decode tick).
6. Breaker drill: serve the IS weights with the FS weights as the
   circuit breaker's fallback (threshold 2) while a ``ChaosMonkey``
   fails the decode at tick 3 twice; the engine must fall back once and
   serve every request ``ok`` through ``w4a8_gemm_fs``.
7. Profile one IS decode step under ``obs.trace_window`` and print the
   eight device kernels with the most CUDA time. Free the llama2-7b
   weights.
8. ``mixtral-8x7b`` at full width (32 layers, 8 experts top-2, expert d_ff
   14336), built block by block (``ptq.quantize_by_layer``: one block's
   fp weights on the card at a time) under IS, FS and W4A16, one recipe at
   a time, each served as in phase 5 (same prompts and ``ServeConfig``):
   every outcome ``ok``, exactly the recipe's kernels launched (the
   grouped kernel of its scheme on every expert linear), the first token
   of prompt 0 the argmax of the logits, ``engine_moe_m_tiles_total``
   executed <= total and > 0, and for IS the first two layers on the card
   against the same layers on the CPU. The decode step is timed eagerly
   and as a captured CUDA graph with no routing sink attached; the
   capture is itself the check that the MoE layer makes no host sync.
9. Print the ``kernels`` JSON line (the eight kernels, launches summed
   over every served path), then the result line
   ``{"ok": true, "device": {...}}`` last.

Per-shape and per-recipe numbers also go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores

GEMM_KN = ((4096, 4096), (4096, 11008), (11008, 4096))
DECODE_M = (1, 2, 3, 4)
PREFILL_M = 128
TIMED_M = (4, PREFILL_M)
GROUP = 128
# rotate weight copies so the timed launches read them from device memory,
# as the serving path does (the 50 MB L2 cannot hold a layer's weights
# across a decode tick of 32 layers)
ROTATE_BYTES = 128 << 20
# fine float scale: f32 group sums in another order than torch.sum
FS_RTOL, FS_ATOL = 1e-5, 1e-4
# logits of the first layers on the CPU (every wrapper's plain version)
# vs the same layers on the card (the kernels), relative to the largest
# logit: flash and plain attention differ by a bf16 ulp, and the CPU's
# elementwise ops by f32 ulps; each such difference can flip an int8
# activation code, and through all 32 random layers the flips grow to
# several percent of the logits, so the check stops after two layers
PLAIN_CHECK_LAYERS = 2
PLAIN_LOGIT_REL_TOL = 5e-2
KERNELS_OF = {  # recipe -> kernels its serve must launch; the rest must not
    "w4a8-is": {"act_quant", "w4a8_gemm_is", "flash_attention"},
    "w4a8-fs": {"act_quant", "w4a8_gemm_fs", "flash_attention"},
    "w4a8-coarse": {"act_quant", "w4a8_gemm_fs", "flash_attention"},
    "w4a16-fg": {"w4a16_gemm", "flash_attention"},
}
# the same on Mixtral: the recipe's dense kernels (attention linears) and
# its grouped kernel (every expert linear)
MOE_KERNEL_OF = {"w4a8-is": "moe_w4a8_is", "w4a8-fs": "moe_w4a8_fs",
                 "w4a16-fg": "moe_w4a16"}
# Mixtral-8x7B's expert linears: 8 experts, (K, N) of gate/up and of down,
# at the 4-slot decode capacity and the 128-token prefill capacity
# (models.moe.capacity(4, 2, 8, 1.25) = 8, capacity(128, 2, 8, 1.25) = 40)
MOE_E = 8
MOE_KN = ((4096, 14336), (14336, 4096))
MOE_C = (8, 40)
# kernels vs plain versions on Mixtral's first layers: two, as for
# llama2-7b (the CPU's plain grouped GEMMs take about 15 s a layer on the
# card's 8-core host), with the same bound
MIXTRAL_PLAIN_CHECK_LAYERS = 2


def log(*a):
    print(*a, flush=True)


def time_ms(fn, args_list, iters=30, reps=5):
    """Mean device ms per call, cycling over ``args_list``: ``iters`` calls
    are captured into one CUDA graph, which is replayed ``reps`` times
    between CUDA events, so host launch cost does not pace the calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        for a in args_list[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(bytes_moved: float, *ops: tuple[float, float]):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and each (operations, peak rate of their type) pair."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / rate * 1e3 for n, rate in ops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_act_quant(gen, rows):
    import torch
    from repro_torch.kernels.act_quant import act_quant, act_quant_plain

    err = 0.0
    for M in (*DECODE_M, PREFILL_M):
        for K in (4096, 11008):
            x = (torch.randn((M, K), generator=gen, device="cuda") * 3
                 ).to(torch.bfloat16)
            qk, sk = act_quant(x)
            qp, sp = act_quant_plain(x)
            torch.cuda.synchronize()
            e = max((qk.int() - qp.int()).abs().max().item(),
                    (sk - sp).abs().max().item())
            err = max(err, e)
            if not (torch.equal(qk, qp) and torch.equal(sk, sp)):
                raise AssertionError(f"act_quant ({M},{K}) not bit-exact: {e}")
            if M in TIMED_M:
                ms = time_ms(lambda a: act_quant(a), [(x,)])
                plain = time_ms(lambda a: act_quant_plain(a), [(x,)])
                b, by = bound(M * K * 2 + M * K + M * 4,
                              (2 * M * K, F32_FLOPS_PER_S))
                rows.append(dict(kernel="act_quant", variant="", shape=[M, K],
                                 ms=ms, plain_ms=plain, bound_ms=b,
                                 bound_by=by, library_ms=None,
                                 bf16_matmul_ms=None))
    return err


def weight_sets(gen, K, N, copies, w_bits=4):
    """``copies`` random (K, N) layers, each RTN-quantized four ways: g128
    packed codes with f32 scales (FS, W4A16) and with integer scales (IS),
    per-channel (coarse FS), and the W4A16-dequantized bf16 weight (the
    bf16 matmul's operand)."""
    import torch
    from repro_torch.core import integer_scale as isc
    from repro_torch.core import packing, quant

    def pack(q):
        return packing.pack_int4(q) if w_bits == 4 else q

    out = []
    for _ in range(copies):
        w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
        qw = quant.quantize_weight(w, w_bits, GROUP)
        isw = isc.integerize(qw, 1024 if w_bits == 4 else "heuristic+6")
        qc = quant.quantize_weight(w, w_bits, -1)
        wd = (qw.qvalue.reshape(K // GROUP, GROUP, N).float()
              * qw.scale[:, None, :]).reshape(K, N).to(torch.bfloat16)
        out.append(dict(packed=pack(qw.qvalue), scale=qw.scale,
                        int_scale=isw.int_scale, alpha=float(isw.alpha),
                        packed_c=pack(qc.qvalue), scale_c=qc.scale[None, :],
                        wd=wd))
        del w, qw, qc
    return out


def _check(name, shape, y, y_plain, how):
    """Max abs diff of a kernel's output against its plain version on the
    same inputs; raises unless it meets ``how`` ("exact", "fs" or a
    relative bound)."""
    import torch

    torch.cuda.synchronize()
    e = (y - y_plain).abs().max().item()
    if how == "exact":
        ok = torch.equal(y, y_plain)
    elif how == "fs":
        ok = bool(((y - y_plain).abs()
                   <= FS_ATOL + FS_RTOL * y_plain.abs()).all())
    else:
        ok = e <= how * y_plain.abs().max().item()
    if not ok:
        raise AssertionError(f"{name} {shape}: kernel vs plain max abs "
                             f"{e} outside its tolerance ({how})")
    return e


def check_gemms(gen, rows):
    """IS, FS (fine and coarse) and W4A16 GEMMs against their plain
    versions at every main-path shape; timed at M = 4 and 128."""
    import torch
    from repro_torch.kernels.act_quant import act_quant_plain
    from repro_torch.kernels.w4a16_gemm import (REL_TOLERANCE, w4a16_gemm,
                                                w4a16_gemm_plain)
    from repro_torch.kernels.w4a8_gemm import (fg_gemm_integer_scale,
                                               fg_gemm_integer_scale_plain)
    from repro_torch.kernels.w4a8_gemm_fscale import (
        fg_gemm_float_scale, fg_gemm_float_scale_plain)

    gemms = {  # (name, variant) -> (kernel, plain, operands of a set, how)
        ("w4a8_gemm_is", "fine"): (
            lambda xq, sa, xb, q, s, a, **kw: fg_gemm_integer_scale(
                xq, sa, q, s, group_size=GROUP, alpha=a, **kw),
            lambda xq, sa, xb, q, s, a, **kw: fg_gemm_integer_scale_plain(
                xq, sa, q, s, group_size=GROUP, alpha=a, **kw),
            lambda d: (d["packed"], d["int_scale"], d["alpha"]), "exact"),
        ("w4a8_gemm_fs", "fine"): (
            lambda xq, sa, xb, q, s, **kw: fg_gemm_float_scale(
                xq, sa, q, s, group_size=GROUP, **kw),
            lambda xq, sa, xb, q, s, **kw: fg_gemm_float_scale_plain(
                xq, sa, q, s, group_size=GROUP, **kw),
            lambda d: (d["packed"], d["scale"]), "fs"),
        ("w4a8_gemm_fs", "coarse"): (
            lambda xq, sa, xb, q, s: fg_gemm_float_scale(
                xq, sa, q, s, group_size=-1),
            lambda xq, sa, xb, q, s: fg_gemm_float_scale_plain(
                xq, sa, q, s, group_size=-1),
            lambda d: (d["packed_c"], d["scale_c"]), "exact"),
        ("w4a16_gemm", "fine"): (
            lambda xq, sa, xb, q, s: w4a16_gemm(xb, q, s, group_size=GROUP),
            lambda xq, sa, xb, q, s: w4a16_gemm_plain(xb, q, s,
                                                      group_size=GROUP),
            lambda d: (d["packed"], d["scale"]), REL_TOLERANCE),
    }
    errs: dict[str, float] = {}

    def matmul(xb, wd):
        return xb @ wd

    for K, N in GEMM_KN:
        wbytes = K * N // 2 + (K // GROUP) * N * 4
        copies = max(1, math.ceil(ROTATE_BYTES / wbytes))
        sets = weight_sets(gen, K, N, copies)
        x = torch.randn((PREFILL_M, K), generator=gen, device="cuda")
        xq_all, sa_all = act_quant_plain(x)
        xb_all = x.to(torch.bfloat16)
        for M in (*DECODE_M, PREFILL_M):
            xs = (xq_all[:M].contiguous(), sa_all[:M].contiguous(),
                  xb_all[:M].contiguous())
            mm = None
            if M in TIMED_M:
                mm = time_ms(matmul, [(xs[2], d["wd"]) for d in sets])
            for (name, variant), (kern, plain, opnds, how) in gemms.items():
                args = [(*xs, *opnds(d)) for d in sets]
                e = _check(f"{name} {variant}", [M, K, N], kern(*args[0]),
                           plain(*args[0]), how)
                errs[name] = max(errs.get(name, 0.0), e)
                if M not in TIMED_M:
                    continue
                scale_bytes = (K // GROUP if variant == "fine" else 1) * N * 4
                w4 = K * N // 2 + scale_bytes + M * N * 4
                if name == "w4a16_gemm":
                    b, by = bound(M * K * 2 + w4,
                                  (2 * M * K * N, BF16_FLOPS_PER_S))
                else:
                    b, by = bound(M * K + M * 4 + w4,
                                  (2 * M * K * N, INT8_OPS_PER_S))
                rows.append(dict(
                    kernel=name, variant=variant, shape=[M, K, N],
                    ms=time_ms(kern, args),
                    plain_ms=time_ms(plain, args[:2], iters=3, reps=3),
                    bound_ms=b, bound_by=by,
                    library_ms=mm if name == "w4a16_gemm" else None,
                    bf16_matmul_ms=mm, copies=copies))
        del sets, x, xq_all, sa_all, xb_all
        torch.cuda.empty_cache()

    # W8A8 (unpacked int8 weights) through the IS and FS kernels, at one
    # decode shape
    M, K, N = 4, 4096, 4096
    copies = max(1, math.ceil(ROTATE_BYTES / (K * N + (K // GROUP) * N * 4)))
    sets = weight_sets(gen, K, N, copies, w_bits=8)
    x = torch.randn((M, K), generator=gen, device="cuda")
    xs = (*act_quant_plain(x), x.to(torch.bfloat16))
    mm = time_ms(matmul, [(xs[2], d["wd"]) for d in sets])
    for name in ("w4a8_gemm_is", "w4a8_gemm_fs"):
        kern, plain, opnds, how = gemms[(name, "fine")]
        args = [(*xs, *opnds(d)) for d in sets]
        e = _check(f"{name} w8", [M, K, N], kern(*args[0], w_bits=8),
                   plain(*args[0], w_bits=8), how)
        errs[name] = max(errs[name], e)
        b, by = bound(M * K + M * 4 + K * N + (K // GROUP) * N * 4 + M * N * 4,
                      (2 * M * K * N, INT8_OPS_PER_S))
        rows.append(dict(
            kernel=name, variant="w8", shape=[M, K, N],
            ms=time_ms(lambda *a: kern(*a, w_bits=8), args),
            plain_ms=time_ms(lambda *a: plain(*a, w_bits=8), args[:2],
                             iters=3, reps=3),
            bound_ms=b, bound_by=by, library_ms=None, bf16_matmul_ms=mm,
            copies=copies))
    return errs


def check_flash(gen, rows):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        TOLERANCE, flash_attention, flash_attention_plain)

    err = 0.0
    # (B, Sq, Hq, Hkv, D, window): the prefill shape, then GQA + window +
    # a ragged length
    for B, S, Hq, Hkv, D, win in ((1, 128, 32, 32, 128, None),
                                  (1, 128, 32, 8, 128, None),  # Mixtral GQA
                                  (2, 200, 8, 2, 128, 64),
                                  (1, 77, 4, 1, 64, None)):
        q, k, v = (torch.randn((B, S, h, D), generator=gen, device="cuda"
                               ).to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        ok_ = flash_attention(q, k, v, window=win)
        op = flash_attention_plain(q, k, v, window=win)
        torch.cuda.synchronize()
        e = (ok_.float() - op.float()).abs().max().item()
        err = max(err, e)
        if not e <= TOLERANCE:
            raise AssertionError(f"flash ({B},{S},{Hq},{Hkv},{D},{win}): "
                                 f"max abs {e} > {TOLERANCE}")
        if S == 128:
            ms = time_ms(lambda *a: flash_attention(*a), [(q, k, v)])
            pms = time_ms(lambda *a: flash_attention_plain(*a), [(q, k, v)])
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = time_ms(lambda *a: F.scaled_dot_product_attention(
                *a, is_causal=True, enable_gqa=Hq != Hkv), [(qt, kt, vt)])
            pairs = S * (S + 1) // 2
            b, by = bound(2 * B * S * (Hq + Hkv) * D * 2,
                          (4 * B * Hq * pairs * D, BF16_FLOPS_PER_S))
            rows.append(dict(kernel="flash_attention",
                             variant="" if Hq == Hkv else f"gqa kv{Hkv}",
                             shape=[B, S, Hq, D], ms=ms, plain_ms=pms,
                             bound_ms=b, bound_by=by, library_ms=lib,
                             bf16_matmul_ms=None))
    return err


def moe_counts(C, seed):
    """Seeded routed counts of 8 experts at capacity C: expert 0 empty,
    expert 1 full, the rest in [1, C) (none a multiple of the row tile)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [0, C] + rng.integers(1, C, size=MOE_E - 2).tolist()


def moe_weights(gen, K, N, w_bits=4):
    """Stacked RTN weights of 8 experts, as ``weight_sets`` makes one
    layer's: packed codes with f32 and integer scales (per-expert alpha),
    per-channel codes and scales, and the bf16 dequantized weight."""
    import torch

    sets = weight_sets(gen, K, N, MOE_E, w_bits=w_bits)
    out = {k: torch.stack([d[k] for d in sets])
           for k in ("packed", "scale", "int_scale", "packed_c", "scale_c",
                     "wd")}
    out["alpha"] = torch.tensor([d["alpha"] for d in sets], device="cuda")
    return out


def check_grouped(gen, rows):
    """The grouped (MoE) kernels at Mixtral's expert shapes: each ragged
    entry point (the serving path) and each dense-grouped one (codes
    quantized before the call, every row computed) against its plain
    version, ragged == dense grouped on the same zero-padded buffer; each
    timed with its plain version, a bf16 ``torch.bmm`` over the same
    buffer, and its bound."""
    import torch
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels.act_quant import act_quant_plain
    from repro_torch.kernels.w4a16_gemm import REL_TOLERANCE

    def on_weights(fn, q, sc, **fixed):
        """(a, b, w) -> fn(a, b, w[q], w[sc]): a grouped entry point over
        the codes ``q`` and scales ``sc`` of a weight set"""
        return lambda a, b, w, **kw: fn(a, b, w[q], w[sc], **fixed, **kw)

    # (kernel, variant) -> (ragged, its plain, dense grouped, its plain,
    # tolerance); ragged ones take (x, counts, w), dense W4A8 ones
    # (xq, sa, w), dense W4A16 (x, None, w)
    groups = {
        ("moe_w4a8_is", "fine"): (
            lambda x, rc, w, **kw: mg.fg_grouped_gemm_integer_scale_ragged(
                x, rc, w["packed"], w["int_scale"], alpha=w["alpha"], **kw),
            lambda x, rc, w, **kw:
                mg.fg_grouped_gemm_integer_scale_ragged_plain(
                    x, rc, w["packed"], w["int_scale"], group_size=GROUP,
                    alpha=w["alpha"], **kw),
            lambda xq, sa, w, **kw: mg.fg_grouped_gemm_integer_scale(
                xq, sa, w["packed"], w["int_scale"], alpha=w["alpha"], **kw),
            lambda xq, sa, w, **kw: mg.fg_grouped_gemm_integer_scale_plain(
                xq, sa, w["packed"], w["int_scale"], group_size=GROUP,
                alpha=w["alpha"], **kw),
            "exact"),
        ("moe_w4a8_fs", "fine"): (
            on_weights(mg.fg_grouped_gemm_float_scale_ragged, "packed", "scale"),
            on_weights(mg.fg_grouped_gemm_float_scale_ragged_plain, "packed",
               "scale", group_size=GROUP),
            on_weights(mg.fg_grouped_gemm_float_scale, "packed", "scale"),
            on_weights(mg.fg_grouped_gemm_float_scale_plain, "packed", "scale",
               group_size=GROUP),
            "fs"),
        ("moe_w4a8_fs", "coarse"): (
            on_weights(mg.fg_grouped_gemm_float_scale_ragged, "packed_c", "scale_c",
               group_size=-1),
            on_weights(mg.fg_grouped_gemm_float_scale_ragged_plain, "packed_c",
               "scale_c", group_size=-1),
            on_weights(mg.fg_grouped_gemm_float_scale, "packed_c", "scale_c",
               group_size=-1),
            on_weights(mg.fg_grouped_gemm_float_scale_plain, "packed_c", "scale_c",
               group_size=-1),
            "exact"),
        ("moe_w4a16", "fine"): (
            on_weights(mg.grouped_w4a16_gemm_ragged, "packed", "scale"),
            on_weights(mg.grouped_w4a16_gemm_ragged_plain, "packed", "scale",
               group_size=GROUP),
            lambda x, _, w: mg.grouped_w4a16_gemm(x, w["packed"], w["scale"]),
            lambda x, _, w: mg.grouped_w4a16_gemm_plain(
                x, w["packed"], w["scale"], group_size=GROUP),
            REL_TOLERANCE),
    }
    errs: dict[str, float] = {}

    def bmm(x, wd):
        return torch.bmm(x, wd)

    def one(name, variant, C, K, N, x, rc, xq, sa, w, fns, w_bits=4):
        ragged, ragged_plain, dense, dense_plain, how = fns
        kw = {} if w_bits == 4 else dict(w_bits=8)
        shape = [MOE_E, C, K, N]
        dargs = (x, None, w) if name == "moe_w4a16" else (xq, sa, w)
        y = ragged(x, rc, w, **kw)
        y_d = dense(*dargs, **kw)
        for tag, got, want in (("ragged", y, ragged_plain(x, rc, w, **kw)),
                               ("dense", y_d, dense_plain(*dargs, **kw))):
            e = _check(f"{name} {variant} {tag}", shape, got, want, how)
            errs[name] = max(errs.get(name, 0.0), e)
        if not torch.equal(y, y_d):
            raise AssertionError(f"{name} {variant} {shape}: ragged != "
                                 "dense grouped")
        counts = [min(int(c), C) for c in rc.tolist()]
        routed, active = sum(counts), sum(c > 0 for c in counts)
        wbytes = K * N // (2 if w_bits == 4 else 1)
        sbytes = (K // GROUP if variant == "fine" else 1) * N * 4
        out_bytes = MOE_E * C * N * 4
        wo = name == "moe_w4a16"
        rate = BF16_FLOPS_PER_S if wo else INT8_OPS_PER_S
        # ragged: the routed experts' weights, the routed bf16 rows; dense
        # grouped: every expert and every row (codes + scale, or bf16)
        b, by = bound(active * (wbytes + sbytes) + routed * K * 2
                      + out_bytes, (2 * routed * K * N, rate))
        db, dby = bound(MOE_E * (wbytes + sbytes) + out_bytes
                        + MOE_E * C * (K * 2 if wo else K + 4),
                        (2 * MOE_E * C * K * N, rate))
        return dict(
            kernel=name, variant=variant if w_bits == 4 else "w8",
            shape=shape, counts=counts,
            ms=time_ms(lambda *a: ragged(*a, **kw), [(x, rc, w)]),
            plain_ms=time_ms(lambda *a: ragged_plain(*a, **kw), [(x, rc, w)],
                             iters=2, reps=2),
            bound_ms=b, bound_by=by,
            dense_ms=time_ms(lambda *a: dense(*a, **kw), [dargs]),
            dense_plain_ms=time_ms(lambda *a: dense_plain(*a, **kw), [dargs],
                                   iters=2, reps=2),
            dense_bound_ms=db, dense_bound_by=dby)

    def inputs(C, K, counts):
        """A bf16 (E, C, K) dispatch buffer zero past ``counts``, its
        counts on the card, and its codes and scales."""
        rc = torch.tensor(counts, dtype=torch.int32, device="cuda")
        live = torch.arange(C, device="cuda")[None, :] < rc[:, None]
        x = torch.where(live[..., None], torch.randn(
            (MOE_E, C, K), generator=gen, device="cuda"), 0.0
        ).to(torch.bfloat16)
        xq, sa = act_quant_plain(x.reshape(MOE_E * C, K))
        return x, rc, xq.reshape(MOE_E, C, K), sa.reshape(MOE_E, C, 1)

    for K, N in MOE_KN:
        w = moe_weights(gen, K, N)
        for C in MOE_C:
            x, rc, xq, sa = inputs(C, K, moe_counts(C, seed=C * K))
            mm = time_ms(bmm, [(x, w["wd"])])
            for (name, variant), fns in groups.items():
                r = one(name, variant, C, K, N, x, rc, xq, sa, w, fns)
                rows.append(dict(r, library_ms=mm if name == "moe_w4a16"
                                 else None, bf16_matmul_ms=mm, copies=1))
            del x, xq, sa
        del w
        torch.cuda.empty_cache()

    # W8A8 weights through the IS kernel at one decode shape
    K, N, C = 4096, 14336, 8
    w = moe_weights(gen, K, N, w_bits=8)
    x, rc, xq, sa = inputs(C, K, moe_counts(C, seed=7))
    r = one("moe_w4a8_is", "fine", C, K, N, x, rc, xq, sa, w,
            groups[("moe_w4a8_is", "fine")], w_bits=8)
    rows.append(dict(r, library_ms=None,
                     bf16_matmul_ms=time_ms(bmm, [(x, w["wd"])]), copies=1))
    del w, x, xq, sa
    torch.cuda.empty_cache()
    return errs


def build_models(api, cfg, recipes):
    """Random bf16 weights at full width, quantized under each recipe;
    the fp weights are freed before returning."""
    import torch
    from repro_torch import obs
    from repro_torch.core import ptq
    from repro_torch.nn import spec as S

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    fp = S.materialize(api.param_specs(cfg, None), gen, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; random bf16 "
        f"weights {time.perf_counter() - t0:.2f} s")
    out = {}
    for recipe in recipes:
        reg = obs.Registry()
        t0 = time.perf_counter()
        with obs.use_registry(reg):
            qparams = ptq.post_training_quantize(api, cfg, fp, recipe)
        torch.cuda.synchronize()
        qbytes = sum(t.numel() * t.element_size()
                     for blk in qparams["blocks"] for t in S.leaves(blk))
        caps = reg.counter("alpha_cap_events_total").total()
        log(f"[model] {recipe.name}: RTN quantize {time.perf_counter() - t0:.2f}"
            f" s, quantized blocks {qbytes / 1e9:.3f} GB, alpha caps {caps:g}")
        out[recipe.name] = qparams
    del fp
    torch.cuda.empty_cache()
    return out


def _decode_inputs(api, cfg, sc):
    import torch
    from repro_torch.nn import spec as S

    B = sc.max_slots
    cache = S.materialize(api.cache_specs(cfg, B, sc.max_seq), device="cuda")
    toks = torch.zeros((B, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((B,), 100, dtype=torch.int64, device="cuda")
    return cache, toks, pos


def time_decode_step(api, cfg, model, sc, reps=5):
    """ms of one batched decode step at position 100 in every slot: eager
    calls between CUDA events, and the same call captured as a CUDA graph
    and replayed. The graph's time is the device's; the difference is the
    host time the eager step adds."""
    import torch

    cache, toks, pos = _decode_inputs(api, cfg, sc)

    def step():
        return model(toks, mode="decode", cache=cache, pos=pos)[0]

    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        step()  # the allocator's blocks for this stream, outside the timing
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            step()
        end.record()
        end.synchronize()
        eager = start.elapsed_time(end) / reps
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        replay = start.elapsed_time(end) / reps
    del graph, cache
    torch.cuda.empty_cache()
    return eager, replay


def profile_decode_step(api, cfg, model, sc, top=8):
    """One decode step under ``obs.trace_window``: the ``top`` device
    kernels by CUDA time, and the step's total device time (ms)."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch import obs

    cache, toks, pos = _decode_inputs(api, cfg, sc)
    with torch.inference_mode():
        model(toks, mode="decode", cache=cache, pos=pos)  # warm
        torch.cuda.synchronize()
        with obs.trace_window(str(ROOT / "build" / "profile")) as prof:
            model(toks, mode="decode", cache=cache, pos=pos)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        raise AssertionError("the profiler recorded no device kernels")
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    del cache
    return total, [dict(name=e.key[:120], count=e.count,
                        ms=e.self_device_time_total / 1e3) for e in ranked]


def serve_recipe(api, cfg, qparams, recipe, sc, prompts, *, drill=False,
                 fallback=None):
    """Serve ``prompts``; return (engine, outputs, launches, registry,
    wall seconds). ``drill`` arms the breaker drill (fallback weights,
    threshold 2, two injected decode failures at tick 3)."""
    import torch
    from repro_torch import obs
    from repro_torch.kernels import _build
    from repro_torch.serving.chaos import ChaosConfig, ChaosMonkey, KernelFault
    from repro_torch.serving.engine import Engine

    reg = obs.Registry()
    with obs.use_registry(reg):
        if drill:
            fb_params, fb_recipe = fallback
            eng = Engine(api, cfg, qparams,
                         dataclasses.replace(sc, breaker_threshold=2),
                         recipe=recipe, fallback_params=fb_params,
                         fallback_recipe=fb_recipe)
            ChaosMonkey(ChaosConfig(kernel_failures=(
                KernelFault(tick=3, count=2),))).install(eng)
        else:
            eng = Engine(api, cfg, qparams, sc, recipe=recipe)
        rids = [eng.submit(p) for p in prompts]
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    bad = {r: eng.outcome(r) for r in rids if eng.outcome(r) != "ok"}
    if bad:
        raise AssertionError(f"{recipe.name}: requests not ok: {bad}")
    if any(len(outs[r]) != sc.max_new_tokens for r in rids):
        raise AssertionError(f"{recipe.name}: a request did not generate "
                             "max_new_tokens")
    if not all(0 <= t < cfg.vocab_size for r in rids for t in outs[r]):
        raise AssertionError(f"{recipe.name}: token id out of range")
    return eng, [outs[r] for r in rids], launches, reg, wall


def report_serve(tag, name, api, cfg, eng, outs, launches, reg, wall, sc):
    """Time one decode step (eager, and as a replayed CUDA graph), log the
    serving numbers of one recipe and return them."""
    step_eager, step_graph = time_decode_step(api, cfg, eng.model, sc)
    ntok = sum(len(o) for o in outs)
    phase = reg.histogram("engine_phase_seconds", "", ("phase",))
    dev = reg.histogram("engine_phase_device_seconds", "", ("phase",))
    ttft = reg.histogram("engine_ttft_seconds").get()

    def mean(h, **lb):
        st = h.get(**lb)
        return st["sum"] / st["count"]

    st = dict(
        depth=cfg.num_layers, requests=len(outs), tokens=ntok,
        wall_s=wall, tokens_per_s=ntok / wall, ticks=eng.ticks,
        decode_tick_s=mean(phase, phase="decode"),
        prefill_s=mean(phase, phase="prefill"),
        ttft_mean_s=ttft["sum"] / ttft["count"],
        decode_device_s=mean(dev, phase="decode"),
        prefill_device_s=mean(dev, phase="prefill"),
        step_eager_ms=step_eager, step_graph_ms=step_graph,
        launches=launches)
    log(f"[{tag}] {name}: {cfg.num_layers} layers, {len(outs)} requests "
        f"ok, {ntok} tokens in {wall:.3f} s = {st['tokens_per_s']:.1f} "
        f"tokens/s; {eng.ticks} ticks, {st['decode_tick_s'] * 1e3:.2f} ms "
        f"per tick (device timer {st['decode_device_s'] * 1e3:.2f} ms); "
        f"prefill {st['prefill_s'] * 1e3:.2f} ms (device timer "
        f"{st['prefill_device_s'] * 1e3:.2f} ms); mean TTFT "
        f"{st['ttft_mean_s'] * 1e3:.1f} ms")
    log(f"[{tag}] {name}: one 4-slot decode step eager "
        f"{step_eager:.3f} ms, CUDA graph replay {step_graph:.3f} ms "
        f"(device idle share of the eager step "
        f"{1 - step_graph / step_eager:.3f}); first token of prompt 0 is "
        f"the argmax of the logits; launches {json.dumps(launches)}")
    return st


def first_token_is_argmax(tag, eng, toks, n0, first):
    """The engine's first generated token for a prompt is the argmax of
    the model's logits at the prompt's end."""
    import torch

    with torch.inference_mode():
        lk = eng.model(toks)[0][0, n0 - 1]
    if not torch.isfinite(lk).all():
        raise AssertionError(f"{tag}: non-finite logits")
    if first != int(torch.argmax(lk)):
        raise AssertionError(f"{tag}: the engine's first token for prompt 0 "
                             "is not the argmax of the model's logits")


def plain_check(api, cfg, qparams, recipe, toks, n0, layers):
    """Logits of the model cut to its first ``layers`` layers on the card
    (kernels) against the same layers copied to the CPU (plain versions):
    (max abs diff relative to the largest logit, CPU seconds)."""
    import torch
    from repro_torch.nn import spec as S

    cut = dict(qparams, blocks=qparams["blocks"][:layers])
    c2 = dataclasses.replace(cfg, num_layers=layers)
    with torch.inference_mode():
        la = api.build(c2, cut, recipe)(toks)[0][0, n0 - 1]
        t0 = time.perf_counter()
        on_cpu = S.tree_map(lambda t: t.cpu(), cut)
        lp = api.build(c2, on_cpu, recipe)(toks.cpu())[0][0, n0 - 1]
        cpu_s = time.perf_counter() - t0
    rel = ((la.cpu() - lp).abs().max() / lp.abs().max()).item()
    if not rel <= PLAIN_LOGIT_REL_TOL:
        raise AssertionError(f"{cfg.name}: kernels vs plain versions, first "
                             f"{layers} layers: logits rel {rel}")
    log(f"[check] {cfg.name} {recipe.name}: first {layers} layers, kernels "
        f"on the card vs plain versions on the CPU ({cpu_s:.1f} s): "
        f"logits rel {rel:.2e} (<= {PLAIN_LOGIT_REL_TOL})")
    return rel, cpu_s


def check_launches(tag, launches, must):
    missing = sorted(k for k in must if launches[k] <= 0)
    extra = sorted(k for k, n in launches.items() if k not in must and n)
    if missing or extra:
        raise AssertionError(f"{tag}: kernels that should have launched and "
                             f"did not: {missing}; launched and should not "
                             f"have: {extra}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a GPU", file=sys.stderr)
        return 2
    from repro_torch.core.recipe import (DEFAULT_RECIPE, FLOAT_SCALE_RECIPE,
                                         W4A8_COARSE, WEIGHT_ONLY_RECIPE,
                                         QuantRecipe)
    from repro_torch import obs
    from repro_torch.core import ptq
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_arch, get_model
    from repro_torch.nn import spec as S
    from repro_torch.serving.engine import ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. the card -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} x{torch.cuda.device_count()}")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    times = _build.build()
    log(f"[build] {len(times)} kernels in {time.perf_counter() - t0:.1f} s "
        + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # -- 3. kernels against their plain versions --------------------------------
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows: list[dict] = []
    errs = {"act_quant": check_act_quant(gen, rows),
            **check_gemms(gen, rows),
            "flash_attention": check_flash(gen, rows),
            **check_grouped(gen, rows)}

    def opt(v):
        return "-" if v is None else f"{v:.4f} ms"

    for r in rows:
        extra = "" if "counts" not in r else (
            f" counts {r['counts']}; dense grouped {r['dense_ms']:.4f} ms, "
            f"plain {r['dense_plain_ms']:.4f} ms, bound "
            f"{r['dense_bound_ms']:.5f} ms ({r['dense_bound_by']})")
        log(f"[kernel] {r['kernel']} {r['variant']} {r['shape']}: "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}), library "
            f"{opt(r['library_ms'])}, bf16 matmul {opt(r['bf16_matmul_ms'])}"
            f"{extra}")
    log(f"[kernel] max abs diff vs plain: {json.dumps(errs)}")

    # -- 4. llama2-7b at full width under four recipes ---------------------------
    cfg = get_arch("llama2-7b")
    api = get_model(cfg)
    coarse = QuantRecipe(rules=(("*", W4A8_COARSE),), name="w4a8-coarse")
    recipes = {r.name: r for r in (DEFAULT_RECIPE, FLOAT_SCALE_RECIPE, coarse,
                                   WEIGHT_ONLY_RECIPE)}
    qparams = build_models(api, cfg, recipes.values())

    # -- 5. serve each recipe --------------------------------------------------------
    sc = ServeConfig(max_slots=4, prefill_len=128, max_seq=256,
                     max_new_tokens=32)
    rng = np.random.default_rng(0)
    lengths = rng.integers(16, 129, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lengths]
    toks = torch.tensor([prompts[0] + [0] * (128 - len(prompts[0]))],
                        device="cuda")
    n0 = len(prompts[0])
    launches_total = {k: 0 for k in _build.KERNELS}
    serve_stats: dict[str, dict] = {}
    rel = cpu_s = None
    for name, recipe in recipes.items():
        eng, outs, launches, reg, wall = serve_recipe(
            api, cfg, qparams[name], recipe, sc, prompts)
        check_launches(name, launches, KERNELS_OF[name])
        for k, n in launches.items():
            launches_total[k] += n
        first_token_is_argmax(name, eng, toks, n0, outs[0][0])
        if name == DEFAULT_RECIPE.name:
            # the kernels against the plain versions on the same weights
            rel, cpu_s = plain_check(api, cfg, qparams[name], recipe, toks,
                                     n0, PLAIN_CHECK_LAYERS)
        serve_stats[name] = report_serve(
            "serve", name, api, cfg, eng, outs, launches, reg, wall, sc)
        if name != DEFAULT_RECIPE.name:
            del eng
            torch.cuda.empty_cache()
        else:
            is_model = eng.model
            del eng

    # -- 6. breaker drill: IS -> FS on the card -----------------------------------
    eng, outs, launches, reg, wall = serve_recipe(
        api, cfg, qparams[DEFAULT_RECIPE.name], DEFAULT_RECIPE, sc, prompts,
        drill=True, fallback=(qparams[FLOAT_SCALE_RECIPE.name],
                              FLOAT_SCALE_RECIPE))
    fb = reg.counter("engine_fallback_events_total", "", ("reason",))
    if eng.fallbacks != 1 or fb.get(reason="decode_exception") != 1:
        raise AssertionError(f"breaker drill: {eng.fallbacks} fallbacks, "
                             f"{fb.total()} fallback events")
    if launches["w4a8_gemm_fs"] <= 0 or launches["w4a8_gemm_is"] <= 0:
        raise AssertionError(f"breaker drill launches: {launches}")
    for k, n in launches.items():
        launches_total[k] += n
    drill = dict(fallbacks=eng.fallbacks, ticks=eng.ticks, launches=launches,
                 kernel_failures=reg.counter(
                     "engine_kernel_failures_total", "", ("phase",)).total())
    log(f"[drill] IS->FS breaker: 2 injected decode failures at tick 3, "
        f"threshold 2: fallbacks {eng.fallbacks}, all 8 requests ok, "
        f"{eng.ticks} ticks; launches {json.dumps(launches)}")
    del eng
    torch.cuda.empty_cache()

    # -- 7. profile one IS decode step ---------------------------------------------
    prof_total, prof_top = profile_decode_step(api, cfg, is_model, sc)
    log(f"[profile] one IS 4-slot decode step: {prof_total:.3f} ms of device "
        "kernels; top 8:")
    for p in prof_top:
        log(f"[profile]   {p['ms']:.3f} ms  x{p['count']}  {p['name']}")

    del is_model, qparams
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8. mixtral-8x7b at full width, one recipe at a time ------------------------
    mcfg = get_arch("mixtral-8x7b")
    mapi = get_model(mcfg)
    log(f"[mixtral] {mcfg.name}: {mcfg.num_layers} layers, d_model "
        f"{mcfg.d_model}, {mcfg.num_heads} query heads over "
        f"{mcfg.num_kv_heads} KV heads, {mcfg.num_experts} experts top-"
        f"{mcfg.top_k} of d_ff {mcfg.moe_d_ff}, vocab {mcfg.vocab_size}")
    mixtral_stats: dict[str, dict] = {}
    mrel = mcpu_s = None
    for recipe in (DEFAULT_RECIPE, FLOAT_SCALE_RECIPE, WEIGHT_ONLY_RECIPE):
        name = recipe.name
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with obs.use_registry(obs.Registry()):
            mq = ptq.quantize_by_layer(mapi, mcfg, recipe, seed=0,
                                       device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated()
        qbytes = sum(t.numel() * t.element_size() for t in S.leaves(mq))
        ebytes = sum(t.numel() * t.element_size() for blk in mq["blocks"]
                     for k in ("gate", "up", "down")
                     for t in S.leaves(blk["mlp"][k]))
        log(f"[mixtral] {name}: built block by block in {build_s:.1f} s; "
            f"weights on the card {qbytes / 1e9:.2f} GB (expert stacks "
            f"{ebytes / 1e9:.2f} GB); peak allocated while building "
            f"{build_peak / 1e9:.2f} GB")
        torch.cuda.reset_peak_memory_stats()  # from here: serving's peak
        eng, outs, launches, reg, wall = serve_recipe(
            mapi, mcfg, mq, recipe, sc, prompts)
        eng.close()  # no routing sink from here on: the graph capture below
        check_launches(f"mixtral {name}", launches,
                       KERNELS_OF[name] | {MOE_KERNEL_OF[name]})
        for k, n in launches.items():
            launches_total[k] += n
        tiles = reg.counter("engine_moe_m_tiles_total", "", ("kind",))
        executed, total = tiles.get(kind="executed"), tiles.get(kind="total")
        if not 0 < executed <= total:
            raise AssertionError(f"mixtral {name}: m-tiles executed "
                                 f"{executed}, total {total}")
        first_token_is_argmax(f"mixtral {name}", eng, toks, n0, outs[0][0])
        if name == DEFAULT_RECIPE.name:
            mrel, mcpu_s = plain_check(mapi, mcfg, mq, recipe, toks, n0,
                                       MIXTRAL_PLAIN_CHECK_LAYERS)
        st = report_serve("mixtral", name, mapi, mcfg, eng, outs, launches,
                          reg, wall, sc)
        st.update(build_s=build_s, weight_bytes=qbytes, expert_bytes=ebytes,
                  build_peak_bytes=build_peak,
                  peak_bytes=torch.cuda.max_memory_allocated(),
                  m_tiles_executed=executed, m_tiles_total=total)
        mixtral_stats[name] = st
        log(f"[mixtral] {name}: m-tiles executed/total {executed:g}/"
            f"{total:g}; peak allocated while serving "
            f"{st['peak_bytes'] / 1e9:.2f} GB")
        del eng, mq
        gc.collect()
        torch.cuda.empty_cache()
    missing = sorted(k for k, n in launches_total.items() if n <= 0)
    if missing:
        raise AssertionError(f"kernels never launched on a served path: "
                             f"{missing}")

    # -- 9. report ----------------------------------------------------------------
    meta = {
        "act_quant": ("src/repro_torch/csrc/act_quant.cu",
                      "src/repro/kernels/act_quant.py:44", [4, 4096]),
        "w4a8_gemm_is": ("src/repro_torch/csrc/w4a8_gemm_is.cu",
                         "src/repro/kernels/w4a8_gemm.py:112",
                         [4, 4096, 11008]),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:85",
                            [1, 128, 32, 128]),
        "w4a8_gemm_fs": ("src/repro_torch/csrc/w4a8_gemm_fs.cu",
                         "src/repro/kernels/w4a8_gemm_fscale.py:52",
                         [4, 4096, 11008]),
        "w4a16_gemm": ("src/repro_torch/csrc/w4a16_gemm.cu",
                       "src/repro/kernels/w4a16_gemm.py:63",
                       [4, 4096, 11008]),
        "moe_w4a8_is": ("src/repro_torch/csrc/moe_w4a8_is.cu",
                        "src/repro/kernels/moe_gemm.py:437",
                        [MOE_E, 8, 4096, 14336]),
        "moe_w4a8_fs": ("src/repro_torch/csrc/moe_w4a8_fs.cu",
                        "src/repro/kernels/moe_gemm.py:437",
                        [MOE_E, 8, 4096, 14336]),
        "moe_w4a16": ("src/repro_torch/csrc/moe_w4a16.cu",
                      "src/repro/kernels/moe_gemm.py:589",
                      [MOE_E, 8, 4096, 14336]),
    }
    kernels = []
    for name, (src, replaces, shape) in meta.items():
        r = next(r for r in rows if r["kernel"] == name and r["shape"] == shape
                 and r["variant"] in ("", "fine"))
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches_total[name],
            "max_abs_err": errs[name], "max_abs_diff": errs[name],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "bf16_matmul_ms": r["bf16_matmul_ms"], "shape": shape})
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "torch": torch.__version__, "kernels": kernels,
        "shapes": rows, "serve": serve_stats, "breaker_drill": drill,
        "launches_total": launches_total,
        "profile": {"device_ms": prof_total, "top": prof_top},
        "check": {"plain_logit_rel": rel, "plain_layers": PLAIN_CHECK_LAYERS,
                  "plain_cpu_s": cpu_s, "mixtral_plain_logit_rel": mrel,
                  "mixtral_plain_layers": MIXTRAL_PLAIN_CHECK_LAYERS,
                  "mixtral_plain_cpu_s": mcpu_s},
        "mixtral": mixtral_stats,
        "seconds": time.perf_counter() - t_start,
    }, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
