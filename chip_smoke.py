#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build every kernel of the path from ``src/repro_torch/csrc`` (one nvcc
   per source, started together) and print the build time.
3. Hold each kernel against its plain PyTorch version on the card at the
   main-path shapes of LLaMA-2-7B (W4A8 g128: decode M 1..4 and prefill
   M 128 for (K, N) in (4096, 4096), (4096, 11008), (11008, 4096);
   flash attention at 128 tokens, 32 heads of 128) and time kernel,
   plain version and, where one exists, a single PyTorch library call.
   Each is timed as a CUDA graph of back-to-back calls, replayed between
   CUDA events, so the host cannot pace a microsecond kernel. act_quant
   and the IS GEMM must be bit-exact; flash attention must be within
   ``TOLERANCE`` (bf16 output).
4. Build ``llama2-7b`` at its full published widths (32 layers) in bf16
   from a seeded generator on the card and RTN-quantize every linear with
   W4A8, g=128, Integer Scale, alpha=1024.
5. Serve 8 seeded prompts (lengths 16..128) through ``Engine.submit`` /
   ``Engine.run`` with 4 slots, prefill_len 128, max_seq 256 and 32 new
   tokens; the weights are on the card, so every quantized linear and
   every prefill attention launches its kernel. Every outcome must be
   ``ok`` and every kernel's launch count (zeroed just before the run)
   must be > 0. Then one prompt: the full model's logits on the card
   must give the engine's first token, and the first layers, copied to
   the CPU where every wrapper takes its plain version, must agree with
   the same layers on the card within a stated bound. Last, one batched
   decode step is timed eagerly and as a replayed CUDA graph: the
   difference is the host's share of a decode tick.
6. Print the ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

Per-shape numbers also go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
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
# rotate weight copies so the timed launches read them from device memory,
# as the serving path does (the 50 MB L2 cannot hold a layer's weights
# across a decode tick of 32 layers)
ROTATE_BYTES = 128 << 20
# logits of the first layers on the CPU (every wrapper's plain version)
# vs the same layers on the card (the kernels), relative to the largest
# logit: flash and plain attention differ by a bf16 ulp, and the CPU's
# elementwise ops by f32 ulps; each such difference can flip an int8
# activation code, and through all 32 random layers the flips grow to
# several percent of the logits, so the check stops after two layers
PLAIN_CHECK_LAYERS = 2
PLAIN_LOGIT_REL_TOL = 5e-2


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


def bound(bytes_moved: float, ops: float, ops_rate: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
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
            if M in (4, PREFILL_M):
                ms = time_ms(lambda a: act_quant(a), [(x,)])
                plain = time_ms(lambda a: act_quant_plain(a), [(x,)])
                b, by = bound(M * K * 2 + M * K + M * 4, 2 * M * K,
                              F32_FLOPS_PER_S)
                rows.append(dict(kernel="act_quant", shape=[M, K], ms=ms,
                                 plain_ms=plain, bound_ms=b, bound_by=by,
                                 library_ms=None))
    return err


def _gemm_operands(gen, M, K, N, w_bits=4, amplifier=1024, copies=1):
    import torch
    from repro_torch.core import integer_scale as isc
    from repro_torch.core import packing, quant
    from repro_torch.kernels.act_quant import act_quant_plain

    x = torch.randn((M, K), generator=gen, device="cuda")
    xq, sa = act_quant_plain(x)
    out = []
    for _ in range(copies):
        w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
        qw = quant.quantize_weight(w, w_bits, 128)
        isw = isc.integerize(qw, amplifier)
        qv = packing.pack_int4(qw.qvalue) if w_bits == 4 else qw.qvalue
        out.append((xq, sa, qv, isw.int_scale, float(isw.alpha)))
        del w, qw
    return out


def check_gemm(gen, rows):
    import torch
    from repro_torch.kernels.w4a8_gemm import (fg_gemm_integer_scale,
                                               fg_gemm_integer_scale_plain)

    def kern(xq, sa, qv, s, a, w_bits=4):
        return fg_gemm_integer_scale(xq, sa, qv, s, group_size=128, alpha=a,
                                     w_bits=w_bits)

    def plain(xq, sa, qv, s, a, w_bits=4):
        return fg_gemm_integer_scale_plain(xq, sa, qv, s, group_size=128,
                                           alpha=a, w_bits=w_bits)

    err = 0.0
    for K, N in GEMM_KN:
        wbytes = K * N // 2 + (K // 128) * N * 4
        copies = max(1, math.ceil(ROTATE_BYTES / wbytes))
        sets = _gemm_operands(gen, PREFILL_M, K, N, copies=copies)
        for M in (*DECODE_M, PREFILL_M):
            args = [(xq[:M].contiguous(), sa[:M].contiguous(), qv, s, a)
                    for xq, sa, qv, s, a in sets]
            yk, yp = kern(*args[0]), plain(*args[0])
            torch.cuda.synchronize()
            e = (yk - yp).abs().max().item()
            err = max(err, e)
            if not torch.equal(yk, yp):
                raise AssertionError(f"IS GEMM ({M},{K},{N}) not bit-exact: {e}")
            if M in (4, PREFILL_M):
                ms = time_ms(kern, args)
                pms = time_ms(plain, args[:2], iters=3, reps=3)
                b, by = bound(M * K + M * 4 + wbytes + M * N * 4,
                              2 * M * K * N, INT8_OPS_PER_S)
                rows.append(dict(kernel="w4a8_gemm_is", shape=[M, K, N],
                                 ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
                                 library_ms=None, copies=copies))
        del sets
    # W8A8 (unpacked int8 weights) through the same kernel
    xq, sa, qv, s, a = _gemm_operands(gen, 4, 4096, 4096, w_bits=8,
                                      amplifier="heuristic+6")[0]
    yk, yp = kern(xq, sa, qv, s, a, 8), plain(xq, sa, qv, s, a, 8)
    torch.cuda.synchronize()
    if not torch.equal(yk, yp):
        raise AssertionError("W8 IS GEMM not bit-exact")
    return err


def check_flash(gen, rows):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        TOLERANCE, flash_attention, flash_attention_plain)

    err = 0.0
    # (B, Sq, Hq, Hkv, D, window): the prefill shape, then GQA + window +
    # a ragged length
    for B, S, Hq, Hkv, D, win in ((1, 128, 32, 32, 128, None),
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
                *a, is_causal=True), [(qt, kt, vt)])
            pairs = S * (S + 1) // 2
            b, by = bound(4 * B * S * Hq * D * 2, 4 * B * Hq * pairs * D,
                          BF16_FLOPS_PER_S)
            rows.append(dict(kernel="flash_attention",
                             shape=[B, S, Hq, D], ms=ms, plain_ms=pms,
                             bound_ms=b, bound_by=by, library_ms=lib))
    return err


def build_model(api, cfg, recipe):
    import torch
    from repro_torch.core import ptq
    from repro_torch.nn import spec as S

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    fp = S.materialize(api.param_specs(cfg, None), gen, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    qparams = ptq.post_training_quantize(api, cfg, fp, recipe)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del fp
    torch.cuda.empty_cache()
    qbytes = sum(t.numel() * t.element_size()
                 for blk in qparams["blocks"] for t in _leaves(blk))
    allbytes = qbytes + sum(t.numel() * t.element_size()
                            for k, v in qparams.items() if k != "blocks"
                            for t in _leaves(v))
    log(f"[model] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; random bf16 "
        f"weights {t1 - t0:.2f} s, RTN W4A8-IS g128 quantize {t2 - t1:.2f} s")
    log(f"[model] quantized linears {qbytes / 1e9:.3f} GB, all weights "
        f"{allbytes / 1e9:.3f} GB")
    return qparams


def time_decode_step(api, cfg, model, sc, reps=5):
    """ms of one batched decode step at position 100 in every slot: eager
    calls between CUDA events, and the same call captured as a CUDA graph
    and replayed. The graph's time is the device's; the difference is the
    host time the eager step adds."""
    import torch
    from repro_torch.nn import spec as S

    B = sc.max_slots
    cache = S.materialize(api.cache_specs(cfg, B, sc.max_seq),
                          device="cuda")
    toks = torch.zeros((B, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((B,), 100, dtype=torch.int64, device="cuda")

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


def _leaves(tree):
    from repro_torch.nn import spec as S

    return S.leaves(tree)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a GPU", file=sys.stderr)
        return 2
    from repro_torch import obs
    from repro_torch.core.recipe import DEFAULT_RECIPE
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_arch, get_model
    from repro_torch.nn import spec as S
    from repro_torch.serving.engine import Engine, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
            "w4a8_gemm_is": check_gemm(gen, rows),
            "flash_attention": check_flash(gen, rows)}
    for r in rows:
        lib = r["library_ms"]
        log(f"[kernel] {r['kernel']} {r['shape']}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}), library "
            + ("-" if lib is None else f"{lib:.4f} ms"))

    # -- 4. llama2-7b at full width, RTN W4A8-IS ----------------------------------
    cfg = get_arch("llama2-7b")
    api = get_model(cfg)
    reg = obs.Registry()
    with obs.use_registry(reg):
        qparams = build_model(api, cfg, DEFAULT_RECIPE)
    caps = reg.counter("alpha_cap_events_total").total()
    log(f"[model] alpha caps: {caps:g} of "
        f"{reg.counter('quantized_layers_total', '', ('scheme',)).total():g}"
        " layers capped below the requested alpha 1024")

    # -- 5. serve -----------------------------------------------------------------
    sc = ServeConfig(max_slots=4, prefill_len=128, max_seq=256,
                     max_new_tokens=32)
    rng = np.random.default_rng(0)
    lengths = rng.integers(16, 129, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lengths]
    reg = obs.Registry()
    with obs.use_registry(reg):
        eng = Engine(api, cfg, qparams, sc, recipe=DEFAULT_RECIPE)
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
        raise AssertionError(f"requests not ok: {bad}")
    if any(len(outs[r]) != sc.max_new_tokens for r in rids):
        raise AssertionError("a request did not generate max_new_tokens")
    if not all(0 <= t < cfg.vocab_size for r in rids for t in outs[r]):
        raise AssertionError("token id out of range")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    ntok = sum(len(outs[r]) for r in rids)
    phase = reg.histogram("engine_phase_seconds", "", ("phase",))
    dec = phase.get(phase="decode")
    pre = phase.get(phase="prefill")
    ttft = reg.histogram("engine_ttft_seconds").get()
    log(f"[serve] {len(rids)} requests ok, {ntok} tokens in {wall:.3f} s = "
        f"{ntok / wall:.1f} tokens/s; {eng.ticks} decode ticks, "
        f"{dec['sum'] / dec['count'] * 1e3:.2f} ms per tick; prefill "
        f"{pre['sum'] / pre['count'] * 1e3:.2f} ms each; mean TTFT "
        f"{ttft['sum'] / ttft['count'] * 1e3:.1f} ms")
    log(f"[serve] launches during serving: {json.dumps(launches)}")

    # the kernels against the plain versions on the same weights, one prompt
    toks = torch.tensor([prompts[0] + [0] * (128 - len(prompts[0]))],
                        device="cuda")
    n0 = len(prompts[0])
    cut = dict(qparams, blocks=qparams["blocks"][:PLAIN_CHECK_LAYERS])
    c2 = dataclasses.replace(cfg, num_layers=PLAIN_CHECK_LAYERS)
    with torch.inference_mode():
        lk = api.build(cfg, qparams, DEFAULT_RECIPE)(toks)[0][0, n0 - 1]
        la = api.build(c2, cut, DEFAULT_RECIPE)(toks)[0][0, n0 - 1]
        t0 = time.perf_counter()
        on_cpu = S.tree_map(lambda t: t.cpu(), cut)
        lp = api.build(c2, on_cpu, DEFAULT_RECIPE)(toks.cpu())[0][0, n0 - 1]
        cpu_s = time.perf_counter() - t0
    if not torch.isfinite(lk).all():
        raise AssertionError("non-finite logits on the kernel path")
    if outs[rids[0]][0] != int(torch.argmax(lk)):
        raise AssertionError("the engine's first token for prompt 0 is not "
                             "the argmax of the model's logits")
    rel = ((la.cpu() - lp).abs().max() / lp.abs().max()).item()
    if not rel <= PLAIN_LOGIT_REL_TOL:
        raise AssertionError(f"kernels vs plain versions, first "
                             f"{PLAIN_CHECK_LAYERS} layers: logits rel {rel}")
    log(f"[check] prompt 0: the engine's first token is the argmax of the "
        f"model's logits; first {PLAIN_CHECK_LAYERS} layers, kernels on the "
        f"card vs plain versions on the CPU ({cpu_s:.1f} s): logits rel "
        f"{rel:.2e} (<= {PLAIN_LOGIT_REL_TOL})")

    # one batched decode step: eager (host-paced) vs replayed CUDA graph
    step_eager, step_graph = time_decode_step(api, cfg, eng.model, sc)
    log(f"[decode] one 4-slot decode step, {cfg.num_layers} layers: eager "
        f"{step_eager:.3f} ms, CUDA graph replay {step_graph:.3f} ms; device "
        f"idle share of the eager step {1 - step_graph / step_eager:.3f}")

    # -- 6. report ----------------------------------------------------------------
    meta = {
        "act_quant": ("src/repro_torch/csrc/act_quant.cu",
                      "src/repro/kernels/act_quant.py:44", [4, 4096]),
        "w4a8_gemm_is": ("src/repro_torch/csrc/w4a8_gemm_is.cu",
                         "src/repro/kernels/w4a8_gemm.py:112",
                         [4, 4096, 11008]),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:85",
                            [1, 128, 32, 128]),
    }
    kernels = []
    for name, (src, replaces, shape) in meta.items():
        r = next(r for r in rows if r["kernel"] == name and r["shape"] == shape)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "max_abs_diff": errs[name],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": shape})
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "torch": torch.__version__, "kernels": kernels,
        "shapes": rows, "serve": {
            "requests": len(rids), "tokens": ntok, "wall_s": wall,
            "ticks": eng.ticks, "decode_tick_s": dec["sum"] / dec["count"],
            "prefill_s": pre["sum"] / pre["count"],
            "ttft_mean_s": ttft["sum"] / ttft["count"],
            "launches": launches, "depth": cfg.num_layers},
        "decode_step_ms": {"eager": step_eager, "graph": step_graph},
        "check": {"plain_logit_rel": rel, "plain_layers": PLAIN_CHECK_LAYERS},
    }, indent=1))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
