"""Serving CLI: build a model, quantize it per recipe (RTN), run the
continuous-batching engine over a stream of requests. Port of
``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --scale-mode float --requests 8            # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch llama2-7b --smoke --a-bits 16       # plain versions, CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mixtral-8x7b --smoke                # MoE, plain versions
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch xlstm-1.3b --smoke                  # recurrent, plain versions

The engine refuses the VLM and Whisper (they read a ``memory`` it does not
pass) and RecurrentGemma (its decode takes one scalar position, the
engine's one per slot), as the reference's cannot serve them either; the
CLI exits with the reason before building anything.

The recipe flags (``--scale-mode``, ``--w-bits``, ``--a-bits``,
``--group``, ``--amplifier``, ``--algo``, ``--fp``) choose among the
paper's schemes: W4A8 Integer Scale (the default), float scale
(``--scale-mode float``), coarse per-channel (``--group -1``) and W4A16
weight-only (``--a-bits 16``), each under RTN, GPTQ, AWQ, SmoothQuant or
OmniQuant (``--algo``). The paper's LLaMA-3 recipe
(``core.recipe.LLAMA3_RECIPE``) is reached through the API, as in the
reference: ``Engine(..., recipe=LLAMA3_RECIPE)`` over
``core.ptq.post_training_quantize`` (``chip_smoke.py``'s ``[llama3]``
phase). With weights on the card every quantized linear launches its
Hopper kernel; with ``--device cpu`` the kernels' plain versions run.

``--arch bench-lm`` (the default) is a random init of the reference's
~30M benchmark LM, reported as ``trained=False``: the reference loads a
trained checkpoint through ``benchmarks.common``, which is outside the
port and absent from the repo. Registry architectures run at their
published widths unless ``--smoke`` is given. Weights are random, drawn
block by block from generators seeded per block (``core.ptq``). As in
the reference, only ``--arch bench-lm`` is calibrated (one batch of 8 x
128 synthetic tokens, ``data.pipeline.calib_batches``): its fp weights
are drawn whole and quantized with the calibration rows. Every other
arch is quantized one block at a time without calibration (the
calibration algorithms fall back to RTN there, rotation applies), so
Mixtral-8x7B, whose 93 GB of bf16 weights exceed the card, never holds
more than one block's fp weights (about 2.9 GB) on it.

``--metrics-out PATH`` writes the run's telemetry as JSONL (one event per
line, then a ``{"snapshot": ...}`` line); ``--trace-out PATH`` writes the
same event log as a Perfetto timeline; ``--profile-dir DIR`` wraps the
serving loop in a ``torch.profiler`` window that writes a Chrome trace.
Telemetry is flushed and the telemetry cell, with the outcome
conservation law, is printed in a ``finally`` block, so a run that raises
still leaves them. On the card the engine captures prefill and decode
once each as CUDA graphs and replays them (``serving/graphs.py``); on the
CPU the same static-buffer steps run eagerly. The run summary prints the
capture counts, and the run asserts the reference's steady-state
contract ``decode_traces == 1 + fallbacks``: a recapture outside a
breaker fallback fails the run.

Robustness flags map onto ``ServeConfig``: ``--deadline-s``,
``--max-queue``, ``--truncate-prompts``, ``--breaker-threshold``;
``--chaos-nan-ticks`` / ``--chaos-kernel-ticks`` arm the
``repro_torch.serving.chaos`` fault drill. The reference's
``--kernel-mode`` and ``--fallback-kernel-mode`` have no counterpart: the
tensor's device is the port's only kernel switch.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import obs
from repro_torch.core import ptq
from repro_torch.core.recipe import QuantRecipe, QuantSpec
from repro_torch.data.pipeline import (DataConfig, SyntheticPipeline,
                                       calib_batches)
from repro_torch.serving.engine import Engine, ServeConfig, refusal


def _load_model(arch: str, smoke: bool, device: str, recipe):
    """(api, cfg, params, trained): random weights from seed 0 on
    ``device``, quantized under ``recipe`` (fp if None): the bench LM
    whole, with one calibration batch; any other arch block by block,
    without calibration."""
    from repro_torch.configs.paper_llama import bench_lm
    from repro_torch.models.registry import get_arch, get_model

    cfg = bench_lm() if arch == "bench-lm" else get_arch(arch, smoke=smoke)
    why = refusal(cfg)
    if why is not None:  # before building anything
        raise SystemExit(why)
    api = get_model(cfg)
    if recipe is None:
        params = ptq.materialize_by_layer(api, cfg, device=device)
    elif arch == "bench-lm":
        params = ptq.post_training_quantize(
            api, cfg, ptq.materialize_by_layer(api, cfg, device=device),
            recipe, calib_batches(1))
    else:
        params = ptq.quantize_by_layer(api, cfg, recipe, device=device)
    return api, cfg, params, False


def _fmt_hist(h: dict) -> str:
    n = h["count"]
    if not n:
        return "n=0"
    out = f"n={n} mean={h['sum'] / n * 1e3:.2f}ms"
    q = h.get("quantiles")
    if q:
        out += (f" p50={q['p50'] * 1e3:.2f}ms p95={q['p95'] * 1e3:.2f}ms"
                f" p99={q['p99'] * 1e3:.2f}ms")
    return out


def _telemetry_cell(reg: obs.Registry) -> bool:
    """Print the run's telemetry summary; returns whether the outcome
    conservation law holds (outcomes sum to submitted requests)."""
    snap = reg.snapshot()
    c, g, h = snap["counters"], snap["gauges"], snap["histograms"]

    def csum(name: str) -> float:
        return sum(c.get(name, {}).values())

    print("[serve] --- telemetry ---------------------------------------")
    print(f"[serve] ticks={int(csum('engine_ticks_total'))} "
          f"tokens={int(csum('engine_tokens_total'))} "
          f"requests={c.get('engine_requests_total', {})} "
          f"queue_depth={g.get('engine_queue_depth', {}).get('', 0)}")
    outcomes = c.get("engine_request_outcomes_total", {})
    submitted = c.get("engine_requests_total", {}).get(
        'event="submitted"', 0)
    conserved = sum(outcomes.values()) == submitted
    pretty = {k: int(v) for k, v in sorted(outcomes.items())}
    print(f"[serve] outcomes={pretty} submitted={int(submitted)} "
          f"conserved={'yes' if conserved else 'NO'}")
    if csum("engine_fallback_events_total"):
        print(f"[serve] breaker fallbacks="
              f"{c.get('engine_fallback_events_total', {})} "
              f"kernel_failures="
              f"{c.get('engine_kernel_failures_total', {})}")
    if csum("engine_slow_ticks_total"):
        print(f"[serve] slow_ticks={int(csum('engine_slow_ticks_total'))}")
    phases = h.get("engine_phase_seconds", {})
    for sk in sorted(phases):
        print(f"[serve] phase {sk or '<all>'}: {_fmt_hist(phases[sk])}")
    # device-time attribution: host phase span minus this = host overhead
    for sk, st in sorted(h.get("engine_phase_device_seconds", {}).items()):
        print(f"[serve] device {sk or '<all>'}: {_fmt_hist(st)}")
    for name in ("engine_ttft_seconds", "engine_tpot_seconds"):
        for sk, st in h.get(name, {}).items():
            print(f"[serve] {name}{('{' + sk + '}') if sk else ''}: "
                  f"{_fmt_hist(st)}")
    tiles = c.get("engine_moe_m_tiles_total", {})
    if tiles:
        ex = tiles.get('kind="executed"', 0)
        tot = tiles.get('kind="total"', 0)
        frac = f" ({ex / tot:.2f}x dense)" if tot else ""
        print(f"[serve] moe m-tiles executed/total={int(ex)}/{int(tot)}"
              f"{frac}")
    if c.get("qgemm_calls_total"):
        print(f"[serve] qgemm_calls_total: {c['qgemm_calls_total']}")
    print(f"[serve] alpha_cap_events_total="
          f"{int(csum('alpha_cap_events_total'))} "
          f"amax_floor_hits={c.get('amax_floor_hits_total', {})}")
    return conserved


def _ticks(spec: str) -> list[int]:
    return [int(t) for t in spec.split(",") if t]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="--kernel-mode and --fallback-kernel-mode of the reference "
               "CLI have no counterpart: the tensor's device (--device) is "
               "the port's only kernel switch.")
    ap.add_argument("--arch", default="bench-lm",
                    help="bench-lm (random init of the ~30M benchmark LM) "
                         "or a registry architecture, e.g. llama2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="run a registry architecture at its smoke shape")
    ap.add_argument("--device", default="cuda",
                    help="where weights and kernels run (cpu: the "
                         "kernels' plain versions)")
    ap.add_argument("--algo", default="rtn",
                    choices=["rtn", "gptq", "awq", "smoothquant",
                             "omniquant"])
    ap.add_argument("--scale-mode", default="integer",
                    choices=["integer", "float"])
    ap.add_argument("--w-bits", type=int, default=4)
    ap.add_argument("--a-bits", type=int, default=8)
    ap.add_argument("--group", type=int, default=128,
                    help="quantization group size (-1 = per channel)")
    ap.add_argument("--amplifier", default="1024")
    ap.add_argument("--fp", action="store_true",
                    help="serve unquantized (baseline)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--prefill-len", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request deadline in seconds (0 = none); "
                         "overruns retire with outcome=timeout")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="admission queue bound (0 = unbounded); surplus "
                         "submits are rejected (backpressure)")
    ap.add_argument("--truncate-prompts", action="store_true",
                    help="opt into clipping over-length prompts to "
                         "prefill-len instead of rejecting them")
    ap.add_argument("--breaker-threshold", type=int, default=3,
                    help="consecutive kernel failures / poisoned ticks "
                         "that trip the circuit breaker (no fallback "
                         "parameter set here, so a trip aborts)")
    ap.add_argument("--chaos-nan-ticks", default="",
                    help="comma-separated decode ticks at which to inject "
                         "NaN logits into every active slot")
    ap.add_argument("--chaos-kernel-ticks", default="",
                    help="comma-separated decode ticks at which to inject "
                         "one kernel exception")
    ap.add_argument("--metrics-out", default="",
                    help="write telemetry JSONL (events + final snapshot "
                         "line) to this path")
    ap.add_argument("--trace-out", default="",
                    help="write a Perfetto/chrome://tracing timeline JSON "
                         "of the run to this path")
    ap.add_argument("--profile-dir", default="",
                    help="capture a torch.profiler Chrome trace of the "
                         "serving loop into this directory")
    args = ap.parse_args(argv)

    reg = obs.current_registry()
    recipe = None
    if not args.fp:
        amp = (args.amplifier if not args.amplifier.isdigit()
               else int(args.amplifier))
        spec = QuantSpec(w_bits=args.w_bits, a_bits=args.a_bits,
                         group_size=args.group, scale_mode=args.scale_mode,
                         amplifier=amp, algo=args.algo)
        recipe = QuantRecipe(rules=(("*", spec),), name=spec.name)
    t0 = time.time()
    api, cfg, qparams, trained = _load_model(args.arch, args.smoke,
                                             args.device, recipe)
    print(f"[serve] model={cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} trained={trained} device={args.device}")
    if recipe is not None:
        how = ("with calibration" if args.arch == "bench-lm"
               else "block by block")
        print(f"[serve] quantized ({recipe.name}) {how} in "
              f"{time.time() - t0:.1f}s")

    sc = ServeConfig(max_slots=args.slots, max_seq=args.max_seq,
                     prefill_len=args.prefill_len,
                     max_new_tokens=args.max_new,
                     temperature=args.temperature,
                     deadline_s=args.deadline_s,
                     max_queue=args.max_queue,
                     truncate_prompts=args.truncate_prompts,
                     breaker_threshold=args.breaker_threshold)
    eng = Engine(api, cfg, qparams, sc, recipe=recipe)
    if args.chaos_nan_ticks or args.chaos_kernel_ticks:
        from repro_torch.serving import chaos

        chaos.ChaosMonkey(chaos.ChaosConfig(
            nan_logits=tuple(chaos.NanFault(tick=t)
                             for t in _ticks(args.chaos_nan_ticks)),
            kernel_failures=tuple(chaos.KernelFault(tick=t)
                                  for t in _ticks(args.chaos_kernel_ticks)),
        )).install(eng)
        print(f"[serve] chaos armed: nan_ticks=[{args.chaos_nan_ticks}] "
              f"kernel_ticks=[{args.chaos_kernel_ticks}]")
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=args.prefill_len,
                                        batch_size=1))
    for i in range(args.requests):
        eng.submit(pipe.batch(300_000 + i)["tokens"][0].tolist())
    # flush-on-failure: the event log + snapshot (and the timeline) are
    # written even when a tick raises
    conserved = False
    try:
        with obs.trace_window(args.profile_dir or None):
            t0 = time.time()
            outs = eng.run()
            dt = time.time() - t0
        total = sum(len(v) for v in outs.values())
        print(f"[serve] {len(outs)} requests, {total} tokens in {dt:.1f}s "
              f"({total / dt:.1f} tok/s, {eng.ticks} decode ticks, "
              f"{eng.fallbacks} breaker fallbacks)")
        kind = "captures" if eng.device.type == "cuda" else "establishments"
        print(f"[serve] step {kind}: prefill_traces={eng.prefill_traces} "
              f"decode_traces={eng.decode_traces}")
        for rid in sorted(outs)[:4]:
            print(f"[serve] r{rid}: {outs[rid][:16]}...")
        # steady-state decode captures exactly once per established
        # parameter set (each breaker fallback captures once more)
        if eng.decode_traces != 1 + eng.fallbacks:
            raise RuntimeError(f"decode captured {eng.decode_traces}x with "
                               f"{eng.fallbacks} fallbacks")
    finally:
        eng.close()
        conserved = _telemetry_cell(reg)
        if args.metrics_out:
            n = reg.write_events_jsonl(args.metrics_out)
            print(f"[serve] wrote {n} telemetry lines -> {args.metrics_out}")
        if args.trace_out:
            n = obs.write_trace(args.trace_out, reg)
            print(f"[serve] wrote {n} trace events -> {args.trace_out} "
                  "(open at https://ui.perfetto.dev)")
        if args.profile_dir:
            print(f"[serve] torch.profiler trace -> {args.profile_dir}")
    if not conserved:
        raise RuntimeError("outcome conservation law violated: outcomes do "
                           "not sum to submitted requests")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
