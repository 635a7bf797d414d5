"""Multi-pod dry-run: every (arch x shape) cell laid out on the production
meshes and stepped once on ``meta`` tensors. Port of
``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
        --shape decode_32k --multi-pod both --out results.jsonl

Training cells step ``train_step`` (fp bf16 + AdamW); prefill/decode cells
the quantized serving step (the paper's W4A8 Integer Scale recipe), as the
reference's. It allocates nothing: params, AdamW state, cache and inputs
are ``meta`` tensors (``configs.shapes.input_specs``).

``--mesh production`` (the default) builds the (16, 16) ("data", "model")
or (2, 16, 16) ("pod", "data", "model") ``DeviceMesh`` over a ``"fake"``
process group of 256 or 512 ranks in this one process: the counterpart of
the reference's 512 placeholder devices. ``--mesh host`` lays the cells
out on the GPUs of the current group instead (``launch.mesh.
make_host_mesh``; one rank a GPU, a one-rank NCCL group when none is
open); it raises without a GPU.

Each JSONL record holds, per device, ``memory``: ``param_bytes``,
``opt_bytes``, ``cache_bytes``, ``input_bytes`` and ``argument_bytes``,
their sum, from each leaf's local shard shape under the rule tables'
placements (what XLA's ``argument_size_in_bytes`` counts; a decode cell's
0-d ``pos`` is an input, as the reference's argument); ``cost.
flops_counted``, the whole step's flops (every device's) as
``torch.utils.flop_counter.FlopCounterMode`` counts them over one step on
``meta`` (not XLA's per-device ``cost_analysis``); and, on serve cells, the
recipe's static overflow verdicts (``qcert``). The reference also counts
the collectives GSPMD inserts into the compiled HLO; the port has no
compiler that places them, so it records none (``--no-hlo`` skips the
traced step instead: memory only).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.shapes import (SHAPES, Shape, input_specs,
                                        memory_arg, shape_applicable)
from repro_torch.core.recipe import DEFAULT_RECIPE
from repro_torch.distributed import sharding as shard
from repro_torch.launch.mesh import (axis_sizes, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.registry import get_arch, get_model, list_archs
from repro_torch.nn import spec as S
from repro_torch.training import optimizer as O
from repro_torch.training.train_step import make_train_step


def fake_store():
    """A store for the ``"fake"`` backend. torch keeps it in a private
    test module with no stability promise (``torch.testing._internal.
    distributed.fake_pg``; importing it also registers the backend), so
    a torch that moved it is named here rather than failing deep in
    ``init_process_group``."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "--mesh production needs torch's \"fake\" process-group "
            "backend (torch.testing._internal.distributed.fake_pg."
            f"FakeStore), which torch {torch.__version__} does not "
            "provide; use --mesh host on a GPU") from e
    return FakeStore()


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``"fake"`` default process group of ``world_size`` ranks in this
    process (this one rank 0): collectives are no-ops, so a mesh of that
    many ranks can be built and laid out without a device."""
    import torch.distributed as dist

    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=fake_store())
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def host_group():
    """The current process group, or a one-rank NCCL group over this
    process's GPU while none is open."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    if not torch.cuda.is_available():
        raise RuntimeError("--mesh host: no CUDA device")
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.HashStore(),
                            device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in axis_sizes(mesh).values())


def shard_bytes(leaves_and_pspecs, sizes: dict) -> int:
    """Bytes of one device's shards: (shape, dtype, partition spec)s."""
    return sum(math.prod(S.local_shape(shape, p, sizes)) * dt.itemsize
               for shape, dt, p in leaves_and_pspecs)


def tree_shard_bytes(spec_tree, rules, sizes: dict) -> int:
    specs = S.leaves(spec_tree)
    pspecs = S.leaves(S.partition_specs(spec_tree, rules, sizes))
    return shard_bytes([(s.shape, s.dtype, p)
                        for s, p in zip(specs, pspecs)], sizes)


@dataclasses.dataclass
class Cell:
    """A cell laid out on a mesh: its config and mode, each device's
    bytes, and ``step()``, which runs the cell's step once on ``meta``
    tensors."""
    cfg: object
    mode: str
    memory: dict
    step: object


def _shape(shape) -> Shape:
    return SHAPES[shape] if isinstance(shape, str) else shape


def build_cell(arch, shape, mesh, multi_pod: bool) -> Cell:
    """``arch``: a name in the registry or a ``ModelConfig`` (the flop
    counts' reduced-depth probes); ``shape``: a name in ``SHAPES`` or a
    :class:`Shape`."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shp = _shape(shape)
    sizes = axis_sizes(mesh)
    data_ways = sizes.get("pod", 1) * sizes["data"]
    if cfg.num_experts:
        g = data_ways if (shp.batch * (shp.seq if shp.kind == "train" else 1)
                          ) % data_ways == 0 else 1
        cfg = dataclasses.replace(cfg, dispatch_groups=g)
    api = get_model(cfg)
    mode = shp.kind
    recipe = None if mode == "train" else DEFAULT_RECIPE
    rules = shard.rules_for(mode, multi_pod)
    pspecs = api.param_specs(cfg, recipe)
    inputs = input_specs(cfg, shp)
    if mode == "decode":  # one new token at a scalar position
        inputs["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    ipspecs = shard.input_pspecs(mesh, inputs, multi_pod)
    memory = {"param_bytes": tree_shard_bytes(pspecs, rules, sizes),
              "opt_bytes": 0, "cache_bytes": 0,
              "input_bytes": shard_bytes(
                  [(tuple(v.shape), v.dtype, ipspecs[k])
                   for k, v in inputs.items()], sizes)}
    mem = memory_arg(cfg, inputs)

    if mode == "train":
        ospecs = O.state_specs(pspecs)
        memory["opt_bytes"] = tree_shard_bytes(ospecs, rules, sizes)
        train_step = make_train_step(api, cfg, O.AdamWConfig())

        def step():
            return train_step(S.abstract(pspecs), S.abstract(ospecs), inputs)
    else:
        cspecs = api.cache_specs(cfg, shp.batch, shp.seq)
        memory["cache_bytes"] = tree_shard_bytes(cspecs, rules, sizes)

        # decode: one new token at the cache's last slot (a python int:
        # ``meta`` holds no value to read a position from)
        pos = 0 if mode == "prefill" else shp.seq - 1

        def step():
            model = api.build(cfg, S.abstract(pspecs), recipe)
            with torch.no_grad():
                logits, cache, _ = model(
                    inputs["tokens"], mode=mode, cache=S.abstract(cspecs),
                    pos=pos, memory=mem)
            return logits[:, -1], cache

    memory["argument_bytes"] = sum(memory.values())
    return Cell(cfg, mode, memory, step)


def count_flops(step) -> int:
    """The flops ``FlopCounterMode`` counts over one call of ``step``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        step()
    return int(fc.get_total_flops())


# On ``meta`` each op costs about half a millisecond of host time, and
# the port steps some loops in python where the reference's lower to one
# XLA loop: xLSTM's recurrences token by token, MLA's prefill attention
# chunk pair by chunk pair, and every model layer by layer. So a full
# cell's step is counted where its flops are exactly affine in what it
# loops over, and carried to the cell: in the number of repeats R of the
# layer pattern (every repeat is the same layers on the same shapes; the
# probes keep the layer kinds of the full depth's first layers), and
# for xLSTM's scan mLSTM in the sequence length too (each token's work is
# the same at every position: counted at SEQ_PROBE and 2 x SEQ_PROBE
# tokens). The chunked mLSTM is not affine in length (each chunk's
# intra-chunk work grows as its length squared), so it is counted at the
# cell's own length.
SEQ_PROBE = 16


def _depth_probes(cfg) -> tuple[int, int, int] | None:
    """(L1, L2, R): the layer counts of 1 and 2 repeats of the layer
    pattern after the prefix, and the full config's repeats; None where
    a direct count is as quick (R < 3) or the family has no single
    layer stack (the encoder-decoder)."""
    from repro_torch import convert

    if cfg.family == "audio":
        return None
    api = get_model(cfg)
    kinds = convert.layer_kinds_of(api.param_specs(cfg, None)["blocks"])
    prefix, pattern, R = convert.reference_split(kinds, cfg)
    if R < 3:
        return None
    Ls = (len(prefix) + len(pattern), len(prefix) + 2 * len(pattern))
    for L in Ls:
        c = dataclasses.replace(cfg, num_layers=L)
        if convert.layer_kinds_of(get_model(c).param_specs(c, None)[
                "blocks"]) != kinds[:L]:
            return None
    return (*Ls, R)


def cell_flops(shp: Shape, mesh, multi_pod: bool, cell: Cell
               ) -> tuple[int, str]:
    """(the step's flops, how they were counted): one step, or steps at
    reduced depth and length carried to the cell (exact: see above)."""
    cfg = cell.cfg
    depth = _depth_probes(cfg)
    P = SEQ_PROBE
    by_seq = (cfg.family == "ssm" and cfg.mlstm_impl == "scan"
              and shp.kind != "decode" and shp.seq > 2 * P)
    if depth is None and not by_seq:
        return count_flops(cell.step), "one step"
    Ls = depth[:2] if depth else (None,)
    Ss = (P, 2 * P) if by_seq else (shp.seq,)
    f = {}
    for L in Ls:
        for S in Ss:
            c = cfg if L is None else dataclasses.replace(cfg, num_layers=L)
            f[L, S] = count_flops(build_cell(
                c, dataclasses.replace(shp, seq=S), mesh, multi_pod).step)
    (L1, L2), (S1, S2) = (Ls + Ls)[:2], (Ss + Ss)[:2]
    # bilinear in the repeats past the first and the tokens past S1:
    # exact where the step is affine in each
    r, t = (depth[2] - 1 if depth else 0), shp.seq - S1
    base = f[L1, S1]
    dr, ds = f[L2, S1] - base, f[L1, S2] - base
    drs = f[L2, S2] - f[L2, S1] - ds
    total = base + dr * r + (ds * t + drs * r * t) // (S2 - S1 or 1)
    how = []
    if depth:
        how.append(f"affine in layer repeats from {L1} and {L2} layers")
    if by_seq:
        how.append(f"affine in seq from {S1} and {S2} tokens")
    return total, "; ".join(how)


_VERDICT_RANK = ("fallback", "capped-alpha", "data-dependent", "certified",
                 "n/a")


def qcert_for(cfg) -> dict:
    """Static overflow verdicts for the serve recipe at this arch's
    contraction sizes (the port's certificates, no tensors). A width of 0
    (xLSTM has no ``d_ff``) is no contraction and is left out: the
    reference certifies K = 0 too, and its certificate raises there."""
    from repro_torch.core.recipe import certify_recipe

    dims = {"d_model": cfg.d_model, "d_ff": cfg.d_ff}
    if getattr(cfg, "moe_d_ff", 0):
        dims["moe_d_ff"] = cfg.moe_d_ff
    return certify_recipe(DEFAULT_RECIPE, {k: v for k, v in dims.items()
                                           if v})


def _qcert_worst(verdicts: dict) -> str:
    real = [v for v in verdicts.values() if v != "n/a"]
    if not real:
        return "n/a"
    return min(real, key=_VERDICT_RANK.index)


def run_cell(arch: str, shape, mesh, multi_pod: bool,
             collect_hlo: bool = True) -> dict:
    shp = _shape(shape)
    rec: dict = {"arch": arch, "shape": shp.name, "mesh": mesh_name(mesh),
                 "multi_pod": multi_pod}
    cfg = get_arch(arch)
    ok, reason = shape_applicable(cfg, shp)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.time()
    try:
        cell = build_cell(arch, shp, mesh, multi_pod)
        cost = {}
        if collect_hlo:
            cost["flops_counted"], cost["flops_from"] = cell_flops(
                shp, mesh, multi_pod, cell)
        rec.update(status="ok", trace_s=round(time.time() - t0, 1),
                   param_count=cell.cfg.param_count_estimate(),
                   memory=cell.memory, cost=cost)
        if shp.kind != "train":
            # serve cells run the quantized recipe: attach the static
            # overflow-certificate verdicts for its contraction sizes
            rec["qcert"] = qcert_for(cell.cfg)
            rec["qcert_worst"] = _qcert_worst(rec["qcert"])
    except Exception as e:  # noqa: BLE001 (record and continue the sweep)
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec


def _mesh_for(kind: str, multi_pod: bool):
    if kind == "host":
        return make_host_mesh()
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mesh", default="production",
                    choices=["production", "host"])
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--no-hlo", action="store_true",
                    help="skip the traced step (memory only)")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]
    if args.mesh == "host":
        pods = [False]  # the host mesh has no pod axis

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_ok = n_skip = n_err = 0
    with open(args.out, "a") as f:
        for mp in pods:
            group = (host_group() if args.mesh == "host"
                     else fake_group(512 if mp else 256))
            with group:
                mesh = _mesh_for(args.mesh, mp)
                for arch in archs:
                    for shape in shapes:
                        rec = run_cell(arch, shape, mesh, mp,
                                       collect_hlo=not args.no_hlo)
                        f.write(json.dumps(rec) + "\n")
                        f.flush()
                        tag = rec["status"]
                        n_ok += tag == "ok"
                        n_skip += tag == "skipped"
                        n_err += tag == "error"
                        msg = rec.get("error", rec.get("reason", ""))[:90]
                        extra = ""
                        if tag == "ok":
                            gib = rec["memory"]["argument_bytes"] / 2**30
                            extra = f"args/dev={gib:.2f}GiB "
                            if "flops_counted" in rec["cost"]:
                                extra += (f"flops(step)="
                                          f"{rec['cost']['flops_counted']:.3g} ")
                            extra += f"trace={rec['trace_s']}s"
                            if "qcert_worst" in rec:
                                extra += f" qcert={rec['qcert_worst']}"
                        print(f"[{rec['mesh']}] {arch} x {shape}: {tag} "
                              f"{extra}{msg}", flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    _telemetry_cell()
    if n_err:
        raise SystemExit(1)


def _telemetry_cell() -> None:
    """Print the dry-run's registry snapshot: certificate verdicts, any
    quantization-health counters ticked while stepping the serve cells,
    and p50/p95/p99 for any ``*_seconds`` histograms."""
    from repro_torch import obs

    snap = obs.default_registry().snapshot()
    c = snap["counters"]
    cells = []
    for name in ("qcert_verdicts_total", "quantized_layers_total",
                 "alpha_cap_events_total", "int_scale_floor_hits_total",
                 "amax_floor_hits_total"):
        if c.get(name):
            cells.append(f"{name}={c[name]}")
    print("[dryrun] telemetry: " + ("; ".join(cells) if cells
                                    else "no counters ticked"))
    for name, series in sorted(snap["histograms"].items()):
        if not name.endswith("_seconds"):
            continue
        for sk, st in sorted(series.items()):
            if not st["count"]:
                continue
            q = st["quantiles"]
            print(f"[dryrun] {name}{{{sk}}}: n={st['count']} "
                  f"p50={q['p50'] * 1e3:.2f}ms "
                  f"p95={q['p95'] * 1e3:.2f}ms "
                  f"p99={q['p99'] * 1e3:.2f}ms")


if __name__ == "__main__":
    main()
