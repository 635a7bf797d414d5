"""Training loop: data -> train_step -> checkpoints, fault-tolerant.
Port of ``repro/launch/train.py``.

The reference's loop: deterministic synthetic batches
(``data.pipeline.SyntheticPipeline``), a heartbeat per step and
deterministic failure injection (``distributed.fault``), async atomic
checkpoints every ``ckpt_every`` steps and in ``finally``, and
restart-from-latest when ``ckpt_dir`` holds a checkpoint. The step is
``training.train_step.make_train_step``; params and optimizer state stay
on ``device`` (the GPU unless the caller asks for another) and are
updated in place.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 200 \
        --ckpt /tmp/ck                                  # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 3 --batch 2 --seq 32 --ckpt /tmp/ck     # plain versions, CPU
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import ptq
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.distributed.fault import FailureInjector, Heartbeat
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.nn import spec as S
from repro_torch.training import optimizer as O
from repro_torch.training.train_step import make_train_step


def train_loop(
    cfg: ModelConfig,
    data_cfg: DataConfig,
    opt_cfg: O.AdamWConfig,
    *,
    steps: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    seed: int = 0,
    log_every: int = 10,
    fail_at_step: int | None = None,
    grad_accum: int = 1,
    log_fn=print,
    device=None,
):
    """Returns (params, opt_state, history). Restarts from the latest
    checkpoint in ckpt_dir if one exists (fault tolerance drill), else
    draws the params from ``seed`` (``core.ptq.materialize_by_layer``)
    and starts the optimizer state at zero."""
    dev = S.resolve_device(device)
    api = get_model(cfg)
    pspecs = api.param_specs(cfg, None)
    ospecs = O.state_specs(pspecs)
    pipe = SyntheticPipeline(data_cfg)
    step_fn = make_train_step(api, cfg, opt_cfg, grad_accum=grad_accum)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    injector = FailureInjector(fail_at_step)
    hb = Heartbeat()

    start = 0
    if mgr and mgr.latest_step() is not None:
        start = mgr.latest_step()
        state, meta = mgr.restore(start, {"params": pspecs, "opt": ospecs},
                                  device=dev)
        params, opt_state = state["params"], state["opt"]
        log_fn(f"[train] restored checkpoint at step {start}")
    else:
        params = ptq.materialize_by_layer(api, cfg, seed=seed, device=dev)
        opt_state = S.materialize(ospecs, device=dev)

    history = []
    try:
        for step in range(start, steps):
            injector.maybe_fail(step)
            hb.start()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.global_batch(step).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = hb.stop(step)
            history.append({"step": step, "loss": loss, "dt": dt})
            if step % log_every == 0 or step == steps - 1:
                log_fn(f"[train] step {step:5d} loss {loss:.4f} "
                       f"({dt:.2f}s/step)")
            if mgr and ((step + 1) % ckpt_every == 0 or step == steps - 1):
                mgr.save_async(step + 1,
                               {"params": params, "opt": opt_state},
                               meta={"loss": loss})
    finally:
        # preemption safety: never lose an in-flight checkpoint, even when
        # a node failure (or injected drill) aborts the loop mid-step
        if mgr:
            mgr.wait()
    return params, opt_state, history


def main(argv: list[str] | None = None) -> None:
    from repro_torch.configs.paper_llama import tiny_lm

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="results/tiny_lm_ckpt")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg = tiny_lm()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          batch_size=args.batch)
    opt_cfg = O.AdamWConfig(lr=args.lr, warmup_steps=20,
                            total_steps=args.steps)
    t0 = time.time()
    _, _, hist = train_loop(cfg, data_cfg, opt_cfg, steps=args.steps,
                            ckpt_dir=args.ckpt, device=args.device)
    print(f"[train] done in {time.time()-t0:.0f}s; "
          f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
