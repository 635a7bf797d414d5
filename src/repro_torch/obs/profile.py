"""Device-time attribution and opt-in profiler capture windows. Port of
``repro/obs/profile.py``.

The host wall-clock spans (``repro_torch.obs.tracing``) time whole tick
phases. This module adds the device side:

* :func:`device_timer` wraps a callable so every call is bracketed by
  ``torch.cuda.synchronize()`` on the registry clock (the counterpart of
  ``jax.block_until_ready``) and observed into a ``*_device_seconds``
  histogram on the *current* registry. The first ``warmup`` calls are
  excluded (they land in a ``*_device_warmup_total`` counter instead).
  In eager PyTorch the host enqueues each kernel as it goes, so this span
  still holds the host's launch time wherever the host is slower than the
  device: it bounds the device time from above, and equals it only once
  the wrapped call is a replayed CUDA graph. On CPU tensors there is
  nothing to synchronize and the span is plain wall-clock.
* :func:`trace_window` is the ``torch.profiler`` capture window behind
  ``launch/serve.py --profile-dir``: a no-op when the dir is falsy,
  otherwise it records CPU (and, with a GPU, CUDA) activity and writes a
  Chrome trace (``torch_trace_<time>_<pid>.json``) into the dir.

Both sit on the host side of the call; neither records from inside a
captured region. ``torch`` is imported lazily so ``repro_torch.obs``
itself stays stdlib-only.
"""
from __future__ import annotations

import contextlib
import os
import time

from .metrics import DEFAULT_LATENCY_BUCKETS, current_registry


def _on_cuda(tree) -> bool:
    """Whether any tensor in a (nested) tuple/list/dict lies on a GPU."""
    if isinstance(tree, (tuple, list)):
        return any(_on_cuda(v) for v in tree)
    if isinstance(tree, dict):
        return any(_on_cuda(v) for v in tree.values())
    return getattr(tree, "is_cuda", False) is True


def device_timer(fn, metric: str, *, warmup: int = 1, help: str = "",
                 **labels):
    """Wrap ``fn`` with synchronize-bracketed device timing.

    ``metric`` must end in ``_device_seconds`` (the naming contract that
    pairs it with the host ``*_seconds`` span histogram). The registry is
    resolved per call via :func:`current_registry`, and its clock is used
    (a fake clock drives deterministic tests end to end).
    """
    if not metric.endswith("_device_seconds"):
        raise ValueError(
            f"device_timer metric {metric!r} must end '_device_seconds'")
    warm_metric = metric[: -len("_device_seconds")] + "_device_warmup_total"
    state = {"calls": 0}

    def timed(*args, **kwargs):
        sync = _on_cuda((args, kwargs))
        if sync:
            import torch

            torch.cuda.synchronize()
        reg = current_registry()
        t0 = reg.now()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        dt = reg.now() - t0
        state["calls"] += 1
        if state["calls"] > warmup:
            reg.histogram(metric, help, tuple(sorted(labels)),
                          buckets=DEFAULT_LATENCY_BUCKETS,
                          ).observe(dt, **labels)
        else:
            reg.counter(warm_metric,
                        "device_timer calls excluded as warmup",
                        tuple(sorted(labels))).inc(**labels)
        return out

    timed.calls = lambda: state["calls"]
    timed.__wrapped__ = fn
    return timed


@contextlib.contextmanager
def trace_window(log_dir: str | None):
    """Opt-in ``torch.profiler`` capture: no-op (yields None) when
    ``log_dir`` is falsy, else profile the enclosed block, yield the
    profiler (``key_averages()`` is readable after the block) and write a
    Chrome trace into ``log_dir``."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    stamp = time.strftime("%Y%m%d-%H%M%S")
    prof.export_chrome_trace(
        os.path.join(log_dir, f"torch_trace_{stamp}_{os.getpid()}.json"))
