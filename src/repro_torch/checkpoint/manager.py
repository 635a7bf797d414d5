"""Fault-tolerant checkpointing: atomic, async, retained. Port of
``repro/checkpoint/manager.py``, on the same file format, so each package
reads the other's files.

* atomic: write to ``<dir>/tmp.<step>.<pid>`` then ``os.replace`` -> a
  crash mid-save never corrupts the latest checkpoint.
* async: ``save_async`` snapshots to host memory synchronously and writes
  in a background thread; ``wait`` joins it and re-raises its error.
* retention: keep the most recent ``keep`` checkpoints.
* restore: ``restore(step, template, device=)`` fills the template's
  structure with tensors on ``device`` (the reference's ``shardings=``
  re-shards onto a mesh; that comes with the sharding slice).

Storage: one ``ckpt_%08d.npz`` per checkpoint, flat ``a/b/0/c`` keys (dict
keys and list indices joined by ``/``), bf16 stored as its uint16 bits
and listed in ``__meta__["__viewed__"]``, the meta JSON under
``__meta__``. A tree is written as it is laid out: the port's param tree
keeps one entry per layer (``params/blocks/<i>/...``), the reference's a
stacked one (``params/blocks/s0/...``); ``repro_torch.convert`` carries
params and optimizer state between the two layouts.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.nn import spec as S

# dtypes numpy can't serialize natively -> stored as a same-width uint view
_VIEWED = {"bfloat16": (torch.bfloat16, np.uint16)}


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(template: Any, flat: dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        vals = [_unflatten_into(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(template)]
        return type(template)(vals)
    return flat[prefix[:-1]]


def _to_host(v) -> tuple[np.ndarray, str | None]:
    """(a numpy copy of ``v``, "bfloat16" if it is stored viewed). A copy,
    never a view: the train loop updates its tensors in place while a
    background save writes."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.array(v, copy=True), None


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- paths ---------------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".npz"):
                out.append(int(f[5:-4]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save ----------------------------------------------------------------
    def _snapshot(self, tree: Any) -> tuple[dict, dict]:
        enc, viewed = {}, {}
        for k, v in _flatten(tree).items():
            enc[k], name = _to_host(v)
            if name is not None:
                viewed[k] = name
        return enc, viewed

    def _write(self, step: int, enc: dict, viewed: dict, meta: dict) -> None:
        meta = dict(meta or {}, __viewed__=viewed)
        tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **enc)
        os.replace(tmp, self._path(step))  # atomic
        self._gc()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

    def save(self, step: int, tree: Any, meta: dict | None = None) -> None:
        self._write(step, *self._snapshot(tree), meta or {})

    def save_async(self, step: int, tree: Any,
                   meta: dict | None = None) -> None:
        """Snapshot to host now, write in the background."""
        self.wait()  # one in-flight save at a time
        enc, viewed = self._snapshot(tree)  # device -> host copies

        def run():
            try:
                self._write(step, enc, viewed, meta or {})
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # -- restore -------------------------------------------------------------
    def restore(self, step: int, template: Any,
                device=None) -> tuple[Any, dict]:
        """template: a tree (dicts, lists; any leaves) of the saved one's
        structure. Returns (the tree of tensors on ``device``, default the
        GPU; the meta)."""
        dev = S.resolve_device(device)
        with np.load(self._path(step), allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            viewed = meta.pop("__viewed__", {})
            flat = {}
            for k in z.files:
                if k == "__meta__":
                    continue
                # (ascontiguousarray would make a 0-d scalar (1,))
                a = np.asarray(z[k], order="C")
                t = torch.from_numpy(a.view(np.int16) if k in viewed else a)
                if k in viewed:
                    t = t.view(_VIEWED[viewed[k]][0])
                flat[k] = t.to(dev)
        return _unflatten_into(template, flat), meta
