"""The serving engine's compiled steps: prefill and decode captured once as
CUDA graphs and replayed. The reference jits both steps
(``repro/serving/engine.py``); a captured graph is the torch counterpart
of "trace once, run the compiled program every tick". No reference module
corresponds to this one.

A :class:`Step` runs a function ``fn()`` of fixed shapes that reads only
static buffers it closes over: the step's inputs, which the caller fills
before each call, the weights and the KV cache. The first call
establishes the step. On a CUDA device that is one warm-up call on a
side stream, which loads every kernel library outside the capture; then
one capture into a ``torch.cuda.CUDAGraph``; then a replay. Every later
call replays the graph. On the CPU nothing is captured, and every call
runs ``fn`` eagerly on the same buffers.

What a replay keeps true:

* ``kernels._build.LAUNCHES`` stays a count of device launches: the
  capture launches nothing, so its counts are taken back out, and every
  replay adds them again.
* The MoE routing records made during the capture
  (``models.moe.hold_routing``) hold the graph's count tensors; after
  every replay they go to ``on_replay``, which consumes them before the
  next replay overwrites them.
* The warm-up's routing records are dropped and its metrics go to a
  scratch registry. So the served registry counts the wrappers' calls
  once per establishment, at the capture, as the reference counts them
  once per trace.
* The returned output is the graph's static output buffer, overwritten
  by the next replay: the caller consumes it first.
* ``state``: tensors that ``fn`` reads and advances in place (a recurrent
  cache, where a second call is not a repeat of the first) are cloned
  before the warm-up and copied back after it, so the first call moves
  them one step, as every later one does.

A call that raises drops the step's graph. The next call establishes the
step again, and ``on_establish`` counts each establishment.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.models import moe


class Step:
    """One engine step of fixed shapes: captured on its first call on a
    CUDA device and replayed after, eager on the CPU (module docstring)."""

    def __init__(self, fn, device: torch.device, *, pool=None,
                 on_establish=None, on_replay=None, state=()):
        self.fn = fn
        self.device = device
        self.pool = pool
        self.state = list(state)
        self._on_establish = on_establish or (lambda: None)
        self._on_replay = on_replay or (lambda records: None)
        self.release()

    @property
    def captured(self) -> bool:
        return self._graph is not None

    @property
    def launches(self) -> dict[str, int]:
        """Kernel launches of one replay (empty before a capture)."""
        return dict(self._launches)

    def release(self) -> None:
        """Drop the graph and its outputs; the next call establishes the
        step again."""
        self._established = False
        self._graph = self._out = None
        self._routing: list = []
        self._launches: dict[str, int] = {}

    @torch.inference_mode()
    def __call__(self, *inputs):
        """Run the step; ``inputs`` are its static input buffers, already
        filled (passed so that wrappers and timers around the step see
        them), and ``fn`` reads them itself."""
        try:
            if not self._established:
                self._established = True
                self._on_establish()
                if self.device.type == "cuda":
                    self._capture()
            if self._graph is None:
                return self.fn()
            return self._replay()
        except Exception:
            self.release()
            raise

    def _capture(self) -> None:
        here = torch.cuda.current_stream(self.device)
        saved = [t.clone() for t in self.state]
        with obs.use_registry(obs.Registry()), moe.hold_routing():
            side = torch.cuda.Stream(self.device)
            side.wait_stream(here)
            with torch.cuda.stream(side):
                self.fn()
            here.wait_stream(side)
        for t, s in zip(self.state, saved):
            t.copy_(s)
        del saved
        before = dict(_build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with moe.hold_routing() as records, \
                    torch.cuda.graph(graph, pool=self.pool):
                out = self.fn()
        finally:
            launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()
                        if n != before[k]}
            _build.LAUNCHES.update(before)
        self._graph, self._out = graph, out
        self._routing, self._launches = records, launches

    def _replay(self):
        self._graph.replay()
        _build.add_launches(self._launches)
        if self._routing:
            self._on_replay(self._routing)
        return self._out
