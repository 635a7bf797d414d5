"""Deliberately broken kernels — qlint's regression fixtures, in CUDA.
Port of ``repro/analysis/fixtures.py``.

Each fixture seeds exactly the defect of its reference namesake; ``python
-m repro_torch.analysis.qlint --fixtures`` runs only these and must exit
nonzero (tested in tests/test_torch_analysis.py). The reference wraps each
kernel body in an interpret-mode ``pallas_call`` (its factory ``_pallas``)
and only traces it; here the factory :func:`_cuda` turns the fixture's
hand-written source ``csrc/fixtures/<name>.cu`` into

* a launchable op, compiled for ``sm_90a`` by ``kernels/_build.py`` and
  bound through ctypes like the port's kernels (``op(*inputs, out=)`` on
  CUDA tensors; on CPU tensors its plain version), and
* the :class:`~.registry.KernelEntry` qlint checks: the op's plain PyTorch
  version (the same broken arithmetic, traced on the CPU), its launch plan
  and its source for the PTX level.

Operands are padded to the grid's full reach, as Pallas pads blocks
(:func:`~.interp.reach`), so the index-map and divisibility fixtures read
and write the pad and never leave their buffers; their plain versions take
the same padded tensors. On the card (:func:`run_on_card`) each
fixture runs once on seeded inputs in buffers
with a guard past their padded extent: its output must equal its plain
version's bit for bit, and every input and every guard must be unchanged.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import _build

from .interp import LaunchPlan, Operand, reach
from .intervals import Interval
from .registry import KernelEntry

_M, _K, _N = 8, 256, 128
GUARD_BYTES = 256  # checked past every buffer's padded extent

_X = Interval(-127, 127)   # activation codes
_W = Interval(-7, 7)       # int4 weight codes


@dataclasses.dataclass(frozen=True)
class CudaOp:
    """One fixture's kernel: ``csrc/fixtures/<name>.cu`` and its plain
    version, over the padded operands of ``plan`` (inputs first, the
    output last, with their ``dtypes`` and the inputs' value ranges)."""

    name: str
    plan: LaunchPlan
    plain: Callable
    dtypes: tuple
    ranges: tuple
    dims: tuple  # the C entry point's int arguments

    def shapes(self) -> list:
        return [reach(self.plan, op) for op in self.plan.operands]

    def __call__(self, *inputs, out=None):
        if inputs[0].device.type == "cpu":
            return self.plain(*inputs)
        _build.require_cuda(self.name, *inputs)
        shapes = self.shapes()
        for t, shape, dt in zip(inputs, shapes, self.dtypes):
            if tuple(t.shape) != tuple(shape) or t.dtype != dt \
                    or not t.is_contiguous():
                raise ValueError(f"{self.name}: operands do not match the "
                                 "padded plan")
        if out is None:
            out = torch.empty(shapes[-1], dtype=self.dtypes[-1],
                              device=inputs[0].device)
        argtypes = ([ctypes.c_void_p] * (len(inputs) + 1)
                    + [ctypes.c_int] * len(self.dims) + [ctypes.c_void_p])
        fn = _build.function(self.name, f"{self.name}_launch", argtypes)
        with torch.cuda.device(out.device):
            err = fn(*(t.data_ptr() for t in inputs), out.data_ptr(),
                     *self.dims, _build.stream_of(out))
        _build.check(err, self.name)
        _build.count(self.name)
        return out


def _cuda(name: str, plan: LaunchPlan, plain: Callable, dtypes, ranges,
          dims, *, config: str, **entry) -> KernelEntry:
    """Row 11's factory, the counterpart of the reference's ``_pallas``:
    the fixture's CUDA op and the entry qlint checks (its plain version
    traced on zeros of the padded shapes, the contract ``ranges`` seeded,
    its plan, its source)."""
    op = CudaOp(name, plan, plain, tuple(dtypes), tuple(ranges), tuple(dims))

    def build():
        args = tuple(torch.zeros(s, dtype=dt)
                     for s, dt in zip(op.shapes()[:-1], op.dtypes))
        return op, args, dict(enumerate(op.ranges))

    return KernelEntry(name.replace("_", "-"), config, build, sources=(name,),
                       plans=(plan,), op=op, **entry)


def _whole(name, shape, output=False):
    return Operand(name, shape, shape, lambda *_: (0,) * len(shape),
                   output=output)


def _dot_plan(name):
    return LaunchPlan(name, (1,), (_whole("x", (_M, _K)),
                                   _whole("w", (_K, _N)),
                                   _whole("out", (_M, _N), output=True)))


def _int_product(x, w):
    """(M, K) x (K, N) int8 -> int32, exact (the int32 contraction the
    port's plain versions use: one group over all of K)."""
    from repro_torch.core.quant import group_partials

    return group_partials(x, w, x.shape[1])[0]


def _plain_fp32_dot(x, w):
    """The int8 operands converted to f32, multiplied and summed in f32
    (exact: every partial sum is an integer below 2^24)."""
    return torch.mm(x.float(), w.float())


def _plain_no_preferred(x, w):
    """int8 @ int8 in an int8 accumulator: torch's int mm returns the
    operands' dtype and wraps. CUDA has no integer mm, so the plain
    version forms it on the host (a no-op move for CPU tensors)."""
    return torch.mm(x.cpu(), w.cpu()).to(x.device)


def _plain_narrowing(x, w):
    """The int32 accumulator through int16 and back."""
    return _int_product(x, w).to(torch.int16).to(torch.int32)


def _plain_index_map(x):
    """Output m-tile i is input m-tile i + 1 of the padded x."""
    bm = _M // 2
    return x[bm:bm + _M].clone()


def _plain_divisibility(x):
    """Every padded column copied, the 64 past N = 192 included."""
    return x.clone()


def entries() -> list:
    """All broken fixtures; every one must produce >= 1 finding."""
    bm, n, bn = _M // 2, 192, 128
    index_plan = LaunchPlan("broken_index_map", (_M // bm,), (
        Operand("x", (_M, _K), (bm, _K),
                lambda i, c: (i + Interval.point(1), 0)),
        Operand("out", (_M, _K), (bm, _K), lambda i, c: (i, 0),
                output=True)))
    div_plan = LaunchPlan("broken_divisibility", (-(-n // bn),), (
        Operand("x", (_M, n), (_M, bn), lambda j, c: (0, j)),
        Operand("out", (_M, n), (_M, bn), lambda j, c: (0, j),
                output=True)))
    i8, i32, f32 = torch.int8, torch.int32, torch.float32
    return [
        _cuda("broken_fp32_dot", _dot_plan("broken_fp32_dot"),
              _plain_fp32_dot, (i8, i8, f32), (_X, _W), (_M, _K, _N),
              config="float dot on IS path", integer_scale=True,
              alpha=1024),
        _cuda("broken_no_preferred", _dot_plan("broken_no_preferred"),
              _plain_no_preferred, (i8, i8, i8), (_X, _W), (_M, _K, _N),
              config="int dot w/o int32 accumulator"),
        _cuda("broken_narrowing", _dot_plan("broken_narrowing"),
              _plain_narrowing, (i8, i8, i32), (_X, _W), (_M, _K, _N),
              config="int32 acc through int16"),
        _cuda("broken_index_map", index_plan, _plain_index_map, (i8, i8),
              (_X,), (_M, _K), config="m-tile index map off by one"),
        _cuda("broken_divisibility", div_plan, _plain_divisibility,
              (i8, i8), (_X,),
              (_M, n, reach(div_plan, div_plan.operands[0])[1]),
              config="192 % 128 != 0"),
    ]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _guarded(shape, dtype, gen, rng: Interval | None):
    """A CUDA tensor of ``shape`` at the front of a buffer with
    GUARD_BYTES more, every element seeded (``rng``: within that range;
    else any value of the dtype)."""
    n = int(np.prod(shape))
    g = GUARD_BYTES // torch.empty((), dtype=dtype).element_size()
    lo, hi = (int(rng.lo), int(rng.hi)) if rng is not None else (
        (-128, 127) if dtype == torch.int8 else (-2**31, 2**31 - 1))
    if dtype.is_floating_point:
        flat = torch.randn(n + g, generator=gen, device="cuda").to(dtype)
    else:
        flat = torch.randint(lo, hi + 1, (n + g,), generator=gen,
                             device="cuda", dtype=torch.int64).to(dtype)
    return flat, flat[:n].view(shape)


def run_on_card(op: CudaOp, seed: int = 0) -> float:
    """Launch ``op`` once on seeded CUDA inputs in guarded buffers; raise
    unless its output equals its plain version's bit for bit and every
    input (pad included) and every guard is unchanged. Returns the max
    abs difference (0)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = op.shapes()
    bufs = [_guarded(s, dt, gen, r) for s, dt, r in
            zip(shapes[:-1], op.dtypes, op.ranges)]
    out_flat, out = _guarded(shapes[-1], op.dtypes[-1], gen, None)
    before = [f.clone() for f, _ in bufs]
    guard = out_flat[out.numel():].clone()
    inputs = [t for _, t in bufs]
    op(*inputs, out=out)
    want = op.plain(*inputs)
    torch.cuda.synchronize()
    err = (out.double() - want.double()).abs().max().item()
    if not torch.equal(out, want):
        raise AssertionError(f"{op.name}: kernel != plain version "
                             f"(max abs {err})")
    for (f, _), b in zip(bufs, before):
        if not torch.equal(f, b):
            raise AssertionError(f"{op.name}: an input or its guard changed")
    if not torch.equal(out_flat[out.numel():], guard):
        raise AssertionError(f"{op.name}: the output's guard changed")
    return err
