"""Interval dataflow interpreter over traced aten graphs (qlint pass 1).
Port of ``repro/analysis/interp.py``.

``analyze_fn(fn, *args, input_ranges=...)`` traces ``fn`` on CPU tensors
with ``torch.fx.experimental.proxy_tensor.make_fx`` and abstractly
interprets the aten graph, propagating one
:class:`~repro_torch.analysis.intervals.Interval` per value. A CUDA kernel
has no graph to trace: the port traces each kernel's plain PyTorch version
(the same arithmetic, on the CPU) and states the kernel's launch as a
:class:`LaunchPlan`, which takes the place of the reference's
``analyze_index_map`` over Pallas ``BlockSpec`` index maps.

Soundness notes
---------------
* Unknown ops fall back to the output dtype's full range and are recorded
  as ``unknown-prim`` events (never silently precise).
* Integer add/sub/mul/mm/bmm/sum/cumsum whose result interval escapes the
  dtype the kernel accumulates in emit an ``int-overflow`` event; the
  *unclamped* interval keeps propagating. torch promotes an integer
  ``sum`` to int64 unless a dtype is given, so a sum is judged against its
  explicit dtype, else its input's. A left shift that wraps (the int4
  nibble idiom) clamps to the dtype range without an event.
* An integer-narrowing ``_to_copy`` whose input interval does not fit the
  target dtype emits ``narrowing-convert``; in-range narrowing (unpacked
  nibbles int32 -> int8) is clean.
* Tensors from ``empty`` allocations are tracked by their rows (dim 0):
  writes through ``slice``/``select`` views mark rows written, and a read
  of rows that nothing wrote emits ``uninit-read`` and falls back to the
  dtype range.
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Callable

import numpy as np
import torch

from .intervals import INT_RANGES, Interval

ARITH_OPS = frozenset({"add", "sub", "rsub", "mul", "mm", "bmm", "addmm",
                       "baddbmm", "sum", "cumsum"})
MATMUL_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm"})
PASSTHRU_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
    "unsqueeze", "squeeze", "slice", "select", "alias", "clone",
    "contiguous", "detach", "index_select", "gather", "index", "repeat",
    "repeat_interleave", "flip", "narrow", "narrow_copy", "as_strided",
    "lift_fresh_copy", "_unsafe_index", "roll", "mean", "amax", "amin",
    "max", "min", "expand_copy", "view_copy", "permute_copy",
    "unsqueeze_copy", "slice_copy",
})
VIEW_OPS = frozenset({"view", "_unsafe_view", "reshape", "expand", "permute",
                      "transpose", "t", "unsqueeze", "squeeze", "slice",
                      "select", "alias", "detach", "as_strided"})
ALLOC_OPS = frozenset({"empty", "empty_like", "new_empty", "empty_strided"})
WRITE_OPS = frozenset({"copy", "fill", "zero", "index_put", "masked_fill",
                       "index_copy", "index_fill", "scatter"})
COMPARE_OPS = frozenset({"eq", "ne", "lt", "le", "gt", "ge"})

DATA = "data"  # input_ranges sentinel: seed from dtype, not tensor values


def dtype_interval(dtype) -> Interval:
    """The range of a torch dtype: integers and bool exactly, floats top."""
    lim = INT_RANGES.get(str(dtype).replace("torch.", ""))
    return Interval(float(lim[0]), float(lim[1])) if lim else Interval.top()


def is_int(dtype) -> bool:
    """Integer (not bool) dtype, from a torch dtype or its name."""
    name = str(dtype).replace("torch.", "")
    return name in INT_RANGES and name != "bool"


def itemsize(dtype) -> int:
    return getattr(torch, str(dtype).replace("torch.", "")).itemsize


def tensor_interval(t: torch.Tensor) -> Interval:
    """Tight interval of a concrete tensor's values."""
    if t.numel() == 0:
        return Interval.point(0.0)
    return Interval.of_array(t.detach().cpu().double().numpy())


@dataclasses.dataclass(frozen=True)
class Event:
    """Analyzer-emitted fact consumed by lint rules / certificates."""

    kind: str  # int-overflow | narrowing-convert | uninit-read | unknown-prim
    prim: str
    detail: str
    interval: Interval | None
    where: str


@dataclasses.dataclass(frozen=True)
class EqnRecord:
    """One interpreted aten node with its value intervals (lint input)."""

    prim: str
    scope: str  # "" here: the whole graph is one kernel's plain version
    out_dtype: str
    out_interval: Interval
    in_dtypes: tuple
    in_intervals: tuple
    params: dict
    where: str
    eqn_id: int


@dataclasses.dataclass
class Analysis:
    records: list
    events: list
    out_intervals: list

    @property
    def int_accum_bound(self) -> float:
        """Max |value| over integer arithmetic results (int64 included) —
        the worst-case magnitude any integer accumulator chain reaches."""
        b = 0.0
        for r in self.records:
            if r.prim in ARITH_OPS and is_int(r.out_dtype):
                b = max(b, r.out_interval.max_abs())
        return b

    def events_of(self, *kinds) -> list:
        return [e for e in self.events if e.kind in kinds]


def op_name(node) -> str:
    """aten op name without overload or in-place suffix ("add_" -> "add")."""
    t = node.target
    if t is operator.getitem:
        return "getitem"
    name = getattr(getattr(t, "overloadpacket", None), "__name__", None) \
        or getattr(t, "__name__", str(t))
    if name.startswith("__") and name.endswith("__"):  # __rshift__
        return name.strip("_")
    return name[:-1] if name.endswith("_") else name


def _inplace(node) -> bool:
    name = getattr(getattr(node.target, "overloadpacket", None),
                   "__name__", "")
    return name.endswith("_") and not name.startswith("__")


def _meta(node):
    return node.meta.get("val")


def _dtype_of(node) -> str:
    v = _meta(node)
    return str(v.dtype).replace("torch.", "") if hasattr(v, "dtype") else ""


def _shape_of(node) -> tuple:
    v = _meta(node)
    return tuple(v.shape) if hasattr(v, "shape") else ()


class _Cell:
    """An ``empty`` allocation: which of its rows (dim 0) were written,
    and the union of what was written."""

    __slots__ = ("dtype", "written", "iv")

    def __init__(self, dtype):
        self.dtype = dtype
        self.written: list[tuple[int, int]] = []
        self.iv: Interval | None = None

    def covers(self, lo: int, hi: int) -> bool:
        for a, b in sorted(self.written):
            if a <= lo < b:
                lo = b
        return lo >= hi


class _Interp:
    def __init__(self, gm):
        self.gm = gm
        self.records: list[EqnRecord] = []
        self.events: list[Event] = []
        self.env: dict = {}
        # node -> (cell, (row_lo, row_hi), dim 0 still the cell's rows)
        self.cells: dict = {}

    def note(self, kind, node, detail, interval=None):
        self.events.append(Event(kind, op_name(node), detail, interval,
                                 node.name))

    # -- values -------------------------------------------------------------

    def value(self, a, reader=None):
        """Interval (or list) of a node argument; a read of an ``empty``
        tensor's rows that nothing wrote is an ``uninit-read``."""
        if isinstance(a, torch.fx.Node):
            if a in self.cells and reader is not None:
                return self.read_cell(a, reader)
            return self.env[a]
        if isinstance(a, bool):
            return Interval.point(int(a))
        if isinstance(a, (int, float)):
            return Interval.point(a)
        if isinstance(a, (list, tuple)):
            return [self.value(x, reader) for x in a]
        return a

    def read_cell(self, a, reader):
        cell, (lo, hi), _ = self.cells[a]
        if cell.covers(lo, hi):
            return cell.iv
        self.note("uninit-read", reader,
                  f"read of rows [{lo}, {hi}) of {a.name}: an empty "
                  "allocation whose rows nothing wrote")
        return dtype_interval(cell.dtype)

    # -- run ----------------------------------------------------------------

    def run(self, seeds) -> list:
        it = iter(seeds)
        out = []
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                self.env[node] = next(it)
            elif node.op == "get_attr":
                self.env[node] = tensor_interval(getattr(self.gm, node.target))
            elif node.op == "call_function":
                self.env[node] = self.call(node)
            elif node.op == "output":
                out = self.value(node.args[0])
        return out if isinstance(out, list) else [out]

    def call(self, node):
        name = op_name(node)
        dt = _dtype_of(node)
        base = node.args[0] if node.args else None
        if name in ALLOC_OPS:
            self.cells[node] = (_Cell(dt), (0, _rows(node)), True)
            return dtype_interval(dt)
        if name in VIEW_OPS and base in self.cells:
            self.cells[node] = _view_region(name, node, self.cells[base])
            return self.env[base]
        writes = _inplace(node) and base in self.cells
        # a pure write (copy_, fill_, ...) does not read its target's rows
        ins = [self.env[a] if k == 0 and writes and name in WRITE_OPS
               else self.value(a, node) for k, a in enumerate(node.args)]
        kw = {k: self.value(v, node) for k, v in node.kwargs.items()}
        out = self.apply(name, node, ins, kw)
        if writes:
            cell, region, _ = self.cells[base]
            cell.written.append(region)
            cell.iv = out if cell.iv is None else cell.iv.union(out)
            self.cells[node] = self.cells[base]
        return out

    def apply(self, name, node, ins, kw):
        handler = _OPS.get(name)
        if handler is None and name in PASSTHRU_OPS:
            handler = _passthru
        if handler is None:
            self.note("unknown-prim", node, f"no transfer fn for '{name}'")
            return _top_of(node)
        out = handler(self, node, ins, kw)
        if isinstance(out, Interval):
            self.surveil(name, node, ins, kw, out)
            self.records.append(EqnRecord(
                name, "", _dtype_of(node), out,
                tuple(_dtype_of(a) for a in node.args
                      if isinstance(a, torch.fx.Node)),
                tuple(i for i in ins if isinstance(i, Interval)),
                dict(node.kwargs), node.name, id(node)))
        return out

    def surveil(self, name, node, ins, kw, out):
        """Overflow of the integer arithmetic chain, judged against the
        dtype it accumulates in."""
        if name not in ARITH_OPS:
            return
        dt = _dtype_of(node)
        if name == "sum" and kw.get("dtype") is None and node.args:
            dt = _dtype_of(node.args[0])  # torch's int64 promotion aside
        elif name == "sum":
            dt = str(kw["dtype"]).replace("torch.", "")
        if is_int(dt) and not out.fits_dtype(np.dtype(dt)):
            self.note("int-overflow", node,
                      f"{name} result {out} exceeds {dt}", out)


def _rows(node) -> int:
    shape = _shape_of(node)
    return int(shape[0]) if shape else 1


def _view_region(name, node, state):
    """The rows of the cell a view of it covers (dim 0 only)."""
    cell, (lo, hi), rows = state
    args = node.args
    if rows and name == "slice" and len(args) > 1 and args[1] == 0:
        start = args[2] if len(args) > 2 and args[2] is not None else 0
        stop = args[3] if len(args) > 3 and args[3] is not None else hi - lo
        step = args[4] if len(args) > 4 else 1
        n = hi - lo
        start, stop = max(0, min(start, n)), max(0, min(stop, n))
        if step == 1:
            return cell, (lo + start, lo + max(start, stop)), True
        return cell, (lo, hi), False
    if rows and name == "select" and args[1] == 0:
        return cell, (lo + args[2], lo + args[2] + 1), False
    keeps = (name in ("slice", "select") and args[1] != 0) or \
        (name in ("unsqueeze", "squeeze") and len(args) > 1 and args[1] > 0) \
        or name in ("alias", "detach")
    return cell, (lo, hi), rows and keeps


def _top_of(node):
    v = _meta(node)
    if isinstance(v, (list, tuple)):
        return [dtype_interval(t.dtype) if hasattr(t, "dtype")
                else Interval.top() for t in v]
    return dtype_interval(v.dtype) if hasattr(v, "dtype") else Interval.top()


# ---------------------------------------------------------------------------
# Transfer functions: (interp, node, arg values, kwarg values) -> value
# ---------------------------------------------------------------------------


def _passthru(s, n, i, kw):
    v = _meta(n)
    if isinstance(v, (list, tuple)):  # split / unbind / chunk
        return [i[0]] * len(v)
    return i[0]


def _iv(x) -> Interval:
    return x if isinstance(x, Interval) else Interval.point(x)


def _union_all(vals):
    vals = [_iv(v) for v in vals]
    out = vals[0]
    for v in vals[1:]:
        out = out.union(v)
    return out


def _h_add(s, n, i, kw):
    b = _iv(i[1])
    alpha = kw.get("alpha")
    if alpha is not None:
        b = b * _iv(alpha)
    return _iv(i[0]) + b


def _h_sub(s, n, i, kw):
    b = _iv(i[1])
    alpha = kw.get("alpha")
    if alpha is not None:
        b = b * _iv(alpha)
    return _iv(i[0]) - b


def _h_rsub(s, n, i, kw):
    return _iv(i[1]) - _iv(i[0])


def _h_mm(s, n, i, kw):
    a_node = n.args[0] if op_name(n) in ("mm", "bmm") else n.args[1]
    k = _shape_of(a_node)[-1]
    a, b = (i[0], i[1]) if op_name(n) in ("mm", "bmm") else (i[1], i[2])
    prod = (_iv(a) * _iv(b)).sum_n(k)
    if op_name(n) in ("addmm", "baddbmm"):
        beta, alpha = kw.get("beta"), kw.get("alpha")
        bias = _iv(i[0]) * _iv(beta) if beta is not None else _iv(i[0])
        prod = prod * _iv(alpha) if alpha is not None else prod
        return bias + prod
    return prod


def _h_sum(s, n, i, kw):
    shape = _shape_of(n.args[0])
    dims = n.args[1] if len(n.args) > 1 else n.kwargs.get("dim")
    if not dims:  # sum.default, or dim=[]: every element
        count = int(np.prod(shape)) if shape else 1
    else:
        count = 1
        for d in ([dims] if isinstance(dims, int) else dims):
            count *= shape[d]
    return _iv(i[0]).sum_n(count)


def _h_cumsum(s, n, i, kw):
    return _iv(i[0]).sum_n(_shape_of(n.args[0])[n.args[1]])


def _h_convert(s, n, i, kw):
    """``_to_copy`` / ``copy``: a dtype change; int->int narrowing that
    may truncate is an event, out-of-range float->int clamps silently."""
    src_node = n.args[-1] if op_name(n) == "copy" else n.args[0]
    src, dst = _dtype_of(src_node), _dtype_of(n)
    iv = _iv(i[-1] if op_name(n) == "copy" else i[0])
    if is_int(dst) and not iv.fits_dtype(np.dtype(dst)):
        if is_int(src):
            s.note("narrowing-convert", n,
                   f"{src}->{dst} may truncate {iv}", iv)
        iv = dtype_interval(dst)
    return iv


def _h_div(s, n, i, kw):
    mode = kw.get("rounding_mode")
    a, b = _iv(i[0]), _iv(i[1])
    if mode == "floor":
        return a.floordiv(b)
    if mode == "trunc":
        return a.intdiv(b)
    return a.truediv(b)


def _h_remainder(s, n, i, kw):
    """Python-style remainder (sign of the divisor); fmod truncates."""
    a, b = _iv(i[0]), _iv(i[1])
    if b.lo > 0:
        return Interval(0.0, b.hi)
    return Interval(-b.max_abs(), b.max_abs())


def _h_clamp(s, n, i, kw):
    x = _iv(i[0])
    lo = i[1] if len(i) > 1 else kw.get("min")
    hi = i[2] if len(i) > 2 else kw.get("max")
    if lo is not None:
        x = x.maximum(_iv(lo))
    if hi is not None:
        x = x.minimum(_iv(hi))
    return x


def _h_compare(s, n, i, kw):
    a, b = _iv(i[0]), _iv(i[1])
    name = op_name(n)
    if name in ("lt", "gt", "le", "ge"):
        x, y = (a, b) if name in ("lt", "le") else (b, a)
        strict = name in ("lt", "gt")
        if (x.hi < y.lo) or (not strict and x.hi <= y.lo):
            return Interval.point(1)
        if (x.lo > y.hi) or (strict and x.lo >= y.hi):
            return Interval.point(0)
    elif name in ("eq", "ne"):
        same = a.is_point() and b.is_point() and a.lo == b.lo
        apart = a.hi < b.lo or a.lo > b.hi
        if same or apart:
            return Interval.point(int(same == (name == "eq")))
    return Interval(0.0, 1.0)


def _nonneg_bits(a: Interval, b: Interval) -> Interval | None:
    """[0, 2^bits - 1] covering both operands, when both are >= 0."""
    if a.lo >= 0 and b.lo >= 0 and math.isfinite(max(a.hi, b.hi)):
        return Interval(0.0, float(2 ** int(max(a.hi, b.hi)).bit_length()
                                   - 1))
    return None


def _h_bitwise(s, n, i, kw):
    name = op_name(n)
    dt = _dtype_of(n)
    a, b = _iv(i[0]), _iv(i[1]) if len(i) > 1 else None
    if dt == "bool":
        if name == "bitwise_not" or name == "logical_not":
            return Interval.point(1 - a.lo) if a.is_point() \
                else Interval(0.0, 1.0)
        if name in ("bitwise_and", "logical_and"):
            if a.hi == 0 or b.hi == 0:
                return Interval.point(0)
            if a.lo == 1 and b.lo == 1:
                return Interval.point(1)
        if name in ("bitwise_or", "logical_or"):
            if a.lo == 1 or b.lo == 1:
                return Interval.point(1)
            if a.hi == 0 and b.hi == 0:
                return Interval.point(0)
        return Interval(0.0, 1.0)
    if name == "bitwise_and" and b is not None:
        for m, x in ((b, a), (a, b)):  # a non-negative mask bounds it
            if m.lo >= 0 and math.isfinite(m.hi):
                return Interval(0.0, m.hi if x.lo < 0 else min(x.hi, m.hi))
    if name in ("bitwise_or", "bitwise_xor") and b is not None:
        r = _nonneg_bits(a, b)
        if r is not None:
            return r
    return dtype_interval(dt)


def _h_lshift(s, n, i, kw):
    dt = _dtype_of(n)
    a, b = _iv(i[0]), _iv(i[1])
    if b.is_point():
        f = float(2 ** int(b.lo))
        iv = Interval(a.lo * f, a.hi * f)
        if iv.fits_dtype(np.dtype(dt)):
            return iv
    return dtype_interval(dt)  # wrapping shift: the int4 nibble idiom


def _h_rshift(s, n, i, kw):
    return _iv(i[0]).shift_right(_iv(i[1]))


def _h_where(s, n, i, kw):
    return _union_all(i[1:3])


def _h_masked_fill(s, n, i, kw):
    return _iv(i[0]).union(_iv(i[2]))


def _h_index_put(s, n, i, kw):
    return _iv(i[0]).union(_iv(i[2]))


def _h_fill(s, n, i, kw):
    return _iv(i[1])


def _h_full(s, n, i, kw):
    return _iv(i[1])


def _h_scalar(s, n, i, kw):
    return _iv(i[0])


def _h_arange(s, n, i, kw):
    args = [a.lo for a in i if isinstance(a, Interval)]
    start, end, step = (0.0, args[0], 1.0) if len(args) == 1 else \
        (args[0], args[1], args[2] if len(args) > 2 else 1.0)
    last = start + step * max(math.ceil((end - start) / step) - 1, 0)
    return Interval(min(start, last), max(start, last))


def _h_argmax(s, n, i, kw):
    shape = _shape_of(n.args[0])
    dim = n.args[1] if len(n.args) > 1 else None
    count = int(np.prod(shape)) if dim is None else shape[dim]
    return Interval(0.0, float(max(count - 1, 0)))


def _h_max_dim(s, n, i, kw):
    return [_iv(i[0]), Interval(0.0, float(max(
        _shape_of(n.args[0])[n.args[1]] - 1, 0)))]


def _h_getitem(s, n, i, kw):
    return i[0][n.args[1]]


def _h_pow(s, n, i, kw):
    a, e = _iv(i[0]), _iv(i[1])
    if e.is_point() and e.lo == 2:
        lo = 0.0 if a.lo <= 0 <= a.hi else min(abs(a.lo), abs(a.hi)) ** 2
        return Interval(lo, a.max_abs() ** 2)
    return Interval.top()


def _mono(f):
    def h(s, n, i, kw):
        def g(v):
            try:
                return f(v)
            except (OverflowError, ValueError):
                return math.inf if v > 0 else -math.inf
        return _iv(i[0]).monotone(g)
    return h


def _round(v):
    return v if not math.isfinite(v) else float(round(v))


_OPS: dict[str, Callable] = {
    "add": _h_add, "sub": _h_sub, "rsub": _h_rsub,
    "mul": lambda s, n, i, kw: _iv(i[0]) * _iv(i[1]),
    "mm": _h_mm, "bmm": _h_mm, "addmm": _h_mm, "baddbmm": _h_mm,
    "sum": _h_sum, "cumsum": _h_cumsum,
    "_to_copy": _h_convert, "copy": _h_convert,
    "div": _h_div,
    "floor_divide": lambda s, n, i, kw: _iv(i[0]).floordiv(_iv(i[1])),
    "remainder": _h_remainder, "fmod": _h_remainder,
    "neg": lambda s, n, i, kw: -_iv(i[0]),
    "abs": lambda s, n, i, kw: _iv(i[0]).abs(),
    "sign": lambda s, n, i, kw: Interval(-1.0, 1.0),
    "maximum": lambda s, n, i, kw: _iv(i[0]).maximum(_iv(i[1])),
    "minimum": lambda s, n, i, kw: _iv(i[0]).minimum(_iv(i[1])),
    "clamp": _h_clamp,
    "clamp_min": lambda s, n, i, kw: _iv(i[0]).maximum(_iv(i[1])),
    "clamp_max": lambda s, n, i, kw: _iv(i[0]).minimum(_iv(i[1])),
    "round": _mono(_round),
    "floor": _mono(lambda v: v if not math.isfinite(v) else math.floor(v)),
    "ceil": _mono(lambda v: v if not math.isfinite(v) else math.ceil(v)),
    "trunc": _mono(lambda v: v if not math.isfinite(v) else math.trunc(v)),
    "exp": _mono(lambda v: math.inf if v == math.inf else math.exp(v)),
    "exp2": _mono(lambda v: math.inf if v == math.inf else 2.0 ** v),
    "log": _mono(lambda v: math.log(v) if v > 0 else -math.inf),
    "sqrt": _mono(lambda v: math.sqrt(max(v, 0.0))),
    "rsqrt": lambda s, n, i, kw: Interval(0.0, math.inf),
    "reciprocal": lambda s, n, i, kw: _iv(1.0).truediv(_iv(i[0])),
    "tanh": lambda s, n, i, kw: Interval(-1.0, 1.0),
    "sigmoid": lambda s, n, i, kw: Interval(0.0, 1.0),
    "erf": lambda s, n, i, kw: Interval(-1.0, 1.0),
    "_softmax": lambda s, n, i, kw: Interval(0.0, 1.0),
    "isfinite": lambda s, n, i, kw: Interval(0.0, 1.0),
    "isnan": lambda s, n, i, kw: Interval(0.0, 1.0),
    "pow": _h_pow,
    "where": _h_where, "masked_fill": _h_masked_fill,
    "index_put": _h_index_put,
    "cat": lambda s, n, i, kw: _union_all(i[0]),
    "stack": lambda s, n, i, kw: _union_all(i[0]),
    "fill": _h_fill, "zero": lambda s, n, i, kw: Interval.point(0),
    "full": _h_full, "full_like": _h_full,
    "new_full": lambda s, n, i, kw: _iv(i[2]),
    "ones": lambda s, n, i, kw: Interval.point(1),
    "ones_like": lambda s, n, i, kw: Interval.point(1),
    "new_ones": lambda s, n, i, kw: Interval.point(1),
    "zeros": lambda s, n, i, kw: Interval.point(0),
    "zeros_like": lambda s, n, i, kw: Interval.point(0),
    "new_zeros": lambda s, n, i, kw: Interval.point(0),
    "scalar_tensor": _h_scalar,
    "arange": _h_arange,
    "argmax": _h_argmax, "argmin": _h_argmax,
    "getitem": _h_getitem,
    "lshift": _h_lshift, "bitwise_left_shift": _h_lshift,
    "rshift": _h_rshift, "bitwise_right_shift": _h_rshift,
    **{k: _h_bitwise for k in ("bitwise_and", "bitwise_or", "bitwise_xor",
                               "bitwise_not", "logical_and", "logical_or",
                               "logical_not")},
    **{k: _h_compare for k in COMPARE_OPS},
}


def _maxmin(s, n, i, kw):
    if isinstance(_meta(n), (list, tuple)):  # max.dim: (values, indices)
        return _h_max_dim(s, n, i, kw)
    if len(i) > 1 and isinstance(i[1], Interval):  # max.other
        return (_iv(i[0]).maximum if op_name(n) == "max"
                else _iv(i[0]).minimum)(i[1])
    return _iv(i[0])


_OPS["max"] = _OPS["min"] = _maxmin


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def analyze_graph(gm, in_intervals) -> Analysis:
    """Interpret a traced ``GraphModule`` with the given input intervals."""
    it = _Interp(gm)
    outs = it.run(list(in_intervals))
    return Analysis(it.records, it.events, outs)


def analyze_fn(fn, *args, input_ranges: dict | None = None) -> Analysis:
    """Trace ``fn(*args)`` on CPU tensors and run the interval pass.

    Each input is seeded with the tight interval of its concrete values
    (static operands: weights, scales); ``input_ranges={i: Interval(..)
    | DATA}`` widens input ``i`` to a contract range (``DATA`` = the full
    dtype range) for data-dependent operands like activations and ragged
    row counts.
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(fn)(*args)
    ranges = input_ranges or {}
    seeds = []
    for i, a in enumerate(args):
        r = ranges.get(i)
        if isinstance(r, Interval):
            seeds.append(r)
        elif r == DATA:
            seeds.append(dtype_interval(a.dtype))
        else:
            seeds.append(tensor_interval(a))
    return analyze_graph(gm, seeds)


# ---------------------------------------------------------------------------
# Launch plans: what the Pallas BlockSpecs said, for a hand-written kernel
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Operand:
    """One operand of a launch: its declared extent, the block (tile) one
    grid point touches, and the block index the grid point touches as a
    function of the grid axes' Intervals (and the ragged counts' contract
    range, last). ``guarded`` lists the dims whose ragged edge the kernel
    masks (a block that overhangs them reads and writes nothing there)."""

    name: str
    shape: tuple
    block: tuple
    index_map: Callable[..., tuple]
    guarded: tuple = ()
    output: bool = False


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """A CUDA kernel's launch as the lint rules read it: its logical grid
    (the expert and K-split axes apart, where the kernel folds them into
    one block index), the operands, and the K split (``splits`` pieces on
    ``unit``-row packing units of ``k``; k = 0: no contraction)."""

    kernel: str
    grid: tuple
    operands: tuple
    k: int = 0
    splits: int = 1
    unit: int = 128
    counts: Interval | None = None


def block_indices(plan: LaunchPlan, op: Operand) -> tuple:
    """Interval of the block index in each dim of ``op`` over the whole
    grid (and every ragged count the contract admits)."""
    axes = [Interval(0.0, float(max(g - 1, 0))) for g in plan.grid]
    return tuple(_iv(v) for v in op.index_map(*axes, plan.counts))


def reach(plan: LaunchPlan, op: Operand) -> tuple:
    """Elements of each dim the grid's blocks reach (at least the declared
    extent): the extent a buffer padded to the grid's full reach has."""
    return tuple(max(int(s), int((iv.hi + 1) * b))
                 for s, b, iv in zip(op.shape, op.block,
                                     block_indices(plan, op)))


def units(split: Interval, n_units: int, splits: int) -> Interval:
    """Packing units [s U / S, (s + 1) U / S) that K split s takes (as
    ``kernels/w4a8_gemm.launch_plan``), over the splits of ``split``."""
    lo = math.floor(split.lo * n_units / splits)
    hi = math.floor((split.hi + 1) * n_units / splits) - 1
    return Interval(float(lo), float(max(hi, lo)))
