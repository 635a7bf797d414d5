"""Interval (value-range) domain for the aten-graph dataflow analyzer.
A numpy-only copy of ``repro/analysis/intervals.py`` (the port imports
nothing of ``repro``).

One :class:`Interval` abstracts the element-wise value range of a whole
array — the analysis deliberately collapses tensor structure (per-group,
per-channel) into a single ``[lo, hi]`` so every transfer function is a
few scalar ops and soundness is easy to audit: whatever any element of
the concrete array can be, it lies inside the interval.

Bounds are python floats (ints promote losslessly up to 2**53; beyond
that float rounding only ever *widens* toward +/-inf, which stays sound
for overflow certification). ``+/-inf`` are legal bounds.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

INT_RANGES = {
    "int8": (-(2**7), 2**7 - 1),
    "int16": (-(2**15), 2**15 - 1),
    "int32": (-(2**31), 2**31 - 1),
    "int64": (-(2**63), 2**63 - 1),
    "uint8": (0, 2**8 - 1),
    "uint16": (0, 2**16 - 1),
    "uint32": (0, 2**32 - 1),
    "uint64": (0, 2**64 - 1),
    "bool": (0, 1),
}


def _mul(a: float, b: float) -> float:
    """Corner product with the interval convention 0 * inf = 0."""
    if a == 0 or b == 0:
        return 0.0
    return a * b


def _div(a: float, b: float) -> float:
    """Corner quotient; indeterminate inf/inf widens to +/-inf (sound)."""
    if a == 0:
        return 0.0
    if math.isinf(a) and math.isinf(b):
        return math.copysign(math.inf, a) * math.copysign(1.0, b)
    return a / b


@dataclasses.dataclass(frozen=True)
class Interval:
    lo: float
    hi: float

    def __post_init__(self):
        # indeterminate corner arithmetic (inf - inf, ...) widens, not errors
        if math.isnan(self.lo):
            object.__setattr__(self, "lo", -math.inf)
        if math.isnan(self.hi):
            object.__setattr__(self, "hi", math.inf)
        assert not (self.lo > self.hi), f"bad interval [{self.lo}, {self.hi}]"

    # -- constructors -------------------------------------------------------

    @staticmethod
    def point(v) -> "Interval":
        v = float(v)
        return Interval(v, v)

    @staticmethod
    def top() -> "Interval":
        return Interval(-math.inf, math.inf)

    @staticmethod
    def from_dtype(dtype) -> "Interval":
        name = np.dtype(dtype).name
        if name in INT_RANGES:
            lo, hi = INT_RANGES[name]
            return Interval(float(lo), float(hi))
        return Interval.top()  # floats: unconstrained

    @staticmethod
    def of_array(x) -> "Interval":
        """Tight interval of a concrete array's values."""
        a = np.asarray(x)
        if a.size == 0:
            return Interval.point(0.0)
        return Interval(float(a.min()), float(a.max()))

    # -- predicates ---------------------------------------------------------

    def is_point(self) -> bool:
        return self.lo == self.hi and math.isfinite(self.lo)

    def within(self, lo: float, hi: float) -> bool:
        return self.lo >= lo and self.hi <= hi

    def fits_dtype(self, dtype) -> bool:
        name = np.dtype(dtype).name
        if name not in INT_RANGES:
            return True
        lo, hi = INT_RANGES[name]
        return self.within(lo, hi)

    def max_abs(self) -> float:
        return max(abs(self.lo), abs(self.hi))

    # -- lattice ------------------------------------------------------------

    def union(self, o: "Interval") -> "Interval":
        return Interval(min(self.lo, o.lo), max(self.hi, o.hi))

    # -- arithmetic transfer functions -------------------------------------

    def __add__(self, o: "Interval") -> "Interval":
        return Interval(self.lo + o.lo, self.hi + o.hi)

    def __sub__(self, o: "Interval") -> "Interval":
        return Interval(self.lo - o.hi, self.hi - o.lo)

    def __neg__(self) -> "Interval":
        return Interval(-self.hi, -self.lo)

    def __mul__(self, o: "Interval") -> "Interval":
        cs = (_mul(self.lo, o.lo), _mul(self.lo, o.hi),
              _mul(self.hi, o.lo), _mul(self.hi, o.hi))
        return Interval(min(cs), max(cs))

    def truediv(self, o: "Interval") -> "Interval":
        if o.lo <= 0 <= o.hi:  # denominator may cross zero
            return Interval.top()
        cs = (_div(self.lo, o.lo), _div(self.lo, o.hi),
              _div(self.hi, o.lo), _div(self.hi, o.hi))
        return Interval(min(cs), max(cs))

    def intdiv(self, o: "Interval") -> "Interval":
        """Integer division truncating toward zero (C, XLA)."""
        if o.lo <= 0 <= o.hi:
            return Interval.top()

        def t(a, b):
            if not (math.isfinite(a) and math.isfinite(b)):
                return _div(a, b)
            return float(math.trunc(a / b))

        cs = (t(self.lo, o.lo), t(self.lo, o.hi),
              t(self.hi, o.lo), t(self.hi, o.hi))
        return Interval(min(cs), max(cs))

    def floordiv(self, o: "Interval") -> "Interval":
        """Floor division (rounds toward -inf), as Python and torch."""
        if o.lo <= 0 <= o.hi:
            return Interval.top()

        def t(a, b):
            if not (math.isfinite(a) and math.isfinite(b)):
                return _div(a, b)
            return float(math.floor(a / b))

        cs = (t(self.lo, o.lo), t(self.lo, o.hi),
              t(self.hi, o.lo), t(self.hi, o.hi))
        return Interval(min(cs), max(cs))

    def sum_n(self, n: int) -> "Interval":
        """Sum of n elements each drawn from this interval."""
        return Interval(_mul(float(n), self.lo), _mul(float(n), self.hi))

    def abs(self) -> "Interval":
        if self.lo >= 0:
            return self
        if self.hi <= 0:
            return -self
        return Interval(0.0, self.max_abs())

    def maximum(self, o: "Interval") -> "Interval":
        return Interval(max(self.lo, o.lo), max(self.hi, o.hi))

    def minimum(self, o: "Interval") -> "Interval":
        return Interval(min(self.lo, o.lo), min(self.hi, o.hi))

    def clamp(self, lo: "Interval", hi: "Interval") -> "Interval":
        """clamp(x, lo, hi) = min(max(x, lo), hi)."""
        return self.maximum(lo).minimum(hi)

    def monotone(self, f) -> "Interval":
        """Apply a monotone-nondecreasing scalar map to both ends."""
        return Interval(f(self.lo), f(self.hi))

    def shift_right(self, n: "Interval") -> "Interval":
        """Arithmetic right shift: floor division by 2**n."""
        if not n.is_point():
            shifts = [int(n.lo), int(n.hi)]
        else:
            shifts = [int(n.lo)]
        los, his = [], []
        for s in shifts:
            d = float(2 ** max(s, 0))
            los.append(math.floor(self.lo / d)
                       if math.isfinite(self.lo) else self.lo)
            his.append(math.floor(self.hi / d)
                       if math.isfinite(self.hi) else self.hi)
        return Interval(min(los), max(his))

    def __repr__(self) -> str:  # compact for findings/certificates
        def f(v):
            if math.isfinite(v) and v == int(v) and abs(v) < 2**63:
                return str(int(v))
            return f"{v:.3g}"
        return f"[{f(self.lo)}, {f(self.hi)}]"
