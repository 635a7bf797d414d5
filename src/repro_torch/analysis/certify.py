"""Overflow certificates for the Eq. 2 INT32 group accumulator (qlint).
Port of ``repro/analysis/certify.py``: the same contract, API and
verdicts, with the bound derived by the port's own interval interpreter
(:mod:`.interp`) over a traced aten graph.

The certificate contract
------------------------
A :class:`Certificate` states, for one (kernel, config):

    under the activation contract |x| <= qmax(a_bits) and the weight
    contract |w| <= qmax(w_bits), with the GIVEN integer scales, the
    worst-case magnitude any integer value reaches in the accumulation
    chain is ``bound`` — and ``bound < 2**31`` implies the kernel can
    NEVER overflow INT32, for any input.

The bound comes from the interpreter over a traced graph — either a
registered kernel's plain version (registry path) or the port's own
int32 Eq. 2 contraction (``core.integer_scale._is_accumulate``, the
per-layer path used at quantization time) — never from a formula.

Verdicts:

* ``certified``    — safe at the requested amplifier.
* ``capped-alpha`` — the requested amplifier could overflow; the largest
  safe alpha = 2^e (``resolved_alpha``) was substituted.
* ``fallback``     — no power-of-two amplifier >= 1 is statically safe:
  the layer must take the paper's §B.4 de-amplified safe GEMM.

``finish_quant`` (core/qlinear.py) calls :func:`resolve_amplifier` for
every integer-scale layer and applies the verdict; every certificate
passes through :func:`record` into a module-level log (:func:`log`,
:func:`summary`) so PTQ and recipes can surface what was certified,
capped, or demoted.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import numpy as np

from repro_torch import obs

from .intervals import Interval

INT32_LIMIT = float(2**31)


def _qmax(bits: int) -> int:
    return 2 ** (bits - 1) - 1


@dataclasses.dataclass(frozen=True)
class Certificate:
    kernel: str      # kernel entry / layer path this certifies
    config: str      # human-readable config (bits, group, K, ...)
    alpha: int       # requested amplifier
    resolved_alpha: int  # amplifier after capping (== alpha if certified)
    bound: float     # worst-case |integer accumulator| at resolved_alpha
    verdict: str     # "certified" | "capped-alpha" | "fallback"

    @property
    def ok(self) -> bool:
        """Gate semantics: capping is designed actuation, not a failure."""
        return self.verdict in ("certified", "capped-alpha")

    def __str__(self) -> str:
        extra = ""
        if self.verdict == "capped-alpha":
            extra = f" alpha {self.alpha}->{self.resolved_alpha}"
        return (f"[{self.verdict}] {self.kernel} ({self.config}) "
                f"bound={self.bound:.3g} "
                f"({self.bound / INT32_LIMIT:.3f} of 2^31){extra}")


# -- certificate log (consumed by ptq / recipe summaries) -------------------

_LOG: list[Certificate] = []
_CONTEXT: list[str] = []


@contextlib.contextmanager
def context(label: str):
    """Label certificates recorded inside (e.g. the PTQ layer path)."""
    _CONTEXT.append(label)
    try:
        yield
    finally:
        _CONTEXT.pop()


def record(cert: Certificate) -> Certificate:
    """Single chokepoint every certificate passes through — also the place
    the ``qcert_verdicts_total{verdict}`` telemetry counter ticks."""
    _LOG.append(cert)
    obs.current_registry().counter(
        "qcert_verdicts_total",
        "INT32-overflow certificates by verdict", ("verdict",),
    ).inc(verdict=cert.verdict)
    return cert


def log() -> list[Certificate]:
    return list(_LOG)


def clear_log() -> None:
    _LOG.clear()


def summary(certs: list[Certificate] | None = None) -> dict:
    """{"certified": n, "capped-alpha": n, "fallback": n, "worst_frac": f}"""
    certs = _LOG if certs is None else certs
    out = {"certified": 0, "capped-alpha": 0, "fallback": 0}
    worst = 0.0
    for c in certs:
        out[c.verdict] = out.get(c.verdict, 0) + 1
        worst = max(worst, c.bound / INT32_LIMIT)
    out["worst_frac"] = round(worst, 4)
    return out


# -- per-layer static bound (the port's Eq. 2 int32 contraction) ------------


@functools.lru_cache(maxsize=None)
def _contraction_graph(G: int, gs: int, N: int):
    """The port's Eq. 2 int32 contraction traced on CPU tensors: per-group
    int32 partials, int32 scale multiply, int32 sum over groups."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core.integer_scale import ISWeight, _is_accumulate
    from repro_torch.core.quant import int32_partials

    def f(xq, w, int_scale):
        with int32_partials():
            return _is_accumulate(xq, ISWeight(w, int_scale, 1, 8, gs))

    # fake tensors: the trace records shapes and dtypes, computes nothing
    return make_fx(f, tracing_mode="fake")(
        torch.zeros((8, G * gs), dtype=torch.int8),
        torch.zeros((G * gs, N), dtype=torch.int8),
        torch.ones((G, N), dtype=torch.int32))


def static_accum_bound(int_scale, *, group_size: int, w_bits: int,
                       a_bits: int = 8) -> float:
    """Worst-case |int32 accumulator| for Eq. 2 with these integer scales.

    Seeds: activations from the a_bits contract, weight codes from the
    w_bits code range, scales tight from the concrete array; the bound is
    whatever the interval pass derives over the traced contraction. It
    dominates ``integer_scale.empirical_max_accum`` on any input that
    satisfies the contracts (tested in tests/test_torch_analysis.py).
    """
    ints = np.asarray(int_scale)
    if ints.ndim != 2:
        raise ValueError(f"int_scale must be (G, N), got {ints.shape}")
    G, N = ints.shape
    from .interp import analyze_graph

    gm = _contraction_graph(G, int(group_size), N)
    qa, qw = _qmax(a_bits), _qmax(w_bits)
    seeds = [Interval(-qa, qa), Interval(-qw, qw), Interval.of_array(ints)]
    return analyze_graph(gm, seeds).int_accum_bound


def _int_scales_at(scales: np.ndarray, alpha: int) -> np.ndarray:
    """Mirror of integer_scale.integerize's rounding (numpy)."""
    return np.clip(np.round(scales.astype(np.float64) * alpha),
                   1, 2**31 - 1)


def resolve_amplifier(scales, *, alpha: int, group_size: int, w_bits: int,
                      a_bits: int = 8, kernel: str = "") -> Certificate:
    """Certify ``alpha`` for a layer's float scales — or cap it.

    Searches downward over power-of-two amplifiers for the largest
    statically safe one; the bound is monotone in max(int_scale), so a
    per-unit coefficient jumps straight to the largest plausibly safe
    exponent, which one more interval run verifies. Returns (and logs) a
    Certificate; callers apply ``resolved_alpha``.
    """
    s = np.asarray(scales, np.float32)
    if s.ndim == 1:
        s = s[:, None]
    kernel = kernel or "/".join(_CONTEXT) or "layer"
    e0 = int(round(math.log2(alpha)))
    cfg = (f"W{w_bits}A{a_bits} g{group_size} K={s.shape[0] * group_size} "
           f"alpha=2^{e0}")
    kw = dict(group_size=group_size, w_bits=w_bits, a_bits=a_bits)

    bound0 = static_accum_bound(_int_scales_at(s, alpha), **kw)
    if bound0 < INT32_LIMIT:
        return record(Certificate(kernel, cfg, alpha, alpha, bound0,
                                  "certified"))

    smax = float(s.max())
    coeff = bound0 / max(float(_int_scales_at(s, alpha).max()), 1.0)
    for e in range(e0 - 1, -1, -1):
        max_int = max(1.0, float(np.round(smax * 2**e)))
        if coeff * max_int >= INT32_LIMIT:
            continue
        bound = static_accum_bound(_int_scales_at(s, 2**e), **kw)
        if bound < INT32_LIMIT:
            return record(Certificate(kernel, cfg, alpha, 2**e, bound,
                                      "capped-alpha"))
    return record(Certificate(kernel, cfg, alpha, alpha, bound0, "fallback"))


# -- registry-kernel certification (bound from the traced plain version) ----


def certify_analysis(name: str, config: str, analysis, *,
                     alpha) -> Certificate:
    """Certificate for an analyzed kernel trace: the bound is the interval
    pass's worst integer-arithmetic magnitude over the kernel's traced
    plain version (its int32 contraction on the CPU), not over the
    reference contraction."""
    bound = analysis.int_accum_bound
    a = int(alpha) if alpha else 1
    verdict = "certified" if bound < INT32_LIMIT else "fallback"
    return record(Certificate(name, config, a, a, bound, verdict))


# -- spec-level verdict (no tensors yet: recipe summaries) ------------------

# Scale contract for data-free spec verdicts: fine-grained RTN group scales
# satisfy scale = group absmax / qmax, and the paper's LLaMA/Mistral
# families sit well below absmax=0.35 per group => scale < 0.05 for W4.
# Quantization-time certificates (above) replace this assumption with the
# layer's real scales; the spec verdict only feeds recipe summaries.
SCALE_CONTRACT = 0.05


def spec_verdict(spec, K: int) -> str:
    """Static verdict for a QuantSpec at contraction size K.

    Returns one of "certified" / "capped-alpha" / "fallback" for integer-
    scale specs (under the SCALE_CONTRACT assumption), "n/a" for float-
    scale / weight-only / coarse specs (no INT32 accumulation to certify),
    and "data-dependent" for heuristic amplifiers (resolved per layer at
    quantization time).
    """
    if spec is None or spec.weight_only or spec.scale_mode != "integer" \
            or not spec.fine_grained:
        return "n/a"
    if isinstance(spec.amplifier, str):
        return "data-dependent"
    if K % spec.group_size:
        return "n/a"
    G = K // spec.group_size
    scales = np.full((G, 1), SCALE_CONTRACT, np.float32)
    cert = resolve_amplifier(
        scales, alpha=int(spec.amplifier), group_size=spec.group_size,
        w_bits=spec.w_bits, a_bits=spec.a_bits,
        kernel=f"spec:{spec.name}@K={K}")
    return cert.verdict
