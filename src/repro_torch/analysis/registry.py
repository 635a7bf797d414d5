"""Kernel/config registry walked by ``python -m repro_torch.analysis.qlint``.
Port of ``repro/analysis/registry.py``: the reference's 17 entries, each
with its counterpart in the port.

A CUDA kernel has no graph to trace, so an entry gives three things, one
for each level qlint checks:

* ``build`` returns ``(fn, args, input_ranges)``: ``fn(*args)`` is the
  kernel's wrapper called on CPU tensors, so it runs (and ``make_fx``
  traces) the plain PyTorch version, the kernel's arithmetic. Static
  operands (weights, scales) are seeded tight from their values;
  ``input_ranges`` maps arg positions to an :class:`Interval` contract
  range (or ``interp.DATA``) for activations and ragged row counts.
* ``sources``: the ``csrc`` sources it compiles to (the PTX level).
* ``plans``: each launch as a :class:`~.interp.LaunchPlan`, from
  ``kernels/w4a8_gemm.launch_plan`` (every GEMM kernel's) on the H100's
  132 SMs, act_quant's and flash attention's own launch arithmetic.

Set ``integer_scale=True`` (and ``alpha``) iff the kernel carries the
Eq. 2 INT32 accumulation: it then gets an overflow certificate and the
float-accumulation rule. The synthetic shapes and seeds are the
reference's: small, but multi-tile where it matters (several groups per
split, packed int4 weights, padded ragged expert slabs).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np

from .interp import DATA, LaunchPlan, Operand, units
from .intervals import Interval

# synthetic shapes — the reference's (its K block BK = 256 has no
# counterpart: the port's kernels split K by their launch plan)
M, K, N, GS = 8, 512, 256, 128
E, C = 2, 64
# engine decode shapes: a decode tick routes at most max_slots * top_k
# tokens, so per-expert capacity snaps to the 8-row floor
E_DEC, C_DEC = 4, 8
SMS = 132  # the H100's SMs: the launch plans are the card's


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    name: str
    config: str
    build: Callable[[], tuple]  # -> (fn, args, input_ranges)
    integer_scale: bool = False
    alpha: float | None = None
    a_bits: int = 8
    sources: tuple = ()   # csrc sources the entry's launches compile to
    plans: tuple = ()     # LaunchPlan per launch
    op: Any = None        # fixtures: the CUDA op (run_on_card)
    note: str = ""        # what the trace stands for, where it differs


def _t(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def _codes(rng, k, n, bits):
    q = 2 ** (bits - 1) - 1
    return rng.integers(-q, q + 1, size=(k, n)).astype(np.int8)


def _packed(codes4):
    from repro_torch.core import packing

    return packing.pack_int4(_t(codes4)).numpy()


def _w4_operands(rng, k=K, n=N, alpha=1024):
    packed = _packed(_codes(rng, k, n, 4))
    scales = rng.uniform(0.005, 0.02, (k // GS, n)).astype(np.float32)
    ints = np.clip(np.round(scales * alpha), 1, 2**31 - 1).astype(np.int32)
    return packed, scales, ints


def _w8_operands(rng, k=K, n=N):
    """W8 scales are ~18x smaller; the amplifier follows the shipped
    heuristic+6 spec (recipe.W8A8_FG)."""
    from repro_torch.core import integer_scale as isc

    codes = _codes(rng, k, n, 8)
    scales = rng.uniform(8e-4, 1.2e-3, (k // GS, n)).astype(np.float32)
    exp = isc.heuristic_amplifier_exp(_t(scales)) + 6
    alpha = int(2 ** min(exp, isc.MAX_AMPLIFIER_EXP))
    ints = np.clip(np.round(scales * alpha), 1, 2**31 - 1).astype(np.int32)
    return codes, scales, ints, alpha


def _sa(rng, *lead):
    return rng.uniform(1e-3, 0.05, (*lead, 1)).astype(np.float32)


# ---------------------------------------------------------------------------
# Launch plans
# ---------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _live(m: Interval, counts: Interval | None, bm: int) -> Interval:
    """The m-tiles a ragged launch runs: those below cdiv(count, bm) (the
    kernel skips the rest, writing their rows as +0.0)."""
    if counts is None:
        return m
    return Interval(m.lo, min(m.hi, float(_cdiv(int(counts.hi), bm) - 1)))


def gemm_plan(kernel: str, Mr: int, Nc: int, Kc: int, gs: int, *,
              w_bits: int = 4, experts: int = 1,
              counts: Interval | None = None) -> LaunchPlan:
    """The launch of a GEMM kernel on the loops ``csrc/w4a8_ring.cuh`` /
    ``csrc/w4a16_ring.cuh``: ``launch_plan``'s row tile and K split; the
    grid (n-block, m-block, expert, split), which the kernel folds into
    ``blockIdx`` (x, y, z = expert * splits + split); K in 128-row packing
    units. Rows and columns past the extents are masked."""
    from repro_torch.core.packing import LAYOUT_UNIT
    from repro_torch.kernels.w4a8_gemm import TILE_N, launch_plan

    p = launch_plan(Mr, Nc, Kc, SMS, experts=experts)
    bm, S, U = p["bm"], p["splits"], Kc // LAYOUT_UNIT
    Ex, gs = experts, gs if gs > 0 else Kc

    def groups(s):
        u = units(s, U, S)
        return Interval(float(u.lo * LAYOUT_UNIT // gs),
                        float(((u.hi + 1) * LAYOUT_UNIT - 1) // gs))

    wo = kernel.endswith("w4a16") or kernel == "w4a16_gemm"
    rows_w = Kc // 2 if w_bits == 4 else Kc
    unit_w = LAYOUT_UNIT // 2 if w_bits == 4 else LAYOUT_UNIT
    ops = [
        Operand("x", (Ex, Mr, Kc), (1, bm, LAYOUT_UNIT),
                lambda n, m, e, s, c: (e, _live(m, c, bm), units(s, U, S)),
                guarded=(1,)),
        Operand("w", (Ex, rows_w, Nc), (1, unit_w, TILE_N),
                lambda n, m, e, s, c: (e, units(s, U, S), n), guarded=(2,)),
        Operand("scale", (Ex, Kc // gs, Nc), (1, 1, TILE_N),
                lambda n, m, e, s, c: (e, groups(s), n), guarded=(2,)),
        Operand("out", (Ex, Mr, Nc), (1, bm, TILE_N),
                lambda n, m, e, s, c: (e, m, n), guarded=(1, 2), output=True),
    ]
    if not wo:
        ops.insert(1, Operand("sa", (Ex, Mr), (1, bm),
                              lambda n, m, e, s, c: (e, _live(m, c, bm)),
                              guarded=(1,)))
    if kernel.endswith("_is"):
        ops.insert(2, Operand("alpha", (Ex,), (1,),
                              lambda n, m, e, s, c: (e,)))
    if counts is not None:
        ops.append(Operand("counts", (Ex,), (1,),
                           lambda n, m, e, s, c: (e,)))
    if S > 1:
        ops.append(Operand("workspace", (S, Ex, Mr, Nc), (1, 1, bm, TILE_N),
                           lambda n, m, e, s, c: (s, e, m, n),
                           guarded=(2, 3), output=True))
    grid = (_cdiv(Nc, TILE_N), _cdiv(Mr, bm), Ex, S)
    return LaunchPlan(kernel, grid, tuple(ops), k=Kc, splits=S,
                      unit=LAYOUT_UNIT, counts=counts)


def act_quant_plan(rows: int, Kc: int, elem_bytes: int = 4, *,
                   C: int = 0, counts: Interval | None = None) -> LaunchPlan:
    """``csrc/act_quant.cu``'s launch (its ``launch``): 2^sh threads a row
    (two 16-byte chunks a thread where the row has them, at most 1024),
    blocks of at least 256 threads holding ``per`` rows each, rows past
    the end masked; the routed entry reads counts[row / C]."""
    v = 16 // elem_bytes
    nch, sh = _cdiv(Kc, v), 5
    while (1 << sh) < 1024 and (4 << sh) <= nch:
        sh += 1
    per = max(1 << sh, 256) >> sh

    def rows_of(i):
        return Interval(i.lo * per, min((i.hi + 1) * per - 1, rows - 1))

    ops = [Operand("x", (rows, Kc), (per, Kc), lambda i, c: (i, 0),
                   guarded=(0,)),
           Operand("q", (rows, Kc), (per, Kc), lambda i, c: (i, 0),
                   guarded=(0,), output=True),
           Operand("scale", (rows, 1), (per, 1), lambda i, c: (i, 0),
                   guarded=(0,), output=True)]
    if counts is not None:
        ops.append(Operand("counts", (rows // C,), (1,),
                           lambda i, c: (rows_of(i).floordiv(
                               Interval.point(C)),)))
    return LaunchPlan("act_quant", (_cdiv(rows, per),), tuple(ops),
                      counts=counts)


def flash_plan(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
               bf16: bool = False) -> LaunchPlan:
    """``csrc/flash_attention.cu``'s launch: one block per (batch, query
    head, query tile: 64 rows f32, 32 bf16), which walks the key tiles of
    64 of its KV head (query head h reads KV head h // (Hq / Hkv)); query
    and key rows past the extents are masked."""
    bq, bk, grp = (32 if bf16 else 64), 64, Hq // Hkv
    kt = Interval(0.0, float(_cdiv(Sk, bk) - 1))

    def kv(b, h, q, c):
        return (b, kt, h.floordiv(Interval.point(grp)), 0)

    ops = (Operand("q", (B, Sq, Hq, D), (1, bq, 1, D),
                   lambda b, h, q, c: (b, q, h, 0), guarded=(1,)),
           Operand("k", (B, Sk, Hkv, D), (1, bk, 1, D), kv, guarded=(1,)),
           Operand("v", (B, Sk, Hkv, D), (1, bk, 1, D), kv, guarded=(1,)),
           Operand("o", (B, Sq, Hq, D), (1, bq, 1, D),
                   lambda b, h, q, c: (b, q, h, 0), guarded=(1,),
                   output=True))
    return LaunchPlan("flash_attention", (B, Hq, _cdiv(Sq, bq)), ops)


# ---------------------------------------------------------------------------
# Entries' builds: the port's wrappers on CPU tensors (= plain versions)
# ---------------------------------------------------------------------------


def _build_dense_is(w_bits: int, a_bits: int):
    def build():
        from repro_torch.kernels import w4a8_gemm as W

        rng = np.random.default_rng(0)
        if w_bits == 4:
            wq, _, ints = _w4_operands(rng)
            alpha = 1024.0
        else:
            wq, _, ints, alpha = _w8_operands(rng)
        qa = 2 ** (a_bits - 1) - 1
        fn = functools.partial(W.fg_gemm_integer_scale, group_size=GS,
                               alpha=float(alpha), w_bits=w_bits)
        args = (_t(np.zeros((M, K), np.int8)), _t(_sa(rng, M)), _t(wq),
                _t(ints))
        return fn, args, {0: Interval(-qa, qa)}
    return build


def _build_dense_fs(group_size: int):
    def build():
        from repro_torch.kernels import w4a8_gemm_fscale as W

        rng = np.random.default_rng(1)
        wq, scales, _ = _w4_operands(rng)
        if group_size <= 0:
            scales = scales.max(axis=0, keepdims=True)  # (1, N) coarse
        fn = functools.partial(W.fg_gemm_float_scale, group_size=group_size,
                               w_bits=4)
        args = (_t(np.zeros((M, K), np.int8)), _t(_sa(rng, M)), _t(wq),
                _t(scales))
        return fn, args, {0: Interval(-127, 127)}
    return build


def _build_w4a16():
    from repro_torch.kernels import w4a16_gemm as W

    rng = np.random.default_rng(2)
    wq, scales, _ = _w4_operands(rng)
    fn = functools.partial(W.w4a16_gemm, group_size=GS)
    args = (_t(np.zeros((M, K), np.float32)), _t(wq), _t(scales))
    return fn, args, {0: DATA}


def _build_act_quant():
    from repro_torch.kernels import act_quant as A

    fn = functools.partial(A.act_quant, bits=8)
    return fn, (_t(np.zeros((64, 256), np.float32)),), {0: DATA}


def _build_flash():
    from repro_torch.kernels import flash_attention as F

    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 256, 2, 64)).astype(np.float32)
    k = rng.normal(size=(1, 256, 1, 64)).astype(np.float32)
    v = rng.normal(size=(1, 256, 1, 64)).astype(np.float32)
    fn = functools.partial(F.flash_attention, causal=True)
    return fn, (_t(q), _t(k), _t(v)), {0: DATA, 1: DATA, 2: DATA}


def _moe_w4(rng, n_experts=E, alpha=1024):
    packed, ints = [], []
    for _ in range(n_experts):
        p, _, i = _w4_operands(rng, alpha=alpha)
        packed.append(p)
        ints.append(i)
    return np.stack(packed), np.stack(ints)


def _build_moe_dense(integer: bool):
    def build():
        from repro_torch.kernels import moe_gemm as MG

        rng = np.random.default_rng(4)
        packed, ints = _moe_w4(rng)
        if integer:
            fn = functools.partial(MG.fg_grouped_gemm_integer_scale,
                                   group_size=GS, alpha=1024.0, w_bits=4)
            scale_arg = ints
        else:
            fn = functools.partial(MG.fg_grouped_gemm_float_scale,
                                   group_size=GS, w_bits=4)
            scale_arg = (ints / 1024.0).astype(np.float32)
        args = (_t(np.zeros((E, C, K), np.int8)), _t(_sa(rng, E, C)),
                _t(packed), _t(scale_arg))
        return fn, args, {0: Interval(-127, 127)}
    return build


def _build_moe_ragged(integer: bool, n_experts: int, cap: int, seed: int,
                      rc: list):
    def build():
        from repro_torch.kernels import moe_gemm as MG

        rng = np.random.default_rng(seed)
        packed, ints = _moe_w4(rng, n_experts)
        if integer:
            fn = functools.partial(
                MG.fg_grouped_gemm_integer_scale_ragged, group_size=GS,
                alpha=1024.0, a_bits=8, w_bits=4)
            scale_arg = ints
        else:
            fn = functools.partial(
                MG.fg_grouped_gemm_float_scale_ragged, group_size=GS,
                a_bits=8, w_bits=4)
            scale_arg = (ints / 1024.0).astype(np.float32)
        args = (_t(np.zeros((n_experts, cap, K), np.float32)),
                _t(np.asarray(rc, np.int32)), _t(packed), _t(scale_arg))
        return fn, args, {0: DATA, 1: Interval(0, cap)}
    return build


def _qspec_is():
    from repro_torch.core.recipe import QuantSpec

    return QuantSpec(w_bits=4, a_bits=8, group_size=GS,
                     scale_mode="integer", amplifier=1024)


def _build_ops_dense():
    """The instrumented ``kernels.ops.qgemm`` wrapper end to end (its
    telemetry is host-side Python, so the traced graph stays the bare
    act-quant + integer-scale composition)."""
    import torch

    from repro_torch.kernels import ops

    rng = np.random.default_rng(8)
    wq, _, ints = _w4_operands(rng)
    params = {"qvalue": _t(wq), "scale": _t(ints),
              "alpha": torch.tensor(1024.0)}
    spec = _qspec_is()

    def fn(x):
        return ops.qgemm(x, params, spec)

    return fn, (_t(np.zeros((M, K), np.float32)),), {0: DATA}


def _build_ops_grouped():
    """The instrumented ``kernels.ops.qgemm_grouped`` wrapper over the
    ragged path (routed rows quantized, then the grouped GEMM; the counts
    a tensor, as the engine feeds them)."""
    import torch

    from repro_torch.kernels import ops

    rng = np.random.default_rng(9)
    packed, ints = _moe_w4(rng)
    params = {"qvalue": _t(packed), "scale": _t(ints),
              "alpha": torch.full((E,), 1024.0)}
    spec = _qspec_is()

    def fn(x, rc):
        return ops.qgemm_grouped(x, params, spec, row_counts=rc)

    args = (_t(np.zeros((E, C, K), np.float32)),
            _t(np.asarray([23, C], np.int32)))
    return fn, args, {0: DATA, 1: Interval(0, C)}


def _build_w4a16_ragged():
    from repro_torch.kernels import moe_gemm as MG

    rng = np.random.default_rng(6)
    packed, scales = [], []
    for _ in range(E):
        p, s, _ = _w4_operands(rng)
        packed.append(p)
        scales.append(s)
    fn = functools.partial(MG.grouped_w4a16_gemm_ragged, group_size=GS)
    args = (_t(np.zeros((E, C, K), np.float32)),
            _t(np.asarray([17, C], np.int32)), _t(np.stack(packed)),
            _t(np.stack(scales)))
    return fn, args, {0: DATA, 1: Interval(0, C)}


_RC = Interval(0.0, float(C))
_RC_DEC = Interval(0.0, float(C_DEC))


def entries() -> list:
    """All shipped kernels x configs, in lint/certify order (the
    reference's, by name)."""
    dense_is = gemm_plan("w4a8_gemm_is", M, N, K, GS)
    dense_fs = gemm_plan("w4a8_gemm_fs", M, N, K, GS)
    coarse = gemm_plan("w4a8_gemm_fs", M, N, K, -1)
    w4a16 = gemm_plan("w4a16_gemm", M, N, K, GS)
    moe_is = gemm_plan("moe_w4a8_is", C, N, K, GS, experts=E)
    moe_fs = gemm_plan("moe_w4a8_fs", C, N, K, GS, experts=E)
    routed = act_quant_plan(E * C, K, C=C, counts=_RC)
    routed_dec = act_quant_plan(E_DEC * C_DEC, K, C=C_DEC, counts=_RC_DEC)

    def ragged(kernel, e, c, rc):
        return gemm_plan(kernel, c, N, K, GS, experts=e, counts=rc)

    ragged_is = ragged("moe_w4a8_is", E, C, _RC)
    ragged_fs = ragged("moe_w4a8_fs", E, C, _RC)
    dec_is = ragged("moe_w4a8_is", E_DEC, C_DEC, _RC_DEC)
    dec_fs = ragged("moe_w4a8_fs", E_DEC, C_DEC, _RC_DEC)
    return [
        KernelEntry("w4a8-is",
                    f"W4A8 g{GS} K={K} alpha=1024 splits={dense_is.splits}",
                    _build_dense_is(4, 8), integer_scale=True, alpha=1024,
                    sources=("w4a8_gemm_is",), plans=(dense_is,)),
        KernelEntry("w8a8-is", f"W8A8 g{GS} K={K} alpha=heuristic+6",
                    _build_dense_is(8, 8), integer_scale=True,
                    sources=("w4a8_gemm_is",),
                    plans=(gemm_plan("w4a8_gemm_is", M, N, K, GS,
                                     w_bits=8),)),
        KernelEntry("w4a4-is", f"W4A4 g{GS} K={K} alpha=1024",
                    _build_dense_is(4, 4), integer_scale=True, alpha=1024,
                    a_bits=4, sources=("w4a8_gemm_is",), plans=(dense_is,),
                    note="the W4A8 IS kernel on 4-bit codes (act_quant "
                         "takes qmax 7); no kernel of its own"),
        KernelEntry("w4a8-fs", f"W4A8 float-scale g{GS} K={K}",
                    _build_dense_fs(GS), sources=("w4a8_gemm_fs",),
                    plans=(dense_fs,)),
        KernelEntry("w4a8-coarse", f"W4A8 per-channel K={K}",
                    _build_dense_fs(-1), sources=("w4a8_gemm_fs",),
                    plans=(coarse,)),
        KernelEntry("w4a16", f"W4A16 weight-only g{GS} K={K}", _build_w4a16,
                    sources=("w4a16_gemm",), plans=(w4a16,)),
        KernelEntry("act-quant", "per-token int8, M=64 K=256",
                    _build_act_quant, sources=("act_quant",),
                    plans=(act_quant_plan(64, 256),)),
        KernelEntry("flash-attention", "causal Sq=Sk=256 bq=64 bk=64",
                    _build_flash, sources=("flash_attention",),
                    plans=(flash_plan(1, 256, 256, 2, 1, 64),)),
        KernelEntry("moe-w4a8-is", f"grouped E={E} C={C} K={K} alpha=1024",
                    _build_moe_dense(True), integer_scale=True, alpha=1024,
                    sources=("moe_w4a8_is",), plans=(moe_is,)),
        KernelEntry("moe-w4a8-fs", f"grouped E={E} C={C} K={K} float-scale",
                    _build_moe_dense(False), sources=("moe_w4a8_fs",),
                    plans=(moe_fs,)),
        KernelEntry("moe-w4a8-is-ragged",
                    f"ragged routed-quant E={E} C={C} K={K} alpha=1024",
                    _build_moe_ragged(True, E, C, 5, [37, C]),
                    integer_scale=True, alpha=1024,
                    sources=("act_quant", "moe_w4a8_is"),
                    plans=(routed, ragged_is)),
        KernelEntry("moe-w4a8-fs-ragged",
                    f"ragged routed-quant E={E} C={C} K={K} float-scale",
                    _build_moe_ragged(False, E, C, 5, [37, C]),
                    sources=("act_quant", "moe_w4a8_fs"),
                    plans=(routed, ragged_fs)),
        KernelEntry("moe-w4a16-ragged",
                    f"ragged weight-only E={E} C={C} K={K}",
                    _build_w4a16_ragged, sources=("moe_w4a16",),
                    plans=(ragged("moe_w4a16", E, C, _RC),)),
        KernelEntry("moe-w4a8-is-ragged-decode",
                    f"engine decode E={E_DEC} C={C_DEC} K={K} alpha=1024",
                    _build_moe_ragged(True, E_DEC, C_DEC, 7,
                                      [0, 3, C_DEC, 5]),
                    integer_scale=True, alpha=1024,
                    sources=("act_quant", "moe_w4a8_is"),
                    plans=(routed_dec, dec_is)),
        KernelEntry("moe-w4a8-fs-ragged-decode",
                    f"engine decode E={E_DEC} C={C_DEC} K={K} float-scale",
                    _build_moe_ragged(False, E_DEC, C_DEC, 7,
                                      [0, 3, C_DEC, 5]),
                    sources=("act_quant", "moe_w4a8_fs"),
                    plans=(routed_dec, dec_fs)),
        KernelEntry("ops-qgemm-is",
                    f"ops.qgemm W4A8-IS g{GS} K={K} alpha=1024",
                    _build_ops_dense, integer_scale=True, alpha=1024,
                    sources=("act_quant", "w4a8_gemm_is"),
                    plans=(act_quant_plan(M, K), dense_is)),
        KernelEntry("ops-qgemm-grouped-is",
                    f"ops.qgemm_grouped ragged E={E} C={C} K={K} alpha=1024",
                    _build_ops_grouped, integer_scale=True, alpha=1024,
                    sources=("act_quant", "moe_w4a8_is"),
                    plans=(routed, ragged_is)),
    ]
