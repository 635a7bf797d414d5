"""Lint rules over analyzed kernels (qlint pass 2). Port of
``repro/analysis/lint.py``, with the reference's rule names.

A rule reads up to three levels of one registered kernel
(:mod:`.registry`): the **aten** graph of its traced plain version
(:class:`~.interp.Analysis`, here on the CPU), its **plan** (each launch's
:class:`~.interp.LaunchPlan`, here too) and the **ptx** of its CUDA
sources (``kernels/_build.ptx``; ``nvcc`` is on the machine with the card).

``int-dot-preferred-type`` (aten)
    An integer ``mm``/``bmm`` whose result dtype is narrower than int32
    accumulates its partials in that dtype and wraps silently.
``narrowing-convert`` (aten, ptx)
    aten: an int->int ``_to_copy`` whose derived interval does not fit the
    target (in-range narrowing, the int4 nibble unpack, is clean). ptx: a
    value of the integer accumulator chain (the results of an integer MMA,
    of ``dp4a``, or of an integer multiply of two loaded values, and all
    integer arithmetic on them) converted to, extracted as, moved into or
    stored as 8 or 16 bits. Codes quantized from floats (act_quant) and
    nibbles unpacked from loaded bytes are not on that chain.
``int-overflow`` (aten)
    Integer add/mul/mm/sum whose interval escapes the dtype it accumulates
    in — "the accumulation can overflow before it completes".
``float-accum-on-is-path`` (aten, ptx)
    On kernels registered as integer-scale (Eq. 2): aten: a float
    ``mm``/``bmm``, or more than ONE distinct int32 -> float convert (the
    single final convert is the paper's speedup). ptx: a float MMA, or no
    ``mma...s32.s8.s8.s32`` at all.
``blockspec-divisibility`` (plan)
    A block that does not divide its operand in a dim the kernel does not
    mask, a grid whose blocks leave part of an operand uncovered, or a K
    split off the 128-row packing units.
``index-map-bounds`` (plan)
    A block origin outside its operand anywhere on the grid (ragged counts
    seeded from the wrappers' [0, C] contract).
``uninit-read`` (aten)
    A read of rows of an ``empty`` allocation that nothing wrote (the
    ragged rows past the counts).
"""
from __future__ import annotations

import dataclasses
import re

from .interp import MATMUL_OPS, Analysis, block_indices, is_int, itemsize


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    kernel: str
    message: str
    where: str = ""
    level: str = "aten"  # aten | plan | ptx

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.kernel}: {self.rule} ({self.level}): {self.message}{loc}"


# ---------------------------------------------------------------------------
# aten level
# ---------------------------------------------------------------------------


def rule_int_dot_preferred(entry, an: Analysis) -> list:
    out, seen = [], set()
    for r in an.records:
        if r.prim not in MATMUL_OPS or r.eqn_id in seen:
            continue
        seen.add(r.eqn_id)
        ins = r.in_dtypes[-2:]
        if ins and all(is_int(d) for d in ins) and itemsize(r.out_dtype) < 4:
            out.append(Finding(
                "int-dot-preferred-type", entry.name,
                f"integer {r.prim} accumulates in {r.out_dtype}, not int32",
                r.where))
    return out


def rule_events(entry, an: Analysis) -> list:
    """narrowing-convert / int-overflow / uninit-read events -> findings."""
    out, seen = [], set()
    for e in an.events:
        if e.kind not in ("narrowing-convert", "int-overflow", "uninit-read"):
            continue
        key = (e.kind, e.prim, e.where, e.detail)
        if key in seen:
            continue
        seen.add(key)
        out.append(Finding(e.kind, entry.name, e.detail, e.where))
    return out


def rule_float_accum_on_is_path(entry, an: Analysis) -> list:
    if not entry.integer_scale:
        return []
    out, seen, converts = [], set(), set()
    for r in an.records:
        if r.prim in MATMUL_OPS and r.eqn_id not in seen:
            seen.add(r.eqn_id)
            if not all(is_int(d) for d in r.in_dtypes[-2:]):
                out.append(Finding(
                    "float-accum-on-is-path", entry.name,
                    f"float {r.prim} in an integer-scale kernel (Eq. 2 "
                    "requires the int8 MMA path)", r.where))
        if (r.prim == "_to_copy" and r.in_dtypes and is_int(r.in_dtypes[0])
                and itemsize(r.in_dtypes[0]) >= 4
                and not is_int(r.out_dtype) and r.out_dtype != "bool"):
            converts.add(r.eqn_id)
    if len(converts) > 1:
        out.append(Finding(
            "float-accum-on-is-path", entry.name,
            f"{len(converts)} distinct int->float converts; Eq. 2 allows "
            "ONE (the epilogue) — per-group converts are the Eq. 1 "
            "bottleneck"))
    return out


# ---------------------------------------------------------------------------
# plan level
# ---------------------------------------------------------------------------


def rule_blockspec_divisibility(entry, an: Analysis) -> list:
    out = []
    for p in entry.plans:
        if p.k and (p.k % p.unit or not 1 <= p.splits <= p.k // p.unit):
            out.append(Finding(
                "blockspec-divisibility", entry.name,
                f"{p.kernel}: K={p.k} in {p.splits} splits is off the "
                f"{p.unit}-row packing units", level="plan"))
        for op in p.operands:
            idx = block_indices(p, op)
            for d, (s, b) in enumerate(zip(op.shape, op.block)):
                if s % b and d not in op.guarded:
                    out.append(Finding(
                        "blockspec-divisibility", entry.name,
                        f"{p.kernel} {op.name} dim {d}: extent {s} not "
                        f"divisible by block {b}, edge unmasked",
                        level="plan"))
                if (idx[d].hi + 1) * b < s:
                    out.append(Finding(
                        "blockspec-divisibility", entry.name,
                        f"{p.kernel} {op.name} dim {d}: blocks reach "
                        f"{int((idx[d].hi + 1) * b)} of {s}", level="plan"))
    return out


def rule_index_map_bounds(entry, an: Analysis) -> list:
    out = []
    for p in entry.plans:
        for op in p.operands:
            for d, (iv, s, b) in enumerate(zip(block_indices(p, op),
                                               op.shape, op.block)):
                hi = -(-s // b) - 1
                if not iv.within(0, hi):
                    out.append(Finding(
                        "index-map-bounds", entry.name,
                        f"{p.kernel} {op.name} dim {d}: block index {iv} "
                        f"escapes [0, {hi}]", level="plan"))
    return out


RULES = (
    rule_int_dot_preferred,
    rule_events,
    rule_float_accum_on_is_path,
    rule_blockspec_divisibility,
    rule_index_map_bounds,
)


def run_rules(entry, analysis: Analysis) -> list:
    out = []
    for rule in RULES:
        out.extend(rule(entry, analysis))
    return out


# ---------------------------------------------------------------------------
# ptx level
# ---------------------------------------------------------------------------

_REG = re.compile(r"%[a-z]+\d+")
_NARROW_TYPES = {"s8", "u8", "b8", "s16", "u16", "b16"}
_INT_TYPES = re.compile(r"^[sub](8|16|32|64)$")
_FLOAT_TYPES = {"f16", "bf16", "f32", "f64", "tf32", "e4m3", "e5m2",
                "f16x2", "bf16x2"}


def _instructions(text: str):
    """(line number, function index, opcode, operand strings) of every
    instruction; each ``.entry``/``.func`` starts a new register scope."""
    func = 0
    for no, line in enumerate(text.splitlines(), 1):
        s = line.split("//", 1)[0].strip()
        if s.startswith((".entry", ".visible .entry", ".func",
                         ".visible .func", ".weak .func")):
            func += 1
            continue
        if not s or s.startswith((".", "{", "}", "$")) or not s.endswith(";"):
            continue
        s = re.sub(r"^@!?%\w+\s+", "", s[:-1])
        op, _, rest = s.partition(" ")
        yield no, func, op, _operands(rest)


def _operands(rest: str) -> list:
    out, depth, cur = [], 0, ""
    for ch in rest:
        if ch in "{[":
            depth += 1
        elif ch in "}]":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return out


def _types(op: str) -> list:
    return [p for p in op.split(".")[1:]
            if _INT_TYPES.match(p) or p in _FLOAT_TYPES or p == "pred"]


def _narrow_reg(reg: str) -> bool:
    return reg.startswith(("%rs", "%rc"))


def _taint(body: list) -> tuple[set, set]:
    """(registers holding loaded data, registers on the integer accumulator
    chain) of one function's instructions, to a fixed point (loops carry
    values backwards through the text)."""
    data: set = set()
    acc: set = set()
    changed = True
    while changed:
        n = len(data) + len(acc)
        for _, op, ops in body:
            base = op.split(".")[0]
            if base in _NO_DEST or not ops:
                continue
            types = _types(op)
            dst = set(_REG.findall(ops[0]))
            srcs = [set(_REG.findall(o)) for o in ops[1:]]
            all_src = set().union(*srcs) if srcs else set()
            if (base in ("ld", "ldmatrix", "ldu") and ".param" not in op) \
                    or all_src & data:
                data |= dst
            is_int_op = bool(types) and all(_INT_TYPES.match(t)
                                            for t in types)
            seeds = (base in ("mma", "wgmma") and ".s32" in op) \
                or base in ("dp4a", "dp2a") \
                or (base in ("mad", "mul") and is_int_op and len(srcs) >= 2
                    and srcs[0] & data and srcs[1] & data)
            into_float = bool(types) and types[0] in _FLOAT_TYPES
            if seeds or (all_src & acc and not into_float
                         and base != "setp"):
                acc |= {r for r in dst if not r.startswith(("%f", "%p"))}
        changed = len(data) + len(acc) != n
    return data, acc


_NO_DEST = ("st", "red", "cp", "bar", "bra", "ret", "membar", "fence",
            "call", "exit")


def ptx_accumulator_narrowing(text: str) -> list:
    """(line, instruction) where a value of the integer accumulator chain
    is narrowed to 8 or 16 bits (see ``narrowing-convert``)."""
    funcs: dict = {}
    for no, func, op, ops in _instructions(text):
        funcs.setdefault(func, []).append((no, op, ops))
    hits = []
    for body in funcs.values():
        _, acc = _taint(body)
        for no, op, ops in body:
            base, types = op.split(".")[0], _types(op)
            ins = f"{op} {', '.join(ops)}"
            if base == "st" and len(ops) > 1:
                if set(_REG.findall(ops[1])) & acc and types \
                        and types[-1] in _NARROW_TYPES:
                    hits.append((no, ins))
                continue
            if base in _NO_DEST or len(ops) < 2:
                continue
            if not set().union(*(set(_REG.findall(o)) for o in ops[1:])) \
                    & acc:
                continue
            if base == "cvt" and any(t in _NARROW_TYPES for t in types):
                hits.append((no, ins))
            elif base == "bfe" and len(ops) > 3 and ops[3].isdigit() \
                    and int(ops[3]) <= 16:
                hits.append((no, ins))
            elif any(_narrow_reg(r) for r in _REG.findall(ops[0])):
                hits.append((no, ins))
    return hits


def ptx_mmas(text: str) -> tuple[int, int]:
    """(integer s8/u8 MMAs with an s32 accumulator, float MMAs) in ``text``."""
    n_int = n_float = 0
    for _, _, op, _ in _instructions(text):
        if op.split(".")[0] not in ("mma", "wgmma"):
            continue
        parts = set(op.split("."))
        if "s32" in parts and parts & {"s8", "u8", "s4", "u4"}:
            n_int += 1
        elif parts & _FLOAT_TYPES:
            n_float += 1
    return n_int, n_float


def run_ptx_rules(entry, ptx: dict) -> list:
    """PTX-level findings of ``entry`` over ``ptx`` ({source: text})."""
    out = []
    n_int = 0
    for src in entry.sources:
        text = ptx[src]
        hits = ptx_accumulator_narrowing(text)
        if hits:
            no, ins = hits[0]
            out.append(Finding(
                "narrowing-convert", entry.name,
                f"{len(hits)} instruction(s) narrow the accumulator to 8/16 "
                f"bits, first: {ins}", f"{src}.ptx:{no}", level="ptx"))
        i, f = ptx_mmas(text)
        n_int += i
        if entry.integer_scale and f:
            out.append(Finding(
                "float-accum-on-is-path", entry.name,
                f"{f} float MMAs in an integer-scale kernel", f"{src}.ptx",
                level="ptx"))
    if entry.integer_scale and not n_int:
        out.append(Finding(
            "float-accum-on-is-path", entry.name,
            "no mma...s32.s8.s8.s32 in an integer-scale kernel "
            f"({', '.join(entry.sources)}): Eq. 2 runs on the int8 MMA",
            level="ptx"))
    return out

