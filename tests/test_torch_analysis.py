"""The port's overflow certificates and qlint (``repro_torch.analysis``)
against the reference's (``repro.analysis``), on the CPU.

Certificates are compared field by field (verdict, resolved alpha, bound
as a float, config string): both bounds come from an interval pass over
the same int32 Eq. 2 contraction, so they are equal, not close. The
quantized weights they cap are bit-identical. The lint rules run at the
aten and launch-plan levels here; the PTX level is exercised on synthetic
PTX text here and on the real sources on the card
(``tests/test_torch_cuda.py``).

The reference's interval interpreter reads ``jax.core.Literal``, which
JAX 0.9 moved to ``jax.extend.core``: the ``jax_literal`` fixture aliases
it around the reference's calls only.
"""
import dataclasses
import inspect

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro import obs as jobs
from repro.analysis import certify as jcertify
from repro.analysis import fixtures as jfixtures
from repro.core import integer_scale as jisc
from repro.core import ptq as jptq
from repro.core import qlinear as jqlinear
from repro.core.recipe import DEFAULT_RECIPE as JDEFAULT
from repro.core.recipe import QuantRecipe as JRecipe
from repro.core.recipe import QuantSpec as JSpec
from repro.core.recipe import W8A8_FG as JW8A8
from repro.core.recipe import certify_recipe as jcertify_recipe
from repro.models.config import ModelConfig as JConfig
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro_torch import convert, obs
from repro_torch.analysis import certify, fixtures, qlint, registry
from repro_torch.analysis.interp import DATA, analyze_fn
from repro_torch.analysis.intervals import Interval
from repro_torch.analysis.lint import (ptx_accumulator_narrowing, ptx_mmas,
                                       run_ptx_rules)
from repro_torch.core import integer_scale as isc
from repro_torch.core import ptq, qlinear
from repro_torch.core.quant import QWeight
from repro_torch.core.recipe import (DEFAULT_RECIPE, W4A8_FS, W8A8_FG,
                                     QuantRecipe, QuantSpec, certify_recipe)
from repro_torch.kernels import _build
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model

FIELDS = ("verdict", "resolved_alpha", "bound", "config")


@pytest.fixture
def jax_literal():
    """Alias ``jax.core.Literal`` for the reference's interpreter, for
    this test only (undone at teardown)."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "Literal"):
            mp.setattr(jax.core, "Literal", jax.extend.core.Literal,
                       raising=False)
        yield


def _same_cert(port, ref):
    for f in FIELDS:
        assert getattr(port, f) == getattr(ref, f), (f, port, ref)


def _motivation_weight():
    """(4096, 24) f32 N(0, 0.01) with one large entry: group 0's maximum
    is far above every other group's."""
    w = (np.random.default_rng(0).normal(size=(4096, 24)) * 0.01
         ).astype(np.float32)
    w[0, 0] = 3.0
    return w


# ---------------------------------------------------------------------------
# the fault: the amplifier cap equals the reference's certificate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("amplifier", [2**16, 2**18, 2**20])
def test_alpha_cap_uneven_groups_equals_reference(jax_literal, amplifier):
    """Group maxima that differ: the reference caps by G x gs x qmax_a x
    qmax_w x max(int_scale), so it stores alpha = 1024 where a sum of
    per-group maxima would admit 16384. The port must store the
    reference's alpha, integer scales and certificate."""
    w = _motivation_weight()
    certify.clear_log()
    jcertify.clear_log()
    tp = qlinear.quantize_linear(torch.from_numpy(w),
                                 QuantSpec(amplifier=amplifier))
    jp = jqlinear.quantize_linear(jnp.asarray(w), JSpec(amplifier=amplifier))
    assert float(tp["alpha"]) == float(jp["alpha"]) == 1024.0
    for k in ("qvalue", "scale", "alpha"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    _same_cert(certify.log()[-1], jcertify.log()[-1])
    assert certify.log()[-1].verdict == "capped-alpha"


# ---------------------------------------------------------------------------
# certificates field by field
# ---------------------------------------------------------------------------


def _scales(case: str, w_bits: int) -> tuple[np.ndarray, int, int]:
    """(scales (G, N), requested alpha, group size) of one case."""
    rng = np.random.default_rng(7)
    small = 0.01 if w_bits == 4 else 1e-3
    if case == "certified":
        return (rng.uniform(0.5, 2.0, (4, 8)) * small).astype(np.float32), \
            1024 if w_bits == 4 else 2**16, 128
    if case == "capped-even":
        return np.full((4, 8), small, np.float32), 2**20, 128
    if case == "capped-uneven":
        s = (rng.uniform(0.5, 1.0, (32, 8)) * small).astype(np.float32)
        s[0, 0] = 0.4
        return s, 2**20, 128
    assert case == "fallback"  # too large even at alpha = 1
    return np.full((256, 2), 100.0, np.float32), 1024, 128


@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("case", ["certified", "capped-even",
                                  "capped-uneven", "fallback"])
def test_resolve_amplifier_equals_reference(jax_literal, case, w_bits):
    s, alpha, gs = _scales(case, w_bits)
    got = certify.resolve_amplifier(s, alpha=alpha, group_size=gs,
                                    w_bits=w_bits, kernel="x")
    want = jcertify.resolve_amplifier(s, alpha=alpha, group_size=gs,
                                      w_bits=w_bits, kernel="x")
    _same_cert(got, want)
    assert got.verdict == case.split("-")[0].replace("capped",
                                                     "capped-alpha")


@pytest.mark.parametrize("w_bits,amplifier", [
    (4, 1024), (4, 2**20), (8, "heuristic+6"), (8, 2**24), (8, 2**30)])
@pytest.mark.parametrize("uneven", [False, True])
def test_finish_quant_certificate_equals_reference(jax_literal, w_bits,
                                                   amplifier, uneven):
    w = (np.random.default_rng(3).normal(size=(1024, 16)) * 0.02
         ).astype(np.float32)
    if uneven:
        w[5, 3] = 2.0
    certify.clear_log()
    jcertify.clear_log()
    tp = qlinear.quantize_linear(torch.from_numpy(w), QuantSpec(
        w_bits=w_bits, amplifier=amplifier))
    jp = jqlinear.quantize_linear(jnp.asarray(w), JSpec(
        w_bits=w_bits, amplifier=amplifier))
    for k in ("qvalue", "scale", "alpha"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    _same_cert(certify.log()[-1], jcertify.log()[-1])


def test_spec_verdicts_equal_reference(jax_literal):
    for spec, jspec in ((QuantSpec(), JSpec()),
                        (W4A8_FS, JSpec(scale_mode="float")),
                        (W8A8_FG, JW8A8), (None, None)):
        for K in (512, 100, 1 << 17, 1 << 22):
            assert certify.spec_verdict(spec, K) == \
                jcertify.spec_verdict(jspec, K), (spec, K)
    assert [certify.spec_verdict(QuantSpec(), K)
            for K in (512, 1 << 17, 1 << 22)] == [
        "certified", "capped-alpha", "fallback"]


def test_certify_recipe_default_equals_reference(jax_literal):
    dims = {"d_model": 256, "d_ff": 512}
    got = certify_recipe(DEFAULT_RECIPE, dims)
    assert got == jcertify_recipe(JDEFAULT, dims)
    assert got == {"*@d_model": "certified", "*@d_ff": "certified"}


# ---------------------------------------------------------------------------
# the static bound dominates the empirical accumulator
# ---------------------------------------------------------------------------


def _random_case(rng, w_bits, G, gs, alpha):
    K, N, T = G * gs, 8, 16
    qw_max = 2 ** (w_bits - 1) - 1
    codes = rng.integers(-qw_max, qw_max + 1, (K, N)).astype(np.int8)
    scales = rng.uniform(1e-4, 0.05, (G, N)).astype(np.float32)
    isw = isc.integerize(QWeight(torch.from_numpy(codes),
                                 torch.from_numpy(scales), w_bits, gs), alpha)
    xq = rng.integers(-127, 128, (T, K)).astype(np.int8)
    return xq, isw


def _assert_dominates(w_bits, G, gs, alpha_exp, seed):
    rng = np.random.default_rng(seed)
    xq, isw = _random_case(rng, w_bits, G, gs, 2 ** alpha_exp)
    bound = certify.static_accum_bound(isw.int_scale.numpy(), group_size=gs,
                                       w_bits=w_bits)
    emp = isc.empirical_max_accum(torch.from_numpy(xq), isw)
    assert bound >= emp, (w_bits, G, gs, alpha_exp, bound, emp)
    return xq, isw, bound


@settings(max_examples=25, deadline=None)
@given(w_bits=st.sampled_from([4, 8]), G=st.integers(1, 4),
       gs=st.sampled_from([64, 128]), alpha_exp=st.integers(4, 14),
       seed=st.integers(0, 2**31 - 1))
def test_static_bound_dominates_empirical_prop(w_bits, G, gs, alpha_exp,
                                               seed):
    _assert_dominates(w_bits, G, gs, alpha_exp, seed)


@pytest.mark.parametrize("case", range(8))
def test_static_bound_dominates_empirical(jax_literal, case):
    """The reference's seeded sweep; each bound and empirical maximum also
    equals the reference's."""
    rng = np.random.default_rng(case)
    args = (int(rng.choice([4, 8])), int(rng.integers(1, 5)),
            int(rng.choice([64, 128])), int(rng.integers(4, 15)), case)
    xq, isw, bound = _assert_dominates(*args)
    jisw = jisc.ISWeight(jnp.asarray(isw.qvalue.numpy()),
                         jnp.asarray(isw.int_scale.numpy()), isw.alpha,
                         isw.bits, isw.group_size)
    assert bound == jcertify.static_accum_bound(
        isw.int_scale.numpy(), group_size=args[2], w_bits=args[0])
    assert isc.empirical_max_accum(torch.from_numpy(xq), isw) == \
        int(jisc.empirical_max_accum(xq, jisw))


# ---------------------------------------------------------------------------
# fixtures flagged, registry clean, CLI
# ---------------------------------------------------------------------------

_EXPECT = {  # tests/test_qlint.py's map
    "broken-fp32-dot": "float-accum-on-is-path",
    "broken-no-preferred": "int-dot-preferred-type",
    "broken-narrowing": "narrowing-convert",
    "broken-index-map": "index-map-bounds",
    "broken-divisibility": "blockspec-divisibility",
}


@pytest.mark.parametrize("entry", fixtures.entries(), ids=lambda e: e.name)
def test_broken_fixture_flagged(entry):
    findings, _, _ = qlint.check_entry(entry)
    assert _EXPECT[entry.name] in {f.rule for f in findings}, findings


def test_fixtures_are_the_references():
    assert [e.name for e in fixtures.entries()] == \
        [e.name for e in jfixtures.entries()] == list(_EXPECT)
    assert [e.sources for e in fixtures.entries()] == \
        [(n,) for n in _build.FIXTURES]
    for e in fixtures.entries():
        assert _build.source(e.sources[0]).exists()


@pytest.mark.parametrize("name", list(_EXPECT)[3:])
def test_fixture_plain_versions_read_the_pad(name):
    """The index-map and divisibility fixtures' operands are padded to the
    grid's reach, and their plain versions read the pad."""
    entry = next(e for e in fixtures.entries() if e.name == name)
    shapes = entry.op.shapes()
    x = torch.arange(int(np.prod(shapes[0]))).reshape(shapes[0]).to(
        torch.int8)
    out = entry.op(x)  # CPU: the plain version
    assert tuple(out.shape) == tuple(shapes[-1])
    declared = entry.plans[0].operands[0].shape
    assert tuple(shapes[0]) != tuple(declared)
    if name == "broken-index-map":
        assert torch.equal(out, x[4:12])  # rows 8..11 are the pad
    else:
        assert torch.equal(out[:, 192:], x[:, 192:])


@pytest.mark.parametrize("entry", registry.entries(), ids=lambda e: e.name)
def test_registry_kernel_clean(entry):
    findings, cert, an = qlint.check_entry(entry)
    assert not findings, [str(f) for f in findings]
    assert not an.events_of("unknown-prim"), an.events_of("unknown-prim")
    if cert is not None:
        assert cert.verdict == "certified", str(cert)
    assert entry.sources and entry.plans
    for src in entry.sources:
        assert src in _build.KERNELS


def _entry_int_scales(entry):
    """The integer scales an IS entry's plain version reads, (E, G, N) or
    (G, N): among its arguments, else in the ``params`` it closes over
    (the ``ops`` wrappers)."""
    fn, args, _ = entry.build()
    cands = list(args)
    if inspect.isfunction(fn):
        cands += inspect.getclosurevars(fn).nonlocals.get(
            "params", {}).values()
    (ints,) = [t for t in cands if isinstance(t, torch.Tensor)
               and t.dtype == torch.int32 and t.ndim >= 2]
    return ints.numpy().reshape(-1, *ints.shape[-2:])


@pytest.mark.parametrize(
    "entry", [e for e in registry.entries() if e.integer_scale],
    ids=lambda e: e.name)
def test_registry_bound_against_reference_static_bound(jax_literal, entry):
    """A registry entry's certificate (the interval pass over its whole
    traced plain version: unpack, partials, expert axis) against the
    reference's ``static_accum_bound`` on the entry's integer scales (the
    largest over experts: the trace seeds one interval for all of them).
    W8 entries are equal. W4 entries are 8/7 of it: the trace reads the
    weight codes out of packed bytes, where the interval pass knows only
    the nibble range [-8, 7], while the reference seeds the code contract
    [-7, 7]."""
    _, cert, _ = qlint.check_entry(entry)
    w_bits = 8 if entry.name.startswith("w8") else 4
    ref = max(jcertify.static_accum_bound(
        s, group_size=registry.GS, w_bits=w_bits, a_bits=entry.a_bits)
        for s in _entry_int_scales(entry))
    assert ref > 0
    if w_bits == 8:
        assert cert.bound == ref
    else:
        assert cert.bound * 7 == ref * 8


def test_registry_names_are_the_references():
    from repro.analysis import registry as jregistry

    assert [e.name for e in registry.entries()] == \
        [e.name for e in jregistry.entries()]


def test_qlint_cli_exit_codes(capsys, monkeypatch):
    assert qlint.main(["-k", "w4a4"]) == 0
    assert "certified" in capsys.readouterr().out
    assert qlint.main(["--fixtures"]) == 1
    out = capsys.readouterr().out
    assert "qlint: 5 kernels" in out
    assert qlint.main(["-k", "no-such-kernel"]) == 2

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    assert qlint.main(["--ptx", "-k", "w4a4"]) == 3
    capsys.readouterr()


# ---------------------------------------------------------------------------
# interpreter and PTX rules on small inputs
# ---------------------------------------------------------------------------


def test_uninit_read_of_rows_past_the_counts():
    def partial(x):
        y = torch.empty((8, 4), dtype=torch.int32)
        y[:3] = x[:3]
        return y.sum(dim=1, dtype=torch.int32)

    def whole(x):
        y = torch.empty((8, 4), dtype=torch.int32)
        y[:3] = x[:3]
        y[3:].zero_()
        return y.sum(dim=1, dtype=torch.int32)

    x = torch.ones((8, 4), dtype=torch.int32)
    an = analyze_fn(partial, x, input_ranges={0: Interval(-5, 5)})
    (e,) = an.events_of("uninit-read")
    assert "rows [0, 8)" in e.detail
    an = analyze_fn(whole, x, input_ranges={0: Interval(-5, 5)})
    assert not an.events
    assert an.out_intervals[0] == Interval(-20, 20)


def test_int_sum_judged_in_the_accumulating_dtype():
    """torch promotes an int32 sum to int64; the kernel accumulates in
    int32, so the sum is judged there (and counted in the bound)."""
    x = torch.ones((4, 2**20), dtype=torch.int32)
    an = analyze_fn(lambda t: t.sum(dim=1), x,
                    input_ranges={0: Interval(-4096, 4096)})
    assert [e.kind for e in an.events] == ["int-overflow"]
    assert an.int_accum_bound == 4096 * 2**20
    an = analyze_fn(lambda t: t.sum(dim=1), x, input_ranges={0: DATA})
    assert an.events_of("int-overflow")


_PTX_NARROW = """
.visible .entry k(
{
	ld.global.s8 	%rs1, [%rd1];
	ld.global.s8 	%rs2, [%rd2];
	cvt.s32.s16 	%r1, %rs1;
	cvt.s32.s16 	%r2, %rs2;
$L__BB0_1:
	mad.lo.s32 	%r3, %r1, %r2, %r4;
	mov.u32 	%r4, %r3;
	@%p1 bra 	$L__BB0_1;
	cvt.s32.s16 	%r5, %r4;
	st.global.u32 	[%rd3], %r5;
}
"""

_PTX_CLEAN_IS = """
.visible .entry is_gemm(
{
	ld.param.u64 	%rd1, [p0];
	ld.global.u32 	%r1, [%rd1];
	and.b32 	%r2, %r1, -252645136;
	shl.b32 	%r3, %r1, 4;
	ld.shared.u32 	%r9, [%r8];
	mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%r10, %r11, %r12, %r13}, {%r9, %r9, %r9, %r9}, {%r2, %r3}, {%r10, %r11, %r12, %r13};
	shr.s32 	%r14, %r10, 4;
	ld.global.u32 	%r15, [%rd2];
	mul.lo.s32 	%r16, %r14, %r15;
	add.s32 	%r17, %r17, %r16;
	cvt.rn.f32.s32 	%f1, %r17;
	st.global.f32 	[%rd3], %f1;
	ld.global.f32 	%f2, [%rd4];
	cvt.rni.s32.f32 	%r20, %f2;
	cvt.s8.s32 	%rs5, %r20;
	st.global.u8 	[%rd5], %rs5;
}
"""


def test_ptx_narrowing_follows_the_accumulator_chain():
    hits = ptx_accumulator_narrowing(_PTX_NARROW)
    assert [ins.split()[0] for _, ins in hits] == ["cvt.s32.s16"]
    # nibble masks, float-derived codes and the f32 epilogue are clean
    assert ptx_accumulator_narrowing(_PTX_CLEAN_IS) == []
    assert ptx_mmas(_PTX_CLEAN_IS) == (1, 0)


def test_ptx_float_accum_rule():
    entry = dataclasses.replace(registry.entries()[0], sources=("a",))
    assert run_ptx_rules(entry, {"a": _PTX_CLEAN_IS}) == []
    rules = {f.rule for f in run_ptx_rules(entry, {"a": _PTX_NARROW})}
    assert rules == {"float-accum-on-is-path", "narrowing-convert"}
    fmma = _PTX_CLEAN_IS.replace("s32.s8.s8.s32", "f32.bf16.bf16.f32")
    found = run_ptx_rules(entry, {"a": fmma})
    assert {f.level for f in found} == {"ptx"}
    assert len(found) == 2  # a float MMA, and no int8 MMA at all


# ---------------------------------------------------------------------------
# telemetry: qcert_verdicts_total and the PTQ span equal the reference's
# ---------------------------------------------------------------------------


def test_quantize_tree_verdict_counters_equal_reference(jax_literal):
    rng = np.random.default_rng(11)
    w1 = (rng.normal(size=(512, 32)) * 0.05).astype(np.float32)
    w2 = _motivation_weight()[:1024]
    rules = (("*big*", dict(amplifier=2**20)), ("*", {}))
    tree = {"big": {"w": w2}, "up": {"w": w1}}
    reg, jreg = obs.Registry(), jobs.Registry()
    with obs.use_registry(reg):
        qlinear.quantize_tree({k: {"w": torch.from_numpy(v["w"])}
                               for k, v in tree.items()}, QuantRecipe(
            rules=tuple((p, QuantSpec(**kw)) for p, kw in rules)))
    with jobs.use_registry(jreg):
        jqlinear.quantize_tree({k: {"w": jnp.asarray(v["w"])}
                                for k, v in tree.items()}, None, JRecipe(
            rules=tuple((p, JSpec(**kw)) for p, kw in rules)))
    for name, labels in (("qcert_verdicts_total", ("verdict",)),
                         ("alpha_cap_events_total", ())):
        got = reg.counter(name, "", labels)
        want = jreg.counter(name, "", labels)
        assert got.series() == want.series(), name
    assert reg.counter("qcert_verdicts_total", "", ("verdict",)).get(
        verdict="capped-alpha") == 1


TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=64, dtype="float32")


def test_ptq_span_fields_equal_reference(jax_literal, capsys):
    """The same weights through both PTQs under a recipe that caps the MLP
    amplifiers: the ``ptq_run`` span's certificate fields, the verdict
    counters and the ``[ptq] overflow certificates`` summary line are the
    reference's."""
    jcfg = JConfig(**TINY, q_chunk=16, kv_chunk=16, remat=False)
    japi = jget_model(jcfg)
    jparams = JS.materialize(japi.param_specs(jcfg, None),
                             jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY)
    kw = (("*mlp*", dict(group_size=64, amplifier=2**22)),
          ("*", dict(group_size=64)))
    reg, jreg = obs.Registry(), jobs.Registry()
    with jobs.use_registry(jreg):
        jptq.post_training_quantize(japi, jcfg, jparams, JRecipe(
            rules=tuple((p, JSpec(**k)) for p, k in kw)), None)
    jout = capsys.readouterr().out
    with obs.use_registry(reg):
        ptq.post_training_quantize(
            get_model(cfg), cfg,
            convert.from_reference(jax.tree.map(np.asarray, jparams),
                                   device="cpu"),
            QuantRecipe(rules=tuple((p, QuantSpec(**k)) for p, k in kw)))
    out = capsys.readouterr().out

    def span(r):
        (ev,) = [e for e in r.events() if e.get("ev") == "ptq_run"]
        return {k: ev[k] for k in ("certificates", "certified",
                                   "capped_alpha", "fallback")}

    assert span(reg) == span(jreg)
    assert span(reg)["capped_alpha"] > 0 and span(reg)["certified"] > 0
    assert reg.counter("qcert_verdicts_total", "", ("verdict",)).series() \
        == jreg.counter("qcert_verdicts_total", "", ("verdict",)).series()

    def summary_line(text):
        return [ln for ln in text.splitlines()
                if ln.startswith("[ptq] overflow certificates")]

    assert summary_line(out) == summary_line(jout) != []


def test_interval_repr_of_unbounded_and_large_bounds():
    """An interval with an infinite bound prints (a layer whose
    accumulator overflows is reported, not a crash); integral bounds
    print as integers."""
    assert repr(Interval(-float("inf"), float("inf"))) == "[-inf, inf]"
    assert repr(Interval(-3.0, 2.0 ** 40)) == f"[-3, {2 ** 40}]"
    assert repr(Interval(0.5, 1.5)) == "[0.5, 1.5]"
