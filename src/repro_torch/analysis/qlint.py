"""qlint CLI — lint + overflow-certify every registered kernel of the port.
Port of ``repro/analysis/qlint.py``.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.qlint            # registry
    PYTHONPATH=src python -m repro_torch.analysis.qlint --fixtures # must fail
    PYTHONPATH=src python -m repro_torch.analysis.qlint --ptx      # + PTX

The aten and launch-plan levels run on the CPU. ``--ptx`` adds the PTX
level (``nvcc -ptx`` of every source of the selected entries, in parallel)
and fails when no ``nvcc`` is found.

Exit status: 1 if any lint finding fires or any integer-scale kernel's
certificate is not ``ok`` (certified / capped-alpha); 2 when no entry
matches; 3 when ``--ptx`` finds no ``nvcc``. Unknown aten ops are printed as warnings — they widen the
analysis but are not gate failures.
"""
from __future__ import annotations

import argparse
import sys

from . import certify, fixtures, registry
from .interp import analyze_fn
from .lint import Finding, run_ptx_rules, run_rules


def analyze_entry(entry):
    """Trace the entry's plain version, its group partials formed as the
    int32 contraction the kernels run, and run the interval pass."""
    from repro_torch.core.quant import int32_partials

    fn, args, input_ranges = entry.build()
    with int32_partials():
        return analyze_fn(fn, *args, input_ranges=input_ranges)


def check_entry(entry, ptx: bool = False):
    """-> (findings, certificate | None, analysis); ``ptx`` adds the PTX
    level (compiling the entry's sources where they are not cached)."""
    an = analyze_entry(entry)
    findings = run_rules(entry, an)
    if ptx:
        from repro_torch.kernels import _build

        findings += run_ptx_rules(
            entry, {src: _build.ptx(src) for src in entry.sources})
    cert = None
    if entry.integer_scale:
        cert = certify.certify_analysis(
            entry.name, entry.config, an, alpha=entry.alpha or 1)
    return findings, cert, an


def run_entries(entries, out=None, ptx: bool = False):
    """Check every entry, print one line each (to ``out``, default
    stdout); -> (findings, certs)."""
    out = out or sys.stdout
    all_findings, certs = [], []
    for entry in entries:
        try:
            findings, cert, an = check_entry(entry, ptx)
        except Exception as e:  # an analysis gap is a finding, not a crash
            findings, cert, an = [Finding(
                "analysis-error", entry.name,
                f"{type(e).__name__}: {e}")], None, None
        all_findings.extend(findings)
        if cert is not None:
            certs.append(cert)
        status = "ok " if not findings and (cert is None or cert.ok) \
            else "FAIL"
        tail = ""
        if cert is not None:
            tail = (f" bound={cert.bound:.3g}"
                    f" ({cert.bound / certify.INT32_LIMIT:.3f} of 2^31)"
                    f" [{cert.verdict}]")
        print(f"{status} {entry.name:24s} {entry.config}{tail}", file=out)
        if entry.note:
            print(f"     ~ note: {entry.note}", file=out)
        for f in findings:
            print(f"     - {f}", file=out)
        if an is not None:
            for e in an.events_of("unknown-prim"):
                print(f"     ~ warn: {e.prim}: {e.detail}", file=out)
    return all_findings, certs


def run(argv=None) -> tuple[int, list, list]:
    """The CLI's work: -> (exit status, findings, certificates)."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.qlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fixtures", action="store_true",
                    help="run only the deliberately broken fixtures "
                         "(exit nonzero expected)")
    ap.add_argument("-k", "--filter", default="",
                    help="substring filter on kernel names")
    ap.add_argument("--ptx", action="store_true",
                    help="add the PTX level (needs nvcc)")
    ns = ap.parse_args(argv)

    entries = fixtures.entries() if ns.fixtures else registry.entries()
    if ns.filter:
        entries = [e for e in entries if ns.filter in e.name]
    if not entries:
        print("qlint: no entries matched", file=sys.stderr)
        return 2, [], []
    if ns.ptx:
        from repro_torch.kernels import _build

        try:
            _build.nvcc()
        except RuntimeError as e:
            print(f"qlint: --ptx: {e}", file=sys.stderr)
            return 3, [], []
        _build.build(sorted({s for e in entries for s in e.sources}),
                     ptx=True)

    findings, certs = run_entries(entries, ptx=ns.ptx)
    bad_certs = [c for c in certs if not c.ok]
    n = len(findings) + len(bad_certs)
    s = certify.summary(certs)
    print(f"qlint: {len(entries)} kernels, {len(findings)} findings, "
          f"{s['certified']} certified / {s['capped-alpha']} capped / "
          f"{s['fallback']} fallback, worst accumulator "
          f"{s['worst_frac']:.3f} of 2^31")
    return (1 if n else 0), findings, certs


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
