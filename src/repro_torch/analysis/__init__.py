"""repro_torch.analysis — static certification + lint for the port's
quantized stack. Port of ``repro/analysis``.

Two cooperating passes (nothing here executes a kernel, except
``fixtures.run_on_card`` running a fixture on the card):

1. **Interval dataflow** (:mod:`.intervals`, :mod:`.interp`) — seeds
   value ranges from quantized dtypes and config contracts (|xq| <=
   qmax(a_bits), weight codes from w_bits, integer scales tight from the
   concrete tensor), propagates them through each kernel's plain version
   traced on the CPU as an aten graph (``make_fx``): mm/bmm, add/mul/sum,
   converts, shifts, masks, clamps. Each CUDA kernel states its launch as
   a :class:`LaunchPlan` (grid, tiles, K splits, expert axis).

2. **Lint rules** (:mod:`.lint`) + **overflow certificates**
   (:mod:`.certify`) consuming the analysis:

   * certificate contract: ``bound < 2**31`` proves the Eq. 2 group
     accumulator can never overflow INT32 under the dtype contracts —
     verdicts ``certified`` / ``capped-alpha`` (largest safe power-of-two
     amplifier substituted) / ``fallback`` (take the paper's §B.4 safe
     GEMM). ``core.qlinear.finish_quant`` applies this to every
     integer-scale layer at quantization time.
   * lint rules, at the aten, launch-plan and PTX levels:
     int-dot-preferred-type, narrowing-convert, int-overflow,
     float-accum-on-is-path, blockspec-divisibility, index-map-bounds,
     uninit-read (details in :mod:`.lint`).

To register a kernel, append a ``KernelEntry`` in :mod:`.registry`
(docstring there has the field contract). The gate is ``python -m
repro_torch.analysis.qlint`` (:mod:`.qlint`).
"""
from .certify import (Certificate, certify_analysis, resolve_amplifier,
                      spec_verdict, static_accum_bound, summary)
from .interp import DATA, Analysis, LaunchPlan, analyze_fn, analyze_graph
from .intervals import Interval
from .lint import Finding, run_rules
from .registry import KernelEntry, entries

__all__ = [
    "Analysis", "Certificate", "DATA", "Finding", "Interval",
    "KernelEntry", "LaunchPlan", "analyze_fn", "analyze_graph",
    "certify_analysis", "entries", "resolve_amplifier", "run_rules",
    "spec_verdict", "static_accum_bound", "summary",
]
