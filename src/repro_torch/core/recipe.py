"""Quantization recipes: what to quantize, how, per layer.

A :class:`QuantSpec` describes one linear layer's scheme; a
:class:`QuantRecipe` maps layer-name patterns to specs (e.g. the paper's
LLaMA-3 recipe §5.6: W4A8 fine-grained everywhere, W8A8 fine-grained for
down-projections, QuaRot rotation on).

A stdlib-only copy of ``repro/core/recipe.py`` (the port imports nothing
of ``repro``); ``certify_recipe`` reads the port's own certificates
(``repro_torch.analysis.certify``), imported when it is called.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Literal

Algo = Literal["rtn", "gptq", "awq", "smoothquant", "omniquant", "odyssey"]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """One linear layer's quantization scheme."""

    w_bits: int = 4
    a_bits: int = 8  # 16 => weight-only (activations stay bf16)
    group_size: int = 128  # -1 => coarse per-channel
    scale_mode: Literal["float", "integer"] = "integer"
    amplifier: int | str = 1024  # int power of two, or "heuristic"
    sym: bool = True
    algo: Algo = "rtn"
    rotate: bool = False  # QuaRot-style Hadamard rotation
    clip_ratio: float = 1.0

    @property
    def weight_only(self) -> bool:
        return self.a_bits >= 16

    @property
    def fine_grained(self) -> bool:
        return self.group_size > 0

    @property
    def name(self) -> str:
        g = f"g{self.group_size}" if self.fine_grained else "coarse"
        s = "IS" if self.scale_mode == "integer" else "FS"
        return f"W{self.w_bits}A{self.a_bits}-{g}-{s}-{self.algo}"


FP16 = None  # sentinel: layer not quantized

# The paper's main setting: fine-grained W4A8, symmetric, group 128, IS(1024)
W4A8_IS = QuantSpec()
W4A8_FS = QuantSpec(scale_mode="float")
W4A16_FG = QuantSpec(a_bits=16)  # Marlin-analog weight-only
# W8 scales are ~18x smaller than W4 (qmax 127 vs 7): a fixed alpha=1024
# underflows them, so W8A8+IS uses the Listing-1 heuristic plus 6 margin
# bits (see integer_scale.integerize).
W8A8_FG = QuantSpec(w_bits=8, amplifier="heuristic+6")
W4A8_COARSE = QuantSpec(group_size=-1)  # Odyssey-style
W4A4_FG = QuantSpec(a_bits=4)  # Atom/QuaRot regime


@dataclasses.dataclass(frozen=True)
class QuantRecipe:
    """Ordered (pattern -> spec) rules; first match wins; None = keep FP16.

    Patterns are fnmatch globs over slash-joined parameter paths, e.g.
    ``"*/mlp/down/*"`` or ``"*attn*"``.
    """

    rules: tuple[tuple[str, QuantSpec | None], ...] = (("*", W4A8_IS),)
    name: str = "w4a8-is"

    def spec_for(self, path: str) -> QuantSpec | None:
        for pat, spec in self.rules:
            if fnmatch.fnmatch(path, pat):
                return spec
        return None


# Paper §5.6 LLaMA-3 recipe: W8A8-FG for down projections, W4A8-FG elsewhere,
# rotation enabled (QuaRot), integer scale everywhere.
LLAMA3_RECIPE = QuantRecipe(
    rules=(
        ("*down*", dataclasses.replace(W8A8_FG, rotate=True)),
        ("*", dataclasses.replace(W4A8_IS, rotate=True)),
    ),
    name="llama3-w4a8-down8-quarot-is",
)

DEFAULT_RECIPE = QuantRecipe()
FLOAT_SCALE_RECIPE = QuantRecipe(rules=(("*", W4A8_FS),), name="w4a8-fs")
WEIGHT_ONLY_RECIPE = QuantRecipe(rules=(("*", W4A16_FG),), name="w4a16-fg")


def certify_recipe(recipe: QuantRecipe, dims: dict[str, int]) -> dict:
    """Static overflow verdict per (rule, contraction dim), no tensors.

    ``dims`` maps a label (e.g. "d_model", "d_ff") to a contraction size
    K. Returns {f"{pattern}@{label}": verdict} using the data-free scale
    contract of :func:`repro_torch.analysis.certify.spec_verdict` —
    verdicts are "certified" / "capped-alpha" / "fallback" /
    "data-dependent" (heuristic amplifiers resolve per layer at
    quantization time) / "n/a" (no INT32 accumulation to certify).
    Quantization itself (qlinear.finish_quant) re-certifies with the
    layer's real scales.
    """
    from repro_torch.analysis import certify

    out = {}
    for pat, spec in recipe.rules:
        for label, K in dims.items():
            out[f"{pat}@{label}"] = certify.spec_verdict(spec, int(K))
    return out
