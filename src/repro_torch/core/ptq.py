"""Post-training quantization, RTN path. Port of ``repro/core/ptq.py``.

``post_training_quantize`` turns an fp param tree into a quantized one per
a :class:`~repro_torch.core.recipe.QuantRecipe`. Which tensors quantize
is decided by walking the *quantized spec tree*
(``api.param_specs(cfg, recipe)``) in parallel with the fp params: only
nodes the model declared as quantized linears convert, so the embedding,
head and norms stay fp exactly as the specs say. The port holds one tree
per layer, so each linear quantizes on its own. Calibration-based
algorithms (GPTQ/AWQ/SmoothQuant/OmniQuant/QuaRot) come with a later
slice and raise here.
"""
from __future__ import annotations

from typing import Any

from repro_torch import obs
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelApi
from . import qlinear
from .recipe import QuantRecipe


def post_training_quantize(api: ModelApi, cfg: ModelConfig, fp_params: Any,
                           recipe: QuantRecipe) -> Any:
    """fp params tree -> quantized params tree matching
    ``api.param_specs(cfg, recipe)``.

    Prints one summary line: layers quantized, amplifiers capped by the
    overflow bound (``alpha_cap_events_total``), and the smallest alpha.
    """
    for _, spec in recipe.rules:
        if spec is not None and spec.algo != "rtn":
            raise NotImplementedError(
                f"{spec.name}: only RTN is ported; calibration algorithms "
                "come with a later slice")
    qspec_tree = api.param_specs(cfg, recipe)
    alphas: list[float] = []

    def walk(fp_node, spec_node, path):
        if isinstance(spec_node, dict) and "qvalue" in spec_node:
            spec = recipe.spec_for(path)
            out = qlinear.quantize_linear(fp_node["w"].float(), spec,
                                          bias=fp_node.get("b"))
            if "alpha" in out:
                alphas.append(float(out["alpha"]))
            return out
        if isinstance(spec_node, dict):
            return {k: walk(fp_node[k], v, f"{path}/{k}" if path else k)
                    for k, v in spec_node.items()}
        if isinstance(spec_node, list):
            return [walk(f, v, f"{path}/{i}")
                    for i, (f, v) in enumerate(zip(fp_node, spec_node))]
        return fp_node

    reg = obs.current_registry()
    caps = reg.counter("alpha_cap_events_total", "")
    caps_before = caps.total()
    with obs.span(reg, "ptq_run_seconds", event="ptq_run") as sp:
        out = walk(fp_params, qspec_tree, "")
        sp.fields.update(layers=len(alphas),
                         capped_alpha=int(caps.total() - caps_before))
    reg.counter("ptq_runs_total", "post_training_quantize invocations").inc()
    if alphas:
        print(f"[ptq] {len(alphas)} integer-scale layers: "
              f"{int(caps.total() - caps_before)} alpha capped by the "
              f"overflow bound, min alpha {min(alphas):g}")
    return out
