"""Post-training quantization, RTN path. Port of ``repro/core/ptq.py``.

``post_training_quantize`` turns an fp param tree into a quantized one per
a :class:`~repro_torch.core.recipe.QuantRecipe`. Which tensors quantize
is decided by walking the *quantized spec tree*
(``api.param_specs(cfg, recipe)``) in parallel with the fp params: only
nodes the model declared as quantized linears convert, so the embedding,
head, norms and MoE routers stay fp exactly as the specs say. The port
holds one tree per layer, so each linear quantizes on its own; an expert
stack (E, K, N) quantizes expert by expert, each with its own scales and
its own certified amplifier, and is stacked back, as the
reference's ``_quantize_node`` does. Calibration-based algorithms
(GPTQ/AWQ/SmoothQuant/OmniQuant/QuaRot) come with a later slice and
raise here.

A model larger than the card in fp (Mixtral-8x7B: 93 GB of bf16 weights
against 80 GB) is built with :func:`quantize_by_layer`: each block's fp
weights are drawn from a generator seeded for that block, quantized and
freed before the next, so at most one block's fp weights sit on the
device. :func:`materialize_by_layer` draws the same fp tree whole (for a
model that fits, and for the tests): ``post_training_quantize`` of it
equals ``quantize_by_layer`` leaf for leaf.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch

from repro_torch import obs
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelApi
from repro_torch.nn import spec as S
from . import qlinear
from .recipe import QuantRecipe


def _require_rtn(recipe: QuantRecipe) -> None:
    for _, spec in recipe.rules:
        if spec is not None and spec.algo != "rtn":
            raise NotImplementedError(
                f"{spec.name}: only RTN is ported; calibration algorithms "
                "come with a later slice")


def _quantize(fp_node, spec_node, path: str, recipe: QuantRecipe):
    """Walk ``spec_node`` with ``fp_node``; quantize every node declared as
    a quantized linear (2-D, or an expert stack), its certificates
    labelled with its path."""
    if isinstance(spec_node, dict) and "qvalue" in spec_node:
        from repro_torch.analysis import certify

        spec = recipe.spec_for(path)
        w = fp_node["w"]
        with certify.context(path):
            if w.ndim == 3:
                return qlinear.quantize_experts(w, spec,
                                                bias=fp_node.get("b"))
            return qlinear.quantize_linear(w.float(), spec,
                                           bias=fp_node.get("b"))
    if isinstance(spec_node, dict):
        return {k: _quantize(fp_node[k], v, f"{path}/{k}" if path else k,
                             recipe)
                for k, v in spec_node.items()}
    if isinstance(spec_node, list):
        return [_quantize(f, v, f"{path}/{i}", recipe)
                for i, (f, v) in enumerate(zip(fp_node, spec_node))]
    return fp_node


@contextlib.contextmanager
def _ptq_run():
    """One PTQ run's telemetry, as the reference's: the ``ptq_run_seconds``
    span with the run's certificate counts (``certificates``, and
    ``certified`` / ``capped_alpha`` / ``fallback`` when there are any),
    the ``ptq_runs_total`` count and the ``[ptq] overflow certificates``
    lines (every certificate that is not ``certified`` on its own)."""
    from repro_torch.analysis import certify

    n_before = len(certify.log())
    reg = obs.current_registry()
    s = certs = None
    with obs.span(reg, "ptq_run_seconds", event="ptq_run") as sp:
        yield
        certs = certify.log()[n_before:]
        sp.fields["certificates"] = len(certs)
        if certs:
            s = certify.summary(certs)
            sp.fields.update(certified=s["certified"],
                             capped_alpha=s["capped-alpha"],
                             fallback=s["fallback"])
    reg.counter("ptq_runs_total", "post_training_quantize invocations").inc()
    if s is not None:
        print(f"[ptq] overflow certificates: {s['certified']} certified / "
              f"{s['capped-alpha']} capped-alpha / {s['fallback']} fallback"
              f" (worst accumulator {s['worst_frac']:.3f} of 2^31)")
        for c in certs:
            if c.verdict != "certified":
                print(f"[ptq]   {c}")


def post_training_quantize(api: ModelApi, cfg: ModelConfig, fp_params: Any,
                           recipe: QuantRecipe) -> Any:
    """fp params tree -> quantized params tree matching
    ``api.param_specs(cfg, recipe)``.

    Every integer-scale layer (each expert counts as one) is certified
    for INT32 overflow as it quantizes; the run prints the certificates'
    summary (``[ptq] overflow certificates: ...``).
    """
    _require_rtn(recipe)
    qspec_tree = api.param_specs(cfg, recipe)
    with _ptq_run():
        return _quantize(fp_params, qspec_tree, "", recipe)


def _fp_by_layer(api: ModelApi, cfg: ModelConfig, seed: int, device):
    """Yield (None, the non-block fp params) and then (i, block i's fp
    params), each drawn on ``device`` from its own generator: ``seed`` for
    the non-block params, ``seed + 1 + i`` for block i."""
    dev = S.resolve_device(device)
    specs = api.param_specs(cfg, None)

    def gen(s: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(s)

    yield None, S.materialize({k: v for k, v in specs.items()
                               if k != "blocks"}, gen(seed), dev)
    for i, block in enumerate(specs["blocks"]):
        yield i, S.materialize(block, gen(seed + 1 + i), dev)


def materialize_by_layer(api: ModelApi, cfg: ModelConfig, *, seed: int = 0,
                         device=None) -> dict:
    """The fp param tree with one generator per block (see module doc)."""
    out: dict = {}
    for i, tree in _fp_by_layer(api, cfg, seed, device):
        if i is None:
            out.update(tree, blocks=[])
        else:
            out["blocks"].append(tree)
    return out


def quantize_by_layer(api: ModelApi, cfg: ModelConfig, recipe: QuantRecipe,
                      *, seed: int = 0, device=None) -> dict:
    """``post_training_quantize(materialize_by_layer(...))``, one block at a
    time: block i's fp weights are drawn, quantized and freed before block
    i + 1's are drawn."""
    _require_rtn(recipe)
    qspecs = api.param_specs(cfg, recipe)
    out: dict = {}
    with _ptq_run():
        for i, fp in _fp_by_layer(api, cfg, seed, device):
            if i is None:
                out.update(_quantize(
                    fp, {k: v for k, v in qspecs.items() if k != "blocks"},
                    "", recipe), blocks=[])
            else:
                out["blocks"].append(_quantize(
                    fp, qspecs["blocks"][i], f"blocks/{i}", recipe))
            del fp
    return out
