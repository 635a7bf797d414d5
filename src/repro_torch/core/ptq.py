"""Post-training quantization orchestrator. Port of ``repro/core/ptq.py``.

``post_training_quantize`` turns an fp param tree into a quantized one per
a :class:`~repro_torch.core.recipe.QuantRecipe`:

  1. run the calibration batches through the fp model (``mode="train"``)
     while ``models.common``'s capture records each linear's input rows
     per path (:func:`collect_calibration`);
  2. per linear, run the spec's algorithm (:func:`quantize_one`: RTN,
     GPTQ, AWQ, SmoothQuant, OmniQuant, or QuaRot's rotation) -> codes and
     float scales (+ ``pre_scale`` / ``rot``);
  3. finish with the Integer Scale conversion (or keep float scales) in
     ``qlinear.finish_quant``: the paper's plug-and-play step.

Which tensors quantize is decided by walking the *quantized spec tree*
(``api.param_specs(cfg, recipe)``) in parallel with the fp params: only
nodes the model declared as quantized linears convert, so the embedding,
head, norms and MoE routers stay fp exactly as the specs say. The port
holds one tree per layer, so each linear quantizes on its own with the
rows captured at its own path (``blocks/<i>/attn/q``); an expert stack
(E, K, N) quantizes expert by expert, each with its own scales and its
own certified amplifier, and is stacked back. Seeds and calibration
follow the reference's stacked layout: the linears of a block at repeat
``r`` of the reference's scanned pattern use seed ``r`` (QuaRot's
rotation; ``r`` is the layer index where every layer has one kind, 0 for
a prefix block), expert ``e`` of it seed ``r * E + e``, and expert stacks
get no calibration rows (the calibration algorithms quantize them RTN,
as the reference's >= 4-D stacks).

A model larger than the card in fp (Mixtral-8x7B: 93 GB of bf16 weights
against 80 GB) is built with :func:`quantize_by_layer`: each block's fp
weights are drawn from a generator seeded for that block, quantized and
freed before the next, so at most one block's fp weights sit on the
device. It takes no calibration (the reference's PTQ with
``calib_batches=None``: rotation applies, the calibration algorithms fall
back to RTN). :func:`materialize_by_layer` draws the same fp tree whole
(for a model that fits, and for the tests): ``post_training_quantize`` of
it without calibration equals ``quantize_by_layer`` leaf for leaf.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch import obs
from repro_torch.models import common as MC
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelApi
from repro_torch.nn import spec as S
from . import qlinear
from .algorithms.awq import awq_quantize
from .algorithms.gptq import gptq_quantize
from .algorithms.omniquant import omniquant_quantize
from .algorithms.quarot import quarot_quantize, random_orthogonal
from .algorithms.smoothquant import smoothquant_quantize
from .quant import quantize_weight
from .recipe import QuantRecipe, QuantSpec


def collect_calibration(api: ModelApi, cfg: ModelConfig, fp_params: Any,
                        batches: list[dict]) -> dict[str, list[torch.Tensor]]:
    """Run ``batches`` (``{"tokens": (B, S)}``, with ``"image_embeds"`` or
    ``"frames"`` passed as the model's ``memory``, as the reference's)
    through the fp model on its weights' device and capture every
    linear's input rows: ``{path: [one (rows, K) f32 record per
    batch]}``."""
    model = api.build(cfg, fp_params)
    dev = next(iter(model.buffers())).device
    MC.start_capture()
    try:
        with torch.inference_mode():
            for b in batches:
                mem = b.get("image_embeds", b.get("frames"))
                model(torch.as_tensor(b["tokens"], device=dev), mode="train",
                      memory=None if mem is None else torch.as_tensor(
                          mem, device=dev))
    finally:
        captured = MC.end_capture()
    return captured


def _calib_for(captured: dict, path: str) -> torch.Tensor | None:
    """The rows captured at ``path`` over every batch (None: none)."""
    recs = captured.get(path)
    return torch.cat(recs) if recs else None


def quantize_one(w: torch.Tensor, x: torch.Tensor | None, spec: QuantSpec,
                 bias=None, seed: int = 0, *, cache=None) -> dict:
    """One linear: algorithm -> codes/scales(+extras) -> finish_quant.

    ``x``: its calibration rows (None or empty: none, and the calibration
    algorithms quantize RTN). Under ``spec.rotate`` the rotation is
    ``random_orthogonal(K, seed)`` (the algorithm is ignored), stored as
    bf16. ``cache``: a dict kept across the linears of one block, where
    each (K, seed)'s rotation is made once and shared by every linear
    that takes it, and GPTQ keeps its captured group loops."""
    w = w.float()
    if spec.rotate:
        key = ("rot", w.shape[0], seed)
        if cache is not None and key in cache:
            rot, rot16 = cache[key]
        else:
            rot = random_orthogonal(w.shape[0], seed, w.device)
            rot16 = rot.to(torch.bfloat16)
            if cache is not None:
                cache[key] = (rot, rot16)
        codes, scales, _ = quarot_quantize(w, spec.w_bits, spec.group_size,
                                           seed=seed, rot=rot)
        return qlinear.finish_quant(codes, scales, spec, bias=bias, rot=rot16)
    if spec.algo in ("rtn", "odyssey") or x is None or x.numel() == 0:
        gs = -1 if spec.algo == "odyssey" else spec.group_size
        eff = dataclasses.replace(spec, group_size=gs)
        qw = quantize_weight(w, spec.w_bits, gs, spec.clip_ratio)
        scales = qw.scale if eff.fine_grained else qw.scale[None, :]
        return qlinear.finish_quant(qw.qvalue, scales, eff, bias=bias)
    pre_scale = None
    if spec.algo == "gptq":
        codes, scales = gptq_quantize(w, x, spec.w_bits, spec.group_size,
                                      cache=cache)
    elif spec.algo == "awq":
        codes, scales, pre_scale = awq_quantize(
            w, x, spec.w_bits, spec.group_size)
    elif spec.algo == "smoothquant":
        codes, scales, pre_scale = smoothquant_quantize(
            w, x, spec.w_bits, spec.group_size)
    elif spec.algo == "omniquant":
        codes, scales = omniquant_quantize(w, x, spec.w_bits,
                                           spec.group_size)
    else:
        raise ValueError(spec.algo)
    return qlinear.finish_quant(codes, scales, spec, bias=bias,
                                pre_scale=pre_scale)


def _quantize(fp_node, spec_node, path: str, recipe: QuantRecipe,
              captured: dict, seed: int, cache: dict, cfg=None):
    """Walk ``spec_node`` with ``fp_node``; quantize every node declared as
    a quantized linear (2-D with its captured rows and ``seed``, or an
    expert stack without rows, expert e with ``seed * E + e``), its
    certificates labelled with its path. ``cfg`` gives a list of blocks
    its seeds (:func:`_block_seeds`)."""
    if isinstance(spec_node, dict) and "qvalue" in spec_node:
        from repro_torch.analysis import certify

        spec = recipe.spec_for(path)
        w, bias = fp_node["w"], fp_node.get("b")
        with certify.context(path):
            if w.ndim == 2:
                return quantize_one(w, _calib_for(captured, path), spec,
                                    bias=bias, seed=seed, cache=cache)
            E = w.shape[0]
            outs = [quantize_one(w[e], None, spec,
                                 bias=None if bias is None else bias[e],
                                 seed=seed * E + e, cache=cache)
                    for e in range(E)]
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    if isinstance(spec_node, dict):
        return {k: _quantize(fp_node[k], v, f"{path}/{k}" if path else k,
                             recipe, captured, seed, cache, cfg)
                for k, v in spec_node.items()}
    if isinstance(spec_node, list):  # blocks: block i's seed (see below)
        seeds = _block_seeds(spec_node, cfg)
        return [_quantize(f, v, f"{path}/{i}", recipe, captured, seeds[i],
                          {})
                for i, (f, v) in enumerate(zip(fp_node, spec_node))]
    return fp_node


def _block_seeds(block_specs: list, cfg: ModelConfig | None) -> list[int]:
    """Each block's PTQ seed: its repeat index in the reference's layout
    for ``cfg`` (``convert.scan_repeats``: Griffin's own split for a
    hybrid config), which seeds the reference's stacked linears; a prefix
    block's is 0, as the reference's unstacked linears."""
    from repro_torch import convert

    return convert.scan_repeats(convert.layer_kinds_of(block_specs), cfg)


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
                           recipe: QuantRecipe,
                           calib_batches: list[dict] | None = None) -> Any:
    """fp params tree -> quantized params tree per
    ``api.param_specs(cfg, recipe)``.

    ``calib_batches`` are captured through the fp model first when the
    recipe needs them (:func:`collect_calibration`). Without them, the
    calibration algorithms quantize RTN. Every integer-scale layer (each
    expert counts as one) is certified for INT32 overflow as it
    quantizes; the run prints the certificates' summary (``[ptq] overflow
    certificates: ...``).
    """
    qspec_tree = api.param_specs(cfg, recipe)
    needs_calib = any(
        spec is not None and (spec.algo != "rtn" or spec.rotate)
        for _, spec in recipe.rules)
    captured = {}
    if needs_calib and calib_batches:
        captured = collect_calibration(api, cfg, fp_params, calib_batches)
    with _ptq_run():
        return _quantize(fp_params, qspec_tree, "", recipe, captured, 0, {},
                         cfg)


def _require_blocks(cfg: ModelConfig, specs: dict) -> None:
    if "blocks" not in specs:
        raise ValueError(
            f"{cfg.name}: its params have no top-level 'blocks' to build one "
            "at a time (an encoder-decoder); draw it whole with "
            "nn.spec.materialize and quantize it with post_training_quantize")


def _fp_by_layer(api: ModelApi, cfg: ModelConfig, seed: int, device):
    """Yield (None, the non-block fp params) and then (i, block i's fp
    params), each drawn on ``device`` from its own generator: ``seed`` for
    the non-block params, ``seed + 1 + i`` for block i."""
    dev = S.resolve_device(device)
    specs = api.param_specs(cfg, None)
    _require_blocks(cfg, specs)

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
    """``post_training_quantize(materialize_by_layer(...), recipe)``, one
    block at a time: block i's fp weights are drawn, quantized and freed
    before block i + 1's are drawn. No calibration: rotation applies, the
    calibration algorithms quantize RTN."""
    qspecs = api.param_specs(cfg, recipe)
    _require_blocks(cfg, qspecs)
    seeds = _block_seeds(qspecs["blocks"], cfg)
    out: dict = {}
    with _ptq_run():
        for i, fp in _fp_by_layer(api, cfg, seed, device):
            if i is None:
                out.update(_quantize(
                    fp, {k: v for k, v in qspecs.items() if k != "blocks"},
                    "", recipe, {}, 0, {}), blocks=[])
            else:
                out["blocks"].append(_quantize(
                    fp, qspecs["blocks"][i], f"blocks/{i}", recipe, {},
                    seeds[i], {}))
            del fp
    return out
