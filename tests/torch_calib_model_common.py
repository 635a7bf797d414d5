"""Shared fixtures of the whole-model calibration PTQ tests
(``tests/test_torch_calib_model.py`` and
``tests/test_torch_calib_model_llama3_mixtral.py``, split by arch so that
each file's models, quantized once per process, run on one worker): both
packages' f32 smoke models on the reference's weights, each recipe's
(reference tree, port tree), and the two per-(arch, recipe) checks. The
tolerances are stated in ``tests/test_torch_calib_model.py``."""
import dataclasses
import functools

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ptq as jptq
from repro.core import recipe as jrecipe_mod
from repro.models.registry import get_arch as jget_arch
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro_torch import convert
from repro_torch.core import ptq, qlinear
from repro_torch.core import recipe as recipe_mod
from repro_torch.core.algorithms import quarot
from repro_torch.core.recipe import QuantRecipe, QuantSpec
from repro_torch.data.pipeline import calib_batches
from repro_torch.models.registry import get_arch, get_model

CAPTURE_TOL = 1e-6
Q_REL_TOL = 2e-2

@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """One BLAS / OpenMP thread a process while a module that imports this
    fixture runs: beside the suite's other parallel workers, each
    process's pool of spinning BLAS threads (the reference's numpy GPTQ,
    the port's PyTorch one) costs far more than it saves. Both packages
    run under the same limit."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


# -- whole models -----------------------------------------------------------

ALGO_RECIPES = ("gptq", "awq", "smoothquant", "omniquant")


def _recipes(name: str):
    """(reference recipe, port recipe) of a test recipe name."""
    if name == "llama3":
        return jrecipe_mod.LLAMA3_RECIPE, recipe_mod.LLAMA3_RECIPE
    return (jrecipe_mod.QuantRecipe(
        rules=(("*", jrecipe_mod.QuantSpec(algo=name)),), name=name),
            QuantRecipe(rules=(("*", QuantSpec(algo=name)),), name=name))


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32",
                               kv_cache_dtype="float32")


def _port_captured(jcap: dict, num_layers: int) -> dict:
    """The reference's records (scanned path ``blocks/s0/...``, in call
    order: batch b, layer l at ``b * L + l``) under the port's paths
    (``blocks/<l>/...``), one tensor per batch."""
    out = {}
    for path, recs in jcap.items():
        for i, r in enumerate(recs):
            port = path.replace("blocks/s0/", f"blocks/{i % num_layers}/")
            out.setdefault(port, []).append(torch.from_numpy(np.array(r)))
    return out


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    """Both packages' f32 smoke model of ``arch`` on the reference's
    weights, and one calibration batch captured by the reference."""
    jcfg = _f32(jget_arch(arch, smoke=True))
    japi = jget_model(jcfg)
    jparams = JS.materialize(japi.param_specs(jcfg, None),
                             jax.random.PRNGKey(0))
    cfg = _f32(get_arch(arch, smoke=True))
    fp = convert.from_reference(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    batches = calib_batches(1)
    jcap = jptq.collect_calibration(japi, jcfg, jparams, batches)
    return (japi, jcfg, jparams), (get_model(cfg), cfg, fp), batches, jcap


def _reference_ptq(japi, jcfg, jparams, jrecipe, batches):
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "Literal"):
            mp.setattr(jax.core, "Literal", jax.extend.core.Literal,
                       raising=False)
        return jptq.post_training_quantize(japi, jcfg, jparams, jrecipe,
                                           batches)


@functools.lru_cache(maxsize=None)
def _ptq_pair(arch: str, name: str):
    """(reference tree, port tree) of one recipe on one arch, the port
    quantizing the same batches from the reference's captured rows (its
    own capture of them is held in :func:`test_capture_matches_reference`)."""
    (japi, jcfg, jparams), (api, cfg, fp), batches, jcap = _model(arch)
    jr, tr = _recipes(name)
    jq = _reference_ptq(japi, jcfg, jparams, jr, batches)
    calls = []

    def reference_rows(api_, cfg_, fp_, batches_):
        assert batches_ is batches
        calls.append(1)
        return _port_captured(jcap, cfg.num_layers)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ptq, "collect_calibration", reference_rows)
        tq = ptq.post_training_quantize(api, cfg, fp, tr, batches)
    assert calls == [1]
    return jq, tq


def _by_path(tree, path="") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_by_path(v, f"{path}/{k}" if path else str(k)))
    return out


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.bfloat16:
        return b.dtype == a.dtype and torch.equal(a.view(torch.int16),
                                                  b.view(torch.int16))
    return a.dtype == b.dtype and torch.equal(a, b)


def check_ptq_tree(arch, name):
    """Whole-model PTQ from the same captured rows: every leaf equal to the
    reference's (rot as bf16 bits). Seeds: block l's linears rotate by
    seed l; on Mixtral expert e of block l by seed l * E + e, and expert
    stacks get no calibration rows (RTN under the four algorithms)."""
    jq, tq = _ptq_pair(arch, name)
    want = _by_path(convert.from_reference(jax.tree.map(np.asarray, jq),
                                           device="cpu"))
    got = _by_path(tq)
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert _same(t, want[path]), path
    blk = tq["blocks"][1]
    if name in ("awq", "smoothquant"):
        assert "pre_scale" in blk["attn"]["q"]
    if name == "llama3":
        assert blk["mlp"]["down"]["qvalue"].shape[-2] == \
            blk["mlp"]["down"]["rot"].shape[-1]  # W8: one code a byte
        K = blk["attn"]["q"]["rot"].shape[0]
        assert torch.equal(blk["attn"]["q"]["rot"], quarot.random_orthogonal(
            K, 1).to(torch.bfloat16))
    if arch == "mixtral-8x7b":
        E = len(blk["mlp"]["gate"]["qvalue"])
        if name == "llama3":
            K = blk["mlp"]["gate"]["rot"].shape[-1]
            assert torch.equal(blk["mlp"]["gate"]["rot"][2],
                               quarot.random_orthogonal(K, E + 2).to(
                                   torch.bfloat16))
        else:
            _, _, fp = _model(arch)[1]
            w = fp["blocks"][1]["mlp"]["gate"]["w"][2].float()
            rtn = qlinear.quantize_linear(w, QuantSpec())
            for k in ("qvalue", "scale", "alpha"):
                assert torch.equal(blk["mlp"]["gate"][k][2], rtn[k]), k
            assert "pre_scale" not in blk["mlp"]["gate"]


def check_calibrated_logits(arch, name):
    """The port's own PTQ (its capture of the calibration batch, then its
    algorithms) serves logits within 2e-2 of the largest logit of the
    reference's PTQ (its own capture)."""
    (japi, jcfg, _), (api, cfg, fp), batches, _ = _model(arch)
    jq, _ = _ptq_pair(arch, name)
    jr, tr = _recipes(name)
    tq = ptq.post_training_quantize(api, cfg, fp, tr, batches)
    toks = np.random.default_rng(50).integers(0, cfg.vocab_size, (2, 12))
    want = np.asarray(japi.apply(jq, jcfg, jnp.asarray(toks), recipe=jr,
                                 mode="train")[0])
    got = api.build(cfg, tq, tr)(torch.from_numpy(toks))[0].numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= Q_REL_TOL, err
