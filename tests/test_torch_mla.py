"""Multi-head latent attention and DeepSeek-V2's layer layout in the port
(``repro_torch.models.attention`` MLA part, shared experts in
``models.moe``, leading dense layers in ``models.transformer``,
``repro_torch.convert``'s three layouts, the ``minicpm3-4b`` and
``deepseek-v2-236b`` configs) against the JAX reference, on the CPU.

Tolerances and why:

* Config fields, ``mla_cache_specs``, ``_dense_weight`` (IS, FS, coarse,
  W8 and fp), the converted trees and the W4A8-IS PTQ trees: equal, bit
  for bit (the reference is exact there).
* The ported chunked attention against the reference's jnp
  ``flash_attention`` with D != Dv, f32: atol 1e-5 (the same ops; the
  einsums sum in another order).
* One MLA layer's prefill output and latent cache, then a decode step,
  against ``mla_apply``: f32 rtol 1e-5 (atol 1e-6 for terms that cancel
  to near zero); bf16 2e-2 of the largest value (one bf16 ulp at about
  2, where an f32 sum in another order rounds the other way).
* A shared-expert MoE layer against ``moe_apply`` (f32, top-2 and top-6):
  rtol / atol 1e-5 (expert GEMMs sum in another order; the combine adds
  each token's terms in the reference's order).
* Whole smoke models in f32 on the reference's weights: fp prefill and
  decode logits within 1e-4 (as ``tests/test_torch_configs.py``);
  W4A8-IS logits within 2e-2 of the largest logit (an f32 rounding
  upstream can move an activation code by one); greedy streams of both
  engines equal under W4A8-IS.
* ``act_quant`` launches per layer kind in a prefill and a decode step,
  with logits bit-identical to sharing turned off.

The reference's integer-scale PTQ needs ``jax.core.Literal``, which JAX
0.9 moved: it is aliased only inside ``pytest.MonkeyPatch.context()``.

    PYTHONPATH=src python -m pytest tests/test_torch_mla.py -q
"""
import dataclasses
import functools
import math

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ptq as jptq
from repro.core.recipe import QuantRecipe as JRecipe
from repro.core.recipe import QuantSpec as JSpec
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.registry import get_arch as jget_arch
from repro.models.registry import get_model as jget_model
from repro.models.transformer import layer_kinds as jlayer_kinds
from repro.nn import spec as JS
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import convert
from repro_torch.core import ptq, qlinear
from repro_torch.core.recipe import QuantRecipe, QuantSpec
from repro_torch.kernels import act_quant as aq
from repro_torch.kernels import ops
from repro_torch.models import attention, moe
from repro_torch.models.registry import get_arch, get_model
from repro_torch.models.transformer import layer_kinds
from repro_torch.nn import spec as S
from repro_torch.serving.engine import Engine, ServeConfig

FP_TOL = 1e-4
Q_REL_TOL = 2e-2
ARCHS = ("minicpm3-4b", "deepseek-v2-236b")
FULL = {  # arch -> (layers, d_model, heads, q_lora, kv_lora, rope, nope, v,
          #          d_ff, experts, top_k, shared, dense first layers)
    "minicpm3-4b": (62, 2560, 40, 768, 256, 32, 64, 64, 6400, 0, 2, 0, 0),
    "deepseek-v2-236b": (60, 5120, 128, 1536, 512, 64, 128, 128, 12288, 160,
                         6, 2, 1),
}


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


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


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _tokens(seed, shape, V):
    return np.random.default_rng(seed).integers(0, V, size=shape)


def _jax_literal(mp):
    if not hasattr(jax.core, "Literal"):
        mp.setattr(jax.core, "Literal", jax.extend.core.Literal,
                   raising=False)


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    """Both packages' f32 smoke model of ``arch`` on the reference's
    weights, and each package's W4A8-IS g128 tree of it."""
    jcfg = _f32(jget_arch(arch, smoke=True))
    japi = jget_model(jcfg)
    jparams = JS.materialize(japi.param_specs(jcfg, None),
                             jax.random.PRNGKey(0))
    cfg = _f32(get_arch(arch, smoke=True))
    api = get_model(cfg)
    fp = convert.from_reference(_np_tree(jparams), device="cpu")
    jrecipe = JRecipe(rules=(("*", JSpec()),), name="w4a8-is")
    recipe = QuantRecipe(rules=(("*", QuantSpec()),), name="w4a8-is")
    with pytest.MonkeyPatch.context() as mp:
        _jax_literal(mp)
        jq = jptq.post_training_quantize(japi, jcfg, jparams, jrecipe, None)
    tq = ptq.post_training_quantize(api, cfg, fp, recipe)
    return {"fp": ((japi, jcfg, jparams, None), (api, cfg, fp, None)),
            "w4a8-is": ((japi, jcfg, jq, jrecipe), (api, cfg, tq, recipe))}


# ---------------------------------------------------------------------------
# configs, cache specs, layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch):
    for smoke in (False, True):
        j, t = jget_arch(arch, smoke=smoke), get_arch(arch, smoke=smoke)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (smoke, f.name)
    c = get_arch(arch)
    assert (c.num_layers, c.d_model, c.num_heads, c.q_lora_rank,
            c.kv_lora_rank, c.qk_rope_dim, c.qk_nope_dim, c.v_head_dim,
            c.d_ff, c.num_experts, c.top_k, c.num_shared_experts,
            c.first_dense_layers) == FULL[arch]
    assert c.attention == "mla" and c.dtype == "bfloat16"
    for smoke in (False, True):
        assert layer_kinds(get_arch(arch, smoke=smoke)) == jlayer_kinds(
            jget_arch(arch, smoke=smoke))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_mla_cache_specs_equal_reference(arch, kv):
    """The latent cache in the activation dtype whatever
    ``kv_cache_dtype`` says, as the reference's."""
    for smoke in (False, True):
        jc = dataclasses.replace(jget_arch(arch, smoke=smoke),
                                 kv_cache_dtype=kv)
        c = dataclasses.replace(get_arch(arch, smoke=smoke),
                                kv_cache_dtype=kv)
        want = jattn.mla_cache_specs(jc, 4, 256)
        got = attention.mla_cache_specs(c, 4, 256)
        assert sorted(got) == sorted(want) == ["c_kv", "k_rope"]
        for k, s in got.items():
            assert s.shape == want[k].shape
            assert str(s.dtype).removeprefix("torch.") == str(want[k].dtype)
        cache = get_model(c).cache_specs(c, 4, 256)
        assert len(cache["blocks"]) == c.num_layers
        assert cache["blocks"][0]["c_kv"].shape == (4, 256, c.kv_lora_rank)


# the reference's split_layers takes a pattern of up to 8 kinds: DeepSeek-V2
# (one dense layer, then MoE ones) is one pattern repeated once up to 8
# layers, and the dense layer a prefix from 9 layers on
LAYOUTS = {  # name -> (arch, layers, the reference's prefix and blocks)
    "blocks-s0-x4": ("minicpm3-4b", 4, [], ["s0"]),
    "blocks-s0..s2-x1": ("deepseek-v2-236b", 3, [], ["s0", "s1", "s2"]),
    "prefix-0-blocks-s0-x8": ("deepseek-v2-236b", 9, ["0"], ["s0"]),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_convert_round_trips_every_layout(name):
    """Port layer ``len(prefix) + r * P + j`` is reference ``blocks/s{j}``
    at repeat r; ``to_reference`` gives back the reference's tree bit for
    bit (bf16 leaves as f32 arrays of the same values)."""
    arch, L, prefix, pattern = LAYOUTS[name]
    jcfg = dataclasses.replace(jget_arch(arch, smoke=True), num_layers=L)
    japi = jget_model(jcfg)
    jparams = _np_tree(JS.materialize(japi.param_specs(jcfg, None),
                                      jax.random.PRNGKey(3)))
    assert sorted(jparams.get("prefix", {})) == prefix
    assert sorted(jparams["blocks"]) == pattern
    port = convert.from_reference(jparams, device="cpu")
    cfg = dataclasses.replace(get_arch(arch, smoke=True), num_layers=L)
    specs = get_model(cfg).param_specs(cfg)
    assert len(port["blocks"]) == L
    assert (sorted(_by_path(port)) == sorted(_by_path(specs)))
    n, P = len(prefix), len(pattern)
    for i, blk in enumerate(port["blocks"]):
        want = (jparams["prefix"][str(i)] if i < n else jax.tree.map(
            lambda a, r=(i - n) // P: a[r],
            jparams["blocks"][f"s{(i - n) % P}"]))
        for path, t in _by_path(blk).items():
            w = _by_path(want)[path]
            assert np.array_equal(t.float().numpy(),
                                  np.asarray(w, np.float32)), (i, path)
    back = convert.to_reference(port)
    assert sorted(_by_path(back)) == sorted(_by_path(jparams))
    for path, a in _by_path(back).items():
        w = _by_path(jparams)[path]
        assert a.shape == w.shape
        assert np.array_equal(a, np.asarray(w, np.float32)), path


# ---------------------------------------------------------------------------
# the MLA pieces
# ---------------------------------------------------------------------------

CHUNKED = [  # (B, Sq, Hq, Hkv, D, Dv, q_chunk, kv_chunk)
    (2, 40, 4, 4, 48, 32, 16, 16),   # MLA smoke: nope 32 + rope 16
    (1, 33, 4, 2, 24, 16, 8, 16),    # GQA, padding in both chunkings
    (2, 20, 2, 1, 40, 24, 16, 8),    # more key chunks than query chunks
    (1, 128, 8, 8, 192, 128, 512, 1024),  # DeepSeek-V2's head widths
]


@pytest.mark.parametrize("B,Sq,Hq,Hkv,D,Dv,qc,kc", CHUNKED)
def test_chunked_attention_matches_reference(B, Sq, Hq, Hkv, D, Dv, qc, kc):
    """Causal from position 0, as MLA's prefill calls it."""
    rng = np.random.default_rng(Sq + D)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Sq, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sq, Hkv, Dv)).astype(np.float32)
    scale = 1.0 / math.sqrt(D - 8)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, q_chunk=qc,
                                 kv_chunk=kc, softmax_scale=scale)
    got = attention.chunked_attention(_t(q), _t(k), _t(v), q_chunk=qc,
                                      kv_chunk=kc, softmax_scale=scale)
    assert got.shape == (B, Sq, Hq, Dv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


DENSE_SPECS = {  # name -> QuantSpec kwargs (None: an unquantized linear)
    "is": dict(),
    "fs": dict(scale_mode="float"),
    "coarse": dict(scale_mode="float", group_size=-1),
    "w8-is": dict(w_bits=8, amplifier="heuristic+6"),
    "fp": None,
}


@pytest.mark.parametrize("name", sorted(DENSE_SPECS))
def test_dense_weight_bit_equal_to_reference(name):
    """MLA decode's dequantized k_up / v_up: codes unpacked, scale / alpha
    (a tensor division), times the codes in f32, cast to bf16."""
    K, N = 256, 384
    w = _t(np.random.default_rng(11).normal(size=(K, N)) / 16)
    kw = DENSE_SPECS[name]
    if kw is None:
        params, spec, jrecipe = {"w": w.to(torch.bfloat16)}, None, None
    else:
        spec = QuantSpec(**kw)
        params = qlinear.quantize_linear(w, spec)
        jrecipe = JRecipe(rules=(("*", JSpec(**kw)),))
    got = attention._dense_weight(params, spec, K, torch.bfloat16)
    jp = {k: (jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
              if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy()))
          for k, v in params.items()}
    want = jattn._dense_weight(jp, jrecipe, "l", K, jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (K, N)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


def _mla_layer(arch, dtype):
    """Layer 0's attention params of the fp smoke model, in ``dtype``, for
    both packages, and both configs."""
    (_, jcfg, jparams, _), (_, cfg, fp, _) = _model(arch)["fp"]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jcfg, cfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, cfg))
    jp = jax.tree.map(lambda a: a[0].astype(jdt),
                      jparams["blocks"]["s0"]["attn"])
    tp = S.tree_map(lambda t: t.to(cfg.activation_dtype),
                    fp["blocks"][0]["attn"])
    return jcfg, jp, cfg, attention.MLAttention(cfg, tp, None,
                                                "blocks/0/attn")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_cache_and_decode_match_reference(arch, dtype):
    """A prefill of 10 tokens into the latent cache (its outputs and the
    cache), then two decode steps at per-row positions (the absorbed
    form), against ``mla_apply``."""
    jcfg, jp, cfg, layer = _mla_layer(arch, dtype)
    B, P, Smax = 2, 10, 24
    jdt = jcfg.activation_dtype
    rng = np.random.default_rng(5)

    def close(got, want):
        got = got.float().numpy()
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()

    x = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
    jcache = JS.materialize(jattn.mla_cache_specs(jcfg, B, Smax),
                            jax.random.PRNGKey(0))
    cache = S.materialize(attention.mla_cache_specs(cfg, B, Smax),
                          device="cpu")
    want, jcache = jattn.mla_apply(jp, jnp.asarray(x).astype(jdt), jcfg,
                                   None, "blocks/0/attn", mode="prefill",
                                   cache=jcache, pos=0)
    got, cache = layer(_t(x).to(cfg.activation_dtype), mode="prefill",
                       cache=cache, pos=0)
    close(got, want)
    for k in ("c_kv", "k_rope"):
        close(cache[k], jcache[k])
    pos = np.array([P, P - 3])
    for step in range(2):
        x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jattn.mla_apply(
            jp, jnp.asarray(x).astype(jdt), jcfg, None, "blocks/0/attn",
            mode="decode", cache=jcache, pos=jnp.asarray(pos))
        got, cache = layer(_t(x).to(cfg.activation_dtype), mode="decode",
                           cache=cache, pos=torch.from_numpy(pos))
        close(got, want)
        pos = pos + 1


@pytest.mark.parametrize("top_k", [2, 6])
def test_shared_expert_moe_layer_matches_reference(top_k):
    """DeepSeek-V2's MoE layer (8 routed experts plus a 2-expert shared
    MLP over the router's input) in f32, at the smoke config's top-2 and
    at the full config's top-6 (six terms a token in the combine)."""
    (_, jcfg, jparams, _), (_, cfg, fp, _) = _model("deepseek-v2-236b")["fp"]
    jc = dataclasses.replace(jcfg, top_k=top_k)
    tc = dataclasses.replace(cfg, top_k=top_k)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["s1"]["mlp"])
    assert sorted(jp["shared"]) == ["down", "gate", "up"]
    assert jp["shared"]["gate"]["w"].shape == (cfg.d_model, 2 * cfg.moe_d_ff)
    x = np.random.default_rng(30 + top_k).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32)
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jc, None,
                                "blocks/s1/mlp")
    got, aux = moe.moe_apply(fp["blocks"][1]["mlp"], _t(x), tc, None,
                             "blocks/1/mlp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


# ---------------------------------------------------------------------------
# whole smoke models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_fp_prefill_and_decode_logits_match_reference(arch):
    """Prefill 10 tokens into the latent cache, then two batched decode
    steps at per-row positions."""
    (japi, jcfg, jparams, _), (api, cfg, fp, _) = _model(arch)["fp"]
    B, P, Smax = 2, 10, 32
    V = cfg.vocab_size
    model = api.build(cfg, fp)
    jcache = JS.materialize(japi.cache_specs(jcfg, B, Smax),
                            jax.random.PRNGKey(1))
    cache = S.materialize(api.cache_specs(cfg, B, Smax), device="cpu")
    toks = _tokens(3, (B, P), V)
    want, jcache, _ = japi.apply(jparams, jcfg, jnp.asarray(toks),
                                 mode="prefill", cache=jcache, pos=0)
    got, cache, _ = model(torch.from_numpy(toks), mode="prefill",
                          cache=cache, pos=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FP_TOL,
                               atol=FP_TOL)
    pos = np.array([P, P - 4])
    for step in range(2):
        nxt = _tokens(10 + step, (B, 1), V)
        want, jcache, _ = japi.apply(jparams, jcfg, jnp.asarray(nxt),
                                     mode="decode", cache=jcache,
                                     pos=jnp.asarray(pos))
        got, cache, _ = model(torch.from_numpy(nxt), mode="decode",
                              cache=cache, pos=torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FP_TOL, atol=FP_TOL)
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_ptq_tree_equals_reference_leaf_for_leaf(arch):
    (*_, jq, _), (*_, tq, _) = _model(arch)["w4a8-is"]
    want = _by_path(convert.from_reference(_np_tree(jq), device="cpu"))
    got = _by_path(tq)
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path
    blk = tq["blocks"][-1]
    assert blk["attn"]["k_up"]["scale"].dtype == torch.int32
    assert ("shared" in blk["mlp"]) == (arch == "deepseek-v2-236b")


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_logits_match_reference(arch):
    (japi, jcfg, jq, jrecipe), (api, cfg, tq, recipe) = \
        _model(arch)["w4a8-is"]
    toks = _tokens(5, (2, 12), cfg.vocab_size)
    want = np.asarray(japi.apply(jq, jcfg, jnp.asarray(toks), recipe=jrecipe,
                                 mode="train")[0])
    got = api.build(cfg, tq, recipe)(torch.from_numpy(toks))[0]
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= Q_REL_TOL, err


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_equal_reference_engine(arch):
    """W4A8-IS, more requests than slots (staggered admission, per-slot
    decode positions over the latent cache)."""
    (japi, jcfg, jparams, jrecipe), (api, cfg, params, recipe) = \
        _model(arch)["w4a8-is"]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 8, 3)]
    kw = dict(max_slots=2, max_seq=32, prefill_len=8, max_new_tokens=4)
    jeng = JEngine(japi, jcfg, jparams,
                   JServeConfig(**kw, kernel_mode="reference"),
                   recipe=jrecipe)
    jrids = [jeng.submit(p) for p in prompts]
    want = jeng.run()
    jeng.close()
    eng = Engine(api, cfg, params, ServeConfig(**kw), recipe=recipe)
    rids = [eng.submit(p) for p in prompts]
    got = eng.run()
    eng.close()
    assert rids == jrids
    for r in rids:
        assert eng.outcome(r) == jeng.outcome(r) == "ok"
        assert got[r] == want[r], (r, got[r], want[r])
    assert (eng.prefill_traces, eng.decode_traces) == (1, 1)


# act_quant launches a layer, (dense, routed), shared -> each alone:
# an MLA layer quantizes x once for q_down / kv_down, then cq (q_up), c_kv
# (k_up / v_up: prefill only, decode reads dequantized weights), the
# attention output (o), and the MLP's two (gate / up, down); a MoE layer
# adds the routed pair (gate / up over one dispatch buffer, down) and its
# shared MLP's two in place of the dense MLP's
ACT_QUANT = {  # (kind, mode) -> ((dense, routed) shared, (dense, routed) alone)
    ("self", "train"): ((6, 0), (9, 0)),
    ("self", "decode"): ((5, 0), (7, 0)),
    ("moe", "train"): ((6, 2), (9, 3)),
    ("moe", "decode"): ((5, 2), (7, 3)),
}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["train", "decode"])
def test_act_quant_once_per_shared_activation(arch, mode):
    """act_quant launches per layer kind in a forward; the logits equal
    those with sharing turned off bit for bit (act_quant is a pure
    function of (x, a_bits))."""
    _, (api, cfg, tq, recipe) = _model(arch)["w4a8-is"]
    B = 2
    toks = torch.from_numpy(_tokens(9, (B, 12 if mode == "train" else 1),
                                    cfg.vocab_size))
    runs = []
    for share in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            if not share:
                mp.setattr(ops, "quantize_for", lambda *a, **k: None)
            calls = {"dense": [], "routed": []}
            for kind, mod, fn in (("dense", ops, "act_quant"),
                                  ("routed", aq, "act_quant_routed_plain")):
                def counted(*a, _real=getattr(mod, fn), _n=calls[kind], **k):
                    _n.append(1)
                    return _real(*a, **k)
                mp.setattr(mod, fn, counted)
            model = api.build(cfg, tq, recipe)
            if mode == "train":
                got = model(toks)[0]
            else:
                cache = S.materialize(api.cache_specs(cfg, B, 16),
                                      device="cpu")
                model(torch.zeros((B, 4), dtype=torch.int64), mode="train",
                      cache=cache, pos=0)
                for c in calls.values():
                    c.clear()
                got = model(toks, mode="decode", cache=cache,
                            pos=torch.tensor([4, 4]))[0]
        runs.append((got, (len(calls["dense"]), len(calls["routed"]))))
    want = [tuple(sum(x) for x in zip(*(ACT_QUANT[k, mode][i]
                                        for k in layer_kinds(cfg))))
            for i in (0, 1)]
    assert [n for _, n in runs] == want
    assert torch.equal(runs[0][0], runs[1][0])
