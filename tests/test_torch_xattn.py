"""Cross attention in the port: Llama-3.2-Vision's gated cross-attention
layers (``models.attention.CrossAttention``, ``models.transformer``'s
``cross`` blocks) and Whisper's encoder-decoder (``models.encdec``), the
``llama-3.2-vision-90b`` and ``whisper-tiny`` configs, ``convert``'s
encoder-decoder layout and cross layers, the calibration capture of
``memory``, against the JAX reference on the CPU.

The reference's init leaves every cross gate at 0, so tanh(0) multiplies
each cross layer's output away; the model fixtures set both trees' gates
to the same nonzero values, so the comparisons see cross attention.

Tolerances and why:

* Config fields, cache specs, the converted trees, the PTQ trees (under
  ``DEFAULT_RECIPE`` and the rotating ``LLAMA3_RECIPE``, whose QuaRot
  seeds follow the reference's repeat index): equal, bit for bit.
* LayerNorm, f32: rtol 1e-5 / atol 1e-6 (the same ops; f32 sums in
  another order); bf16: one bf16 ulp of the largest value (the f32 value
  before the cast can differ in its last bit).
* The sinusoid table: within 2^-24 (XLA's f32 sin / cos are not
  correctly rounded; the port rounds f64 values), and equal once cast to
  bf16 as the encoder adds it.
* Non-causal flash attention's plain version with Sq != Sk against the
  reference's jnp ``flash_attention``: atol 1e-5 (f32, another order).
* One cross-attention layer's prefill output, cross cache and decode
  output against ``cross_attn_apply`` with f32 memory: f32 rtol 1e-5
  (atol 1e-6); bf16 2e-2 of the largest value (one bf16 ulp at about 2).
* Whole smoke models in f32 on the reference's weights: fp prefill and
  decode logits within 1e-4; W4A8-IS logits within 2e-2 of the largest
  logit (an f32 rounding upstream can move an activation code by one),
  and 8 greedy tokens equal.
* ``act_quant`` launches per layer kind, with logits bit-identical to
  sharing turned off (``act_quant`` is a pure function of its input).

The reference's integer-scale PTQ needs ``jax.core.Literal``, which JAX
0.9 moved: it is aliased only inside ``pytest.MonkeyPatch.context()``.

    PYTHONPATH=src python -m pytest tests/test_torch_xattn.py -q
"""
import dataclasses
import functools

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ptq as jptq
from repro.core.recipe import DEFAULT_RECIPE as J_DEFAULT
from repro.core.recipe import LLAMA3_RECIPE as J_LLAMA3
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.models.registry import get_arch as jget_arch
from repro.models.registry import get_model as jget_model
from repro.models.transformer import layer_kinds as jlayer_kinds
from repro.nn import spec as JS
from repro_torch import convert
from repro_torch.core import ptq
from repro_torch.core.recipe import DEFAULT_RECIPE, LLAMA3_RECIPE
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch import serve
from repro_torch.models import attention, common, encdec
from repro_torch.models.registry import get_arch, get_model
from repro_torch.models.transformer import layer_kinds
from repro_torch.nn import spec as S
from repro_torch.serving.engine import Engine, ServeConfig

FP_TOL = 1e-4
Q_REL_TOL = 2e-2
VLM, WHISPER = "llama-3.2-vision-90b", "whisper-tiny"
ARCHS = (VLM, WHISPER)
RECIPES = {"w4a8-is": (J_DEFAULT, DEFAULT_RECIPE),
           "llama3": (J_LLAMA3, LLAMA3_RECIPE)}


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
    return torch.from_numpy(np.array(a, np.float32))


def _tokens(seed, shape, V):
    return np.random.default_rng(seed).integers(0, V, size=shape)


def _memory(cfg, B, seed):
    """Seeded f32 memory, normal x 0.1, as the reference's smoke tests
    draw it: (B, num_image_tokens or encoder_seq, d)."""
    Sm = cfg.num_image_tokens or cfg.encoder_seq
    return (np.random.default_rng(seed).normal(size=(B, Sm, cfg.d_model))
            * 0.1).astype(np.float32)


def _dt(spec) -> str:
    """A spec's dtype name, in either package."""
    d = spec.dtype
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


def _jax_literal(mp):
    if not hasattr(jax.core, "Literal"):
        mp.setattr(jax.core, "Literal", jax.extend.core.Literal,
                   raising=False)


def _set_gates(jparams):
    """The reference's params with every cross gate drawn from a seed,
    uniform in [0.5, 1.5] (its init leaves them at 0)."""
    if "blocks" not in jparams:
        return jparams
    rng = np.random.default_rng(17)
    blocks = dict(jparams["blocks"])
    for name, blk in blocks.items():
        if "gate_attn" in blk:
            R = blk["gate_attn"].shape[0]
            blocks[name] = dict(blk, **{
                g: jnp.asarray(rng.uniform(0.5, 1.5, R).astype(np.float32))
                for g in ("gate_attn", "gate_mlp")})
    return dict(jparams, blocks=blocks)


def _ref_ptq(japi, jcfg, jparams, jrecipe):
    with pytest.MonkeyPatch.context() as mp:
        _jax_literal(mp)
        return jptq.post_training_quantize(japi, jcfg, jparams, jrecipe,
                                           None)


@functools.lru_cache(maxsize=None)
def _fp(arch: str, layers: int = 0):
    """Both packages' f32 smoke model of ``arch`` (``layers``: its depth,
    0 the smoke config's) on the reference's weights, gates set nonzero:
    ((japi, jcfg, jparams, None), (api, cfg, params, None))."""
    jcfg = _f32(jget_arch(arch, smoke=True))
    cfg = _f32(get_arch(arch, smoke=True))
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, num_layers=layers)
    japi, api = jget_model(jcfg), get_model(cfg)
    jparams = _set_gates(JS.materialize(japi.param_specs(jcfg, None),
                                        jax.random.PRNGKey(0)))
    fp = convert.from_reference(_np_tree(jparams), device="cpu")
    return (japi, jcfg, jparams, None), (api, cfg, fp, None)


@functools.lru_cache(maxsize=None)
def _quantized(arch: str, recipe: str = "w4a8-is", layers: int = 0):
    """Each package's tree of :func:`_fp`'s model under ``recipe``, in
    the same layout as :func:`_fp`'s, with the recipe in last place."""
    (japi, jcfg, jparams, _), (api, cfg, fp, _) = _fp(arch, layers)
    jr, tr = RECIPES[recipe]
    return ((japi, jcfg, _ref_ptq(japi, jcfg, jparams, jr), jr),
            (api, cfg, ptq.post_training_quantize(api, cfg, fp, tr), tr))


# ---------------------------------------------------------------------------
# configs, norms, tables, layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch):
    for smoke in (False, True):
        j, t = jget_arch(arch, smoke=smoke), get_arch(arch, smoke=smoke)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (smoke, f.name)
    c = get_arch(arch)
    if arch == VLM:
        assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
                c.d_ff, c.vocab_size, c.cross_attn_every,
                c.num_image_tokens) == (100, 8192, 64, 8, 28672, 128256, 5,
                                        1600)
        for smoke in (False, True):
            assert layer_kinds(get_arch(arch, smoke=smoke)) == jlayer_kinds(
                jget_arch(arch, smoke=smoke))
        assert layer_kinds(c).count("cross") == 20
    else:
        assert (c.num_layers, c.num_encoder_layers, c.d_model, c.num_heads,
                c.head_dim, c.d_ff, c.vocab_size, c.encoder_seq,
                c.max_positions) == (4, 4, 384, 6, 64, 1536, 51865, 1500,
                                     32768)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_cache_specs_equal_reference(arch, kv):
    """Cross caches (and Whisper's self caches) stay in the activation
    dtype whatever ``kv_cache_dtype`` says, as the reference's."""
    for smoke in (False, True):
        jc = dataclasses.replace(jget_arch(arch, smoke=smoke),
                                 kv_cache_dtype=kv)
        c = dataclasses.replace(get_arch(arch, smoke=smoke),
                                kv_cache_dtype=kv)
        got = get_model(c).cache_specs(c, 4, 256)
        want = jget_model(jc).cache_specs(jc, 4, 256)
        if arch == VLM:
            kinds = layer_kinds(c)
            for i, blk in enumerate(got["blocks"]):
                ref = want["blocks"][f"s{i % 5}"]
                for k, s in blk.items():
                    assert s.shape == ref[k].shape[1:], (i, k)
                    assert _dt(s) == _dt(ref[k]), (i, k)
                if kinds[i] == "cross":
                    assert blk["k"].shape == (4, c.num_image_tokens,
                                              c.num_kv_heads, c.head_dim)
        else:
            ref = _by_path(want)
            for p, s in _by_path(got).items():
                w = ref["blocks/" + p.split("/", 2)[2]]
                assert s.shape == w.shape[1:], p
                assert _dt(s) == _dt(w), p
            assert len(got["blocks"]) == c.num_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 7, 96)) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=(96,)).astype(np.float32)
    b = rng.normal(size=(96,)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    want = jcommon.layernorm({"g": jnp.asarray(g), "b": jnp.asarray(b)},
                             jnp.asarray(x).astype(jdt), 1e-5)
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    ln = common.LayerNorm({"g": _t(g), "b": _t(b)}, 1e-5)
    got = ln(_t(x).to(tdt))
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    assert common.layernorm_spec(96)["b"].init == "zeros"


@pytest.mark.parametrize("S_,d", [(1500, 384), (24, 128)])
def test_sinusoid_matches_reference(S_, d):
    want = jencdec._sinusoid(S_, d)
    got = encdec.sinusoid(S_, d)
    assert got.dtype == torch.float32 and got.shape == (S_, d)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2.0 ** -24
    assert np.array_equal(
        got.bfloat16().float().numpy(),
        np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (2, 1, 37, 4, 2, 64),    # a decode step over a ragged memory
    (1, 10, 24, 4, 4, 32),   # Whisper's smoke cross attention
    (2, 16, 16, 4, 2, 64),   # an encoder's self attention
])
def test_flash_plain_non_causal_matches_reference(B, Sq, Sk, Hq, Hkv, D):
    rng = np.random.default_rng(Sq * 100 + Sk)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False, q_chunk=16,
                                 kv_chunk=16)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


LAYOUTS = {  # name -> (arch, layers)
    "vlm-blocks-s0..s4-x1": (VLM, 5),
    "vlm-blocks-s0..s4-x2": (VLM, 10),
    "whisper-enc-dec-blocks": (WHISPER, 0),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_convert_round_trips_and_layer_kinds(name):
    """Port layer ``r * 5 + j`` is the VLM's ``blocks/s{j}`` at repeat r;
    Whisper's ``enc/blocks`` and ``dec/blocks`` unstack with period 1.
    ``to_reference`` gives back the reference's tree bit for bit;
    ``layer_kinds_of`` gives "cross" for a gated block, so the PTQ seeds
    are the repeat index, as the reference's stacked linears get."""
    arch, L = LAYOUTS[name]
    jcfg = jget_arch(arch, smoke=True)
    cfg = get_arch(arch, smoke=True)
    if L:
        jcfg = dataclasses.replace(jcfg, num_layers=L)
        cfg = dataclasses.replace(cfg, num_layers=L)
    japi = jget_model(jcfg)
    jparams = _np_tree(_set_gates(JS.materialize(
        japi.param_specs(jcfg, None), jax.random.PRNGKey(3))))
    port = convert.from_reference(jparams, device="cpu")
    specs = get_model(cfg).param_specs(cfg)
    assert sorted(_by_path(port)) == sorted(_by_path(specs))
    back = convert.to_reference(port)
    assert sorted(_by_path(back)) == sorted(_by_path(jparams))
    for path, a in _by_path(back).items():
        w = _by_path(jparams)[path]
        assert a.shape == w.shape
        assert np.array_equal(a, np.asarray(w, np.float32)), path
    if arch == VLM:
        kinds = convert.layer_kinds_of(specs["blocks"])
        assert kinds == jlayer_kinds(jcfg)
        assert kinds.count("cross") == L // 5
        assert convert.scan_repeats(kinds) == [i // 5 for i in range(L)]
        for i, blk in enumerate(port["blocks"]):
            want = jax.tree.map(lambda a, r=i // 5: a[r],
                                jparams["blocks"][f"s{i % 5}"])
            for path, t in _by_path(blk).items():
                assert np.array_equal(t.float().numpy(), np.asarray(
                    _by_path(want)[path], np.float32)), (i, path)
    else:
        for part in ("enc", "dec"):
            assert convert.scan_repeats(convert.layer_kinds_of(
                specs[part]["blocks"])) == list(range(
                    len(specs[part]["blocks"])))


# ---------------------------------------------------------------------------
# one cross-attention layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attn_prefill_cache_and_decode_match_reference(dtype):
    """Layer 4's cross attention: a prefill over f32 memory (the mixed
    dtype path in bf16) that writes the cross cache, then a decode step
    that reads it, against ``cross_attn_apply``."""
    (_, jcfg, jparams, _), (_, cfg, fp, _) = _fp(VLM)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jcfg, cfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, cfg))
    jp = jax.tree.map(lambda a: a[0].astype(jdt),
                      jparams["blocks"]["s4"]["attn"])
    tp = S.tree_map(lambda t: t.to(cfg.activation_dtype),
                    fp["blocks"][4]["attn"])
    layer = attention.CrossAttention(cfg, tp, None, "blocks/4/xattn")
    B, P = 2, 6
    rng = np.random.default_rng(5)

    def close(got, want):
        got = got.float().numpy()
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()

    mem = _memory(cfg, B, 6)
    x = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
    jcache = JS.materialize(jattn.cross_attn_cache_specs(
        jcfg, B, cfg.num_image_tokens), jax.random.PRNGKey(0))
    cache = S.materialize(attention.cross_attn_cache_specs(
        cfg, B, cfg.num_image_tokens), device="cpu")
    want, jcache = jattn.cross_attn_apply(
        jp, jnp.asarray(x).astype(jdt), jcfg, None, "blocks/4/xattn",
        memory=jnp.asarray(mem), cache=jcache, mode="prefill")
    got, cache = layer(_t(x).to(cfg.activation_dtype), memory=_t(mem),
                       cache=cache, mode="prefill")
    assert got.dtype == cfg.activation_dtype
    close(got, want)
    for k in ("k", "v"):
        assert cache[k].dtype == cfg.activation_dtype
        close(cache[k], jcache[k])
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    want, _ = jattn.cross_attn_apply(
        jp, jnp.asarray(x).astype(jdt), jcfg, None, "blocks/4/xattn",
        cache=jcache, mode="decode")
    got, _ = layer(_t(x).to(cfg.activation_dtype), cache=cache,
                   mode="decode")
    close(got, want)


# ---------------------------------------------------------------------------
# whole smoke models
# ---------------------------------------------------------------------------

def _decode_pos(arch, B, p):
    """The VLM decodes at a per-row position vector, Whisper at a scalar
    (the reference refuses a vector there)."""
    return np.full((B,), p) if arch == VLM else p


@pytest.mark.parametrize("arch", ARCHS)
def test_fp_prefill_and_decode_logits_match_reference(arch):
    """A prefill of 10 tokens with memory into the caches, then two
    batched decode steps."""
    (japi, jcfg, jparams, _), (api, cfg, fp, _) = _fp(arch)
    B, P, Smax = 2, 10, 32
    V = cfg.vocab_size
    model = api.build(cfg, fp)
    jcache = JS.materialize(japi.cache_specs(jcfg, B, Smax),
                            jax.random.PRNGKey(1))
    cache = S.materialize(api.cache_specs(cfg, B, Smax), device="cpu")
    toks, mem = _tokens(3, (B, P), V), _memory(cfg, B, 4)
    want, jcache, _ = japi.apply(jparams, jcfg, jnp.asarray(toks),
                                 mode="prefill", cache=jcache, pos=0,
                                 memory=jnp.asarray(mem))
    got, cache, _ = model(torch.from_numpy(toks), mode="prefill",
                          cache=cache, pos=0, memory=_t(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FP_TOL,
                               atol=FP_TOL)
    for step in range(2):
        nxt = _tokens(10 + step, (B, 1), V)
        pos = _decode_pos(arch, B, P + step)
        want, jcache, _ = japi.apply(jparams, jcfg, jnp.asarray(nxt),
                                     mode="decode", cache=jcache,
                                     pos=jnp.asarray(pos))
        got, cache, _ = model(torch.from_numpy(nxt), mode="decode",
                              cache=cache, pos=torch.as_tensor(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FP_TOL, atol=FP_TOL)


@pytest.mark.parametrize("arch,recipe", [(a, r) for a in ARCHS
                                         for r in sorted(RECIPES)])
def test_ptq_tree_equals_reference_leaf_for_leaf(arch, recipe):
    """Under the LLaMA-3 recipe every linear is rotated by QuaRot with the
    reference's seed: the VLM's at 10 layers (two repeats of its
    5-layer pattern) gets seeds 0 and 1 by repeat, Whisper's its layer
    index in each stack."""
    layers = 10 if arch == VLM and recipe == "llama3" else 0
    (*_, jq, _), (*_, tq, _) = _quantized(arch, recipe, layers)
    want = _by_path(convert.from_reference(_np_tree(jq), device="cpu"))
    got = _by_path(tq)
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path
    if recipe == "llama3":
        rots = [p for p in got if p.endswith("/rot")]
        assert rots
        if arch == VLM:  # layer 0 and layer 5 share a seed only by repeat
            r0 = got["blocks/0/attn/q/rot"]
            assert not torch.equal(r0, got["blocks/5/attn/q/rot"])
            assert torch.equal(r0, got["blocks/1/attn/q/rot"])


def _greedy(model, toks, mem, arch, steps, cache):
    """Prefill with memory at position 0, then ``steps`` greedy decode
    steps over the cache: (every step's logits, the tokens)."""
    B, P = toks.shape
    logits = model(toks, mode="prefill", cache=cache, pos=0, memory=mem)[0]
    out, tok = [logits[:, -1]], logits[:, -1].argmax(-1)
    seq = [tok]
    for s in range(steps - 1):
        pos = torch.as_tensor(_decode_pos(arch, B, P + s))
        logits = model(tok[:, None], mode="decode", cache=cache, pos=pos)[0]
        out.append(logits[:, 0])
        tok = logits[:, 0].argmax(-1)
        seq.append(tok)
    return out, torch.stack(seq, 1)


def _jgreedy(japi, jcfg, jparams, jrecipe, toks, mem, arch, steps, B, Smax):
    jcache = JS.materialize(japi.cache_specs(jcfg, B, Smax),
                            jax.random.PRNGKey(1))
    P = toks.shape[1]
    logits, jcache, _ = japi.apply(jparams, jcfg, jnp.asarray(toks),
                                   recipe=jrecipe, mode="prefill",
                                   cache=jcache, pos=0,
                                   memory=jnp.asarray(mem))
    out = [np.asarray(logits[:, -1])]
    tok = np.asarray(logits[:, -1]).argmax(-1)
    seq = [tok]
    for s in range(steps - 1):
        logits, jcache, _ = japi.apply(
            jparams, jcfg, jnp.asarray(tok[:, None]), recipe=jrecipe,
            mode="decode", cache=jcache,
            pos=jnp.asarray(_decode_pos(arch, B, P + s)))
        out.append(np.asarray(logits[:, 0]))
        tok = np.asarray(logits[:, 0]).argmax(-1)
        seq.append(tok)
    return out, np.stack(seq, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_logits_and_greedy_tokens_match_reference(arch):
    """W4A8-IS, gates nonzero: the prefill's and every decode step's
    logits, and 8 greedy tokens, against the reference's ``apply``."""
    (japi, jcfg, jq, jrecipe), (api, cfg, tq, recipe) = \
        _quantized(arch)
    B, P, Smax, steps = 2, 8, 24, 8
    toks, mem = _tokens(5, (B, P), cfg.vocab_size), _memory(cfg, B, 8)
    want, want_seq = _jgreedy(japi, jcfg, jq, jrecipe, toks, mem, arch,
                              steps, B, Smax)
    cache = S.materialize(api.cache_specs(cfg, B, Smax), device="cpu")
    got, seq = _greedy(api.build(cfg, tq, recipe), torch.from_numpy(toks),
                       _t(mem), arch, steps, cache)
    for g, w in zip(got, want):
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= Q_REL_TOL, err
    assert np.array_equal(seq.numpy(), want_seq)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_path_is_live(arch):
    """Two memories give different logits, in prefill and in a decode
    step that reads only the cross cache; under the reference's zero
    gates the VLM's logits do not depend on the memory."""
    _, (api, cfg, tq, recipe) = _quantized(arch)
    toks = torch.from_numpy(_tokens(6, (1, 6), cfg.vocab_size))
    model = api.build(cfg, tq, recipe)
    runs = []
    for seed in (1, 2):
        cache = S.materialize(api.cache_specs(cfg, 1, 16), device="cpu")
        pre = model(toks, mode="prefill", cache=cache, pos=0,
                    memory=_t(_memory(cfg, 1, seed)))[0]
        dec = model(toks[:, :1], mode="decode", cache=cache,
                    pos=torch.as_tensor(_decode_pos(arch, 1, 6)))[0]
        runs.append((pre, dec))
    for a, b in zip(*runs):
        assert (a - b).abs().max() > 1e-3 * a.abs().max()
    if arch == VLM:
        closed = dict(tq, blocks=[dict(b, gate_attn=torch.zeros(()),
                                       gate_mlp=torch.zeros(()))
                                  if "gate_attn" in b else b
                                  for b in tq["blocks"]])
        m0 = api.build(cfg, closed, recipe)
        outs = [m0(toks, memory=_t(_memory(cfg, 1, s)))[0] for s in (1, 2)]
        assert torch.equal(*outs)


def test_collect_calibration_records_memory_inputs():
    """The capture passes each batch's ``image_embeds`` as memory: the
    cross layer's k and v record the memory's rows, equal to the
    reference's capture at ``blocks/s4/xattn/{k,v}``; Whisper's ``frames``
    reach every decoder layer's cross k/v as the encoder output."""
    (japi, jcfg, jparams, _), (api, cfg, fp, _) = _fp(VLM)
    batches = [{"tokens": _tokens(20 + i, (2, 8), cfg.vocab_size),
                "image_embeds": _memory(cfg, 2, 30 + i)} for i in range(2)]
    want = jptq.collect_calibration(japi, jcfg, jparams, batches)
    got = ptq.collect_calibration(api, cfg, fp, batches)
    for name in ("k", "v"):
        recs = got[f"blocks/4/xattn/{name}"]
        assert len(recs) == 2
        for r, b, w in zip(recs, batches, want[f"blocks/s4/xattn/{name}"]):
            assert torch.equal(r, _t(b["image_embeds"].reshape(-1, 256)))
            np.testing.assert_array_equal(r.numpy(), w)
    # q reads the hidden state after four f32 layers (the fp logits'
    # tolerance)
    np.testing.assert_allclose(got["blocks/4/xattn/q"][0].numpy(),
                               want["blocks/s4/xattn/q"][0], rtol=FP_TOL,
                               atol=FP_TOL)
    (_, (wapi, wcfg, wfp, _)) = _fp(WHISPER)
    wb = [{"tokens": _tokens(40, (2, 5), wcfg.vocab_size),
           "frames": _memory(wcfg, 2, 41)}]
    cap = ptq.collect_calibration(wapi, wcfg, wfp, wb)
    enc_out = wapi.build(wcfg, wfp).encode(_t(wb[0]["frames"]))
    for i in range(wcfg.num_layers):
        assert torch.equal(cap[f"dec/blocks/{i}/cross/k"][0],
                           enc_out.reshape(-1, wcfg.d_model))
    assert cap["enc/blocks/0/attn/q"][0].shape == (48, wcfg.d_model)


# act_quant launches a layer, shared: the VLM's self layer quantizes q/k/v,
# o, gate/up and down (4); its cross layer q, o, gate/up and down, plus
# the memory once for k/v in train and prefill (5 / 4). Whisper's encoder
# layer quantizes q/k/v, o, up and down (4); its decoder layer the self
# q/k/v and o, the cross q and o, up and down, plus the encoder output
# once for the cross k/v in train and prefill (7 / 6). Alone: one per
# quantized linear.
ACT_QUANT = {  # (kind, mode) -> (shared, alone)
    ("self", "train"): (4, 7), ("self", "decode"): (4, 7),
    ("cross", "train"): (5, 7), ("cross", "decode"): (4, 5),
    ("enc", "train"): (4, 6),
    ("dec", "train"): (7, 10), ("dec", "decode"): (6, 8),
}


def _layer_kinds(arch, cfg, mode):
    if arch == VLM:
        return layer_kinds(cfg)
    enc = ["enc"] * cfg.num_encoder_layers if mode == "train" else []
    return enc + ["dec"] * cfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["train", "decode"])
def test_act_quant_once_per_shared_activation(arch, mode):
    """act_quant launches per layer kind in a forward; the logits equal
    those with sharing turned off bit for bit."""
    _, (api, cfg, tq, recipe) = _quantized(arch)
    B = 2
    toks = torch.from_numpy(_tokens(9, (B, 8 if mode == "train" else 1),
                                    cfg.vocab_size))
    mem = _t(_memory(cfg, B, 10))
    runs = []
    for share in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            if not share:
                mp.setattr(ops, "quantize_for", lambda *a, **k: None)
            calls = []

            def counted(*a, _real=ops.act_quant, **k):
                calls.append(1)
                return _real(*a, **k)

            mp.setattr(ops, "act_quant", counted)
            model = api.build(cfg, tq, recipe)
            if mode == "train":
                got = model(toks, memory=mem)[0]
            else:
                cache = S.materialize(api.cache_specs(cfg, B, 16),
                                      device="cpu")
                model(torch.zeros((B, 4), dtype=torch.int64), mode="prefill",
                      cache=cache, pos=0, memory=mem)
                calls.clear()
                got = model(toks, mode="decode", cache=cache,
                            pos=torch.as_tensor(_decode_pos(arch, B, 4)))[0]
        runs.append((got, len(calls)))
    kinds = _layer_kinds(arch, cfg, mode)
    want = [sum(ACT_QUANT[k, mode][i] for k in kinds) for i in (0, 1)]
    assert [n for _, n in runs] == want
    assert torch.equal(runs[0][0], runs[1][0])


# ---------------------------------------------------------------------------
# what the port refuses, as the reference cannot serve these either
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_serve_refuse_memory_families(arch):
    """The engine passes no memory (the reference's neither): both
    families are refused up front, with a message naming the model API,
    before any weight is built."""
    _, (api, cfg, fp, _) = _fp(arch)
    with pytest.raises(NotImplementedError, match="model API"):
        Engine(api, cfg, fp, ServeConfig(max_slots=1, prefill_len=4))
    with pytest.raises(SystemExit, match="memory="):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_whisper_refuses_a_position_vector_and_layer_by_layer_build():
    _, (api, cfg, fp, _) = _fp(WHISPER)
    model = api.build(cfg, fp)
    cache = S.materialize(api.cache_specs(cfg, 2, 16), device="cpu")
    with pytest.raises(ValueError, match="scalar position"):
        model(torch.zeros((2, 1), dtype=torch.int64), mode="decode",
              cache=cache, pos=torch.tensor([3, 3]))
    with pytest.raises(ValueError, match="post_training_quantize"):
        ptq.quantize_by_layer(api, cfg, DEFAULT_RECIPE, device="cpu")


def test_vlm_quantize_by_layer_equals_whole_tree():
    """``quantize_by_layer`` over the VLM's blocks (its cross layers
    included) equals ``post_training_quantize`` of
    ``materialize_by_layer``'s tree leaf for leaf."""
    cfg = get_arch(VLM, smoke=True)
    api = get_model(cfg)
    by_layer = ptq.quantize_by_layer(api, cfg, DEFAULT_RECIPE, seed=2,
                                     device="cpu")
    whole = ptq.post_training_quantize(
        api, cfg, ptq.materialize_by_layer(api, cfg, seed=2, device="cpu"),
        DEFAULT_RECIPE)
    a, b = _by_path(by_layer), _by_path(whole)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert "blocks/4/attn/k/qvalue" in a and "blocks/4/gate_attn" in a
