"""The port's int8 KV cache (``kv_cache_dtype="int8"``,
``repro_torch.models.attention``) against the JAX reference on the CPU.

Both packages get the same seeded numpy inputs. Tolerances:

* ``quantize_kv``: codes and scales bit-exact (both round half to even in
  f32), on bf16 and f32 inputs, rows at .5 ties and an all-zero row (the
  1e-8 floor) included.
* Cache specs: dtypes and shapes equal to the reference's for
  ``"bfloat16"``, ``"float32"`` and ``"int8"``.
* ``decode_attention`` over int8 codes and scales: within 1e-4.
* A tiny f32 model, prefill of 10 tokens then 3 decode steps: logits
  within 1e-4; cached scales within 1e-6 relative; cached codes within 1
  and equal in at least 99.9 % of entries (an f32 ulp upstream can move a
  code across a tie).
* Engines: greedy streams EQUAL to the reference engine's, fp and W4A8-IS,
  with one capture per step; a NaN prefill retires only its request.
"""
import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ptq as jptq
from repro.core.recipe import QuantRecipe as JRecipe
from repro.core.recipe import QuantSpec as JSpec
from repro.models import attention as JA
from repro.models.config import ModelConfig as JConfig
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import convert
from repro_torch.core import ptq
from repro_torch.core.recipe import QuantRecipe, QuantSpec
from repro_torch.models import attention as A
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.nn import spec as S
from repro_torch.serving.engine import Engine, ServeConfig

FP_TOL = 1e-4
SCALE_RTOL = 1e-6
CODES_EQUAL = 0.999

TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=64, dtype="float32",
            kv_cache_dtype="int8")
# the reference's chunked attention takes its chunk sizes from the config
JCHUNKS = dict(q_chunk=16, kv_chunk=16)
TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _kv_input(dtype: str) -> np.ndarray:
    """(2, 6, 3, 16) values in ``dtype`` (as f32 numpy): seeded normal rows,
    rows whose scale is exactly 1 or 2 with values on .5 ties (+-0.5, 2.5,
    3.5, -4.5 ...), and an all-zero row."""
    x = np.random.default_rng(0).normal(size=(2, 6, 3, 16)) * 3
    ties = np.array([0.5, -0.5, 1.5, 2.5, -2.5, 3.5, -4.5, 5.5, 6.5, -7.5,
                     10.5, 20.5, -30.5, 63.5, -100.5, 127.0])
    x[0, 0, 0] = ties                      # amax 127: scale 1
    x[0, 1, 1] = 2 * ties                  # amax 254: scale 2, ties again
    x[1, 2, 2] = -ties[::-1]               # amax at the first lane
    x[1, 3] = 0.0                          # every head: the 1e-8 floor
    return np.asarray(jnp.asarray(x, dtype)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_kv_bit_exact(dtype):
    x = _kv_input(dtype)
    jq, js = JA.quantize_kv(jnp.asarray(x, dtype))
    q, s = A.quantize_kv(torch.from_numpy(x).to(TORCH_DTYPES[dtype]))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (2, 6, 3, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # the rows built for it do land on ties, and round half to even
    assert s[0, 0, 0].item() == 1.0 and s[0, 1, 1].item() == 2.0
    assert q[0, 0, 0, :4].tolist() == [0, 0, 2, 2]
    assert s[1, 3].eq(np.float32(1e-8) / np.float32(127.0)).all()
    assert not q[1, 3].any()


@pytest.mark.parametrize("kv", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cache_specs_equal_reference(kv, dtype):
    """The cache a config asks for, as the reference builds it: an int8
    config gets int8 codes and f32 scales, any other value a cache in the
    activation dtype. (An int8 config once got a bf16 cache here.)"""
    kw = dict(TINY, dtype=dtype, kv_cache_dtype=kv)
    jcfg = JConfig(**kw, **JCHUNKS)
    cfg = ModelConfig(**kw)
    jspecs = jget_model(jcfg).cache_specs(jcfg, 3, 24)["blocks"]["s0"]
    specs = get_model(cfg).cache_specs(cfg, 3, 24)["blocks"]
    assert len(specs) == cfg.num_layers
    for layer in specs:
        assert sorted(layer) == sorted(jspecs)
        for name, spec in layer.items():
            want = jspecs[name]
            assert spec.shape == tuple(want.shape[1:]), name  # no layer axis
            assert str(spec.dtype) == f"torch.{jnp.dtype(want.dtype)}", name
    cache = S.materialize({"blocks": specs}, device="cpu")["blocks"][0]
    want_k = torch.int8 if kv == "int8" else TORCH_DTYPES[dtype]
    assert cache["k"].dtype == cache["v"].dtype == want_k
    assert ("k_scale" in cache) == (kv == "int8")


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_with_scales_matches_reference(window):
    rng = np.random.default_rng(1)
    B, Smax, Hkv, G, D = 3, 12, 2, 3, 16
    q = rng.normal(size=(B, 1, Hkv * G, D)).astype(np.float32)
    k = rng.integers(-127, 128, size=(B, Smax, Hkv, D)).astype(np.int8)
    v = rng.integers(-127, 128, size=(B, Smax, Hkv, D)).astype(np.int8)
    ks = (rng.uniform(0.5, 2, size=(B, Smax, Hkv, 1)) / 127).astype(
        np.float32)
    vs = (rng.uniform(0.5, 2, size=(B, Smax, Hkv, 1)) / 127).astype(
        np.float32)
    length = np.array([4, 12, 9])
    want = JA.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(length),
        window=window, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = A.decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(length),
        window=window, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FP_TOL,
                               atol=FP_TOL)


@pytest.fixture(scope="module")
def models():
    """fp and W4A8-IS g64 weights of the tiny int8-cache config for both
    packages (the reference's certificate needs the ``jax.core.Literal``
    alias, set only while it quantizes)."""
    jcfg = JConfig(**TINY, **JCHUNKS, remat=False)
    japi = jget_model(jcfg)
    jparams = JS.materialize(japi.param_specs(jcfg, None),
                             jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY)
    api = get_model(cfg)
    tparams = convert.from_reference(_np_tree(jparams), device="cpu")
    jrecipe = JRecipe(rules=(("*", JSpec(group_size=64)),), name="w4a8-is")
    recipe = QuantRecipe(rules=(("*", QuantSpec(group_size=64)),),
                         name="w4a8-is")
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "Literal"):
            mp.setattr(jax.core, "Literal", jax.extend.core.Literal,
                       raising=False)
        jq = jptq.post_training_quantize(japi, jcfg, jparams, jrecipe, None)
    tq = ptq.post_training_quantize(api, cfg, tparams, recipe)
    return {"fp": ((japi, jcfg, jparams, None), (api, cfg, tparams, None)),
            "w4a8-is": ((japi, jcfg, jq, jrecipe), (api, cfg, tq, recipe))}


def test_int8_cache_prefill_and_decode_match_reference(models):
    """Prefill 10 tokens into an int8 cache, then three batched decode
    steps at per-row positions, in both packages."""
    (japi, jcfg, jparams, _), (api, cfg, params, _) = models["fp"]
    B, P, Smax = 2, 10, 32
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, P))
    jcache = JS.materialize(japi.cache_specs(jcfg, B, Smax),
                            jax.random.PRNGKey(1))
    cache = S.materialize(api.cache_specs(cfg, B, Smax), device="cpu")
    model = api.build(cfg, params)
    jl, jcache, _ = japi.apply(jparams, jcfg, jnp.asarray(toks),
                               mode="prefill", cache=jcache, pos=0)
    tl, cache, _ = model(torch.from_numpy(toks), mode="prefill", cache=cache,
                         pos=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=FP_TOL,
                               atol=FP_TOL)
    pos = np.array([P, P - 3])  # per-slot positions
    for step in range(3):
        nxt = np.random.default_rng(10 + step).integers(0, cfg.vocab_size,
                                                        (B, 1))
        jl, jcache, _ = japi.apply(jparams, jcfg, jnp.asarray(nxt),
                                   mode="decode", cache=jcache,
                                   pos=jnp.asarray(pos))
        tl, cache, _ = model(torch.from_numpy(nxt), mode="decode",
                             cache=cache, pos=torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=FP_TOL,
                                   atol=FP_TOL)
        pos = pos + 1
    equal = total = 0
    for i in range(cfg.num_layers):
        for name in ("k", "v"):
            got = cache["blocks"][i][name].numpy().astype(np.int32)
            want = np.asarray(jcache["blocks"]["s0"][name][i]).astype(
                np.int32)
            assert np.abs(got - want).max() <= 1, (i, name)
            equal, total = equal + (got == want).sum(), total + got.size
            s = cache["blocks"][i][f"{name}_scale"].numpy()
            js = np.asarray(jcache["blocks"]["s0"][f"{name}_scale"][i])
            np.testing.assert_allclose(s, js, rtol=SCALE_RTOL, atol=0)
            assert not s[:, P + 3:].any()  # never written
    assert equal / total >= CODES_EQUAL, equal / total


def _prompts(seed, lengths, V=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=n).tolist() for n in lengths]


LAYOUTS = {  # name -> (max_slots, prompt lengths)
    "aligned": (3, (8, 8, 8)),
    "staggered": (2, (5, 8, 3, 7, 6)),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("scheme", ["fp", "w4a8-is"])
def test_greedy_streams_equal_reference_engine(models, scheme, layout):
    (japi, jcfg, jparams, jrecipe), (api, cfg, params, recipe) = \
        models[scheme]
    slots, lengths = LAYOUTS[layout]
    prompts = _prompts(len(lengths), lengths)
    kw = dict(max_slots=slots, max_seq=64, prefill_len=8, max_new_tokens=6)
    jeng = JEngine(japi, jcfg, jparams,
                   JServeConfig(**kw, kernel_mode="reference"),
                   recipe=jrecipe)
    jrids = [jeng.submit(p) for p in prompts]
    want = jeng.run()
    eng = Engine(api, cfg, params, ServeConfig(**kw), recipe=recipe)
    assert eng.cache["blocks"][0]["k"].dtype == torch.int8
    rids = [eng.submit(p) for p in prompts]
    got = eng.run()
    assert rids == jrids
    for r in rids:
        assert eng.outcome(r) == jeng.outcome(r) == "ok"
        assert got[r] == want[r], (r, got[r], want[r])
    assert eng.ticks == jeng._steps
    assert (eng.prefill_traces, eng.decode_traces) == (
        jeng.prefill_traces, jeng.decode_traces) == (1, 1)


def test_prefill_splice_clears_the_slot_past_the_prompt(models):
    """The prefill step copies every key of the batch-1 cache into the
    slot, the scales with the codes: the slot's rows equal the batch-1
    cache's, and past prefill_len they come out zero however they were
    left; the other slot keeps its rows."""
    _, (api, cfg, params, _) = models["fp"]
    P = 8
    eng = Engine(api, cfg, params, ServeConfig(max_slots=2, max_seq=32,
                                               prefill_len=P))
    for layer in eng.cache["blocks"]:
        for t in layer.values():
            t.fill_(77 if t.dtype == torch.int8 else float("nan"))
    eng.submit(_prompts(3, (5,))[0])
    eng._admit()  # one prefill into slot 0, no decode tick
    assert eng.slots[0].active and not eng.slots[1].active
    for layer, one in zip(eng.cache["blocks"], eng._cache1["blocks"]):
        assert sorted(layer) == ["k", "k_scale", "v", "v_scale"]
        for name, t in layer.items():
            assert torch.equal(t[0], one[name][0]), name
            assert not t[0, P:].any(), name
            assert bool(t[0, :P].ne(0).any()), name
            if t.dtype == torch.int8:
                assert bool(t[1].eq(77).all()), name
            else:
                assert bool(t[1].isnan().all()), name


def test_nan_prefill_retires_only_that_request(models):
    """A prefill whose activations are NaN writes NaN scales and undefined
    int8 codes into its slot; it retires as ``nan``, and the requests
    served after it, one in that slot, decode exactly as in a clean run:
    no NaN or stale value reaches their attention."""
    _, (api, cfg, params, _) = models["fp"]
    kw = dict(max_slots=2, max_seq=64, prefill_len=8, max_new_tokens=3)
    prompts = _prompts(4, (3, 5, 4))
    clean = Engine(api, cfg, params, ServeConfig(**kw))
    crids = [clean.submit(p) for p in prompts[1:]]
    want = clean.run()

    eng = Engine(api, cfg, params, ServeConfig(**kw))
    rids = [eng.submit(p) for p in prompts]
    model, forward, poisoned = eng.model, eng.model.forward, []

    def poison_first_prefill(tokens, *, mode, cache=None, **kw):
        if mode == "train" and not poisoned:
            embed = model.embed.clone()
            model.embed.fill_(float("nan"))
            try:
                out = forward(tokens, mode=mode, cache=cache, **kw)
            finally:
                model.embed.copy_(embed)
            scale = cache["blocks"][0]["k_scale"]
            poisoned.append(bool(scale[0, :8].isnan().all()))
            return out
        return forward(tokens, mode=mode, cache=cache, **kw)

    model.forward = poison_first_prefill
    outs = eng.run()
    assert poisoned == [True]
    assert [eng.outcome(r) for r in rids] == ["nan", "ok", "ok"]
    assert outs[rids[0]] == []
    assert [outs[r] for r in rids[1:]] == [want[r] for r in crids]
    assert (eng.prefill_traces, eng.decode_traces) == (1, 1)
