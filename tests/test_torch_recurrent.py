"""The recurrent families in the port: xLSTM (``models.xlstm``: the causal
conv, the mLSTM cell and its chunkwise form, the sLSTM block) and
RecurrentGemma / Griffin (``models.griffin``: the RG-LRU scan, local
attention over a ring buffer, the GeGLU MLP), the ``xlstm-1.3b`` and
``recurrentgemma-9b`` configs, ``convert``'s layouts of both families
(Griffin's own split), the PTQ seeds by repeat, and the engine's xLSTM
serving, against the JAX reference on the CPU.

Tolerances and why:

* Config fields, cache specs, the converted trees, the PTQ trees (under
  ``DEFAULT_RECIPE`` and the rotating ``LLAMA3_RECIPE``, whose QuaRot
  seeds follow the reference's repeat index): equal, bit for bit.
* The causal conv: within 1e-6 (f32 sums over the taps in the
  reference's order; the state's dtype is the input's).
* The RG-LRU scan: rtol 1e-5 / atol 1e-6 (the reference's
  ``associative_scan`` and the port's log-depth scan combine in other
  orders; a sequential loop in f64 is the referee for both).
* The mLSTM cell over a sequence and the sLSTM block: rtol 1e-5 / atol
  1e-5 (f32, the same ops; XLA's and PyTorch's f32 contractions sum in
  other orders). The chunkwise mLSTM at chunk 8 and 16 on fixed seeds
  (not drawn by Hypothesis, whose rare seeds miss rtol 1e-4 in the
  reference's own test): within 1e-4 of the largest value of the
  reference's chunkwise form and of the port's sequential form.
* Local attention over the ring buffer, prefilled over 40 tokens at
  window 16 and decoded 24 steps across the ring's wrap: rtol 1e-5 /
  atol 1e-5 per step, ring caches included.
* Whole smoke models in f32 on the reference's weights: fp train,
  prefill and decode logits within 1e-4; W4A8-IS logits within 2e-2 of
  the largest logit (an f32 rounding upstream can move an activation code
  by one), and 8 greedy tokens equal.
* The engine's greedy streams (xLSTM, one slot reused by three requests
  shorter than ``prefill_len``): equal to the reference engine's.
* ``act_quant`` launches per layer kind, with logits bit-identical to
  sharing turned off.

The reference's integer-scale PTQ needs ``jax.core.Literal``, which JAX
0.9 moved: it is aliased only inside ``pytest.MonkeyPatch.context()``.

    PYTHONPATH=src python -m pytest tests/test_torch_recurrent.py -q
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
from repro.models import griffin as jgriffin
from repro.models import xlstm as jxlstm
from repro.models.registry import get_arch as jget_arch
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import convert
from repro_torch.core import ptq
from repro_torch.core.recipe import DEFAULT_RECIPE, LLAMA3_RECIPE
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import griffin, xlstm
from repro_torch.models.registry import get_arch, get_model
from repro_torch.nn import spec as S
from repro_torch.serving.engine import Engine, ServeConfig

FP_TOL = 1e-4
Q_REL_TOL = 2e-2
XLSTM, RG = "xlstm-1.3b", "recurrentgemma-9b"
ARCHS = (XLSTM, RG)
RECIPES = {"w4a8-is": (J_DEFAULT, DEFAULT_RECIPE),
           "llama3": (J_LLAMA3, LLAMA3_RECIPE)}
JMOD = {XLSTM: jxlstm, RG: jgriffin}
PMOD = {XLSTM: xlstm, RG: griffin}


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS / OpenMP thread a process while this module runs: its
    numpy and PyTorch products are small (QuaRot's QR and ``rot.T @ w``
    at K = 256..512, the smoke models' GEMMs), and beside the suite's
    other parallel workers a pool of spinning BLAS threads costs far more
    than it saves. Both packages run under the same limit."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


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


def _dt(spec) -> str:
    """A spec's dtype name, in either package."""
    d = spec.dtype
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


def _jax_literal(mp):
    if not hasattr(jax.core, "Literal"):
        mp.setattr(jax.core, "Literal", jax.extend.core.Literal,
                   raising=False)


def _ref_layers(tree, arch, jcfg) -> list:
    """The reference's tree (params, cache or specs) one layer at a time,
    in the port's order, through the reference's own ``_split``; a
    stacked leaf's repeat axis taken off (a spec keeps its shape minus
    that axis, as ``(shape, dtype)``)."""
    prefix, pattern, R = JMOD[arch]._split(jcfg)

    def take(r):
        def one(a):
            if JS.is_spec(a):
                return (a.shape[1:], _dt(a))
            return np.asarray(a)[r]
        return one

    def plain(a):
        return (a.shape, _dt(a)) if JS.is_spec(a) else np.asarray(a)

    out = [jax.tree.map(plain, tree["prefix"][str(i)], is_leaf=JS.is_spec)
           for i in range(len(prefix))]
    out += [jax.tree.map(take(r), tree["blocks"][f"s{j}"],
                         is_leaf=JS.is_spec)
            for r in range(R) for j in range(len(pattern))]
    return out


def _ref_ptq(japi, jcfg, jparams, jrecipe):
    with pytest.MonkeyPatch.context() as mp:
        _jax_literal(mp)
        return jptq.post_training_quantize(japi, jcfg, jparams, jrecipe,
                                           None)


def _cfgs(arch, layers=0, **kw):
    """Both packages' f32 smoke configs of ``arch``, at ``layers`` layers
    (0: the smoke depth; xLSTM at 4 layers with an sLSTM every 2nd, so
    that its pattern repeats) and with the fields ``kw``."""
    jcfg = _f32(jget_arch(arch, smoke=True))
    cfg = _f32(get_arch(arch, smoke=True))
    if layers:
        kw["num_layers"] = layers
        if arch == XLSTM and layers == 4:
            kw["slstm_every"] = 2
    return (dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw))


@functools.lru_cache(maxsize=None)
def _fp(arch: str, layers: int = 0):
    """Both packages' f32 smoke model of ``arch`` (``layers``: its depth,
    0 the smoke config's) on the reference's weights:
    ((japi, jcfg, jparams, None), (api, cfg, params, None))."""
    jcfg, cfg = _cfgs(arch, layers)
    japi, api = jget_model(jcfg), get_model(cfg)
    jparams = JS.materialize(japi.param_specs(jcfg, None),
                             jax.random.PRNGKey(0))
    fp = convert.from_reference(_np_tree(jparams), device="cpu")
    return (japi, jcfg, jparams, None), (api, cfg, fp, None)


@functools.lru_cache(maxsize=None)
def _quantized(arch: str, recipe: str = "w4a8-is", layers: int = 0):
    """Each package's tree of :func:`_fp`'s model under ``recipe``, the
    recipe in last place."""
    (japi, jcfg, jparams, _), (api, cfg, fp, _) = _fp(arch, layers)
    jr, tr = RECIPES[recipe]
    return ((japi, jcfg, _ref_ptq(japi, jcfg, jparams, jr), jr),
            (api, cfg, ptq.post_training_quantize(api, cfg, fp, tr), tr))


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    """``fn`` jitted with the keyword arguments ``static`` static (the
    reference's config is its second positional argument), compiled once
    per shape: an eager ``lax.scan`` would trace its body on every call."""
    return jax.jit(fn, static_argnums=(1,) if "cfg" in static else (),
                   static_argnames=tuple(a for a in static if a != "cfg"))


def _japply(japi, jparams, jcfg, toks, **kw):
    """The reference's ``apply``, jitted (config, recipe, mode static)."""
    return _jit(japi.apply, "cfg", "recipe", "mode")(
        jparams, jcfg, jnp.asarray(toks), **kw)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(
        jnp.asarray(want).astype(jnp.float32)), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# configs and cache specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch):
    for smoke in (False, True):
        j, t = jget_arch(arch, smoke=smoke), get_arch(arch, smoke=smoke)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (smoke, f.name)
        assert PMOD[arch].layer_kinds(t) == JMOD[arch].layer_kinds(j)
        assert PMOD[arch].split(t) == JMOD[arch]._split(j)
    c = get_arch(arch)
    kinds = PMOD[arch].layer_kinds(c)
    if arch == XLSTM:
        assert (c.num_layers, c.d_model, c.num_heads, c.vocab_size,
                c.slstm_every, c.mlstm_proj_factor, c.mlstm_impl) == (
                    48, 2048, 4, 50304, 8, 2.0, "scan")
        assert (kinds.count("mlstm"), kinds.count("slstm")) == (42, 6)
    else:
        assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
                c.head_dim, c.d_ff, c.vocab_size, c.window,
                c.logit_softcap) == (38, 4096, 16, 1, 256, 12288, 256000,
                                     2048, 30.0)
        assert (kinds.count("rec"), kinds.count("attn")) == (26, 12)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch):
    """Every layer's state (an mLSTM's C, n, m and conv window, an
    sLSTM's c, n, m, h; an RG-LRU's h and conv window, a local
    attention's ring of ``window`` slots in the activation dtype whatever
    ``kv_cache_dtype`` says) equals the reference's, shape and dtype."""
    for smoke in (False, True):
        for kv in ("bfloat16", "int8"):
            jc = dataclasses.replace(jget_arch(arch, smoke=smoke),
                                     kv_cache_dtype=kv)
            c = dataclasses.replace(get_arch(arch, smoke=smoke),
                                    kv_cache_dtype=kv)
            got = get_model(c).cache_specs(c, 4, 256)["blocks"]
            want = _ref_layers(jget_model(jc).cache_specs(jc, 4, 256), arch,
                               jc)
            assert len(got) == len(want) == c.num_layers
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w)
                for k, s in g.items():
                    assert (s.shape, _dt(s)) == w[k], k


# ---------------------------------------------------------------------------
# the pieces: conv, scans, cells, blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(with_state, dtype):
    rng = np.random.default_rng(11)
    w = rng.normal(size=(4, 48)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    x = rng.normal(size=(2, 9, 48)).astype(np.float32)
    st = rng.normal(size=(2, 3, 48)).astype(np.float32) if with_state \
        else None
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    want, wst = jxlstm.causal_conv(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        jnp.asarray(x).astype(jdt),
        state=None if st is None else jnp.asarray(st).astype(jdt))
    got, gst = xlstm.causal_conv(
        {"w": _t(w), "b": _t(b)}, _t(x).to(tdt),
        state=None if st is None else _t(st).to(tdt))
    assert got.dtype == gst.dtype == tdt
    if dtype == "float32":
        _close(got, want, rtol=0, atol=1e-6)
    else:  # the same f32 value before the cast, or one bf16 ulp off
        assert np.abs(got.float().numpy() - np.asarray(
            want.astype(jnp.float32))).max() <= 2.0 ** -7 * np.abs(
                np.asarray(want.astype(jnp.float32))).max()
    _close(gst, wst, rtol=0, atol=0)


@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_matches_reference(with_h0):
    rng = np.random.default_rng(12)
    B, S_, d = 2, 37, 24
    a = rng.uniform(0.05, 0.999, size=(B, S_, d)).astype(np.float32)
    b = rng.normal(size=(B, S_, d)).astype(np.float32)
    h0 = rng.normal(size=(B, d)).astype(np.float32) if with_h0 else None
    want = jgriffin._lru_scan(jnp.asarray(a), jnp.asarray(b),
                              None if h0 is None else jnp.asarray(h0))
    got = griffin._lru_scan(_t(a), _t(b), None if h0 is None else _t(h0))
    _close(got, want, rtol=1e-5, atol=1e-6)
    h = np.zeros((B, d)) if h0 is None else h0.astype(np.float64)
    for t in range(S_):  # the exact recurrence in f64
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(got[:, t].numpy(), h, rtol=1e-5,
                                   atol=1e-6)


def _mlstm_inputs(seed, B=2, S_=32, H=2, dh=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S_, H, dh)).astype(np.float32)
               for _ in range(3))
    k = k / np.sqrt(dh).astype(np.float32)
    i_raw = rng.normal(size=(B, S_, H)).astype(np.float32)
    f_raw = (rng.normal(size=(B, S_, H)) + 2.0).astype(np.float32)
    C0 = rng.normal(size=(B, H, dh, dh)).astype(np.float32) * 0.1
    n0 = rng.normal(size=(B, H, dh)).astype(np.float32) * 0.1
    m0 = rng.normal(size=(B, H)).astype(np.float32) * 0.1
    return q, k, v, i_raw, f_raw, C0, n0, m0


def _port_mlstm_scan(q, k, v, i_raw, f_raw, C0, n0, m0):
    st, hs = (_t(C0), _t(n0), _t(m0)), []
    for t in range(q.shape[1]):
        st, h = xlstm._mlstm_cell(st, tuple(
            _t(x[:, t]) for x in (q, k, v, i_raw, f_raw)))
        hs.append(h)
    return torch.stack(hs, 1), st


def test_mlstm_cell_over_a_sequence_matches_reference():
    q, k, v, i_raw, f_raw, C0, n0, m0 = _mlstm_inputs(13)
    xs = tuple(jnp.moveaxis(jnp.asarray(x), 1, 0)
               for x in (q, k, v, i_raw, f_raw))
    (C, n, m), hs = jax.lax.scan(
        jxlstm._mlstm_cell, tuple(jnp.asarray(x) for x in (C0, n0, m0)), xs)
    got, (gC, gn, gm) = _port_mlstm_scan(q, k, v, i_raw, f_raw, C0, n0, m0)
    _close(got, jnp.moveaxis(hs, 0, 1))
    for g, w in ((gC, C), (gn, n), (gm, m)):
        _close(g, w)


@pytest.mark.parametrize("chunk", [8, 16])
def test_mlstm_chunked_matches_reference_and_the_scan(chunk):
    inputs = _mlstm_inputs(14 + chunk)
    want, (C, n, m) = jxlstm._mlstm_chunked(
        *(jnp.asarray(x) for x in inputs), chunk)
    got, (gC, gn, gm) = xlstm._mlstm_chunked(*(_t(x) for x in inputs),
                                             chunk)
    seq, (sC, sn, sm) = _port_mlstm_scan(*inputs)
    for g, w, s in ((got, want, seq), (gC, C, sC), (gn, n, sn),
                    (gm, m, sm)):
        w = np.asarray(w)
        bound = 1e-4 * max(np.abs(w).max(), 1.0)
        assert np.abs(g.numpy() - w).max() <= bound
        assert np.abs(g.numpy() - s.numpy()).max() <= bound


def test_slstm_block_matches_reference():
    """The smoke xLSTM's sLSTM layer (blocks/s3): 7 tokens from a zero
    state, then 1 more from the state they left, then 5 with no state."""
    (_, jcfg, jparams, _), (_, cfg, fp, _) = _fp(XLSTM)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["s3"])
    blk = xlstm.SLSTMBlock(cfg, fp["blocks"][3], None, "blocks/3")
    jst = JS.materialize(jxlstm.slstm_state_specs(jcfg, 2),
                         jax.random.PRNGKey(0))
    st = S.materialize(xlstm.slstm_state_specs(cfg, 2), device="cpu")
    ref = jax.jit(functools.partial(jxlstm.slstm_apply, cfg=jcfg,
                                    recipe=None, base="blocks/s3"))
    rng = np.random.default_rng(15)
    for n in (7, 1):
        x = rng.normal(size=(2, n, cfg.d_model)).astype(np.float32)
        want, jst = ref(jp, jnp.asarray(x), state=jst)
        got = blk(_t(x), st)
        _close(got, want)
        for k in "cnmh":
            _close(st[k], jst[k])
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    want, _ = ref(jp, jnp.asarray(x))
    _close(blk(_t(x)), want)


def test_local_attention_ring_matches_reference():
    """The smoke Griffin's local attention (layer 2, the reference's
    blocks/s0) at window 16: a prefill of 40 tokens, which keeps the last
    16 in ring order, then 24 decode steps across two wraps of the ring
    (the position an int and a 0-d tensor in turn), outputs and rings
    against ``local_attn_apply``."""
    (_, jcfg, jparams, _), (_, cfg, fp, _) = _fp(RG)
    assert (cfg.window, jgriffin.layer_kinds(jcfg)[2]) == (16, "attn")
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["s0"]["mix"])
    layer = griffin.LocalAttention(cfg, fp["blocks"][2]["mix"], None,
                                   "blocks/2/lattn")
    B, P = 2, 40
    jst = JS.materialize(jgriffin.local_attn_state_specs(jcfg, B),
                         jax.random.PRNGKey(0))
    st = S.materialize(griffin.local_attn_state_specs(cfg, B), device="cpu")
    ref = {mode: jax.jit(functools.partial(
        jgriffin.local_attn_apply, cfg=jcfg, recipe=None,
        base="blocks/s0/lattn", mode=mode)) for mode in ("prefill", "decode")}
    rng = np.random.default_rng(16)
    x = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
    want, jst = ref["prefill"](jp, jnp.asarray(x), state=jst, pos=0)
    _close(layer(_t(x), st, pos=0, mode="prefill"), want)
    for s in range(24):
        for k in ("k", "v"):
            _close(st[k], jst[k])
        x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        pos = P + s
        want, jst = ref["decode"](jp, jnp.asarray(x), state=jst, pos=pos)
        got = layer(_t(x), st, mode="decode",
                    pos=torch.tensor(pos) if s % 2 else pos)
        _close(got, want)


# ---------------------------------------------------------------------------
# layouts, PTQ
# ---------------------------------------------------------------------------

LAYOUTS = {  # name -> (arch, layers, the repeat index of each layer)
    "xlstm-blocks-s0..s3-x1": (XLSTM, 0, [0] * 4),
    "xlstm-blocks-s0..s3-x2": (XLSTM, 8, [0] * 4 + [1] * 4),
    "griffin-prefix-0..1-blocks-s0..s2-x1": (RG, 0, [0] * 5),
    "griffin-prefix-0..1-blocks-s0..s2-x2": (RG, 8, [0] * 5 + [1] * 3),
    "griffin-blocks-s0..s2-x2": (RG, 6, [0] * 3 + [1] * 3),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_convert_round_trips_and_layer_kinds(name):
    """Port layer i is the reference's layer i through each family's own
    split (Griffin: the first ``num_layers % 3`` layers are the prefix;
    ``split_layers`` alone would stack the smoke config's 5 layers as
    ``blocks/s0..s4`` x 1). ``to_reference`` with the config gives back
    the reference's tree bit for bit; ``layer_kinds_of`` names the
    reference's kinds, and ``scan_repeats`` gives each layer's repeat
    index, the PTQ seed of the reference's stacked linears."""
    arch, L, repeats = LAYOUTS[name]
    jcfg, cfg = _cfgs(arch, L)
    japi = jget_model(jcfg)
    jparams = _np_tree(JS.materialize(japi.param_specs(jcfg, None),
                                      jax.random.PRNGKey(3)))
    port = convert.from_reference(jparams, device="cpu")
    specs = get_model(cfg).param_specs(cfg)
    assert sorted(_by_path(port)) == sorted(_by_path(specs))
    for blk, want in zip(port["blocks"], _ref_layers(jparams, arch, jcfg),
                         strict=True):
        w = _by_path(want)
        for path, t in _by_path(blk).items():
            assert np.array_equal(t.numpy(), w[path]), path
    back = convert.to_reference(port, cfg)
    assert sorted(_by_path(back)) == sorted(_by_path(jparams))
    for path, a in _by_path(back).items():
        assert np.array_equal(a, np.asarray(_by_path(jparams)[path],
                                            np.float32)), path
    kinds = convert.layer_kinds_of(specs["blocks"])
    assert kinds == JMOD[arch].layer_kinds(jcfg)
    assert convert.scan_repeats(kinds, cfg) == repeats
    if arch == RG:
        with pytest.raises(ValueError, match="config"):
            convert.to_reference(port)


@pytest.mark.parametrize("arch,recipe,layers", [
    (XLSTM, "w4a8-is", 0), (RG, "w4a8-is", 0), (XLSTM, "llama3", 4),
    (RG, "llama3", 8)])
def test_ptq_tree_equals_reference_leaf_for_leaf(arch, recipe, layers):
    """Under the LLaMA-3 recipe every linear is rotated by QuaRot with the
    reference's seed, its layer's repeat index: xLSTM at 4 layers with an
    sLSTM every 2nd repeats its (mLSTM, sLSTM) pattern twice, and
    Griffin at 8 layers gives its 2 prefix layers and first pattern seed
    0, its second pattern seed 1. The sLSTM's ff_down has K = 384, where
    PyTorch's and numpy's CPU products sum in other orders (QuaRot's
    ``rot.T @ w`` is numpy's on the CPU)."""
    (*_, jq, _), (api, cfg, tq, tr) = _quantized(arch, recipe, layers)
    want = _by_path(convert.from_reference(_np_tree(jq), device="cpu"))
    got = _by_path(tq)
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.dtype == want[path].dtype and torch.equal(t, want[path]), \
            path
    if recipe == "llama3":
        rot, same, other = (("up", 0, 2) if arch == XLSTM
                            else ("mix/gate_proj", 3, 6))
        r = [got[f"blocks/{i}/{rot}/rot"] for i in (0, same, other)]
        assert torch.equal(r[0], r[1]) and not torch.equal(r[0], r[2])
        by_layer = ptq.quantize_by_layer(api, cfg, tr, seed=4, device="cpu")
        whole = ptq.post_training_quantize(
            api, cfg, ptq.materialize_by_layer(api, cfg, seed=4,
                                               device="cpu"), tr)
        a, b = _by_path(by_layer), _by_path(whole)
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# whole smoke models
# ---------------------------------------------------------------------------

def _steps(ref, port, toks, steps, Smax=32):
    """Prefill ``toks`` from a zero cache in both packages, then ``steps``
    - 1 greedy decode steps at scalar positions. ``ref``: (japi, jcfg,
    jparams, jrecipe); ``port``: (api, cfg, model). Returns (each step's
    (port logits, reference logits)), the reference's tokens, the
    port's)."""
    japi, jcfg, jparams, jrecipe = ref
    api, cfg, model = port
    B, P = toks.shape
    jcache = JS.materialize(japi.cache_specs(jcfg, B, Smax),
                            jax.random.PRNGKey(1))
    cache = S.materialize(api.cache_specs(cfg, B, Smax), device="cpu")
    want, jcache, _ = _japply(japi, jparams, jcfg, toks, recipe=jrecipe,
                              mode="prefill", cache=jcache, pos=0)
    got = model(torch.from_numpy(toks), mode="prefill", cache=cache,
                pos=0)[0]
    outs = [(got[:, -1], np.asarray(want[:, -1]))]
    jtok = np.asarray(want[:, -1]).argmax(-1)
    tok = got[:, -1].argmax(-1)
    seqs = ([jtok], [tok])
    for s in range(steps - 1):
        want, jcache, _ = _japply(japi, jparams, jcfg, jtok[:, None],
                                  recipe=jrecipe, mode="decode",
                                  cache=jcache, pos=P + s)
        got = model(tok[:, None], mode="decode", cache=cache,
                    pos=torch.tensor(P + s))[0]
        outs.append((got[:, 0], np.asarray(want[:, 0])))
        jtok, tok = np.asarray(want[:, 0]).argmax(-1), got[:, 0].argmax(-1)
        seqs[0].append(jtok)
        seqs[1].append(tok)
    return outs, np.stack(seqs[0], 1), torch.stack(seqs[1], 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_fp_logits_match_reference(arch):
    """f32 on the reference's weights: a train-mode forward of 24 tokens,
    then a prefill of them into the state and 6 decode steps (Griffin's
    ring of 16 wraps)."""
    (japi, jcfg, jparams, _), (api, cfg, fp, _) = _fp(arch)
    model = api.build(cfg, fp)
    toks = _tokens(3, (2, 24), cfg.vocab_size)
    want = _japply(japi, jparams, jcfg, toks, recipe=None, mode="train")[0]
    _close(model(torch.from_numpy(toks))[0], want, rtol=FP_TOL, atol=FP_TOL)
    outs, _, _ = _steps((japi, jcfg, jparams, None), (api, cfg, model),
                        toks, 7)
    for g, w in outs:
        _close(g, w, rtol=FP_TOL, atol=FP_TOL)


def test_chunked_mlstm_model_matches_reference():
    """``mlstm_impl="chunked"`` at chunk 8: a train-mode forward of 16
    tokens and a prefill (two chunks) with 2 decode steps (the cell)."""
    jcfg, cfg = _cfgs(XLSTM, mlstm_impl="chunked", chunk_size=8)
    (_, _, jparams, _), (_, _, fp, _) = _fp(XLSTM)
    japi, api = jget_model(jcfg), get_model(cfg)
    model = api.build(cfg, fp)
    toks = _tokens(4, (2, 16), cfg.vocab_size)
    want = _japply(japi, jparams, jcfg, toks, recipe=None, mode="train")[0]
    _close(model(torch.from_numpy(toks))[0], want, rtol=FP_TOL, atol=FP_TOL)
    outs, _, _ = _steps((japi, jcfg, jparams, None), (api, cfg, model),
                        toks, 3)
    for g, w in outs:
        _close(g, w, rtol=FP_TOL, atol=FP_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_logits_and_greedy_tokens_match_reference(arch):
    """W4A8-IS: a train-mode forward, then a prefill and 8 greedy tokens,
    each step's logits within 2e-2 of the largest and the tokens equal."""
    (japi, jcfg, jq, jr), (api, cfg, tq, tr) = _quantized(arch)
    model = api.build(cfg, tq, tr)
    toks = _tokens(5, (2, 20), cfg.vocab_size)
    want = np.asarray(_japply(japi, jq, jcfg, toks, recipe=jr,
                              mode="train")[0])
    got = model(torch.from_numpy(toks))[0].numpy()
    assert np.abs(got - want).max() <= Q_REL_TOL * np.abs(want).max()
    outs, jseq, seq = _steps((japi, jcfg, jq, jr), (api, cfg, model), toks,
                             8)
    for g, w in outs:
        assert np.abs(g.numpy() - w).max() <= Q_REL_TOL * np.abs(w).max()
    assert np.array_equal(seq.numpy(), jseq)


# act_quant launches a layer, shared -> alone (one per quantized linear):
# an mLSTM quantizes its input for up, xc once for q / k, xm for v, and h
# for down; an sLSTM its input for wx, x once for ff_gate / ff_up, and
# ff_down's; an RG-LRU its input once for gate_proj / x_proj, out_proj's,
# and the MLP's two (gate / up, down); a local attention q / k / v once,
# o, and the MLP's two
ACT_QUANT = {"mlstm": (4, 5), "slstm": (3, 4), "rec": (4, 6),
             "attn": (4, 7)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["train", "decode"])
def test_act_quant_once_per_shared_activation(arch, mode):
    _, (api, cfg, tq, recipe) = _quantized(arch)
    B = 2
    toks = torch.from_numpy(_tokens(9, (B, 8 if mode == "train" else 1),
                                    cfg.vocab_size))
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
                got = model(toks)[0]
            else:
                cache = S.materialize(api.cache_specs(cfg, B, 16),
                                      device="cpu")
                model(torch.zeros((B, 4), dtype=torch.int64), mode="prefill",
                      cache=cache, pos=0)
                calls.clear()
                got = model(toks, mode="decode", cache=cache,
                            pos=torch.tensor(4))[0]
        runs.append((got, len(calls)))
    kinds = PMOD[arch].layer_kinds(cfg)
    want = [sum(ACT_QUANT[k][i] for k in kinds) for i in (0, 1)]
    assert [n for _, n in runs] == want
    assert torch.equal(runs[0][0], runs[1][0])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_engine_serves_xlstm_as_the_reference_engine():
    """W4A8-IS, one slot reused by three prompts shorter than
    ``prefill_len``: each prefill starts from a zero state (the engine
    zeroes its batch-1 cache inside the step) and reads the prompt padded
    with 0, as the reference's; the streams equal the reference engine's,
    and the last request's stream equals a fresh engine's for it alone."""
    (japi, jcfg, jq, jr), (api, cfg, tq, tr) = _quantized(XLSTM)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 3, 7)]
    kw = dict(max_slots=1, max_seq=32, prefill_len=8, max_new_tokens=4)
    jeng = JEngine(japi, jcfg, jq, JServeConfig(**kw,
                                                kernel_mode="reference"),
                   recipe=jr)
    jrids = [jeng.submit(p) for p in prompts]
    want = jeng.run()
    jeng.close()
    eng = Engine(api, cfg, tq, ServeConfig(**kw), recipe=tr)
    rids = [eng.submit(p) for p in prompts]
    got = eng.run()
    assert rids == jrids
    for r in rids:
        assert eng.outcome(r) == jeng.outcome(r) == "ok"
        assert got[r] == want[r], (r, got[r], want[r])
    assert (eng.prefill_traces, eng.decode_traces) == (1, 1)
    fresh = Engine(api, cfg, tq, ServeConfig(**kw), recipe=tr)
    r = fresh.submit(prompts[2])
    assert fresh.run()[r] == got[rids[2]]


def test_engine_and_serve_refuse_griffin_and_its_decode_a_position_vector():
    """The engine decodes each slot at its own position, which Griffin's
    ring buffer cannot take (the reference's engine fails at its first
    decode): the engine and the CLI refuse the family up front, naming
    the model API, and Griffin's decode raises on a (B,) position, as the
    reference's does."""
    _, (api, cfg, fp, _) = _fp(RG)
    with pytest.raises(NotImplementedError, match="model API"):
        Engine(api, cfg, fp, ServeConfig(max_slots=1, prefill_len=4))
    with pytest.raises(SystemExit, match="scalar pos"):
        serve.main(["--arch", RG, "--smoke", "--device", "cpu"])
    model = api.build(cfg, fp)
    cache = S.materialize(api.cache_specs(cfg, 2, 16), device="cpu")
    model(torch.zeros((2, 4), dtype=torch.int64), mode="prefill",
          cache=cache, pos=0)
    with pytest.raises(ValueError, match="scalar position"):
        model(torch.zeros((2, 1), dtype=torch.int64), mode="decode",
              cache=cache, pos=torch.tensor([4, 4]))
    (japi, jcfg, jparams, _), _ = _fp(RG)
    jst = JS.materialize(jgriffin.local_attn_state_specs(jcfg, 2),
                         jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["s0"]["mix"])
    with pytest.raises(Exception):  # the reference's ring write
        jgriffin.local_attn_apply(
            jp, jnp.zeros((2, 1, jcfg.d_model)), jcfg, None,
            "blocks/s0/lattn", state=jst, pos=jnp.asarray([4, 4]),
            mode="decode")
