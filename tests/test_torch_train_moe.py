"""Training the MoE family and MLA in the port (``training/train_step.py``
over ``models/moe.py`` and ``models/attention.MLAttention``; the int8
dispatch of ``models.moe.Int8Transport``; ``optimizer.decay_mask``,
``convert``'s optimizer state and checkpoints on MoE and DeepSeek-V2
trees) against the JAX reference on the CPU, on the same seeded inputs.

Cases (smoke configs in f32, remat off in both packages but for
``deepseek-top6``; Phi-3.5-MoE, DeepSeek-V2 (its dense layer, then a MoE
one) and MiniCPM3 cut to 2 layers):
``mixtral`` (no token dropped), ``mixtral-drop`` (capacity factor 1.25,
two dispatch groups: tokens dropped), ``phi35``, ``deepseek`` (MLA, a
leading dense layer, shared experts), ``deepseek-top6`` (remat on: the
aux summed over recomputed blocks), ``minicpm3``
(dense MLA) and ``mixtral-int8`` (``moe_int8_dispatch``).

Tolerances and why (``tests/test_torch_train.py``'s, unless stated):

* Each MoE layer's routed counts from both packages' routing sinks are
  compared first and must be equal: a routing flip (an f32 sum in another
  order moving a near tie between two experts) is reported as one, not as
  a gradient error.
* The loss, ce, aux and grad norm at step 0: rtol 1e-5, 20 times that
  at step 2 (computed from the params step 1 moved); every gradient leaf
  ``||dg|| / ||g|| <= 1e-5``; ``mu`` / ``nu`` after 1 and 2 steps within
  1e-3 of each leaf's largest value, ``step`` equal. Params within
  0.01 x lr where both packages' ``mu`` and ``nu`` have agreed to 1e-3
  relative after every step so far, and within one lr step a step taken
  elsewhere, on at most 1 % of the elements (0.1-0.25 % here). A new
  bound beside ``tests/test_torch_train.py``'s: AdamW divides each
  gradient element by its own magnitude, and a MoE model has many more
  elements near eps = 1e-8 (a token's gradient reaches only its experts)
  or whose first moment cancels between steps, where a last-bit gradient
  difference moves the update by several hundredths of an lr step (0.03
  x lr seen on ``attn/k/w``).
* The int8 dispatch buffer: bit-equal to the reference's
  ``_int8_transport`` on the same buffer, and its gradient the identity.
* ``chunked_attention``'s gradient against ``jax.vjp`` of the
  reference's jnp ``flash_attention`` (Sq = Sk not a chunk multiple,
  D != Dv, chunks past the diagonal fully masked): atol 1e-5, finite,
  zero where no query reads a padded key.
* Prefill logits and decode logits with ``moe_int8_dispatch`` through the
  model API, f32: within 1e-4 (``tests/test_torch_moe.py``'s fp bound).
* The Mixtral and DeepSeek-V2 trees (DeepSeek-V2 at 9 layers, where its
  dense layer is the reference's unstacked ``prefix/0``): the layout and
  ``decay_mask`` exactly; two AdamW steps at weight decay 1.0 against
  the reference's jitted update, params rtol 1e-6 (f32), ``mu`` / ``nu``
  within 1e-3 of each leaf's largest value (XLA fuses the jitted moment
  updates; the eager reference takes 30 s on the 9-layer tree); the
  optimizer state converted both ways and a checkpoint written by either
  package and restored by the other, bit for bit.
* Two forwards and backwards of the same MoE model: bit for bit, at
  top-2 and top-6, with 4 threads.

    PYTHONPATH=src python -m pytest tests/test_torch_train_moe.py -q
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.registry import get_arch as jget_arch
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro.training import optimizer as JO
from repro.training import train_step as JT
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.models import attention, moe
from repro_torch.models.registry import get_arch, get_model
from repro_torch.nn import spec as S
from repro_torch.training import optimizer as O
from repro_torch.training import train_step as T

OC = dict(lr=1e-3, warmup_steps=2, total_steps=6)
F32_LOSS_REL, F32_GRAD_REL, F32_STATE_REL = 1e-5, 1e-5, 1e-3
FP_TOL = 1e-4
# an element's moments agree within MOMENT_REL; at most LOOSE_SHARE of
# the elements may not (see the module note)
MOMENT_REL, LOOSE_SHARE = 1e-3, 0.01

CASES = {  # name -> (arch, config fields, (batch, seq))
    "mixtral": ("mixtral-8x7b", {}, (2, 16)),
    "mixtral-drop": ("mixtral-8x7b", dict(capacity_factor=1.25,
                                          dispatch_groups=2), (4, 24)),
    "phi35": ("phi3.5-moe-42b-a6.6b", dict(num_layers=2), (2, 16)),
    "deepseek": ("deepseek-v2-236b", dict(num_layers=2), (2, 20)),
    "deepseek-top6": ("deepseek-v2-236b", dict(num_layers=2, top_k=6,
                                               remat=True), (2, 20)),
    "minicpm3": ("minicpm3-4b", dict(num_layers=2), (2, 20)),
    "mixtral-int8": ("mixtral-8x7b", dict(moe_int8_dispatch=True), (2, 16)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS / OpenMP thread a process while this module runs, as in
    ``tests/test_torch_train.py``."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _by_path(tree, path="") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_by_path(v, f"{path}/{k}" if path else str(k)))
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _configs(case: str):
    arch, kw, _ = CASES[case]
    kw = dict(dict(dtype="float32", remat=False), **kw)
    return (dataclasses.replace(jget_arch(arch, smoke=True), **kw),
            dataclasses.replace(get_arch(arch, smoke=True), **kw))


def _batches(case: str, cfg, steps: int):
    B, Sq = CASES[case][2]
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=Sq, batch_size=B))
    return [pipe.global_batch(i) for i in range(steps)]


def _jrouting(fn):
    """(fn's result, the reference's routed counts per MoE layer call)."""
    recs = jmoe.start_routing_trace()
    try:
        out = fn()
        jax.effects_barrier()
    finally:
        jmoe.stop_routing_trace(recs)
    return out, [np.asarray(r["counts"]) for r in recs]


def _trouting(fn):
    recs = moe.start_routing_trace()
    try:
        out = fn()
    finally:
        moe.stop_routing_trace(recs)
    return out, [r["counts"].numpy() for r in recs], [r["capacity"]
                                                      for r in recs]


def _init_params(case: str) -> dict:
    """The port's params drawn from seed 0 (numpy leaves in the
    reference's layout, the inputs both packages start from)."""
    _, cfg = _configs(case)
    p = S.materialize(get_model(cfg).param_specs(cfg),
                      torch.Generator().manual_seed(0), device="cpu")
    return convert.to_reference(p)


@functools.lru_cache(maxsize=None)
def _reference_steps(case: str, steps: int = 2):
    """The reference's step-0 loss parts, gradients and routed counts,
    and its params, state and metrics after each of ``steps`` train steps
    from :func:`_init_params` and a zero AdamW state. One jitted function
    takes the gradients and applies them, as the reference's
    ``make_train_step`` does."""
    jcfg, _ = _configs(case)
    api = jget_model(jcfg)
    p = jax.tree.map(jnp.asarray, _init_params(case))
    zeros = jax.tree.map(jnp.zeros_like, p)
    opt = {"mu": zeros, "nu": zeros, "step": jnp.int32(0)}
    grad_fn = jax.value_and_grad(JT.make_loss_fn(api, jcfg), has_aux=True)

    @jax.jit
    def step(p, opt, b):
        (loss, parts), grads = grad_fn(p, b)
        p, opt, m = JO.apply_updates(p, grads, opt, JO.AdamWConfig(**OC))
        return p, opt, {"loss": loss, **parts, **m}, grads

    batches = _batches(case, jcfg, steps)
    after, grads0, counts = [], None, None
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if i == 0:  # the first step's routing, from the sinks
            (p, opt, m, grads0), counts = _jrouting(lambda: step(p, opt, jb))
        else:
            p, opt, m, _ = step(p, opt, jb)
        after.append((_np(p), _np(opt), {k: float(v) for k, v in m.items()}))
    return _np(grads0), counts, batches, after


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _port_grads(api, cfg, params, batch):
    loss_fn = T.make_loss_fn(api, cfg)
    leaves = S.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, parts = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    it = iter(grads)
    return ({"loss": float(loss.detach()),
             **{k: float(v.detach()) for k, v in parts.items()}},
            S.tree_map(lambda _: next(it), params))


def _assert_state_close(tp, topt, jp, jopt, lrs, loose, tag):
    """``lrs``: the learning rates of the steps taken so far. An element
    is held to 0.01 x lr where both packages' moments have agreed to
    ``MOMENT_REL`` after every step so far, else to one lr step a step
    taken (see the module note); ``loose`` (path -> mask) keeps the
    elements where they have not, and is updated."""
    ptree = _by_path(convert.to_reference(tp))
    rstate = convert.opt_to_reference(topt)
    mine = {part: _by_path(rstate[part]) for part in ("mu", "nu")}
    theirs = {part: _by_path(jopt[part]) for part in ("mu", "nu")}
    for path, a in _by_path(jp).items():
        err = np.abs(ptree[path] - a)
        for part in ("mu", "nu"):
            m, t = mine[part][path], theirs[part][path]
            loose[path] = loose.get(path, False) | (
                np.abs(m - t) > MOMENT_REL * np.abs(t))
        agree = ~loose[path]
        assert np.all(err[agree] <= 0.01 * max(lrs)), (tag, path,
                                                       err[agree].max())
        assert np.all(err <= sum(lrs)), (tag, path, err.max())
    for part in ("mu", "nu"):
        for path, t in theirs[part].items():
            err = np.abs(mine[part][path] - t).max()
            assert err <= F32_STATE_REL * np.abs(t).max(), (tag, part, path,
                                                            err)
    assert int(rstate["step"]) == int(jopt["step"])


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(case):
    jgrads, jcounts, batches, after = _reference_steps(case)
    jparts = after[0][2]
    _, cfg = _configs(case)
    api = get_model(cfg)
    params = convert.from_reference(_init_params(case), device="cpu")
    (parts, grads), counts, caps = _trouting(
        lambda: _port_grads(api, cfg, params, _tbatch(batches[0])))
    n_moe = sum(k == "moe" for k in convert.layer_kinds_of(params["blocks"]))
    if cfg.remat:  # each package recomputes each block in the backward
        for recs in (counts, jcounts):
            assert len(recs) == 2 * n_moe
            for c, again in zip(recs, reversed(recs[n_moe:])):
                assert np.array_equal(c, again)
        counts, jcounts = counts[:n_moe], jcounts[:n_moe]
    assert len(counts) == len(jcounts) == n_moe
    for i, (c, jc) in enumerate(zip(counts, jcounts)):
        assert np.array_equal(c, jc), f"routing flip in MoE layer {i}"
    if case == "mixtral-drop":  # tokens past capacity were dropped
        assert any((jc >= cap).any() for jc, cap in zip(jcounts, caps))
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(parts[k], jparts[k], rtol=F32_LOSS_REL,
                                   err_msg=k)
    assert (jparts["aux"] > 0) == (n_moe > 0)
    gtree = _by_path(convert.to_reference(grads))
    for path, g in _by_path(jgrads).items():
        assert _rel(gtree[path], g) <= F32_GRAD_REL, (path,
                                                      _rel(gtree[path], g))
    opt = S.materialize(O.state_specs(api.param_specs(cfg)), device="cpu")
    step = T.make_train_step(api, cfg, O.AdamWConfig(**OC))
    lrs, loose = [], {}
    for i, (b, (jp, jopt, jm)) in enumerate(zip(batches, after)):
        params, opt, m = step(params, opt, _tbatch(b))
        lrs.append(jm["lr"])
        assert set(m) == set(jm) == {"loss", "ce", "aux", "grad_norm", "lr"}
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(
                float(m[k]), jm[k], rtol=F32_LOSS_REL * (1 if i == 0 else 20),
                err_msg=(i, k))
        _assert_state_close(params, opt, jp, jopt, lrs, loose,
                            f"step {i + 1}")
        n_loose = sum(int(m.sum()) for m in loose.values())
        assert n_loose <= LOOSE_SHARE * sum(t.numel()
                                            for t in S.leaves(params))
        assert not any(t.requires_grad for t in S.leaves(params))


# ---------------------------------------------------------------------------
# moe_int8_dispatch outside the train step
# ---------------------------------------------------------------------------


def _dispatch_buffer(dtype) -> np.ndarray:
    """Rows of a dispatch buffer: Gaussian rows, capacity padding (zeros),
    a row under the 1e-8 amax floor, and a row whose codes fall on .5
    ties (amax 127 makes the scale exactly 1)."""
    rng = np.random.default_rng(40)
    buf = rng.normal(size=(24, 64)).astype(np.float32) * 3
    buf[5:9] = 0.0
    buf[9] = 1e-10 * rng.normal(size=64)
    buf[10] = np.round(rng.normal(size=64) * 20) + 0.5
    buf[10, 0] = 127.0
    return buf.astype(jnp.dtype(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_transport_is_bit_equal_and_straight_through(dtype):
    buf = _dispatch_buffer(dtype)
    want = np.asarray(jmoe._int8_transport(jnp.asarray(buf)))
    x = convert._to_tensor(buf, "cpu").requires_grad_()
    got = moe.Int8Transport.apply(x)
    assert got.dtype == x.dtype
    assert np.array_equal(convert._to_numpy(got.detach()),
                          want.astype(np.float32))
    assert (got[5:9] == 0).all()  # capacity padding stays zero
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(0)).to(
        x.dtype)
    (g,) = torch.autograd.grad((got * w).sum(), x)
    assert torch.equal(g, w)
    _, vjp = jax.vjp(jmoe._int8_transport, jnp.asarray(buf))
    assert np.array_equal(np.asarray(vjp(jnp.asarray(convert._to_numpy(w),
                                                     buf.dtype))[0]),
                          np.asarray(convert._to_numpy(w), buf.dtype))


def test_int8_dispatch_prefill_and_decode_match_reference(monkeypatch):
    """The smoke Mixtral with ``moe_int8_dispatch`` through the model API,
    f32: a 10-token prefill into a cache, then three decode steps at
    per-row positions. Each dispatch buffer the port rounds equals the
    reference's ``_int8_transport`` of the same buffer, bit for bit."""
    kw = dict(moe_int8_dispatch=True, dtype="float32",
              kv_cache_dtype="float32")
    jcfg = dataclasses.replace(jget_arch("mixtral-8x7b", smoke=True), **kw)
    cfg = dataclasses.replace(get_arch("mixtral-8x7b", smoke=True), **kw)
    japi, api = jget_model(jcfg), get_model(cfg)
    tp = S.materialize(api.param_specs(cfg), torch.Generator().manual_seed(1),
                       device="cpu")
    jp = jax.tree.map(jnp.asarray, convert.to_reference(tp))
    seen = []
    real = moe.Int8Transport.apply

    def spy(buf):
        out = real(buf)
        seen.append((buf.detach().clone(), out.detach().clone()))
        return out

    monkeypatch.setattr(moe.Int8Transport, "apply", spy)
    B, P, Smax = 2, 10, 32
    rng = np.random.default_rng(41)
    model = api.build(cfg, tp)
    jcache = JS.materialize(japi.cache_specs(jcfg, B, Smax),
                            jax.random.PRNGKey(1))
    cache = S.materialize(api.cache_specs(cfg, B, Smax), device="cpu")
    toks = rng.integers(0, cfg.vocab_size, (B, P))
    want, jcache, _ = japi.apply(jp, jcfg, jnp.asarray(toks), mode="prefill",
                                 cache=jcache, pos=0)
    with torch.no_grad():
        got, cache, _ = model(torch.from_numpy(toks), mode="prefill",
                              cache=cache, pos=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FP_TOL,
                               atol=FP_TOL)
    pos = np.array([P, P - 4])
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1))
        want, jcache, _ = japi.apply(jp, jcfg, jnp.asarray(nxt), mode="decode",
                                     cache=jcache, pos=jnp.asarray(pos))
        with torch.no_grad():
            got, cache, _ = model(torch.from_numpy(nxt), mode="decode",
                                  cache=cache, pos=torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FP_TOL, atol=FP_TOL)
        pos = pos + 1
    assert len(seen) == 4 * cfg.num_layers  # every mode rounds the buffer
    for buf, out in seen:
        ref = np.asarray(jmoe._int8_transport(jnp.asarray(buf.numpy())))
        assert np.array_equal(out.numpy(), ref)


# ---------------------------------------------------------------------------
# chunked attention's gradient (MLA's prefill)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first_chunk_only", [False, True])
def test_chunked_attention_gradient_matches_jax_vjp(first_chunk_only):
    """Sq = Sk = 20 over chunks of 8 (padded to 24; each query chunk's kv
    chunks past the diagonal fully masked), D = 12 != Dv = 8, 4 query
    heads over 2. ``first_chunk_only``: the output gradient is zero past
    the first query chunk, so keys 8.. are read by no query that carries
    gradient and their dK and dV must be exactly zero."""
    B, Sq, Hq, Hkv, D, Dv = 2, 20, 4, 2, 12, 8
    rng = np.random.default_rng(42)
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in (
        (B, Sq, Hq, D), (B, Sq, Hkv, D), (B, Sq, Hkv, Dv), (B, Sq, Hq, Dv)))
    if first_chunk_only:
        do[:, 8:] = 0.0
    _, vjp = jax.vjp(lambda *a: jattn.flash_attention(
        *a, causal=True, q_chunk=8, kv_chunk=8, softmax_scale=0.3),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = attention.chunked_attention(*leaves, q_chunk=8, kv_chunk=8,
                                      softmax_scale=0.3)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
    if first_chunk_only:
        for g in got[1:]:
            assert (g[:, 8:] == 0).all()
        assert (got[0][:, 8:] == 0).all()


# ---------------------------------------------------------------------------
# the layout: weight decay, the optimizer state, checkpoints
# ---------------------------------------------------------------------------

TREES = {"mixtral-8x7b": {}, "deepseek-v2-236b": dict(num_layers=9)}


def _tree(arch: str, **kw):
    cfg = dataclasses.replace(get_arch(arch, smoke=True), **TREES[arch], **kw)
    api = get_model(cfg)
    return cfg, api, S.materialize(api.param_specs(cfg),
                                   torch.Generator().manual_seed(0),
                                   device="cpu")


def _jspecs(arch: str, **kw):
    jcfg = dataclasses.replace(jget_arch(arch, smoke=True), **TREES[arch],
                               **kw)
    return jget_model(jcfg).param_specs(jcfg, None)


def _jdtypes(arch: str, **kw):
    """The reference's dtype of each leaf, in its layout."""
    return jax.tree.map(lambda s: s.dtype, _jspecs(arch, **kw),
                        is_leaf=JS.is_spec)


@pytest.mark.parametrize("arch", list(TREES))
def test_moe_trees_take_the_reference_layout(arch):
    """The reference's layout of each tree: Mixtral ``blocks/s0`` x 2;
    DeepSeek-V2 at 9 layers ``prefix/0`` (its dense layer, unstacked) and
    ``blocks/s0`` x 8, each router (R, d, E) and expert stack (R, E, K, N).
    ``decay_mask`` decays what has ndim >= 2 there: every router, expert
    stack and stacked norm gain, and not the prefix's norm gains."""
    cfg, _, tp = _tree(arch)
    kinds = convert.layer_kinds_of(tp["blocks"])
    ref = convert.to_reference(tp)
    E, d = cfg.num_experts, cfg.d_model
    if arch == "deepseek-v2-236b":
        assert convert.reference_split(kinds) == (["self"], ["moe"], 8)
        assert sorted(ref["prefix"]) == ["0"] and sorted(ref["blocks"]) == [
            "s0"]
        assert ref["prefix"]["0"]["ln1"]["g"].shape == (d,)
    else:
        assert convert.reference_split(kinds) == ([], ["moe"], 2)
        assert "prefix" not in ref
    R = cfg.num_layers - len(ref.get("prefix", {}))
    mlp = ref["blocks"]["s0"]["mlp"]
    assert mlp["router"].shape == (R, d, E)
    assert mlp["gate"]["w"].shape == (R, E, d, cfg.moe_d_ff)
    mask = O.decay_mask(tp)
    for i, (b, m) in enumerate(zip(tp["blocks"], mask["blocks"])):
        stacked = i >= len(ref.get("prefix", {}))
        assert m["ln1"]["g"] is m["ln2"]["g"] is stacked
        assert S.leaves(m) == [t.ndim + stacked >= 2 for t in S.leaves(b)]
        if "router" in b["mlp"]:
            assert m["mlp"]["router"] and m["mlp"]["gate"]["w"]
    assert mask["embed"] and not mask["final_norm"]["g"]
    want = jax.tree.map(lambda s: s.shape, _jspecs(arch), is_leaf=JS.is_spec)
    assert jax.tree.map(np.shape, ref) == want


@pytest.mark.parametrize("arch", list(TREES))
def test_weight_decay_on_moe_trees_follows_the_reference(arch):
    """Two AdamW steps at weight decay 1.0, no clip, from the same f32
    params, state and gradients in both layouts, the reference's jitted:
    every param within rtol 1e-6 (``test_weight_decay_follows_the_
    reference_layout``'s f32 bound; a norm gain decayed in one package
    and not the other would be lr = 1e-2 apart) and ``mu`` / ``nu`` within
    ``F32_STATE_REL`` of each leaf's largest value (XLA fuses the jitted
    moment updates, and a moment that cancels keeps few exact bits)."""
    _, _, tp = _tree(arch, dtype="float32")
    # copies: ``to_reference`` shares the f32 tensors' memory, and the
    # port's update writes them in place while the jitted one may run
    jp = jax.tree.map(lambda a, dt: jnp.array(a, dtype=dt, copy=True),
                      convert.to_reference(tp),
                      _jdtypes(arch, dtype="float32"))
    oc = dict(lr=1e-2, warmup_steps=1, total_steps=5, weight_decay=1.0,
              grad_clip=1e9)
    zeros = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), jp)
    jstate = {"mu": zeros, "nu": zeros, "step": jnp.int32(0)}
    tstate = convert.opt_from_reference(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    rng = np.random.default_rng(5)
    update = jax.jit(functools.partial(JO.apply_updates,
                                       cfg=JO.AdamWConfig(**oc)))
    for _ in range(2):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32).astype(a.dtype), jax.tree.map(np.asarray, jp))
        jp, jstate, _ = update(jp, jax.tree.map(jnp.asarray, g), jstate)
        tp, tstate, _ = O.apply_updates(
            tp, convert.from_reference(g, device="cpu"), tstate,
            O.AdamWConfig(**oc))
    ptree = _by_path(convert.to_reference(tp))
    for path, a in _by_path(_np(jp)).items():
        np.testing.assert_allclose(ptree[path], a, rtol=1e-6, atol=1e-8,
                                   err_msg=path)
    rstate = convert.opt_to_reference(tstate)
    for part in ("mu", "nu"):
        st = _by_path(rstate[part])
        for path, a in _by_path(_np(jstate[part])).items():
            err = np.abs(st[path] - a).max()
            assert err <= F32_STATE_REL * np.abs(a).max(), (part, path, err)


def _moved_state(arch):
    """A tree and an AdamW state after one port train step (``mu`` and
    ``nu`` nonzero), in the port's layout."""
    cfg, api, tp = _tree(arch)
    cfg = dataclasses.replace(cfg, remat=False)
    opt = S.materialize(O.state_specs(api.param_specs(cfg)), device="cpu")
    b = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=12,
                                     batch_size=2)).global_batch(0)
    tp, opt, _ = T.make_train_step(api, cfg, O.AdamWConfig(**OC))(
        tp, opt, _tbatch(b))
    return cfg, tp, opt


@pytest.mark.parametrize("arch", list(TREES))
def test_opt_state_of_moe_trees_converts_both_ways(arch):
    _, _, opt = _moved_state(arch)
    ref = convert.opt_to_reference(opt)
    assert ref["step"].dtype == np.int32 and int(ref["step"]) == 1
    back = convert.opt_from_reference(ref, device="cpu")
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 1
    for part in ("mu", "nu"):
        a, b = S.leaves(opt[part]), S.leaves(back[part])
        assert len(a) == len(b) and any(bool(t.any()) for t in a)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), part


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy())


def test_checkpoint_of_a_moe_tree_round_trips_between_packages(tmp_path):
    """DeepSeek-V2's 9-layer bf16 tree and its AdamW state after a step,
    in the reference's layout: the port writes it, the reference restores
    it into its own param and state specs, writes it again, and the port
    restores and converts it back, every leaf bit for bit."""
    arch = "deepseek-v2-236b"
    cfg, tp, opt = _moved_state(arch)
    jspecs = _jspecs(arch)
    dtypes = _jdtypes(arch)

    def ref_layout(tree, dts):  # reference layout, reference dtypes
        return jax.tree.map(lambda a, dt: torch.from_numpy(a).to(
            torch.bfloat16 if dt == jnp.bfloat16 else torch.float32),
            tree, dts)

    ropt = convert.opt_to_reference(opt)
    f32 = jax.tree.map(lambda _: jnp.float32, dtypes)
    tree = {"params": ref_layout(convert.to_reference(tp), dtypes),
            "opt": {"mu": ref_layout(ropt["mu"], f32),
                    "nu": ref_layout(ropt["nu"], f32),
                    "step": torch.tensor(1, dtype=torch.int32)}}
    CheckpointManager(str(tmp_path)).save(1, tree, meta={"step": 1})
    shapes = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jspecs,
                          is_leaf=JS.is_spec)
    tmpl = {"params": shapes,
            "opt": JS.materialize(JO.state_specs(jspecs),
                                  jax.random.PRNGKey(0))}
    jtree, meta = JManager(str(tmp_path)).restore(1, tmpl)
    assert meta == {"step": 1}
    flat_t, flat_j = _by_path(tree), _by_path(jtree)
    assert sorted(flat_t) == sorted(flat_j)
    for path, t in flat_t.items():
        a = np.asarray(flat_j[path])
        assert a.dtype == (jnp.bfloat16 if t.dtype == torch.bfloat16
                           else t.numpy().dtype), path
        assert np.array_equal(a.view(np.int16) if a.dtype == jnp.bfloat16
                              else a, _bits(t)), path
    JManager(str(tmp_path)).save(2, jtree, meta={"step": 2})
    back, _ = CheckpointManager(str(tmp_path)).restore(
        2, jax.tree.map(lambda _: None, jtree), device="cpu")
    as_np = jax.tree.map(lambda t: t.view(torch.int16).numpy().view(
        jnp.bfloat16) if t.dtype == torch.bfloat16 else t.numpy(), back)
    params = convert.from_reference(as_np["params"], device="cpu")
    assert back["opt"]["step"].shape == ()  # a scalar stays 0-d
    state = convert.opt_from_reference(as_np["opt"], device="cpu")
    got = _by_path(params)
    for path, a in _by_path(tp).items():
        assert a.dtype == got[path].dtype and torch.equal(a, got[path]), path
    for part in ("mu", "nu"):
        got = _by_path(state[part])
        for path, a in _by_path(opt[part]).items():
            assert torch.equal(a, got[path]), (part, path)
    assert int(state["step"]) == 1


@pytest.mark.parametrize("top_k", [2, 6])
def test_moe_gradients_repeat_bit_for_bit(top_k):
    """DeepSeek-V2's smoke layout (f32) at top-2 and top-6: two forwards
    and backwards on the same params and batch give the same loss and
    gradients bit for bit, with 4 threads (each token's k dispatch
    gradients are summed in one order, whatever the threads)."""
    cfg = dataclasses.replace(get_arch("deepseek-v2-236b", smoke=True),
                              dtype="float32", top_k=top_k, remat=False)
    api = get_model(cfg)
    params = S.materialize(api.param_specs(cfg),
                           torch.Generator().manual_seed(2), device="cpu")
    b = _tbatch(SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, batch_size=2)).global_batch(0))
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [_port_grads(api, cfg, params, b) for _ in range(2)]
    finally:
        torch.set_num_threads(n)
    (p0, g0), (p1, g1) = runs
    assert p0 == p1
    for a, c in zip(S.leaves(g0), S.leaves(g1)):
        assert torch.equal(a, c)
