"""Training the recurrent families in the port (``training/train_step.py``
over ``models/xlstm.py`` and ``models/griffin.py``, remat through
``torch.utils.checkpoint``; ``optimizer.decay_mask`` on a Griffin tree;
``convert``'s optimizer state and checkpoints on xLSTM and Griffin trees;
the flash backward's plain version at head dim 256) against the JAX
reference on the CPU, on the same seeded inputs.

Cases (smoke configs in f32, from the port's seed-0 params converted):
``rg`` (RecurrentGemma: 5 layers, the reference's prefix of 2 then one
(rec, rec, attn) pattern; window 16 over 40 tokens, so the window masks;
remat off), ``rg-remat`` (the port's remat on, against the same
reference run), ``xlstm-scan`` (4 layers, 3 mLSTM
stepped token by token, 1 sLSTM), ``xlstm-chunked`` (the mLSTM chunkwise,
chunks of 8) and ``rg-accum`` (``grad_accum=2``: the reference's scan
over microbatches).

Tolerances and why (``tests/test_torch_train.py``'s and
``tests/test_torch_train_moe.py``'s, unless stated):

* The loss, ce and grad norm at step 0: rtol 1e-5, 20 times that at step
  2 (computed from the params step 1 moved); ``mu`` / ``nu`` after 1 and
  2 steps within 1e-3 of each leaf's largest value, ``step`` equal.
* Every gradient leaf ``||dg|| / ||g|| <= 1e-5`` for RecurrentGemma
  (worst measured 1.9e-6, ``lru/wa``: the reference's
  ``associative_scan`` and the port's log-depth scan sum the RG-LRU in
  other orders). **xLSTM: 3e-5**, a looser bound: worst measured 9.7e-6
  under ``scan`` (the first mLSTM block's ``conv/b``, ``q/w``, ``k/w``)
  and 4.4e-6 under ``chunked``. The mLSTM divides by max(|n . q|,
  exp(-m)) at every step, and the stabilizer m follows a running max of
  the gates, so an f32 rounding of a sum taken in another order moves
  the q and k gradients further than a feed-forward layer's would.
* Params after 1 and 2 steps (AdamW divides each gradient element by its
  own magnitude): within 0.01 x lr where both packages' ``mu`` and
  ``nu`` have agreed to 1e-3 relative after every step so far, and within
  one lr step a step taken elsewhere, on at most 1 % of the elements
  for RecurrentGemma (0.19 % after one step, 0.51 % after two; worst
  0.12 x lr) and **at most 5 % for xLSTM** (0.44 % / 3.2 % under
  ``scan``, 0.42 % / 2.0 % under ``chunked``; worst 0.49 x lr): most
  of the elements whose moments part are in the mLSTM's q / k / up / v
  matrices, whose per-element gradients carry the relative error above
  (median 5e-5 on ``mu``), and step 2's gradients are taken at params
  step 1 moved apart.
* ``_lru_scan``, ``causal_conv`` and the chunked mLSTM's gradients against
  ``jax.vjp`` of the reference's functions on the same inputs and output
  gradients: ``||dg|| / ||g|| <= 1e-5`` per input (f32).
* ``flash_attention_bwd_plain`` at head dim 256 (MQA, window 16 over 40
  tokens; and non-causal over 24 keys) against ``jax.vjp`` of the
  reference's jnp ``flash_attention``: atol 1e-5 (f32).
* The Griffin and xLSTM trees: ``decay_mask`` equal to the reference's
  ``ndim >= 2`` in the reference's layout, on the smoke trees and on the
  full-depth spec trees; two AdamW steps at weight decay 1.0 against the
  reference's jitted update, params rtol 1e-6 (f32), ``mu`` / ``nu``
  within 1e-3 of each leaf's largest value; the optimizer state converted
  both ways and a checkpoint written by either package restored by the
  other, bit for bit.
* Remat on against remat off in the port: loss and gradients bit for bit
  (CPU), each block called twice.

    PYTHONPATH=src python -m pytest tests/test_torch_train_recurrent.py -q
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
from repro.models import griffin as jgriffin
from repro.models import xlstm as jxlstm
from repro.models.registry import get_arch as jget_arch
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro.training import optimizer as JO
from repro.training import train_step as JT
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import griffin, xlstm
from repro_torch.models.registry import get_arch, get_model
from repro_torch.nn import spec as S
from repro_torch.training import optimizer as O
from repro_torch.training import train_step as T

OC = dict(lr=1e-3, warmup_steps=2, total_steps=6)
F32_LOSS_REL, F32_GRAD_REL, F32_STATE_REL = 1e-5, 1e-5, 1e-3
# by family (see the module note): a gradient leaf's relative bound; an
# element's moments agree within MOMENT_REL, and at most LOOSE_SHARE of
# the elements may not
GRAD_REL = {"hybrid": F32_GRAD_REL, "ssm": 3e-5}
MOMENT_REL, LOOSE_SHARE = 1e-3, {"hybrid": 0.01, "ssm": 0.05}

CASES = {  # name -> (arch, config fields, (batch, seq), grad_accum)
    "rg": ("recurrentgemma-9b", dict(remat=False), (2, 40), 1),
    "rg-remat": ("recurrentgemma-9b", dict(remat=True), (2, 40), 1),
    "xlstm-scan": ("xlstm-1.3b", dict(remat=False), (2, 40), 1),
    "xlstm-chunked": ("xlstm-1.3b", dict(remat=False, mlstm_impl="chunked",
                                         chunk_size=8), (2, 40), 1),
    "rg-accum": ("recurrentgemma-9b", dict(remat=False), (4, 40), 2),
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
    arch, kw, _, _ = CASES[case]
    kw = dict(dtype="float32", **kw)
    return (dataclasses.replace(jget_arch(arch, smoke=True), **kw),
            dataclasses.replace(get_arch(arch, smoke=True), **kw))


def _batches(case: str, cfg, steps: int):
    B, Sq = CASES[case][2]
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=Sq, batch_size=B))
    return [pipe.global_batch(i) for i in range(steps)]


def _init_params(case: str) -> dict:
    """The port's params drawn from seed 0 (numpy leaves in the
    reference's layout, the inputs both packages start from)."""
    _, cfg = _configs(case)
    p = S.materialize(get_model(cfg).param_specs(cfg),
                      torch.Generator().manual_seed(0), device="cpu")
    return convert.to_reference(p, cfg)


def _reference_steps(case: str):
    """The reference's run for ``case``; ``rg-remat`` reads ``rg``'s (the
    reference's remat, ``jax.checkpoint``, recomputes the same values:
    one compile less)."""
    return _reference_run("rg" if case == "rg-remat" else case)


@functools.lru_cache(maxsize=None)
def _reference_run(case: str, steps: int = 2):
    """The reference's step-0 gradients (None under ``grad_accum``) and
    its params, state and metrics after each of ``steps`` train steps
    from :func:`_init_params` and a zero AdamW state. With one
    microbatch, one jitted function takes the gradients and applies them,
    as the reference's ``make_train_step`` does; with two, its jitted
    ``make_train_step`` (the scan over microbatches)."""
    jcfg, _ = _configs(case)
    ga = CASES[case][3]
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

    accum = jax.jit(JT.make_train_step(api, jcfg, JO.AdamWConfig(**OC),
                                       grad_accum=ga))
    batches = _batches(case, jcfg, steps)
    after, grads0 = [], None
    for i, b in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if ga > 1:
            p, opt, m = accum(p, opt, jb)
        else:
            p, opt, m, g = step(p, opt, jb)
            grads0 = g if i == 0 else grads0
        after.append((_np(p), _np(opt), {k: float(v) for k, v in m.items()}))
    return None if grads0 is None else _np(grads0), batches, after


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


def _assert_state_close(cfg, tp, topt, jp, jopt, lrs, loose, tag):
    """``lrs``: the learning rates of the steps taken so far. An element
    is held to 0.01 x lr where both packages' moments have agreed to
    ``MOMENT_REL`` after every step so far, else to one lr step a step
    taken (see the module note); ``loose`` (path -> mask) keeps the
    elements where they have not, and is updated."""
    ptree = _by_path(convert.to_reference(tp, cfg))
    rstate = convert.opt_to_reference(topt, cfg)
    mine = {part: _by_path(rstate[part]) for part in ("mu", "nu")}
    theirs = {part: _by_path(jopt[part]) for part in ("mu", "nu")}
    worst = 0.0
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
        worst = max(worst, float(err.max()) / max(lrs))
    for part in ("mu", "nu"):
        for path, t in theirs[part].items():
            err = np.abs(mine[part][path] - t).max()
            assert err <= F32_STATE_REL * np.abs(t).max(), (tag, part, path,
                                                            err)
    assert int(rstate["step"]) == int(jopt["step"])
    return worst


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(case):
    jgrads, batches, after = _reference_steps(case)
    _, cfg = _configs(case)
    api = get_model(cfg)
    params = convert.from_reference(_init_params(case), device="cpu")
    if jgrads is not None:
        parts, grads = _port_grads(api, cfg, params, _tbatch(batches[0]))
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(parts[k], after[0][2][k],
                                       rtol=F32_LOSS_REL, err_msg=k)
        gtree = _by_path(convert.to_reference(grads, cfg))
        for path, g in _by_path(jgrads).items():
            assert _rel(gtree[path], g) <= GRAD_REL[cfg.family], (
                path, _rel(gtree[path], g))
    opt = S.materialize(O.state_specs(api.param_specs(cfg)), device="cpu")
    step = T.make_train_step(api, cfg, O.AdamWConfig(**OC),
                             grad_accum=CASES[case][3])
    lrs, loose = [], {}
    for i, (b, (jp, jopt, jm)) in enumerate(zip(batches, after)):
        params, opt, m = step(params, opt, _tbatch(b))
        lrs.append(jm["lr"])
        assert set(m) == set(jm) == {"loss", "ce", "aux", "grad_norm", "lr"}
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(
                float(m[k]), jm[k], rtol=F32_LOSS_REL * (1 if i == 0 else 20),
                err_msg=(i, k))
        _assert_state_close(cfg, params, opt, jp, jopt, lrs, loose,
                            f"step {i + 1}")
        n_loose = sum(int(m.sum()) for m in loose.values())
        assert n_loose <= LOOSE_SHARE[cfg.family] * sum(
            t.numel() for t in S.leaves(params))
        assert not any(t.requires_grad for t in S.leaves(params))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_remat_recomputes_each_block_and_changes_no_bit(arch):
    """Remat on and off on the same f32 params and batch: the same loss and
    gradients bit for bit, each block called once without remat and twice
    with it (forward, then the recompute in the backward)."""
    cfg0 = dataclasses.replace(get_arch(arch, smoke=True), dtype="float32")
    params = S.materialize(get_model(cfg0).param_specs(cfg0),
                           torch.Generator().manual_seed(3), device="cpu")
    b = _tbatch(SyntheticPipeline(DataConfig(
        vocab_size=cfg0.vocab_size, seq_len=24, batch_size=2)).global_batch(0))
    leaves = S.leaves(params)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(cfg0, remat=remat)
        model = get_model(cfg).build(cfg, params)
        calls = []
        hooks = [blk.register_forward_pre_hook(lambda *_: calls.append(1))
                 for blk in model.blocks]
        for t in leaves:
            t.requires_grad_(True)
        try:
            logits, _, aux = model(b["tokens"], mode="train")
            loss = T.cross_entropy(logits, b["labels"]) + aux
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
            for h in hooks:
                h.remove()
        out[remat] = (loss.detach(), grads, len(calls))
    assert out[False][2] == cfg0.num_layers
    assert out[True][2] == 2 * cfg0.num_layers
    assert torch.equal(out[False][0], out[True][0])
    for a, c in zip(out[False][1], out[True][1]):
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# the recurrences' gradients against jax.vjp
# ---------------------------------------------------------------------------


def _vjp_inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _check_vjp(jfn, tfn, inputs, out_grads):
    """``jax.vjp`` of ``jfn`` against torch autograd through ``tfn`` on the
    same inputs and output gradients (tuples of numpy arrays)."""
    want = jax.jit(lambda xs, gs: jax.vjp(jfn, *xs)[1](gs))(
        tuple(map(jnp.asarray, inputs)), tuple(map(jnp.asarray, out_grads)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    outs = tfn(*leaves)
    got = torch.autograd.grad(outs, leaves, [torch.from_numpy(g)
                                             for g in out_grads])
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.isfinite(g).all()
        assert _rel(g.numpy(), np.asarray(w)) <= F32_GRAD_REL, (
            i, _rel(g.numpy(), np.asarray(w)))


def test_lru_scan_gradient_matches_associative_scan():
    """RG-LRU's linear recurrence over 37 steps (no power of two) from a
    nonzero state: the port's log-depth scan against the reference's
    ``associative_scan``."""
    B, Sq, d = 2, 37, 24
    a, b, h0, gh = _vjp_inputs(50, (B, Sq, d), (B, Sq, d), (B, d),
                               (B, Sq, d))
    a = 1.0 / (1.0 + np.exp(-a))  # decays in (0, 1)
    _check_vjp(lambda a_, b_, h_: (jgriffin._lru_scan(a_, b_, h_),),
               lambda a_, b_, h_: (griffin._lru_scan(a_, b_, h_),),
               [a, b, h0], [gh])


def test_causal_conv_gradient_matches_reference():
    B, Sq, d, width = 2, 19, 16, 4
    x, w, bias, st, gy, gs = _vjp_inputs(51, (B, Sq, d), (width, d), (d,),
                                         (B, width - 1, d), (B, Sq, d),
                                         (B, width - 1, d))
    _check_vjp(
        lambda x_, w_, b_, s_: jxlstm.causal_conv({"w": w_, "b": b_}, x_,
                                                  state=s_),
        lambda x_, w_, b_, s_: xlstm.causal_conv({"w": w_, "b": b_}, x_,
                                                 state=s_),
        [x, w, bias, st], [gy, gs])


def test_chunked_mlstm_gradient_matches_reference():
    """The chunkwise mLSTM over 3 chunks of 8 from a nonzero state: every
    input's gradient (q, k, v, the gates and the carried state)."""
    B, Sq, H, dh = 2, 24, 2, 8
    q, k, v, i_raw, f_raw, C0, n0, m0 = _vjp_inputs(
        52, (B, Sq, H, dh), (B, Sq, H, dh), (B, Sq, H, dh), (B, Sq, H),
        (B, Sq, H), (B, H, dh, dh), (B, H, dh), (B, H))
    gh, gC, gn, gm = _vjp_inputs(53, (B, Sq, H, dh), (B, H, dh, dh),
                                 (B, H, dh), (B, H))

    def flat(fn):
        def f(*a):
            h, (C, n, m) = fn(*a, 8)
            return h, C, n, m
        return f

    _check_vjp(flat(jxlstm._mlstm_chunked), flat(xlstm._mlstm_chunked),
               [q, k, v, i_raw, f_raw, C0, n0, m0], [gh, gC, gn, gm])


def _jscan_mlstm(q, k, v, i_raw, f_raw, C0, n0, m0):
    """The reference's per-token mLSTM (``_mlstm_cell`` under
    ``lax.scan``): h, C, n, m."""
    xs = tuple(jnp.moveaxis(t, 1, 0) for t in (q, k, v, i_raw, f_raw))
    (C, n, m), hs = jax.lax.scan(jxlstm._mlstm_cell, (C0, n0, m0), xs)
    return jnp.moveaxis(hs, 0, 1), C, n, m


def test_chunked_mlstm_gradient_is_finite_where_masked_entries_overflow():
    """One chunk of 48 tokens under strong forget gates (log sigmoid about
    -4 a step): a masked (future) entry's decay exponent F_t - F_s + li_s
    - m_t reaches about 190, past f32's exp. The reference's chunked form
    takes exp of every entry and masks after, so its gradient is NaN
    there; the port masks the exponent first. Its gradient is finite and
    equals ``jax.vjp`` of the reference's per-token scan (the exact
    recurrence) within ``||dg|| / ||g|| <= 1e-4`` per input (another
    algorithm: the exponentials of other sums)."""
    B, Sq, H, dh = 1, 48, 2, 4
    q, k, v, i_raw, f_raw, C0, n0, m0 = _vjp_inputs(
        55, (B, Sq, H, dh), (B, Sq, H, dh), (B, Sq, H, dh), (B, Sq, H),
        (B, Sq, H), (B, H, dh, dh), (B, H, dh), (B, H))
    f_raw = f_raw - 4.0
    outs = _vjp_inputs(56, (B, Sq, H, dh), (B, H, dh, dh), (B, H, dh), (B, H))
    inputs = [q, k, v, i_raw, f_raw, C0, n0, m0]
    jfn = jax.jit(lambda xs, gs: jax.vjp(_jscan_mlstm, *xs)[1](gs))
    want = jfn(tuple(map(jnp.asarray, inputs)), tuple(map(jnp.asarray, outs)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    h, (C, n, m) = xlstm._mlstm_chunked(*leaves, Sq)
    got = torch.autograd.grad((h, C, n, m), leaves,
                              [torch.from_numpy(g) for g in outs])
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.isfinite(g).all(), i
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-4, (
            i, _rel(g.numpy(), np.asarray(w)))


# ---------------------------------------------------------------------------
# the flash backward at head dim 256
# ---------------------------------------------------------------------------

BWD_256 = {  # (B, Sq, Sk, Hq, Hkv, causal, window): heads of 256
    "mqa-window": (1, 40, 40, 4, 1, True, 16),
    "non-causal": (2, 12, 24, 4, 2, False, None),
}


@pytest.mark.parametrize("case", list(BWD_256))
def test_flash_bwd_plain_at_head_dim_256_matches_jax_vjp(case):
    """``flash_attention_bwd_plain`` at RecurrentGemma's head dim: MQA with
    a window that masks (40 tokens over a window of 16), and non-causal
    with Sq != Sk, f32, against ``jax.vjp`` of the reference's jnp
    attention (chunks of 8) and against torch autograd through the plain
    forward, atol 1e-5."""
    B, Sq, Sk, Hq, Hkv, causal, window = BWD_256[case]
    q, k, v, do = _vjp_inputs(54, (B, Sq, Hq, 256), (B, Sk, Hkv, 256),
                              (B, Sk, Hkv, 256), (B, Sq, Hq, 256))
    want = [np.asarray(g) for g in jax.jit(lambda xs, g: jax.vjp(
        lambda q_, k_, v_: jattn.flash_attention(
            q_, k_, v_, causal=causal, window=window, q_chunk=8, kv_chunk=8),
        *xs)[1](g))(tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(do))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = FA.flash_attention_fwd(tq, tk, tv, causal=causal,
                                      window=window)
    got = FA.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                       causal=causal, window=window)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    ref = torch.autograd.grad(FA.flash_attention_plain(
        *leaves, causal=causal, window=window), leaves, tdo)
    for g, w, r in zip(got, want, ref):
        assert g.shape == r.shape and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the layout: weight decay, the optimizer state, checkpoints
# ---------------------------------------------------------------------------

ARCHS = ("recurrentgemma-9b", "xlstm-1.3b")


def _tree(arch: str, **kw):
    cfg = dataclasses.replace(get_arch(arch, smoke=True), **kw)
    api = get_model(cfg)
    return cfg, api, S.materialize(api.param_specs(cfg),
                                   torch.Generator().manual_seed(0),
                                   device="cpu")


def _jspecs(arch: str, smoke=True, **kw):
    jcfg = dataclasses.replace(jget_arch(arch, smoke=smoke), **kw)
    return jget_model(jcfg).param_specs(jcfg, None)


def _jdtypes(arch: str, **kw):
    """The reference's dtype of each leaf, in its layout."""
    return jax.tree.map(lambda s: s.dtype, _jspecs(arch, **kw),
                        is_leaf=JS.is_spec)


def _as_reference_paths(tree: dict, cfg) -> dict:
    """{path in the reference's layout: leaf} of a port tree: port layer i
    is ``prefix/<i>`` in the prefix, else ``blocks/s<j>`` (one path for
    all its repeats: the leaves that share it are listed)."""
    n, pattern, _ = convert.reference_split(
        convert.layer_kinds_of(tree["blocks"]), cfg)
    n, P = len(n), len(pattern)
    out: dict = {}
    for k, v in tree.items():
        if k != "blocks":
            for path, leaf in _by_path(v, k).items():
                out.setdefault(path, []).append(leaf)
    for i, blk in enumerate(tree["blocks"]):
        base = f"prefix/{i}" if i < n else f"blocks/s{(i - n) % P}"
        for path, leaf in _by_path(blk, base).items():
            out.setdefault(path, []).append(leaf)
    return out


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_follows_the_reference_layout(arch, smoke):
    """``decay_mask`` decays what has ndim >= 2 in the reference's layout:
    on a Griffin tree the first ``num_layers % 3`` layers are the unstacked
    prefix (their norm gains and biases do not decay) and the whole
    patterns after them are stacked (theirs do); xLSTM stacks every layer.
    The smoke trees and the full-depth spec trees (38 and 48 layers, as
    meta tensors)."""
    cfg = get_arch(arch, smoke=smoke)
    specs = get_model(cfg).param_specs(cfg)
    tree = S.tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                            device="meta"), specs)
    got = _as_reference_paths(O.decay_mask(tree, cfg), cfg)
    want = {path: len(s.shape) >= 2 for path, s in _by_path(
        _jspecs(arch, smoke=smoke), "").items()}
    want = {p.lstrip("/"): v for p, v in want.items()}
    assert sorted(got) == sorted(want)
    for path, masks in got.items():
        assert all(m is want[path] for m in masks), (path, masks,
                                                     want[path])
    if arch == "recurrentgemma-9b":  # the prefix's gains stay undecayed
        assert not got["prefix/0/mlp/ln/g"][0]
        assert all(got["blocks/s0/mlp/ln/g"])


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_decay_on_recurrent_trees_follows_the_reference(arch):
    """Two AdamW steps at weight decay 1.0, no clip, from the same f32
    params, state and gradients in both layouts, the reference's jitted:
    every param within rtol 1e-6 (a gain decayed in one package and not
    the other would be lr = 1e-2 apart) and ``mu`` / ``nu`` within
    ``F32_STATE_REL`` of each leaf's largest value."""
    cfg, _, tp = _tree(arch, dtype="float32")
    # copies: ``to_reference`` shares the f32 tensors' memory, and the
    # port's update writes them in place while the jitted one may run
    jp = jax.tree.map(lambda a, dt: jnp.array(a, dtype=dt, copy=True),
                      convert.to_reference(tp, cfg),
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
            O.AdamWConfig(**oc), model_cfg=cfg)
    ptree = _by_path(convert.to_reference(tp, cfg))
    for path, a in _by_path(_np(jp)).items():
        np.testing.assert_allclose(ptree[path], a, rtol=1e-6, atol=1e-8,
                                   err_msg=path)
    rstate = convert.opt_to_reference(tstate, cfg)
    for part in ("mu", "nu"):
        st = _by_path(rstate[part])
        for path, a in _by_path(_np(jstate[part])).items():
            err = np.abs(st[path] - a).max()
            assert err <= F32_STATE_REL * np.abs(a).max(), (part, path, err)


def _moved_state(arch):
    """A bf16 tree and an AdamW state after one port train step (``mu``
    and ``nu`` nonzero), in the port's layout."""
    cfg, api, tp = _tree(arch, remat=False)
    opt = S.materialize(O.state_specs(api.param_specs(cfg)), device="cpu")
    b = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=12,
                                     batch_size=2)).global_batch(0)
    tp, opt, _ = T.make_train_step(api, cfg, O.AdamWConfig(**OC))(
        tp, opt, _tbatch(b))
    return cfg, tp, opt


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_of_recurrent_trees_converts_both_ways(arch):
    cfg, _, opt = _moved_state(arch)
    ref = convert.opt_to_reference(opt, cfg)
    assert ref["step"].dtype == np.int32 and int(ref["step"]) == 1
    want = jax.tree.map(lambda s: s.shape, _jspecs(arch), is_leaf=JS.is_spec)
    for part in ("mu", "nu"):
        assert jax.tree.map(np.shape, ref[part]) == want
    back = convert.opt_from_reference(ref, device="cpu")
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 1
    for part in ("mu", "nu"):
        a, b = S.leaves(opt[part]), S.leaves(back[part])
        assert len(a) == len(b) and any(bool(t.any()) for t in a)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), part


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_of_a_recurrent_tree_round_trips_between_packages(
        arch, tmp_path):
    """The bf16 tree and its AdamW state after a step, in the reference's
    layout: the port writes it, the reference restores it into its own
    param and state specs, writes it again, and the port restores and
    converts it back, every leaf bit for bit."""
    cfg, tp, opt = _moved_state(arch)
    jspecs = _jspecs(arch)
    dtypes = _jdtypes(arch)

    def ref_layout(tree, dts):  # reference layout, reference dtypes
        return jax.tree.map(lambda a, dt: torch.from_numpy(a).to(
            torch.bfloat16 if dt == jnp.bfloat16 else torch.float32),
            tree, dts)

    ropt = convert.opt_to_reference(opt, cfg)
    f32 = jax.tree.map(lambda _: jnp.float32, dtypes)
    tree = {"params": ref_layout(convert.to_reference(tp, cfg), dtypes),
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
    state = convert.opt_from_reference(as_np["opt"], device="cpu")
    got = _by_path(params)
    for path, a in _by_path(tp).items():
        assert a.dtype == got[path].dtype and torch.equal(a, got[path]), path
    for part in ("mu", "nu"):
        got = _by_path(state[part])
        for path, a in _by_path(opt[part]).items():
            assert torch.equal(a, got[path]), (part, path)
    assert int(state["step"]) == 1
