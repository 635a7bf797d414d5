"""Training the cross-attention families in the port
(``training/train_step.py`` over ``models/transformer.py``'s gated cross
layers and ``models/encdec.py``, each taking its memory from the batch:
``image_embeds`` or ``frames``; remat through ``torch.utils.checkpoint``;
``optimizer.decay_mask`` on both trees; ``convert``'s optimizer state and
checkpoints; the flash backward's plain version at non-causal Sq != Sk)
against the JAX reference on the CPU, on the same seeded inputs.

Cases (smoke configs in f32, from the port's seed-0 params converted, the
memory drawn from a seed with numpy): ``vlm`` (Llama-3.2-Vision: 5
layers, 4 self then one gated cross layer over 16 image tokens; the
gates drawn uniform in [0.5, 1.5], since at the reference's init of 0
the cross layer's other weights get zero gradient and any parity test
passes without testing them; remat off), ``vlm-remat`` (the port's remat
on, against the same reference run: the reference's ``jax.checkpoint``
recomputes the same values), ``whisper`` (2 encoder and 2 decoder
layers over 24 frames, remat off), ``whisper-remat`` (the port's decoder
blocks rematted) and ``vlm-accum`` / ``whisper-accum``
(``grad_accum=2``: the reference's scan over microbatches, the memory
split with the tokens).

Tolerances and why (``tests/test_torch_train.py``'s):

* The loss, ce and grad norm at step 0: rtol 1e-5, 20 times that at step
  2 (computed from the params step 1 moved); ``mu`` / ``nu`` after 1 and
  2 steps within 1e-3 of each leaf's largest value, ``step`` equal.
* Every gradient leaf ``||dg|| / ||g|| <= 1e-5``, the VLM's 0-d gates
  included (f32 sums in other orders); every leaf of the cross layer has
  a nonzero gradient.
* Params after 1 and 2 steps (AdamW divides each gradient element by its
  own magnitude, so an element near eps turns a last-bit gradient
  difference into a fraction of one lr step): within 0.01 x lr where both
  packages' ``mu`` and ``nu`` have agreed to 1e-3 relative after every
  step so far, and within one lr step a step taken elsewhere, on at most
  1 % of the elements (``tests/test_torch_train_moe.py``'s bound).
  Measured: the VLM 0.15 % after one step, 0.34 % after two (0.44 %
  under ``grad_accum``), spread over its MLP matrices; Whisper 0.43 % /
  0.63 %, nearly all in ``dec/embed``, the tied embedding, whose
  gradient for a token that is not in the batch is a sum over every
  position of its small softmax share times a LayerNorm output, terms
  that cancel, so f32 sums in another order part its low bits.
* ``flash_attention_bwd_plain`` non-causal at Sq != Sk, lengths that are
  no multiple of the kernel's 64-row tiles, G = 8 and G = 1, against
  ``jax.vjp`` of the reference's jnp ``flash_attention`` (chunks of 8)
  and torch autograd through the plain forward: atol 1e-5 (f32).
* Both trees: ``decay_mask`` equal to the reference's ``ndim >= 2`` in
  the reference's layout (the VLM's 0-d gates stack to (R,) there and do
  not decay; Whisper's ``enc`` and ``dec`` stacks), on the smoke trees and
  on the full-depth spec trees (meta tensors); two AdamW steps at weight
  decay 1.0 against the reference's jitted update, params rtol 1e-6, ``mu``
  / ``nu`` within 1e-3 of each leaf's largest value; the optimizer state
  converted both ways and a checkpoint written by either package restored
  by the other, bit for bit.
* Remat on against remat off in the port: loss and gradients bit for bit
  (CPU), each (decoder) block called twice.

    PYTHONPATH=src python -m pytest tests/test_torch_train_xattn.py -q
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
from repro.models.registry import get_arch as jget_arch
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro.training import optimizer as JO
from repro.training import train_step as JT
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import shapes
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.kernels import flash_attention as FA
from repro_torch.models.registry import get_arch, get_model
from repro_torch.nn import spec as S
from repro_torch.training import optimizer as O
from repro_torch.training import train_step as T

OC = dict(lr=1e-3, warmup_steps=2, total_steps=6)
F32_LOSS_REL, F32_GRAD_REL, F32_STATE_REL = 1e-5, 1e-5, 1e-3
# an element's moments agree within MOMENT_REL, and at most LOOSE_SHARE of
# the elements may not (tests/test_torch_train_moe.py's bound; see below)
MOMENT_REL, LOOSE_SHARE = 1e-3, 0.01
GATE_SEED, MEMORY_SEED = 17, 23

CASES = {  # name -> (arch, config fields, (batch, seq), grad_accum)
    "vlm": ("llama-3.2-vision-90b", dict(remat=False), (2, 24), 1),
    "vlm-remat": ("llama-3.2-vision-90b", dict(remat=True), (2, 24), 1),
    "whisper": ("whisper-tiny", dict(remat=False), (2, 24), 1),
    "whisper-remat": ("whisper-tiny", dict(remat=True), (2, 24), 1),
    "vlm-accum": ("llama-3.2-vision-90b", dict(remat=False), (4, 24), 2),
    "whisper-accum": ("whisper-tiny", dict(remat=False), (4, 24), 2),
}
ARCHS = ("llama-3.2-vision-90b", "whisper-tiny")


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


def _with_memory(cfg, b: dict, seed: int) -> dict:
    """A pipeline batch with the family's memory (``image_embeds`` or
    ``frames``, the shape ``configs.shapes.input_specs`` gives) drawn
    from ``seed`` in the activation dtype."""
    B, Sq = b["tokens"].shape
    spec = shapes.input_specs(cfg, shapes.Shape("x", "train", Sq, B))
    key = {"vlm": "image_embeds", "audio": "frames"}[cfg.family]
    mem = np.random.default_rng(seed).normal(size=spec[key].shape)
    return dict(b, **{key: mem.astype(np.float32)})


def _batches(case: str, cfg, steps: int):
    B, Sq = CASES[case][2]
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=Sq, batch_size=B))
    return [_with_memory(cfg, pipe.global_batch(i), MEMORY_SEED + i)
            for i in range(steps)]


def _set_gates(params: dict, seed: int = GATE_SEED) -> list[float]:
    """Every cross layer's gate_attn and gate_mlp drawn uniform in [0.5,
    1.5] (0-d f32), in place in a port tree."""
    rng = np.random.default_rng(seed)
    drawn = []
    for blk in params.get("blocks", []):
        if "gate_attn" in blk:
            for g in ("gate_attn", "gate_mlp"):
                drawn.append(float(rng.uniform(0.5, 1.5)))
                blk[g] = torch.tensor(drawn[-1], dtype=torch.float32)
    return drawn


def _port_params(cfg, seed: int = 0) -> dict:
    p = S.materialize(get_model(cfg).param_specs(cfg),
                      torch.Generator().manual_seed(seed), device="cpu")
    _set_gates(p)
    return p


def _init_params(case: str) -> dict:
    """The port's params drawn from seed 0, the VLM's gates nonzero (numpy
    leaves in the reference's layout, the inputs both packages start
    from)."""
    _, cfg = _configs(case)
    return convert.to_reference(_port_params(cfg), cfg)


def _reference_steps(case: str):
    """The reference's run for ``case``; a ``-remat`` case reads the run
    without it (one compile less)."""
    return _reference_run(case.removesuffix("-remat"))


@functools.lru_cache(maxsize=None)
def _reference_run(case: str, steps: int = 2):
    """The reference's step-0 gradients (None under ``grad_accum``) and
    its params, state and metrics after each of ``steps`` train steps
    from :func:`_init_params` and a zero AdamW state. With one
    microbatch, one jitted function takes the gradients and applies them,
    as the reference's ``make_train_step`` does; with two, its jitted
    ``make_train_step`` (the scan over microbatches)."""
    jcfg, cfg = _configs(case)
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
    batches = _batches(case, cfg, steps)
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
            assert _rel(gtree[path], g) <= F32_GRAD_REL, (
                path, _rel(gtree[path], g))
        if cfg.family == "vlm":  # the cross layer is live: gates and all
            cross = _by_path(grads["blocks"][4], "blocks/4")
            assert "blocks/4/gate_attn" in cross
            for path, g in cross.items():
                assert float(g.abs().max()) > 0, path
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
        assert n_loose <= LOOSE_SHARE * sum(t.numel()
                                            for t in S.leaves(params))
        assert not any(t.requires_grad for t in S.leaves(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_each_block_and_changes_no_bit(arch):
    """Remat on and off on the same f32 params (gates nonzero), batch and
    memory: the same loss and gradients bit for bit, each (decoder) block
    called once without remat and twice with it (forward, then the
    recompute in the backward). Whisper's encoder blocks run once either
    way, as the reference's."""
    cfg0 = dataclasses.replace(get_arch(arch, smoke=True), dtype="float32")
    params = _port_params(cfg0, seed=3)
    b = _tbatch(_with_memory(cfg0, SyntheticPipeline(DataConfig(
        vocab_size=cfg0.vocab_size, seq_len=20, batch_size=2)).global_batch(0),
        5))
    mem = b.get("image_embeds", b.get("frames"))
    leaves = S.leaves(params)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(cfg0, remat=remat)
        model = get_model(cfg).build(cfg, params)
        calls, enc_calls = [], []
        hooks = [blk.register_forward_pre_hook(lambda *_: calls.append(1))
                 for blk in model.blocks]
        hooks += [blk.register_forward_pre_hook(
            lambda *_: enc_calls.append(1))
            for blk in getattr(model, "enc_blocks", [])]
        for t in leaves:
            t.requires_grad_(True)
        try:
            logits, _, aux = model(b["tokens"], mode="train", memory=mem)
            loss = T.cross_entropy(logits, b["labels"]) + aux
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
            for h in hooks:
                h.remove()
        out[remat] = (loss.detach(), grads, len(calls), len(enc_calls))
    assert out[False][2] == cfg0.num_layers
    assert out[True][2] == 2 * cfg0.num_layers
    assert out[False][3] == out[True][3] == (cfg0.num_encoder_layers or 0)
    assert torch.equal(out[False][0], out[True][0])
    for a, c in zip(out[False][1], out[True][1]):
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# the flash backward at the cross shapes
# ---------------------------------------------------------------------------

BWD_CROSS = {  # (B, Sq, Sk, Hq, Hkv, D): non-causal, Sq != Sk
    "gqa-8": (2, 45, 150, 8, 1, 64),     # G = 8, as the VLM's 64 over 8
    "whisper": (1, 37, 100, 6, 6, 64),   # G = 1, Whisper's heads
    "vlm-heads": (1, 19, 70, 16, 2, 128),
}


@pytest.mark.parametrize("case", list(BWD_CROSS))
def test_flash_bwd_plain_at_cross_shapes_matches_jax_vjp(case):
    """``flash_attention_bwd_plain`` non-causal over a memory longer than
    the queries, neither length a multiple of the kernel's tiles, f32,
    against ``jax.vjp`` of the reference's jnp attention (chunks of 8) and
    against torch autograd through the plain forward, atol 1e-5."""
    B, Sq, Sk, Hq, Hkv, D = BWD_CROSS[case]
    rng = np.random.default_rng(60)
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in (
        (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D), (B, Sq, Hq, D)))
    want = [np.asarray(g) for g in jax.jit(lambda xs, g: jax.vjp(
        lambda q_, k_, v_: jattn.flash_attention(
            q_, k_, v_, causal=False, q_chunk=8, kv_chunk=8),
        *xs)[1](g))(tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(do))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = FA.flash_attention_fwd(tq, tk, tv, causal=False)
    got = FA.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                       causal=False)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    ref = torch.autograd.grad(FA.flash_attention_plain(
        *leaves, causal=False), leaves, tdo)
    for g, w, r in zip(got, want, ref):
        assert g.shape == r.shape and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the layout: weight decay, the optimizer state, checkpoints
# ---------------------------------------------------------------------------


def _tree(arch: str, **kw):
    cfg = dataclasses.replace(get_arch(arch, smoke=True), **kw)
    return cfg, get_model(cfg), _port_params(cfg)


def _jspecs(arch: str, smoke=True, **kw):
    jcfg = dataclasses.replace(jget_arch(arch, smoke=smoke), **kw)
    return jget_model(jcfg).param_specs(jcfg, None)


def _jdtypes(arch: str, **kw):
    """The reference's dtype of each leaf, in its layout."""
    return jax.tree.map(lambda s: s.dtype, _jspecs(arch, **kw),
                        is_leaf=JS.is_spec)


def _as_reference_paths(tree: dict, cfg) -> dict:
    """{path in the reference's layout: [leaf, ...]} of a port tree. A
    decoder-only tree's layer i is ``prefix/<i>`` in the prefix, else
    ``blocks/s<j>``; an encoder-decoder stacks each of ``enc/blocks`` and
    ``dec/blocks`` whole. The leaves that share a stacked path are
    listed."""
    out: dict = {}
    if "enc" in tree:
        for part, sub in tree.items():
            for k, v in sub.items():
                if k != "blocks":
                    for path, leaf in _by_path(v, f"{part}/{k}").items():
                        out.setdefault(path, []).append(leaf)
            for blk in sub["blocks"]:
                for path, leaf in _by_path(blk, f"{part}/blocks").items():
                    out.setdefault(path, []).append(leaf)
        return out
    n, pattern, _ = convert.reference_split(
        convert.layer_kinds_of(tree["blocks"]), cfg)
    n, P = len(n), len(pattern)
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
    the VLM's layers lie stacked in one (self x 4, cross) pattern, so a
    norm gain decays and the 0-d gates, (R,) there, do not; Whisper's
    ``enc`` and ``dec`` blocks are each stacked whole, its ``dec/pos``
    table decays and its final LayerNorms do not. The smoke trees and the
    full-depth spec trees (100 and 4 + 4 layers, as meta tensors)."""
    cfg = get_arch(arch, smoke=smoke)
    specs = get_model(cfg).param_specs(cfg)
    tree = S.tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                            device="meta"), specs)
    got = _as_reference_paths(O.decay_mask(tree, cfg), cfg)
    want = {p.lstrip("/"): len(s.shape) >= 2 for p, s in _by_path(
        _jspecs(arch, smoke=smoke), "").items()}
    assert sorted(got) == sorted(want)
    for path, masks in got.items():
        assert all(m is want[path] for m in masks), (path, masks,
                                                     want[path])
    if arch == "whisper-tiny":
        assert got["dec/pos"] == [True] and got["dec/final_ln/g"] == [False]
        assert all(got["enc/blocks/ln1/g"])
    else:
        assert not any(got["blocks/s4/gate_attn"])
        assert all(got["blocks/s4/ln1/g"])


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_decay_on_cross_trees_follows_the_reference(arch):
    """Two AdamW steps at weight decay 1.0, no clip, from the same f32
    params (gates nonzero), state and gradients in both layouts, the
    reference's jitted: every param within rtol 1e-6 (a leaf decayed in
    one package and not the other would be lr = 1e-2 apart) and ``mu`` /
    ``nu`` within ``F32_STATE_REL`` of each leaf's largest value."""
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
    """A bf16 tree (gates nonzero) and an AdamW state after one port train
    step (``mu`` and ``nu`` nonzero), in the port's layout."""
    cfg, api, tp = _tree(arch, remat=False)
    opt = S.materialize(O.state_specs(api.param_specs(cfg)), device="cpu")
    b = _with_memory(cfg, SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=12, batch_size=2)).global_batch(0),
        7)
    tb = _tbatch(b)
    key = "image_embeds" if cfg.family == "vlm" else "frames"
    tb[key] = tb[key].to(cfg.activation_dtype)
    tp, opt, _ = T.make_train_step(api, cfg, O.AdamWConfig(**OC))(tp, opt,
                                                                   tb)
    return cfg, tp, opt


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_of_cross_trees_converts_both_ways(arch):
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
        assert all(x.shape == y.shape and torch.equal(x, y)
                   for x, y in zip(a, b)), part
    if cfg.family == "vlm":  # the 0-d gates' moments stay 0-d and moved
        for part in ("mu", "nu"):
            g = back[part]["blocks"][4]["gate_attn"]
            assert g.shape == () and float(g) != 0.0


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_of_a_cross_tree_round_trips_between_packages(
        arch, tmp_path):
    """The bf16 tree and its AdamW state after a step, in the reference's
    layout: the port writes it, the reference restores it into its own
    param and state specs, writes it again, and the port restores and
    converts it back, every leaf bit for bit (the VLM's 0-d gates and
    their moments with their shapes)."""
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
    shapes_ = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jspecs,
                           is_leaf=JS.is_spec)
    tmpl = {"params": shapes_,
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
        assert a.shape == tuple(t.shape), path
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
        assert (a.dtype == got[path].dtype and a.shape == got[path].shape
                and torch.equal(a, got[path])), path
    for part in ("mu", "nu"):
        got = _by_path(state[part])
        for path, a in _by_path(opt[part]).items():
            assert a.shape == got[path].shape and torch.equal(a, got[path]), (
                part, path)
    assert int(state["step"]) == 1
