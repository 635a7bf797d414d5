"""Training in the port (``training/optimizer.py``, ``training/train_step.py``,
``checkpoint/manager.py``, ``launch/train.py``, the flash-attention
backward's plain version and autograd Function, ``convert``'s optimizer
state) against the JAX reference on the CPU, on the same seeded inputs.

Tolerances and why:

* The optimizer on the same gradients (``schedule``, ``global_norm``, the
  clip, 3 steps of ``apply_updates`` over f32 and bf16 leaves of ndim
  0/1/2, 2 steps on a model tree at weight decay 1.0 with no clip, whose
  norm gains the reference stacks and decays) and ``cross_entropy``: rtol 1e-6 (the same f32 elementwise ops;
  XLA's and PyTorch's ``cos``, ``pow`` and ``sqrt`` and their sums may
  differ by an ulp); bf16 params within one bf16 ulp (an f32 result one
  ulp apart can round to the neighbouring bf16).
* ``flash_attention_bwd_plain`` against ``jax.vjp`` of the reference's
  jnp attention (``repro.models.attention.flash_attention``, chunks of 8
  so its online softmax spans several chunks) and against torch autograd
  through ``flash_attention_plain``: f32 within 1e-5 absolute (gradients
  of order 1; sums in other orders); bf16 within one bf16 ulp of each
  gradient's largest value, 2^-7 of it (both round f32 gradients to bf16
  once; the port's rowsum(dO o O) reads the bf16-rounded output).
* A CPU replay of the bf16 backward kernels' arithmetic (bf16 operands,
  f32 sums one MMA k16 step at a time in the kernels' order, P and dS as
  bf16 hi + lo parts, the launch plan's head split) against both: bf16
  within the same 2^-7 of each gradient's largest value, the bound the
  kernels are held to on the card (``BWD_REL_TOLERANCE``).
* The train step from the reference's initial params, converted: the
  loss, ce and grad norm rtol 1e-5 (f32) / 2e-3 (bf16: bf16 activations
  rounded in other places), 20 times that at step 2 (computed from the
  params step 1 moved; see below); every gradient leaf ``||dg|| / ||g|| <= 1e-5`` (f32) / 2e-2
  (bf16). After 1 and 2 steps: f32 params within 0.01 x lr (AdamW
  divides each gradient element by its own magnitude, so an element near
  eps = 1e-8 turns a last-bit gradient difference into a fraction of one
  lr step; the largest seen is 0.0024 x lr, on ``mlp/gate/w``), bf16 params within two bf16 ulps of each leaf's largest
  magnitude plus one lr step a step taken (a bf16 gradient element near 0
  can change sign between the packages, which moves that element by up
  to one lr step each way), ``mu`` / ``nu`` within 1e-3 (f32) / 5e-2
  (bf16) of each leaf's largest value, ``step`` equal. ``grad_accum=2``
  the same bounds; remat on equals remat off bit for bit (CPU).
* ``train_loop``: the restart drill's resumed params equal the
  uninterrupted run's within rtol 1e-5 / atol 1e-6 (the reference test's
  bounds; on the CPU they are equal); the history's losses from the
  reference's initial params within 1e-3 relative of the reference's
  ``train_loop`` over 6 steps (the f32 differences above, compounded).
* Checkpoints both ways: bits equal (bf16 through its uint16 view), meta
  equal.
* The port of ``tests/test_system.py``'s train -> PTQ -> eval, on the port
  alone: the reference test's assertions (loss drops to 0.8, logits within
  0.15 relative, greedy agreement above 0.9, IS within 0.02 of FS).

    PYTHONPATH=src python -m pytest tests/test_torch_train.py -q
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.data.pipeline import DataConfig as JDataConfig
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models.config import ModelConfig as JConfig
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro.training import optimizer as JO
from repro.training import train_step as JT
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import ptq
from repro_torch.core.recipe import LLAMA3_RECIPE, QuantRecipe, QuantSpec
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import train as ptrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_arch, get_model
from repro_torch.nn import spec as S
from repro_torch.training import optimizer as O
from repro_torch.training import train_step as T

TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=128, vocab_size=64)
DC = dict(vocab_size=64, seq_len=16, batch_size=4)
OC = dict(lr=1e-3, warmup_steps=2, total_steps=6)
F32_GRAD_REL, BF16_GRAD_REL = 1e-5, 2e-2
F32_STATE_REL, BF16_STATE_REL = 1e-3, 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS / OpenMP thread a process while this module runs (its
    products are tiny; spinning pools beside the suite's other workers
    cost far more than they save). Both packages run under it."""
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


def _configs(dtype, **kw):
    return (JConfig(**TINY, dtype=dtype, q_chunk=8, kv_chunk=8, remat=False),
            ModelConfig(**TINY, dtype=dtype, remat=False, **kw))


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# the optimizer and the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 2, 50, 100, 101, 5000, 10_000, 12_000])
def test_schedule_matches_reference(step):
    for cfg in (dict(), dict(lr=1e-3, warmup_steps=2, total_steps=6,
                             min_lr_ratio=0.0)):
        want = float(JO.schedule(JO.AdamWConfig(**cfg), jnp.int32(step)))
        got = O.schedule(O.AdamWConfig(**cfg),
                         torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


def _opt_tree(seed):
    """f32 and bf16 leaves of ndim 0, 1 and 2, in a dict with a list."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"w": n(8, 16), "b": n(16), "s": n(), "e": n(6, 16),
            "l": [n(16), n(4, 8)]}


_BF16 = ("e", "l/0")  # leaves held in bf16


def _to_both(tree):
    """(jax tree, torch tree) of the same values, bf16 where _BF16 says."""
    def j(path, a):
        return jnp.asarray(a, jnp.bfloat16 if path in _BF16 else jnp.float32)

    def t(path, a):
        x = torch.from_numpy(np.array(a))
        return x.to(torch.bfloat16) if path in _BF16 else x

    flat = _by_path(tree)
    jt = {"w": None, "b": None, "s": None, "e": None, "l": [None, None]}
    tt = {"w": None, "b": None, "s": None, "e": None, "l": [None, None]}
    for path, a in flat.items():
        if path.startswith("l/"):
            i = int(path[2:])
            jt["l"][i], tt["l"][i] = j(path, a), t(path, a)
        else:
            jt[path], tt[path] = j(path, a), t(path, a)
    return jt, tt


def test_global_norm_and_clip_match_reference():
    jg, tg = _to_both(_opt_tree(1))
    want = float(JO.global_norm(jg))
    np.testing.assert_allclose(float(O.global_norm(tg)), want, rtol=1e-6)
    for max_norm in (0.5 * want, 2.0 * want):
        jc, jn = JO.clip_by_global_norm(jg, max_norm)
        tc, tn = O.clip_by_global_norm(tg, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for path, a in _by_path(_np(jc)).items():
            got = _by_path(tc)[path]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), a, rtol=1e-6, atol=1e-7)


def test_apply_updates_three_steps_match_reference():
    jp, tp = _to_both(_opt_tree(2))
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=5, weight_decay=0.1)
    jstate = {"mu": jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32),
                                 jp),
              "nu": jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32),
                                 jp),
              "step": jnp.int32(0)}
    tstate = {"mu": S.tree_map(lambda a: torch.zeros(a.shape), tp),
              "nu": S.tree_map(lambda a: torch.zeros(a.shape), tp),
              "step": torch.zeros((), dtype=torch.int32)}
    for i in range(3):
        jg, tg = _to_both(_opt_tree(10 + i))
        jp, jstate, jm = JO.apply_updates(jp, jg, jstate, JO.AdamWConfig(**cfg))
        tp, tstate, tm = O.apply_updates(tp, tg, tstate, O.AdamWConfig(**cfg))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        tflat = _by_path(tp)
        for path, a in _by_path(jp).items():
            got = tflat[path]
            assert got.dtype == (torch.bfloat16 if path in _BF16
                                 else torch.float32), path
            a32 = np.asarray(a, np.float32)
            if path in _BF16:  # one bf16 ulp
                ulp = 2.0 ** (np.floor(np.log2(np.abs(a32) + 1e-30)) - 7)
                assert np.all(np.abs(got.float().numpy() - a32) <= ulp), path
            else:
                np.testing.assert_allclose(got.numpy(), a32, rtol=1e-6,
                                           atol=1e-8, err_msg=path)
        for part in ("mu", "nu"):
            tflat = _by_path(tstate[part])
            for path, a in _by_path(_np(jstate[part])).items():
                np.testing.assert_allclose(tflat[path].numpy(), a, rtol=1e-6,
                                           atol=1e-9, err_msg=(part, path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_decay_follows_the_reference_layout(dtype):
    """A model tree: the port holds one (d,) norm gain a layer where the
    reference stacks them to (R, d), which its ``ndim >= 2`` rule decays.
    At weight decay 1.0, two steps from the same params and gradients give
    every leaf within the bounds of the test above (the norm gains would
    be lr = 1e-2 apart after one step without the stacked rule)."""
    jcfg, _ = _configs(dtype)
    jp = JS.materialize(jget_model(jcfg).param_specs(jcfg, None),
                        jax.random.PRNGKey(4))
    tp = convert.from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    # no clip: the two layouts group the global norm's sums differently
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=5, weight_decay=1.0,
               grad_clip=1e9)
    jstate = JS.materialize(JO.state_specs(
        jget_model(jcfg).param_specs(jcfg, None)), jax.random.PRNGKey(1))
    tstate = convert.opt_from_reference(jax.tree.map(np.asarray, jstate),
                                        device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(2):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32).astype(a.dtype), jax.tree.map(np.asarray, jp))
        jp, jstate, _ = JO.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                         jstate, JO.AdamWConfig(**cfg))
        tp, tstate, _ = O.apply_updates(
            tp, convert.from_reference(g, device="cpu"), tstate,
            O.AdamWConfig(**cfg))
    ptree = _by_path(convert.to_reference(tp))
    for path, a in _by_path(_np(jp)).items():
        if dtype == "bfloat16":  # one bf16 ulp
            ulp = 2.0 ** (np.floor(np.log2(np.abs(a) + 1e-30)) - 7)
            assert np.all(np.abs(ptree[path] - a) <= ulp), path
        else:
            np.testing.assert_allclose(ptree[path], a, rtol=1e-6, atol=1e-8,
                                       err_msg=path)
    rstate = convert.opt_to_reference(tstate)
    for part in ("mu", "nu"):
        st = _by_path(rstate[part])
        for path, a in _by_path(_np(jstate[part])).items():
            np.testing.assert_allclose(st[path], a, rtol=1e-6, atol=1e-9,
                                       err_msg=(part, path))


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 5, 17)) * 8).astype(np.float32)
    labels = rng.integers(0, 17, size=(3, 5)).astype(np.int32)
    want = float(JT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = T.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the flash-attention backward
# ---------------------------------------------------------------------------

BWD_CASES = {  # (B, Sq, Sk, Hq, Hkv, D, causal, window)
    "mha": (2, 16, 16, 4, 4, 8, True, None),
    "gqa": (2, 24, 24, 4, 2, 16, True, None),
    "window": (2, 40, 40, 4, 2, 8, True, 7),
    "cross": (2, 8, 21, 4, 1, 16, False, None),
}


def _qkv(case, dtype):
    B, Sq, Sk, Hq, Hkv, D, _, _ = BWD_CASES[case]
    rng = np.random.default_rng(len(case))
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
             (B, Sq, Hq, D))]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_flash_bwd_plain_matches_jax_vjp(case, dtype):
    *_, causal, window = BWD_CASES[case]
    (jq, jk, jv, jdo), (q, k, v, do) = _qkv(case, dtype)

    def f(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, causal=causal, window=window,
                                     q_chunk=8, kv_chunk=8)

    jout, vjp = jax.vjp(f, jq, jk, jv)
    want = [np.asarray(g, np.float32) for g in vjp(jdo)]
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert lse.dtype == torch.float32 and lse.shape == (q.shape[0],
                                                        q.shape[2],
                                                        q.shape[1])
    got = FA.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                       window=window)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(w).max()
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=tol)
    if dtype == "float32":  # and torch autograd through the plain forward
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(
            FA.flash_attention_plain(*leaves, causal=causal, window=window),
            leaves, do)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                       atol=1e-5)


def _bwd_cu_int(symbol: str) -> int:
    """An integer constexpr of csrc/flash_attention_bwd.cu."""
    import re

    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    return int(re.search(rf"\b{symbol} = (\d+)", src).group(1))


def _bf16_parts(x):
    """x as the kernels feed P and dS to an MMA: bf16 hi and lo parts."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _bwd_tc_replay(q, k, v, o, lse, do, causal, window, splits):
    """The bf16 backward kernels' arithmetic (csrc/flash_attention_bwd.cu)
    on CPU tensors: bf16 operands into f32 sums, one MMA k16 step at a
    time in the kernels' order; P and dS as the MMAs take them (bf16 hi
    and lo parts, one MMA each); a kv head's dK and dV summed over the G
    query heads of each of its ``splits`` in order, the splits' f32
    partials added in order. Chunks the kernels skip add exact zeros
    here."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    Gs = G // splits
    f32 = torch.float32
    scale = torch.tensor(1.0 / np.sqrt(D), dtype=f32)
    log2e = torch.tensor(1.4426950408889634, dtype=f32)
    sl2 = (scale * log2e).double()
    qh, doh = (t.float().permute(0, 2, 1, 3) for t in (q, do))
    kh, vh = (t.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)
              for t in (k, v))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)

    def over_d(a, b):  # a b^T in k16 steps over the head dim
        acc = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=f32)
        for c in range(0, D, 16):
            acc = acc + a[..., c:c + 16] @ b[..., c:c + 16].transpose(-1, -2)
        return acc

    s, dp = over_d(qh, kh), over_d(doh, vh)  # (B, Hq, Sq, Sk)
    l2 = (lse * log2e)[..., None].double()
    p = torch.where(FA._mask(Sq, Sk, causal, window, "cpu"),
                    torch.exp2((s.double() * sl2 - l2).float()), 0.0)
    ds = p * (dp - delta[..., None])

    dk = dv = None
    for z in range(splits):
        pk = pv = torch.zeros(B, Hkv, Sk, D, dtype=f32)
        for gi in range(Gs):
            heads = [hk * G + z * Gs + gi for hk in range(Hkv)]
            for c in range(0, Sq, 16):
                for part in _bf16_parts(
                        p[:, heads, c:c + 16].transpose(-1, -2)):
                    pv = pv + part @ doh[:, heads, c:c + 16]
                for part in _bf16_parts(
                        ds[:, heads, c:c + 16].transpose(-1, -2)):
                    pk = pk + part @ qh[:, heads, c:c + 16]
        pk = pk * scale
        dk = pk if dk is None else dk + pk
        dv = pv if dv is None else dv + pv
    dq = torch.zeros(B, Hq, Sq, D, dtype=f32)
    for c in range(0, Sk, 16):
        for part in _bf16_parts(ds[..., c:c + 16]):
            dq = dq + part @ kh[:, :, c:c + 16]
    dq = dq * scale
    return tuple(t.permute(0, 2, 1, 3).to(torch.bfloat16)
                 for t in (dq, dk, dv))


@pytest.mark.parametrize("plan", ["card", "unsplit"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_flash_bwd_tensor_core_replay_matches_jax_vjp(case, plan):
    """A CPU replay of the bf16 backward kernels' arithmetic, with the G
    heads split as the launch plan splits them on a 132-SM card or not
    split, within ``BWD_REL_TOLERANCE`` (one bf16 ulp of each gradient's
    largest value) of ``jax.vjp`` of the reference's attention and of
    :func:`flash_attention_bwd_plain`."""
    B, Sq, Sk, Hq, Hkv, D, causal, window = BWD_CASES[case]
    (jq, jk, jv, jdo), (q, k, v, do) = _qkv(case, "bfloat16")
    _, vjp = jax.vjp(lambda q_, k_, v_: jattn.flash_attention(
        q_, k_, v_, causal=causal, window=window, q_chunk=8, kv_chunk=8),
        jq, jk, jv)
    want_jax = [np.asarray(g, np.float32) for g in vjp(jdo)]
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                        window=window)
    splits = (FA.bwd_launch_plan(B, Sq, Sk, Hq, Hkv, D, torch.bfloat16,
                                 132)["splits"] if plan == "card" else 1)
    got = _bwd_tc_replay(q, k, v, out, lse, do, causal, window, splits)
    rel = FA.BWD_REL_TOLERANCE[torch.bfloat16]
    for g, w, wj, t in zip(got, want, want_jax, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=0, atol=rel * w.float().abs().max())
        np.testing.assert_allclose(g.float().numpy(), wj, rtol=0,
                                   atol=rel * np.abs(wj).max())


@pytest.mark.parametrize("shape,dtype,kv_blocks,splits", [
    ((4, 1024, 1024, 24, 8, 128), torch.bfloat16, 512, 1),
    ((2, 1024, 1024, 8, 2, 128), torch.bfloat16, 256, 4),
    ((2, 256, 1024, 8, 2, 64), torch.bfloat16, 256, 4),
    ((3, 300, 300, 4, 2, 64), torch.bfloat16, 60, 2),
    ((8, 256, 256, 8, 8, 64), torch.float32, 256, 1),
    ((1, 4096, 4096, 16, 1, 256), torch.bfloat16, 256, 2),
    ((1, 4096, 4096, 16, 1, 256), torch.float32, 128, 1),
    ((8, 1500, 1500, 6, 6, 64), torch.bfloat16, 1152, 1),
    ((8, 448, 1500, 6, 6, 64), torch.bfloat16, 1152, 1),
    ((2, 1024, 1600, 64, 8, 128), torch.bfloat16, 400, 1),
    ((2, 1024, 1600, 64, 8, 128), torch.float32, 400, 1),
    ((1, 300, 1500, 8, 1, 128), torch.bfloat16, 192, 8)])
def test_flash_bwd_launch_plan(shape, dtype, kv_blocks, splits):
    """The backward's launch plan on a 132-SM H100: llama3.2-3b's train
    step fills the card with key tiles x B Hkv dK/dV blocks; a window or
    a long memory (key tiles x B Hkv = 64) splits each group's G heads
    (a divisor of G) until at least 132 blocks run, or G does; f32 never
    splits. The tiles are the .cu's (``TKV``, ``TQD``; at head dim 256
    ``TKV_256``, and f32's square ``BT_256``), and the workspace holds
    the splits' f32 dK and dV partials. RecurrentGemma's train shape (16
    query heads over one KV head of 256, 4096 tokens): 128 bf16 dK/dV
    blocks of 32 keys, so its heads split in 2. The cross-attention
    families' train shapes (Whisper's 1500 keys: 24 tiles, the last
    ragged; the VLM's 1600 over 8 KV heads) fill the card unsplit; G = 8
    over one KV head at 1500 keys (24 blocks) splits 8 ways."""
    B, Sq, Sk, Hq, Hkv, D = shape
    assert (FA.BWD_KV_TILE, FA.BWD_Q_TILE) == (_bwd_cu_int("TKV"),
                                              _bwd_cu_int("TQD"))
    assert FA.BWD_KV_TILE_256 == _bwd_cu_int("TKV_256") == _bwd_cu_int(
        "BT_256")
    assert D in FA.BWD_HEAD_DIMS
    kv_tile = _bwd_cu_int("TKV_256" if D == 256 else "TKV")
    q_tile = kv_tile if dtype == torch.float32 else _bwd_cu_int("TQD")
    plan = FA.bwd_launch_plan(B, Sq, Sk, Hq, Hkv, D, dtype, 132)
    assert plan["splits"] == splits and (Hq // Hkv) % splits == 0
    assert plan["kv_blocks"] == -(-Sk // kv_tile) * B * Hkv * splits == \
        kv_blocks
    assert plan["q_blocks"] == -(-Sq // q_tile) * B * Hq
    assert plan["workspace"] == (2 * splits * B * Sk * Hkv * D
                                 if splits > 1 else 0)


def test_flash_attention_trains_through_its_autograd_function_on_cpu():
    *_, causal, window = BWD_CASES["window"]
    _, (q, k, v, do) = _qkv("window", "float32")
    before = dict(_build.LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FA.flash_attention(*leaves, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, do)
    o, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert torch.equal(out.detach(), o)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():  # serving: the plain forward, no Function
        assert FA.flash_attention(*leaves, causal=causal,
                                  window=window).grad_fn is None
    assert _build.LAUNCHES == before  # the CPU launches no kernel


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_steps(dtype: str, grad_accum: int, steps: int = 2):
    """The reference's initial params, its step-0 loss and gradients, and
    its params, state and metrics after each of ``steps`` train steps."""
    jcfg, _ = _configs(dtype)
    api = jget_model(jcfg)
    pspecs = api.param_specs(jcfg, None)
    p0 = JS.materialize(pspecs, jax.random.PRNGKey(0))
    opt = JS.materialize(JO.state_specs(pspecs), jax.random.PRNGKey(1))
    pipe = SyntheticPipeline(DataConfig(**DC))
    batches = [pipe.global_batch(i) for i in range(steps)]
    (loss, _), grads = jax.value_and_grad(
        JT.make_loss_fn(api, jcfg), has_aux=True)(p0, _jbatch(batches[0]))
    step = jax.jit(JT.make_train_step(api, jcfg, JO.AdamWConfig(**OC),
                                      grad_accum=grad_accum))
    after, p = [], p0
    for b in batches:
        p, opt, m = step(p, opt, _jbatch(b))
        after.append((_np(p), _np(opt), {k: float(v) for k, v in m.items()}))
    return (jax.tree.map(np.asarray, p0), float(loss), _np(grads), batches,
            after)


def _port_grads(api, cfg, params, batch):
    loss_fn = T.make_loss_fn(api, cfg)
    leaves = S.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    it = iter(grads)
    return float(loss.detach()), S.tree_map(lambda _: next(it), params)


def _assert_state_close(tp, topt, jp, jopt, lrs, dtype, tag):
    """``lrs``: the learning rates of the steps taken so far."""
    ptree = _by_path(convert.to_reference(tp))
    for path, a in _by_path(jp).items():
        err = np.abs(ptree[path] - a).max()
        if dtype == "float32":
            bound = 0.01 * max(lrs)
        else:  # two bf16 ulps, and one lr step each way a step
            bound = 2.0 ** -7 * np.abs(a).max() + sum(lrs)
        assert err <= bound, (tag, path, err, bound)
    rstate = convert.opt_to_reference(topt)
    tol = F32_STATE_REL if dtype == "float32" else BF16_STATE_REL
    for part in ("mu", "nu"):
        st = _by_path(rstate[part])
        for path, a in _by_path(jopt[part]).items():
            err = np.abs(st[path] - a).max()
            assert err <= tol * np.abs(a).max(), (tag, part, path, err)
    assert int(rstate["step"]) == int(jopt["step"])


@pytest.mark.parametrize("dtype,grad_accum", [("float32", 1), ("bfloat16", 1),
                                              ("float32", 2)])
def test_train_step_matches_reference(dtype, grad_accum):
    p0, jloss, jgrads, batches, after = _reference_steps(dtype, grad_accum)
    _, cfg = _configs(dtype)
    api = get_model(cfg)
    params = convert.from_reference(p0, device="cpu")
    loss, grads = _port_grads(api, cfg, params, _tbatch(batches[0]))
    rtol = 1e-5 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(loss, jloss, rtol=rtol)
    gbound = F32_GRAD_REL if dtype == "float32" else BF16_GRAD_REL
    gtree = _by_path(convert.to_reference(grads))
    for path, g in _by_path(jgrads).items():
        assert _rel(gtree[path], g) <= gbound, (path, _rel(gtree[path], g))
    opt = S.materialize(O.state_specs(api.param_specs(cfg)), device="cpu")
    step = T.make_train_step(api, cfg, O.AdamWConfig(**OC),
                             grad_accum=grad_accum)
    lrs = []
    for i, (b, (jp, jopt, jm)) in enumerate(zip(batches, after)):
        params, opt, m = step(params, opt, _tbatch(b))
        lrs.append(jm["lr"])
        assert set(m) == set(jm) == {"loss", "ce", "aux", "grad_norm", "lr"}
        for k in ("loss", "ce", "grad_norm"):  # step 2 from moved params
            np.testing.assert_allclose(float(m[k]), jm[k],
                                       rtol=rtol if i == 0 else 20 * rtol,
                                       err_msg=(i, k))
        np.testing.assert_allclose(float(m["lr"]), jm["lr"], rtol=1e-6)
        assert float(m["aux"]) == jm["aux"] == 0.0
        _assert_state_close(params, opt, jp, jopt, lrs, dtype,
                            f"step {i + 1}")
        assert not any(t.requires_grad for t in S.leaves(params))


def test_remat_recomputes_each_block_and_changes_no_bit():
    out = {}
    for remat in (False, True):
        cfg = ModelConfig(**TINY, dtype="float32", remat=remat)
        api = get_model(cfg)
        params = ptq.materialize_by_layer(api, cfg, seed=3, device="cpu")
        opt = S.materialize(O.state_specs(api.param_specs(cfg)),
                            device="cpu")
        step = T.make_train_step(api, cfg, O.AdamWConfig(**OC))
        calls = []
        pipe = SyntheticPipeline(DataConfig(**DC))
        params, opt, m = step(params, opt, _tbatch(pipe.global_batch(0)))
        mdl = api.build(cfg, params)
        hooks = [blk.register_forward_pre_hook(lambda *_: calls.append(1))
                 for blk in mdl.blocks]
        leaves = S.leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        logits, _, _ = mdl(_tbatch(pipe.global_batch(1))["tokens"],
                           mode="train")
        torch.autograd.grad(logits.square().mean(), leaves)
        for t in leaves:
            t.requires_grad_(False)
        for h in hooks:
            h.remove()
        out[remat] = (S.leaves(params), float(m["loss"]), len(calls))
    assert out[False][2] == TINY["num_layers"]
    assert out[True][2] == 2 * TINY["num_layers"]  # forward + recompute
    assert out[False][1] == out[True][1]
    for a, b in zip(out[False][0], out[True][0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-tiny"])
def test_make_train_step_refuses_other_families(arch):
    """The last families ``make_train_step`` refused, the cross-attention
    ones, now train (held against the reference's train step in
    tests/test_torch_train_xattn.py; the MoE family and MLA in
    tests/test_torch_train_moe.py, xLSTM and RecurrentGemma in
    tests/test_torch_train_recurrent.py), so it refuses no family: one
    step on the smoke config with its memory in the batch
    (``image_embeds`` / ``frames``), finite metrics, more than half the
    leaves moved and none left requiring grad."""
    from repro_torch.configs import shapes

    cfg = get_arch(arch, smoke=True)
    api = get_model(cfg)
    params = S.materialize(api.param_specs(cfg), torch.Generator(
        ).manual_seed(0), device="cpu")
    before = [t.clone() for t in S.leaves(params)]
    opt = S.materialize(O.state_specs(api.param_specs(cfg)), device="cpu")
    b = _tbatch(SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=12, batch_size=2)).global_batch(0))
    spec = shapes.input_specs(cfg, shapes.Shape("t", "train", 12, 2))
    key = {"vlm": "image_embeds", "audio": "frames"}[cfg.family]
    b[key] = torch.randn(spec[key].shape, generator=torch.Generator(
        ).manual_seed(1)).to(spec[key].dtype)
    step = T.make_train_step(api, cfg, O.AdamWConfig(**OC))
    params, opt, m = step(params, opt, b)
    assert set(m) == {"loss", "ce", "aux", "grad_norm", "lr"}
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert int(opt["step"]) == 1
    moved = [not torch.equal(a, t) for a, t in zip(before, S.leaves(params))]
    assert sum(moved) > len(moved) // 2
    assert not any(t.requires_grad for t in S.leaves(params))


def test_opt_state_converts_both_ways():
    _, _, _, _, after = _reference_steps("float32", 1)
    jopt = after[0][1]
    port = convert.opt_from_reference(jopt, device="cpu")
    assert port["step"].dtype == torch.int32 and int(port["step"]) == 1
    assert len(port["mu"]["blocks"]) == TINY["num_layers"]
    back = convert.opt_to_reference(port)
    assert back["step"].dtype == np.int32 and int(back["step"]) == 1
    for part in ("mu", "nu"):
        bt = _by_path(back[part])
        for path, a in _by_path(jopt[part]).items():
            assert np.array_equal(bt[path], a), (part, path)


# ---------------------------------------------------------------------------
# train_loop
# ---------------------------------------------------------------------------


def test_restart_drill(tmp_path):
    """Port of the reference's ``test_restart_drill``: train -> injected
    failure -> restart-from-checkpoint resumes and reaches the same final
    state as an uninterrupted run."""
    cfg = ModelConfig(**TINY, dtype="float32", remat=False)
    dc = DataConfig(**DC)
    oc = O.AdamWConfig(**OC)
    logs = []
    p_ref, _, _ = ptrain.train_loop(cfg, dc, oc, steps=6, ckpt_dir=None,
                                    log_fn=logs.append, device="cpu")
    ck = str(tmp_path / "drill")
    with pytest.raises(RuntimeError, match="injected"):
        ptrain.train_loop(cfg, dc, oc, steps=6, ckpt_dir=ck, ckpt_every=2,
                          fail_at_step=4, log_fn=logs.append, device="cpu")
    assert CheckpointManager(ck).steps() == [2, 4]
    p_res, _, hist = ptrain.train_loop(cfg, dc, oc, steps=6, ckpt_dir=ck,
                                       ckpt_every=2, log_fn=logs.append,
                                       device="cpu")
    assert hist[0]["step"] == 4  # resumed, not restarted
    assert "[train] restored checkpoint at step 4" in logs
    for a, b in zip(S.leaves(p_ref), S.leaves(p_res)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _start_from(ckpt_dir, cfg, jcfg) -> None:
    """A step-0 checkpoint in ``ckpt_dir`` of the reference's initial
    params (those its ``train_loop`` draws from seed 0), converted, and a
    zero AdamW state: ``train_loop(ckpt_dir=...)`` restarts from it."""
    p0 = JS.materialize(jget_model(jcfg).param_specs(jcfg, None),
                        jax.random.PRNGKey(0))
    opt = S.materialize(O.state_specs(get_model(cfg).param_specs(cfg, None)),
                        device="cpu")
    CheckpointManager(ckpt_dir).save(0, {
        "params": convert.from_reference(jax.tree.map(np.asarray, p0),
                                         device="cpu"),
        "opt": opt})


def test_train_loop_history_equals_reference(tmp_path):
    jcfg, cfg = _configs("float32")
    _, _, jhist = jtrain.train_loop(jcfg, JDataConfig(**DC),
                                    JO.AdamWConfig(**OC), steps=6,
                                    log_fn=lambda *_: None)
    _start_from(tmp_path, cfg, jcfg)
    logs = []
    _, opt, hist = ptrain.train_loop(cfg, DataConfig(**DC),
                                     O.AdamWConfig(**OC), steps=6,
                                     ckpt_dir=str(tmp_path),
                                     log_fn=logs.append, device="cpu")
    assert "[train] restored checkpoint at step 0" in logs
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-3)
    assert hist[0]["loss"] == pytest.approx(jhist[0]["loss"], rel=1e-6)
    assert int(opt["step"]) == 6


def test_train_cli_on_the_cpu(capsys):
    ptrain.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                 "--seq", "32", "--ckpt", ""])
    out = capsys.readouterr().out
    assert "[train] step     0 loss" in out and "[train] step     2" in out
    assert "[train] done in" in out


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _ckpt_tree(seed):
    rng = np.random.default_rng(seed)
    bf = rng.normal(size=(3, 5)).astype(np.float32)
    return {"params": {"w": bf, "b": rng.normal(size=(5,)).astype(
        np.float32)}, "opt": [np.int32(7), rng.normal(size=(2, 2)).astype(
            np.float32)]}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_checkpoint_port_writes_reference_restores(tmp_path):
    t = _ckpt_tree(4)
    tree = {"params": {"w": torch.from_numpy(t["params"]["w"]).to(
        torch.bfloat16), "b": torch.from_numpy(t["params"]["b"])},
        "opt": [torch.tensor(7, dtype=torch.int32),
                torch.from_numpy(t["opt"][1])]}
    CheckpointManager(str(tmp_path)).save(3, tree, meta={"loss": 1.5})
    assert os.listdir(tmp_path) == ["ckpt_00000003.npz"]
    tmpl = {"params": {"w": jnp.zeros((3, 5), jnp.bfloat16),
                       "b": jnp.zeros((5,))},
            "opt": [jnp.int32(0), jnp.zeros((2, 2))]}
    out, meta = JManager(str(tmp_path)).restore(3, tmpl)
    assert meta == {"loss": 1.5}
    assert out["params"]["w"].dtype == jnp.bfloat16
    assert np.array_equal(_bits(out["params"]["w"]),
                          tree["params"]["w"].view(torch.int16).numpy()
                          .view(np.uint16))
    assert np.array_equal(np.asarray(out["params"]["b"]), t["params"]["b"])
    assert int(out["opt"][0]) == 7 and out["opt"][0].dtype == jnp.int32
    assert np.array_equal(np.asarray(out["opt"][1]), t["opt"][1])


def test_checkpoint_reference_writes_port_restores(tmp_path):
    t = _ckpt_tree(5)
    jtree = {"params": {"w": jnp.asarray(t["params"]["w"], jnp.bfloat16),
                        "b": jnp.asarray(t["params"]["b"])},
             "opt": [jnp.int32(7), jnp.asarray(t["opt"][1])]}
    JManager(str(tmp_path)).save(9, jtree, meta={"loss": 2.5, "n": [1, 2]})
    tmpl = {"params": {"w": None, "b": None}, "opt": [None, None]}
    out, meta = CheckpointManager(str(tmp_path)).restore(9, tmpl,
                                                         device="cpu")
    assert meta == {"loss": 2.5, "n": [1, 2]}
    w = out["params"]["w"]
    assert w.dtype == torch.bfloat16 and w.shape == (3, 5)
    assert np.array_equal(w.view(torch.int16).numpy().view(np.uint16),
                          _bits(jtree["params"]["w"]))
    assert torch.equal(out["params"]["b"], torch.from_numpy(t["params"]["b"]))
    assert out["opt"][0].dtype == torch.int32 and int(out["opt"][0]) == 7
    assert torch.equal(out["opt"][1], torch.from_numpy(t["opt"][1]))


def test_checkpoint_retention_atomicity_and_async(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    x = torch.arange(6, dtype=torch.float32)
    for s in (1, 2, 3):
        mgr.save(s, {"x": x + s})
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    # async: the snapshot is taken at the call, before the tensor moves on
    mgr.save_async(4, {"x": x}, meta={"loss": 0.25})
    x.add_(100)
    mgr.wait()
    out, meta = mgr.restore(4, {"x": None}, device="cpu")
    assert torch.equal(out["x"], torch.arange(6, dtype=torch.float32))
    assert meta == {"loss": 0.25} and mgr.steps() == [3, 4]
    # a write that fails leaves the latest checkpoint intact, and the
    # async writer's error is raised by the next wait()
    import repro_torch.checkpoint.manager as M

    def broken(f, **kw):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(M.np, "savez", broken)
    mgr.save_async(5, {"x": x})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # raised once
    assert mgr.steps() == [3, 4]
    assert not any(f.startswith("ckpt_00000005") for f in os.listdir(tmp_path))
    with pytest.raises(OSError, match="disk full"):
        mgr.save(6, {"x": x})
    assert mgr.latest_step() == 4
    monkeypatch.undo()
    out, _ = mgr.restore(4, {"x": None}, device="cpu")
    assert torch.equal(out["x"], torch.arange(6, dtype=torch.float32))


# ---------------------------------------------------------------------------
# train -> PTQ -> eval (the port of tests/test_system.py's, port alone)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained_tiny(tmp_path_factory):
    """Train a small LM for a handful of steps (loss must drop), from the
    reference test's initial params (converted), on the port alone."""
    cfg = ModelConfig(name="sys", family="dense", num_layers=2, d_model=128,
                      num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=128,
                      dtype="float32", remat=False)
    dc = DataConfig(vocab_size=128, seq_len=64, batch_size=8)
    oc = O.AdamWConfig(lr=2e-3, warmup_steps=3, total_steps=20)
    jcfg = JConfig(**dict({f.name: getattr(cfg, f.name) for f in
                           dataclasses.fields(cfg)}, q_chunk=32, kv_chunk=32))
    ck = tmp_path_factory.mktemp("trained_tiny")
    _start_from(ck, cfg, jcfg)  # the reference test's init
    params, _, hist = ptrain.train_loop(
        cfg, dc, oc, steps=15, ckpt_dir=str(ck), log_fn=lambda *_: None,
        device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.8, "loss must drop"
    return get_model(cfg), cfg, params, dc


def _logits(api, cfg, params, toks, recipe=None):
    with torch.no_grad():
        return api.build(cfg, params, recipe)(toks, mode="train")[0]


@pytest.mark.parametrize("algo", ["rtn", "gptq", "awq", "smoothquant",
                                  "omniquant"])
def test_train_ptq_eval_all_algorithms(trained_tiny, algo):
    api, cfg, params, dc = trained_tiny
    pipe = SyntheticPipeline(dc)
    cal = [pipe.global_batch(999)]
    toks = torch.from_numpy(pipe.global_batch(1000)["tokens"])
    logits_fp = _logits(api, cfg, params, toks)
    recipe = QuantRecipe(rules=(("*", QuantSpec(algo=algo)),), name=algo)
    qp = ptq.post_training_quantize(api, cfg, params, recipe, cal)
    logits_q = _logits(api, cfg, qp, toks, recipe)
    rel = float(torch.linalg.norm(logits_q - logits_fp)
                / torch.linalg.norm(logits_fp))
    assert rel < 0.15, (algo, rel)
    agree = float((logits_q.argmax(-1) == logits_fp.argmax(-1)).float()
                  .mean())
    assert agree > 0.9, (algo, agree)
    # the eval step reads the same model
    ev = T.make_eval_step(api, cfg, recipe)(qp, _tbatch(
        pipe.global_batch(1000)))
    np.testing.assert_allclose(float(ev["ce"]), float(T.cross_entropy(
        logits_q, torch.from_numpy(pipe.global_batch(1000)["labels"]))),
        rtol=1e-6)


def test_integer_vs_float_scale_free_lunch(trained_tiny):
    """The paper's core claim at system level: IS ~ FS outputs."""
    api, cfg, params, dc = trained_tiny
    toks = torch.from_numpy(SyntheticPipeline(dc).global_batch(1001)
                            ["tokens"])
    outs = {}
    for mode in ("float", "integer"):
        recipe = QuantRecipe(rules=(("*", QuantSpec(scale_mode=mode)),),
                             name=mode)
        qp = ptq.post_training_quantize(api, cfg, params, recipe, None)
        outs[mode] = _logits(api, cfg, qp, toks, recipe)
    rel = float(torch.linalg.norm(outs["integer"] - outs["float"])
                / torch.linalg.norm(outs["float"]))
    assert rel < 0.02, rel  # integerization error only


def test_llama3_recipe_structure(trained_tiny):
    """Paper §5.6 recipe: W8A8 down-proj + rotation + W4A8 elsewhere."""
    api, cfg, params, dc = trained_tiny
    qp = ptq.post_training_quantize(api, cfg, params, LLAMA3_RECIPE, None)
    blk = qp["blocks"][0]["mlp"]
    assert blk["down"]["qvalue"].shape[0] == cfg.d_ff  # w8: K not halved
    assert "rot" in blk["down"]
    assert blk["gate"]["qvalue"].shape[0] == cfg.d_model // 2  # w4: K / 2
    toks = torch.from_numpy(SyntheticPipeline(dc).global_batch(1002)
                            ["tokens"])
    assert bool(_logits(api, cfg, qp, toks, LLAMA3_RECIPE).isfinite().all())


def test_train_loop_params_stay_free_of_grad(trained_tiny):
    _, _, params, _ = trained_tiny
    assert not any(t.requires_grad for t in S.leaves(params))
