"""Training step: loss, gradients, the AdamW update. Port of
``repro/training/train_step.py``.

``make_train_step`` returns a function
    (params, opt_state, batch) -> (params, opt_state, metrics)
with the reference's metric names (``loss``, ``ce``, ``aux``,
``grad_norm``, ``lr``; 0-d f32 tensors on the device). The reference's
is pure and ``jax.value_and_grad``-differentiated; the port builds the
model once over the param tree (its modules hold the leaves themselves),
sets ``requires_grad_()`` on the leaves for the forward and backward
(``torch.autograd.grad``), clears it again, and updates params and state
in place (``optimizer.apply_updates``). ``grad_accum > 1`` splits the
leading batch dim into that many microbatches and sums the loss, ce, aux
and gradients in f32 before dividing, as the reference's scan does.

On the card the model's prefill attention is the flash kernel and its
gradient the hand-written backward kernel (``kernels/flash_attention``;
RecurrentGemma's local attention at head dim 256 with its window too);
the linears of an fp model are ``x @ w``. Under ``cfg.remat`` each block
is recomputed in the backward (``torch.utils.checkpoint`` in
``models/transformer.py``, ``griffin.py``, ``xlstm.py`` and, for the
decoder, ``encdec.py``).

Every family trains: dense and MoE, with GQA or MLA attention (MLA's
prefill is ``models.attention.chunked_attention``, plain PyTorch, as the
reference's is jnp); the MoE aux loss enters ``loss = ce + aux`` summed
over the layers. The ssm (xLSTM: the mLSTM stepped token by token or
chunkwise, the sLSTM scan) and hybrid (RecurrentGemma: the RG-LRU's
log-depth scan, local attention) families' recurrences are plain
PyTorch, as the reference's are jnp. The cross-attention families take
their memory from the batch, as the reference's loss does: the VLM's
``image_embeds`` (its gated cross layers' ``tanh(gate)`` scalars are
leaves with gradients like any other) and Whisper's ``frames`` (its
encoder runs in the step; remat recomputes its decoder blocks). AdamW's
weight decay reads the model's config for a Griffin tree's layout
(``optimizer.decay_mask``).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelApi
from repro_torch.nn import spec as S
from . import optimizer as O


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token-level CE; logits f32 (B,S,V), labels int (B,S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


class _Models:
    """The model built over a param tree, rebuilt only when the tree's
    leaves are other tensor objects (the train step updates them in
    place, so one build serves every step)."""

    def __init__(self, api: ModelApi, cfg: ModelConfig, recipe):
        self.api, self.cfg, self.recipe = api, cfg, recipe
        self._leaves: list = []
        self._model = None

    def __call__(self, params):
        leaves = S.leaves(params)
        if self._model is None or len(leaves) != len(self._leaves) or any(
                a is not b for a, b in zip(leaves, self._leaves)):
            self._model = self.api.build(self.cfg, params, self.recipe)
            self._leaves = leaves
        return self._model


def make_loss_fn(api: ModelApi, cfg: ModelConfig, recipe=None):
    models = _Models(api, cfg, recipe)

    def loss_fn(params, batch):
        logits, _, aux = models(params)(
            batch["tokens"], mode="train",
            memory=batch.get("image_embeds", batch.get("frames")))
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}

    return loss_fn


def _grads(loss_fn, params, batch):
    """(loss, parts, gradient leaves) with the leaves requiring grad only
    for this forward and backward."""
    leaves = S.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, parts = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def _tree_of(params, leaves: list):
    it = iter(leaves)
    return S.tree_map(lambda _: next(it), params)


def make_train_step(api: ModelApi, cfg: ModelConfig,
                    opt_cfg: O.AdamWConfig, recipe=None,
                    grad_accum: int = 1):
    loss_fn = make_loss_fn(api, cfg, recipe)

    def train_step(params, opt_state, batch):
        if grad_accum <= 1:
            loss, parts, grads = _grads(loss_fn, params, batch)
        else:
            # microbatches: split the leading batch dim of every entry
            # (the memory's too) into grad_accum
            mbs = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                *v.shape[1:]) for k, v in batch.items()}
            sums = [torch.zeros((), dtype=torch.float32,
                                device=batch["tokens"].device)] * 3
            grads = [torch.zeros(t.shape, dtype=torch.float32,
                                 device=t.device) for t in S.leaves(params)]
            for i in range(grad_accum):
                lv, p, g = _grads(loss_fn, params,
                                  {k: v[i] for k, v in mbs.items()})
                sums = [a + b for a, b in zip(sums, (lv, p["ce"], p["aux"]))]
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
            loss = sums[0] / grad_accum
            parts = {"ce": sums[1] / grad_accum, "aux": sums[2] / grad_accum}
            for acc in grads:
                acc.div_(grad_accum)
        params, opt_state, om = O.apply_updates(
            params, _tree_of(params, grads), opt_state, opt_cfg,
            model_cfg=cfg)
        metrics = {"loss": loss, **parts, **om}
        return params, opt_state, metrics

    return train_step


def make_eval_step(api: ModelApi, cfg: ModelConfig, recipe=None):
    loss_fn = make_loss_fn(api, cfg, recipe)

    def eval_step(params, batch):
        with torch.no_grad():
            loss, parts = loss_fn(params, batch)
        return {"loss": loss, **parts}

    return eval_step
