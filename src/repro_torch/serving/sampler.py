"""Token samplers for the serving engine. Port of
``repro/serving/sampler.py``: greedy matches the reference exactly (first
maximal index); the stochastic branch draws from an explicit
``torch.Generator``, so its streams differ from JAX's PRNG."""
from __future__ import annotations

import torch


def sample(logits: torch.Tensor, generator: torch.Generator | None = None,
           *, temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (B, V) -> token ids (B,). temperature 0 => greedy."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < cutoff, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
