"""Deterministic synthetic-corpus data pipeline: a numpy-only copy of
``repro/data/pipeline.py`` (the port imports nothing of ``repro``).

Generator: a fixed random 2nd-order Markov chain over the vocab with
Zipfian marginals + periodic copy motifs, fully reproducible from
(seed, step, shard), so the same config gives the reference's prompts
token for token.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 512
    seq_len: int = 256
    batch_size: int = 32
    seed: int = 1234
    num_shards: int = 1  # data-parallel shards
    motif_period: int = 64


class SyntheticPipeline:
    """Stateless: batch(step, shard) is a pure function of the config."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # Zipfian unigram
        ranks = np.arange(1, V + 1)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # sparse bigram transitions: each token has ~8 likely successors
        succ = rng.integers(0, V, size=(V, 8))
        self._succ = succ
        # copy motif: fixed template inserted periodically
        self._motif = rng.integers(0, V, size=16)

    def _gen_tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        cfg = self.cfg
        V = cfg.vocab_size
        out = np.empty(n, np.int32)
        cur = int(rng.choice(V, p=self._unigram))
        for i in range(n):
            if i % cfg.motif_period < len(self._motif):
                out[i] = self._motif[i % cfg.motif_period]
                cur = int(out[i])
                continue
            if rng.random() < 0.8:  # follow the chain
                cur = int(self._succ[cur, rng.integers(0, 8)])
            else:  # resample from unigram
                cur = int(rng.choice(V, p=self._unigram))
            out[i] = cur
        return out

    def batch(self, step: int, shard: int = 0) -> dict[str, np.ndarray]:
        cfg = self.cfg
        per_shard = cfg.batch_size // cfg.num_shards
        rng = np.random.default_rng(
            (cfg.seed, step, shard))  # deterministic per (step, shard)
        toks = np.stack([
            self._gen_tokens(rng, cfg.seq_len + 1) for _ in range(per_shard)
        ])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def global_batch(self, step: int) -> dict[str, np.ndarray]:
        shards = [self.batch(step, s) for s in range(self.cfg.num_shards)]
        return {k: np.concatenate([s[k] for s in shards], 0)
                for k in shards[0]}

    def unigram_entropy(self) -> float:
        p = self._unigram
        return float(-(p * np.log(p)).sum())


def calib_batches(n: int = 2, *, vocab_size: int = 512, seq_len: int = 128,
                  batch_size: int = 8) -> list[dict[str, np.ndarray]]:
    """PTQ calibration batches: global batches 50_000 .. 50_000 + n - 1 of
    the synthetic stream (the benchmarks' calibration region, never
    trained on). The defaults are the ~30M bench LM's
    (``benchmarks/common.py`` ``calib_batches``)."""
    pipe = SyntheticPipeline(DataConfig(vocab_size=vocab_size,
                                        seq_len=seq_len,
                                        batch_size=batch_size))
    return [pipe.global_batch(50_000 + i) for i in range(n)]
