"""Model configuration. Port of ``repro/models/config.py``, cut to the
dense GQA family this port slice runs; the MoE, MLA, VLM, recurrent and
encoder-decoder fields come with their slices."""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # -- attention ----------------------------------------------------------
    attention: Literal["gqa"] = "gqa"
    qkv_bias: bool = False
    rope_theta: float = 10_000.0

    # -- norms / embeddings ---------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # -- execution --------------------------------------------------------------
    dtype: str = "bfloat16"
    kv_cache_dtype: Literal["bfloat16"] = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]
