"""Model configuration. Port of ``repro/models/config.py``, cut to the
dense GQA and MoE families the port runs; the MLA, VLM, recurrent and
encoder-decoder fields come with their slices. The MoE fields that belong
to later slices (shared experts and leading dense layers: DeepSeek-V2;
the int8 dispatch all-to-all: multi-GPU) raise ``NotImplementedError``
when set."""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe"]
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

    # -- MoE ------------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 2
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    dispatch_groups: int = 1
    num_shared_experts: int = 0     # DeepSeek-V2 slice
    first_dense_layers: int = 0     # DeepSeek-V2 slice
    moe_int8_dispatch: bool = False  # multi-GPU slice (the all-to-all)

    # -- norms / embeddings ---------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # -- execution --------------------------------------------------------------
    dtype: str = "bfloat16"
    # "int8": int8 codes plus f32 per-token, per-head scales; any other
    # value: a cache in the activation dtype (the reference's rule)
    kv_cache_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        for name, slice_ in (("num_shared_experts", "DeepSeek-V2"),
                             ("first_dense_layers", "DeepSeek-V2"),
                             ("moe_int8_dispatch", "multi-GPU")):
            if getattr(self, name):
                raise NotImplementedError(
                    f"{self.name}: {name} comes with the {slice_} port slice")

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]
