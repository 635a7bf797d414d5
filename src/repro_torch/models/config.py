"""Model configuration. Port of ``repro/models/config.py``: dense and MoE
with GQA or MLA attention, the VLM (cross-attention layers every
``cross_attn_every``-th layer), the encoder-decoder ("audio", Whisper),
xLSTM ("ssm") and RecurrentGemma / Griffin ("hybrid")."""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "vlm", "ssm", "hybrid", "audio"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # -- attention ----------------------------------------------------------
    attention: Literal["gqa", "mla"] = "gqa"
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # chunk sizes of the chunked attention MLA's prefill runs
    # (``models.attention.chunked_attention``); GQA's prefill is one kernel
    q_chunk: int = 512
    kv_chunk: int = 1024

    # -- MLA (MiniCPM3 / DeepSeek-V2) -----------------------------------------
    q_lora_rank: int = 0     # 0 -> direct q projection
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # -- MoE ------------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 2
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    dispatch_groups: int = 1
    num_shared_experts: int = 0     # an always-on MLP of this many experts
    first_dense_layers: int = 0     # leading dense blocks (DeepSeek-V2: 1)
    # the dispatch buffer rounded through int8 per row, as the reference
    # compresses its all-to-all (``models.moe``)
    moe_int8_dispatch: bool = False

    # -- VLM (Llama-3.2-Vision) -------------------------------------------------
    cross_attn_every: int = 0       # every k-th layer is cross-attention
    num_image_tokens: int = 0

    # -- hybrid (RecurrentGemma / Griffin) ------------------------------------
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    window: int = 2048                   # local-attention window
    conv_width: int = 4
    lru_c: float = 8.0

    # -- xLSTM ----------------------------------------------------------------
    slstm_every: int = 8            # every k-th block is sLSTM (7:1 ratio)
    mlstm_proj_factor: float = 2.0
    chunk_size: int = 256           # mLSTM chunkwise-parallel chunk
    mlstm_impl: str = "scan"        # "scan" (exact recurrence) | "chunked"

    # -- encoder-decoder (Whisper) ----------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500         # frame embeddings the encoder takes
    max_positions: int = 32768      # the decoder's learned-position table

    # -- norms / embeddings ---------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # -- execution --------------------------------------------------------------
    dtype: str = "bfloat16"
    # "int8": int8 codes plus f32 per-token, per-head scales; any other
    # value: a cache in the activation dtype (the reference's rule)
    kv_cache_dtype: str = "bfloat16"
    # train mode with grad enabled recomputes each block in the backward
    # (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
    remat: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]
