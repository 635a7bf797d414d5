"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, a gated cross-attention layer every 5th layer over 1600
image tokens [hf:meta-llama/Llama-3.2-Vision]. Port of
``repro/configs/llama32_vision_90b.py``, field for field.

The port copies the reference's stub: there is no vision tower, and the
caller gives the patch embeddings (B, num_image_tokens, d_model) as the
model's ``memory``.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=28672, vocab_size=128256, head_dim=128,
        rope_theta=500_000.0,
        cross_attn_every=5, num_image_tokens=1600,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke", family="vlm",
        num_layers=5, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=64,
        cross_attn_every=5, num_image_tokens=16,
        q_chunk=16, kv_chunk=16,
    )


register_arch("llama-3.2-vision-90b", full, smoke)
