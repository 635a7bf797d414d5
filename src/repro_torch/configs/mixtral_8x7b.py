"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) expert d_ff=14336
vocab=32000, MoE 8 experts top-2, the paper's §5.5 end-to-end serving
subject [hf:mistralai/Mixtral-8x7B-v0.1]. Port of
``repro/configs/mixtral_8x7b.py``.

The smoke shape keeps the 8-expert top-2 routing at CPU-friendly dims;
capacity_factor=4.0 = E/top_k makes the per-expert capacity cover every
routed token, so no token is ever dropped. The reference's chunk sizes and
remat flag have no counterpart in the port.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=32000, head_dim=128,
        rope_theta=1e6,
        num_experts=8, top_k=2, moe_d_ff=14336,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe",
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=64,
        num_experts=8, top_k=2, moe_d_ff=256,
        capacity_factor=4.0,
        dtype="float32", kv_cache_dtype="float32",
    )


register_arch("mixtral-8x7b", full, smoke)
