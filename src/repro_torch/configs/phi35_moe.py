"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8)
expert d_ff=6400 vocab=32064, MoE 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct]. Port of ``repro/configs/phi35_moe.py``
(the smoke config's chunk sizes are the reference's; GQA's prefill
attention is one kernel and does not read them)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=6400, vocab_size=32064, head_dim=128,
        num_experts=16, top_k=2, moe_d_ff=6400,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke", family="moe",
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=64,
        q_chunk=16, kv_chunk=16,
        num_experts=4, top_k=2, moe_d_ff=256,
    )


register_arch("phi3.5-moe-42b-a6.6b", full, smoke)
