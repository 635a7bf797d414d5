"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256: the small LLaMA-3 [hf:meta-llama/Llama-3.2; unverified].
Port of ``repro/configs/llama32_3b.py`` (the smoke config's chunk sizes
are the reference's; GQA's prefill attention is one kernel and does not
read them)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
        d_ff=8192, vocab_size=128256, head_dim=128,
        rope_theta=500_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b-smoke", family="dense",
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=64,
        q_chunk=16, kv_chunk=16,
    )


register_arch("llama3.2-3b", full, smoke)
