"""granite-34b [dense]: 88L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576
vocab=49152: llama-arch code model [arXiv:2405.04324; hf]. Port of
``repro/configs/granite_34b.py`` (the smoke config's chunk sizes are the
reference's; GQA's prefill attention is one kernel and does not read
them)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", family="dense",
        num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
        d_ff=24576, vocab_size=49152, head_dim=128,
        rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-34b-smoke", family="dense",
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=1,
        d_ff=512, vocab_size=512, head_dim=64,
        q_chunk=16, kv_chunk=16,
    )


register_arch("granite-34b", full, smoke)
