"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064: GQA with QKV bias [arXiv:2407.10671; hf]. Port of
``repro/configs/qwen2_72b.py`` (the smoke config's chunk sizes are the
reference's; GQA's prefill attention is one kernel and does not read
them)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", family="dense",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=29568, vocab_size=152064, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-smoke", family="dense",
        num_layers=4, d_model=256, num_heads=8, num_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32,
        qkv_bias=True, q_chunk=16, kv_chunk=16,
    )


register_arch("qwen2-72b", full, smoke)
