"""recurrentgemma-9b [hybrid]: 38 layers, d_model=4096, 16 heads over one
KV head (MQA) of 256, d_ff=12288, vocab=256000: RG-LRU and local
attention 2:1 (pattern rec, rec, attn), window 2048 [arXiv:2402.19427].
Port of ``repro/configs/recurrentgemma_9b.py``, field for field.

Its decode state is O(window): the local attention keeps a ring buffer of
``window`` keys and values.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        d_ff=12288, vocab_size=256_000, head_dim=256,
        block_pattern=("rec", "rec", "attn"), window=2048,
        logit_softcap=30.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid",
        num_layers=5, d_model=256, num_heads=4, num_kv_heads=1,
        d_ff=512, vocab_size=512, head_dim=64,
        block_pattern=("rec", "rec", "attn"), window=16,
        q_chunk=16, kv_chunk=16,
    )


register_arch("recurrentgemma-9b", full, smoke)
