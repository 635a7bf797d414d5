"""minicpm3-4b [dense, MLA]: 62L d_model=2560 40H d_ff=6400 vocab=73448,
multi-head latent attention (q_lora 768, kv_lora 256, rope 32, nope 64,
v 64) [hf:openbmb/MiniCPM3-4B]. Port of ``repro/configs/minicpm3_4b.py``,
field for field.

Where the reference departs from the published model, the port copies it:
no YaRN-style rope scaling, ``norm_eps`` 1e-5, and none of MiniCPM3's
embedding scaling (``scale_emb``) or depth scaling of the residual
branches (``scale_depth``) [hf:openbmb/MiniCPM3-4B].
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense",
        num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
        d_ff=6400, vocab_size=73448,
        attention="mla", q_lora_rank=768, kv_lora_rank=256,
        qk_rope_dim=32, qk_nope_dim=64, v_head_dim=64,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-smoke", family="dense",
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=4,
        d_ff=512, vocab_size=512,
        attention="mla", q_lora_rank=128, kv_lora_rank=128,
        qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32,
        q_chunk=16, kv_chunk=16,
    )


register_arch("minicpm3-4b", full, smoke)
