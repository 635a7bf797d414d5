"""deepseek-v2-236b [moe, MLA]: 60L d_model=5120 128H, MLA (q_lora 1536,
kv_lora 512, rope 64, nope 128, v 128), MoE 160 routed experts of d_ff
1536 top-6 plus 2 shared, the first layer dense (d_ff 12288 = 8x the
expert width), vocab 102400 [arXiv:2405.04434]. Port of
``repro/configs/deepseek_v2.py``, field for field.

Where the reference departs from the published model, the port copies it
[arXiv:2405.04434]: no YaRN rope scaling; ``norm_eps`` 1e-5; the router's
softmax gates renormalized over the top 6, with no routed scaling factor
and no device- or group-limited routing; capacity-based dispatch
(``capacity_factor`` 1.25, tokens past an expert's capacity dropped).
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
        d_ff=12288,  # the dense first layer; experts use moe_d_ff
        vocab_size=102400,
        attention="mla", q_lora_rank=1536, kv_lora_rank=512,
        qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
        num_experts=160, num_shared_experts=2, top_k=6, moe_d_ff=1536,
        first_dense_layers=1,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke", family="moe",
        num_layers=3, d_model=256, num_heads=4, num_kv_heads=4,
        d_ff=512, vocab_size=512,
        attention="mla", q_lora_rank=128, kv_lora_rank=128,
        qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32,
        num_experts=8, num_shared_experts=2, top_k=2, moe_d_ff=128,
        first_dense_layers=1, q_chunk=16, kv_chunk=16,
    )


register_arch("deepseek-v2-236b", full, smoke)
