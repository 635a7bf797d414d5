"""xlstm-1.3b [ssm]: 48 layers, d_model=2048, 4 heads, vocab=50304:
sLSTM and mLSTM blocks at 1:7 [arXiv:2405.04517]. Port of
``repro/configs/xlstm_1b3.py``, field for field.

Attention-free: its decode state is O(1) in the sequence length. As in the
reference, the mLSTM's q, k and v are dense (4096, 4096) linears, which
with the up (2048, 8192) and down (4096, 2048) projections make about
3.4 B linear parameters where the paper's model has 1.3 B.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        slstm_every=8, mlstm_proj_factor=2.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        num_layers=4, d_model=256, num_heads=2, num_kv_heads=2,
        d_ff=0, vocab_size=512, slstm_every=4,
    )


register_arch("xlstm-1.3b", full, smoke)
