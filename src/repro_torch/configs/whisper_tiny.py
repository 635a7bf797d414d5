"""whisper-tiny [audio]: 4 encoder + 4 decoder layers, d_model=384, 6 heads
of 64, d_ff=1536, vocab=51865, 1500 frames [arXiv:2212.04356]. Port of
``repro/configs/whisper_tiny.py``, field for field.

The port copies the reference's stub: there is no mel-spectrogram conv
stem, and the caller gives the frame embeddings (B, encoder_seq, d_model)
as the model's ``memory``.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio",
        num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
        d_ff=1536, vocab_size=51865, head_dim=64,
        is_encoder_decoder=True, num_encoder_layers=4, encoder_seq=1500,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, head_dim=32,
        is_encoder_decoder=True, num_encoder_layers=2, encoder_seq=24,
        q_chunk=16, kv_chunk=16,
    )


register_arch("whisper-tiny", full, smoke)
