"""The paper's own model family. Port of ``repro/configs/paper_llama.py``:
LLaMA-2-7B at its published widths, its smoke cut, and the two small
llama-style LMs the quantization benchmarks use."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
        d_ff=11008, vocab_size=32000, head_dim=128,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b-smoke", family="dense",
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=4,
        d_ff=512, vocab_size=512, head_dim=64,
        q_chunk=16, kv_chunk=16,
    )


def tiny_lm() -> ModelConfig:
    """~100M llama-style LM; all K dims are multiples of 128."""
    return ModelConfig(
        name="tiny-lm-100m", family="dense",
        num_layers=14, d_model=768, num_heads=12, num_kv_heads=12,
        d_ff=2048, vocab_size=512, head_dim=64, dtype="float32",
        q_chunk=64, kv_chunk=64, remat=False,
    )


register_arch("llama2-7b", full, smoke)


def bench_lm() -> ModelConfig:
    """~30M llama-style LM; K dims (512, 1536) are multiples of 128."""
    return ModelConfig(
        name="bench-lm-30m", family="dense",
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=8,
        d_ff=1536, vocab_size=512, head_dim=64, dtype="float32",
        q_chunk=512, kv_chunk=512, remat=False,
    )
