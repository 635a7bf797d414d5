"""The assigned input-shape grid and each (arch x shape) cell's input specs.
Port of ``repro/configs/shapes.py``.

Every shape cell maps to stand-ins that allocate nothing: tensors on the
``meta`` device (the reference's are ``jax.ShapeDtypeStruct``), for the
step function the cell runs:
  * train_*   -> ``train_step``  : {tokens, labels} (+ modality stubs)
  * prefill_* -> ``prefill_step``: {tokens} + zero cache
  * decode_* / long_* -> ``serve_step``: {tokens (B,1)} + full cache + pos
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k":
        if cfg.family in ("ssm", "hybrid"):
            return True, "sub-quadratic (O(1)/O(window) decode state)"
        return False, (
            "full softmax attention: a 524288-token dense KV cache is "
            "architecturally quadratic in attention reads; skipped per "
            "assignment (see DESIGN.md §5)")
    return True, ""


def _stub(shape: tuple, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: Shape) -> dict:
    """Model inputs (not params or cache: those come from ParamSpec
    trees), as ``meta`` tensors; tokens and labels int32, the modality
    stubs in the config's activation dtype."""
    B = shape.batch
    dt = cfg.activation_dtype
    out: dict = {}
    if shape.kind == "train":
        out["tokens"] = _stub((B, shape.seq))
        out["labels"] = _stub((B, shape.seq))
    elif shape.kind == "prefill":
        out["tokens"] = _stub((B, shape.seq))
    else:  # decode
        out["tokens"] = _stub((B, 1))
    # modality stubs (assignment: the frontend is a stub)
    if cfg.family == "vlm" and shape.kind != "decode":
        out["image_embeds"] = _stub((B, cfg.num_image_tokens, cfg.d_model),
                                    dt)
    if cfg.family == "audio" and shape.kind != "decode":
        out["frames"] = _stub((B, cfg.encoder_seq, cfg.d_model), dt)
    return out


def memory_arg(cfg: ModelConfig, inputs: dict):
    """The modality-stub memory the model's forward takes as ``memory``."""
    return inputs.get("image_embeds", inputs.get("frames"))
