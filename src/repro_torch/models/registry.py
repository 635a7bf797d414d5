"""--arch <id> registry: family -> model implementation, uniform API. Port
of ``repro/models/registry.py``.

Every implementation exposes
    param_specs(cfg, recipe) -> ParamSpec tree
    cache_specs(cfg, batch, max_seq) -> ParamSpec tree (decode state)
    build(cfg, params, recipe) -> nn.Module, called as
        module(tokens, mode=, cache=, pos=) -> (logits f32, cache, aux)
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    param_specs: Callable
    cache_specs: Callable
    build: Callable


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense and moe only)")
    mod = importlib.import_module("repro_torch.models.transformer")
    return ModelApi(mod.param_specs, mod.cache_specs, mod.build)


# -- architecture configs (populated by repro_torch.configs) -----------------

_ARCH_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register_arch(name: str, full: Callable[[], ModelConfig],
                  smoke: Callable[[], ModelConfig]) -> None:
    _ARCH_REGISTRY[name] = full
    _SMOKE_REGISTRY[name] = smoke


def get_arch(name: str, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers every arch)

    reg = _SMOKE_REGISTRY if smoke else _ARCH_REGISTRY
    if name not in reg:
        raise KeyError(f"unknown arch '{name}'; have {sorted(reg)}")
    return reg[name]()
