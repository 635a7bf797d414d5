"""``repro_torch.configs.shapes`` (the input-shape grid and each cell's
input specs) against the JAX reference's ``repro.configs.shapes``, for
every registered arch (full configs) and every shape of ``SHAPES``.

Exact: the grid's fields, ``shape_applicable``'s verdict and reason,
``input_specs``' keys, shapes and dtypes (every tensor on the ``meta``
device: nothing allocated), and the entry ``memory_arg`` picks.

    PYTHONPATH=src python -m pytest tests/test_torch_shapes.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import shapes as jshapes
from repro.models.registry import get_arch as jget_arch
from repro.models.registry import list_archs as jlist_archs
from repro_torch.configs import shapes
from repro_torch.models.registry import get_arch, list_archs

ARCHS = jlist_archs()
_TORCH_OF = {"int32": torch.int32, "bfloat16": torch.bfloat16,
             "float32": torch.float32}


def test_the_grid_and_the_registry_equal_the_reference():
    assert list_archs() == ARCHS
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, s in jshapes.SHAPES.items():
        assert dataclasses.asdict(shapes.SHAPES[name]) == \
            dataclasses.asdict(s)
    from repro_torch import configs
    assert configs.input_specs is shapes.input_specs
    assert configs.shape_applicable is shapes.shape_applicable
    assert configs.SHAPES is shapes.SHAPES and configs.Shape is shapes.Shape


@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, shape):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    s, js = shapes.SHAPES[shape], jshapes.SHAPES[shape]
    assert shapes.shape_applicable(cfg, s) == \
        jshapes.shape_applicable(jcfg, js)
    got, want = shapes.input_specs(cfg, s), jshapes.input_specs(jcfg, js)
    assert list(got) == list(want)
    for k, w in want.items():
        t = got[k]
        assert isinstance(t, torch.Tensor) and t.device.type == "meta", k
        assert tuple(t.shape) == tuple(w.shape), k
        assert t.dtype == _TORCH_OF[str(np.dtype(w.dtype))], k
    mem, jmem = shapes.memory_arg(cfg, got), jshapes.memory_arg(jcfg, want)
    if jmem is None:
        assert mem is None
    else:
        key = next(k for k, v in want.items() if v is jmem)
        assert mem is got[key]
        assert key == {"vlm": "image_embeds", "audio": "frames"}[cfg.family]
