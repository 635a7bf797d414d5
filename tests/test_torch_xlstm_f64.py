"""Whether xLSTM's train-step gradient gap between the port and the
reference is f32 rounding (``tests/test_torch_train_recurrent.py`` holds
xLSTM's gradient leaves to 3e-5, other families to 1e-5).

Both packages' xLSTM, norm and loss code compute in f32 whatever the
model's dtype, so a copy of ``src/`` is made in which those modules
compute in f64 (``jnp.float32`` -> ``jnp.float64`` in the reference's
``models/xlstm.py``, ``models/common.py`` and ``training/train_step.py``,
under ``jax_enable_x64``; ``.float()`` -> ``.double()`` and
``torch.float32`` -> ``torch.float64`` in the port's three, and a
"float64" dtype in its ``models/config.py``), and the smoke xLSTM's step-0 gradients are taken in each package
from the port's seed-0 params on the same batch. If the algorithms agree,
the f64 gap falls to f64 rounding; a gap that stays is a fault.
Measured: worst leaf ``||dg|| / ||g||`` 1.4e-14 under ``scan`` and
1.8e-14 under ``chunked`` (8.4e-6 and 5.1e-6 in f32).

    PYTHONPATH=src python -m pytest -m slow tests/test_torch_xlstm_f64.py -s
"""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_EDITS = {
    "repro/models/xlstm.py": [(r"jnp\.float32", "jnp.float64")],
    "repro/models/common.py": [(r"jnp\.float32", "jnp.float64")],
    "repro/training/train_step.py": [(r"jnp\.float32", "jnp.float64")],
    "repro_torch/models/xlstm.py": [(r"\.float\(\)", ".double()"),
                                    (r"torch\.float32", "torch.float64")],
    "repro_torch/models/common.py": [(r"\.float\(\)", ".double()")],
    "repro_torch/training/train_step.py": [
        (r"torch\.float32", "torch.float64")],
    "repro_torch/models/config.py": [
        (r'"float32": torch\.float32,',
         '"float32": torch.float32, "float64": torch.float64,')],
}

_RUN = r"""
import dataclasses, json, sys
import numpy as np
dtype, impl = sys.argv[1], sys.argv[2]
import jax
jax.config.update("jax_enable_x64", dtype == "float64")
import jax.numpy as jnp
import torch
from repro.models.registry import get_arch as jget_arch
from repro.models.registry import get_model as jget_model
from repro.training import train_step as JT
from repro_torch import convert
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.models.registry import get_arch, get_model
from repro_torch.nn import spec as S
from repro_torch.training import train_step as T
torch.set_num_threads(1)
kw = dict(dtype=dtype, remat=False)
if impl == "chunked":
    kw.update(mlstm_impl="chunked", chunk_size=8)
jcfg = dataclasses.replace(jget_arch("xlstm-1.3b", smoke=True), **kw)
cfg = dataclasses.replace(get_arch("xlstm-1.3b", smoke=True), **kw)
f32 = dataclasses.replace(cfg, dtype="float32")
tdt = {"float32": torch.float32, "float64": torch.float64}[dtype]
params = S.tree_map(lambda t: t.to(tdt), S.materialize(
    get_model(f32).param_specs(f32), torch.Generator().manual_seed(0),
    device="cpu"))
ref = jax.tree.map(lambda a: jnp.asarray(a, dtype),
                   convert.to_reference(params, cfg))
b = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=40,
                                 batch_size=2)).global_batch(0)
(jl, _), jg = jax.value_and_grad(JT.make_loss_fn(jget_model(jcfg), jcfg),
                                 has_aux=True)(
    ref, {k: jnp.asarray(v) for k, v in b.items()})
leaves = S.leaves(params)
for t in leaves:
    t.requires_grad_(True)
loss, _ = T.make_loss_fn(get_model(cfg), cfg)(
    params, {k: torch.from_numpy(v) for k, v in b.items()})
g = iter(torch.autograd.grad(loss, leaves))
mine = convert.to_reference(S.tree_map(lambda _: next(g), params), cfg)


def flat(t, p=""):
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{p}/{k}"))
        return out
    return {p: np.asarray(t, np.float64)}


a, r = flat(mine), flat(jax.tree.map(np.asarray, jg))
rel = {k: float(np.linalg.norm(a[k] - r[k]) / max(np.linalg.norm(r[k]),
                                                   1e-300)) for k in r}
worst = max(rel, key=rel.get)
print(json.dumps({"loss_rel": abs(float(loss) - float(jl)) / abs(float(jl)),
                  "worst_leaf": worst, "worst_rel": rel[worst]}))
"""


def _f64_tree(dst: Path) -> Path:
    src = dst / "src"
    shutil.copytree(ROOT / "src", src,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, edits in _EDITS.items():
        path = src / rel
        text = path.read_text()
        for pat, rep in edits:
            text, n = re.subn(pat, rep, text)
            assert n, (rel, pat)
        path.write_text(text)
    return src


@pytest.mark.slow  # two copies of both packages' models in f64 (~40 s)
@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_xlstm_gradients_agree_in_f64(tmp_path, impl):
    runs = {}
    for dtype, src in (("float32", ROOT / "src"),
                       ("float64", _f64_tree(tmp_path))):
        res = subprocess.run(
            [sys.executable, "-c", _RUN, dtype, impl], capture_output=True,
            text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(src)))
        assert res.returncode == 0, res.stderr[-3000:]
        runs[dtype] = json.loads(res.stdout.strip().splitlines()[-1])
    print(impl, runs)
    assert runs["float32"]["worst_rel"] <= 3e-5  # the train test's bound
    assert runs["float64"]["worst_rel"] <= 1e-12
    assert runs["float64"]["loss_rel"] <= 1e-14
