"""``repro_torch.launch.dryrun`` against the JAX reference's dry-run.

* Per-device bytes, exactly: for every (arch x shape x mesh) cell, the
  port's ``memory`` (params, AdamW state, cache, inputs and their sum)
  equals the bytes of the reference's own specs under its partition
  specs (each leaf's local shard shape times its item size), and the
  skipped cells and their reasons are the reference's. The meshes here
  are stand-ins of the production meshes' names and sizes:
  ``build_cell`` reads nothing else of a mesh (the real ``DeviceMesh``
  placements are ``tests/test_torch_sharding.py``'s).
* The CLI end to end in a subprocess (``whisper-tiny`` x ``train_4k``,
  single pod, over the ``"fake"`` group of 256 ranks), ``--mesh host``
  refused without a GPU, and an erring cell recorded with exit code 1.
* ``flops_counted`` of a dense smoke model's forward against a count by
  hand from its config, and the counts carried over depth (and xLSTM's
  over length) against direct counts.
* ``slow`` (not tier-1): the port's ``argument_bytes`` against the
  reference's compiled ``memory_analysis`` for ``whisper-tiny`` x
  ``train_4k`` on (16, 16).

    PYTHONPATH=src python -m pytest tests/test_torch_dryrun.py -q
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro.configs import shapes as jshapes
from repro.core.recipe import DEFAULT_RECIPE as J_DEFAULT
from repro.distributed import sharding as jshard
from repro.models.registry import get_arch as jget_arch
from repro.models.registry import get_model as jget_model
from repro.training import optimizer as JO
from repro_torch.configs.shapes import SHAPES, Shape
from repro_torch.launch import dryrun as D
from repro_torch.models.registry import get_arch, get_model, list_archs
from repro_torch.nn import spec as S
from torch_sharding_common import (MULTI, SINGLE, ref_shard_bytes,
                                   ref_tree_bytes)

ROOT = Path(__file__).resolve().parents[1]


def stand_in_mesh(sizes: dict):
    """The names and sizes of a production mesh, without a process
    group."""
    return types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 mesh=torch.empty(tuple(sizes.values()),
                                                  device="meta"))


def reference_memory(arch: str, shape: str, multi_pod: bool) -> dict:
    """The reference's per-device bytes of a cell, from its own specs."""
    jcfg, shp = jget_arch(arch), jshapes.SHAPES[shape]
    japi, sizes = jget_model(jcfg), MULTI if multi_pod else SINGLE
    rules = jshard.rules_for(shp.kind, multi_pod)
    jp = japi.param_specs(jcfg, None if shp.kind == "train" else J_DEFAULT)
    out = {"param_bytes": ref_tree_bytes(jp, rules, sizes), "opt_bytes": 0,
           "cache_bytes": 0}
    if shp.kind == "train":
        out["opt_bytes"] = ref_tree_bytes(JO.state_specs(jp), rules, sizes)
    else:
        out["cache_bytes"] = ref_tree_bytes(
            japi.cache_specs(jcfg, shp.batch, shp.seq), rules, sizes)
    bsz = sizes.get("pod", 1) * sizes["data"]
    b = jshard.batch_axes(multi_pod)
    inp = 0
    for v in jshapes.input_specs(jcfg, shp).values():
        p = (b,) if v.shape and v.shape[0] % bsz == 0 else ()
        inp += ref_shard_bytes(v.shape, v.dtype, p, sizes)
    if shp.kind == "decode":
        inp += 4  # the replicated int32 scalar ``pos`` argument
    out["input_bytes"] = inp
    out["argument_bytes"] = sum(out.values())
    return out


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_per_device_bytes_equal_the_reference(arch, shape, multi_pod):
    mesh = stand_in_mesh(MULTI if multi_pod else SINGLE)
    rec = D.run_cell(arch, shape, mesh, multi_pod, collect_hlo=False)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    ok, reason = jshapes.shape_applicable(jget_arch(arch),
                                          jshapes.SHAPES[shape])
    if not ok:
        assert rec == {"arch": arch, "shape": shape, "mesh": rec["mesh"],
                       "multi_pod": multi_pod, "status": "skipped",
                       "reason": reason}
        return
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["memory"] == reference_memory(arch, shape, multi_pod)
    assert rec["param_count"] == jget_arch(arch).param_count_estimate()
    if SHAPES[shape].kind != "train":
        assert rec["qcert_worst"] in ("certified", "capped-alpha")


def test_dispatch_groups_follow_the_data_ways():
    mesh = stand_in_mesh(SINGLE)
    for shape, groups in (("train_4k", 16), ("decode_32k", 16),
                          ("prefill_32k", 16)):
        cell = D.build_cell("mixtral-8x7b", shape, mesh, False)
        assert cell.cfg.dispatch_groups == groups
    odd = Shape("odd", "decode", 64, 3)
    assert D.build_cell("mixtral-8x7b", odd, mesh, False) \
        .cfg.dispatch_groups == 1
    cell = D.build_cell("mixtral-8x7b", "decode_32k", stand_in_mesh(MULTI),
                        True)
    assert cell.cfg.dispatch_groups == 32


def test_the_cli_end_to_end(tmp_path):
    out = tmp_path / "cell.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "train_4k", "--multi-pod", "single",
         "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "[16x16] whisper-tiny x train_4k: ok args/dev=" in res.stdout
    assert "done: 1 ok, 0 skipped, 0 errors" in res.stdout
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"] == reference_memory("whisper-tiny", "train_4k",
                                             False)
    assert rec["cost"]["flops_counted"] > 0
    assert rec["cost"]["flops_from"] == "one step"


def test_host_mesh_is_refused_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is of a host without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        D.main(["--mesh", "host", "--arch", "whisper-tiny", "--shape",
                "train_4k", "--out", str(tmp_path / "x.jsonl")])


def test_an_erring_cell_is_recorded_and_the_run_exits_1(tmp_path,
                                                        monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(D, "build_cell", broken)
    out = tmp_path / "x.jsonl"
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "whisper-tiny", "--shape", "all", "--multi-pod",
                "single", "--out", str(out), "--no-hlo"])
    assert e.value.code == 1
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["error"] * 3 + ["skipped"]
    assert recs[0]["error"] == "RuntimeError: injected"
    assert not torch.distributed.is_initialized()


def test_flops_of_a_dense_forward_equal_a_count_by_hand():
    """llama3.2-3b's smoke config (GQA), fp, one train-
    mode forward of B x Sq tokens on ``meta``: every linear 2 M K N, the
    attention plain version's two einsums over all Sq x Sq scores (each
    query head against its repeated KV head: 2 B Hq Sq Sq D each), the
    logit head 2 M d V."""
    cfg = get_arch("llama3.2-3b", smoke=True)
    api = get_model(cfg)
    B, Sq = 2, 24
    model = api.build(cfg, S.abstract(api.param_specs(cfg, None)), None)
    tokens = torch.empty((B, Sq), dtype=torch.int32, device="meta")
    got = D.count_flops(lambda: model(tokens, mode="train"))
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    Hq, Hkv, hd, M = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, B * Sq
    layer = (2 * M * d * (Hq * hd) * 2 + 2 * M * d * (Hkv * hd) * 2
             + 2 * M * d * f * 3 + 2 * 2 * B * Hq * Sq * Sq * hd)
    assert Hkv < Hq
    assert got == cfg.num_layers * layer + 2 * M * d * V


@pytest.mark.parametrize("arch,layers,kind,seq", [
    ("llama3.2-3b", 6, "train", 64), ("deepseek-v2-236b", 12, "prefill", 64),
    ("recurrentgemma-9b", 11, "train", 32),
    ("llama-3.2-vision-90b", 15, "prefill", 32),
    ("xlstm-1.3b", 12, "prefill", 40)])
def test_extrapolated_flops_equal_a_direct_count(arch, layers, kind, seq):
    """A cell's flops counted at 1 and 2 repeats of its layer pattern
    (and, for xLSTM, at SEQ_PROBE and twice that many tokens) and carried
    to its depth and length equal a direct count of its step (smoke
    widths, the depth set so the pattern repeats at least 3 times)."""
    mesh = stand_in_mesh(SINGLE)
    cfg = dataclasses.replace(get_arch(arch, smoke=True), num_layers=layers)
    shp = Shape("t", kind, seq, 16)
    cell = D.build_cell(cfg, shp, mesh, False)
    got, how = D.cell_flops(shp, mesh, False, cell)
    assert how.startswith("affine in layer repeats")
    assert ("affine in seq" in how) == (arch == "xlstm-1.3b")
    assert got == D.count_flops(cell.step)


def test_chunked_mlstm_flops_are_counted_at_the_cells_length():
    """The chunked mLSTM's intra-chunk work grows as the chunk's length
    squared, so its step is not affine in length: the count is carried
    over depth only, and equals a direct count (xLSTM smoke widths, 12
    layers, 64 tokens in chunks of 32 where a SEQ_PROBE x 2 probe would
    run one chunk of 32)."""
    mesh = stand_in_mesh(SINGLE)
    cfg = dataclasses.replace(get_arch("xlstm-1.3b", smoke=True),
                              num_layers=12, mlstm_impl="chunked",
                              chunk_size=2 * D.SEQ_PROBE)
    shp = Shape("t", "prefill", 4 * D.SEQ_PROBE, 16)
    cell = D.build_cell(cfg, shp, mesh, False)
    got, how = D.cell_flops(shp, mesh, False, cell)
    assert how.startswith("affine in layer repeats")
    assert "affine in seq" not in how
    assert got == D.count_flops(cell.step)


def test_the_fake_backend_is_there():
    """``--mesh production`` stands on torch's private ``fake_pg`` module:
    this fails first, by name, if a torch moves it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert isinstance(D.fake_store(), FakeStore)


def test_a_missing_fake_backend_is_named(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match=torch.__version__.replace(
            "+", r"\+")):
        D.fake_store()


@pytest.mark.slow  # the reference's 256-device lower + compile (~15 s)
def test_argument_bytes_equal_the_references_compiled(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    recs = {}
    for pkg in ("repro", "repro_torch"):
        out = tmp_path / f"{pkg}.jsonl"
        res = subprocess.run(
            [sys.executable, "-m", f"{pkg}.launch.dryrun", "--arch",
             "whisper-tiny", "--shape", "train_4k", "--multi-pod", "single",
             "--out", str(out), "--no-hlo"],
            capture_output=True, text=True, timeout=560, env=env,
            cwd=str(ROOT))
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
        recs[pkg] = json.loads(out.read_text().splitlines()[-1])
    print("reference compiled argument_bytes",
          recs["repro"]["memory"]["argument_bytes"], "port",
          recs["repro_torch"]["memory"]["argument_bytes"])
    assert recs["repro_torch"]["memory"]["argument_bytes"] == \
        recs["repro"]["memory"]["argument_bytes"]
