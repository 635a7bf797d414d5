"""``repro_torch.nn.spec``'s sharding half, ``distributed/sharding.py``,
``launch/mesh.py`` and ``checkpoint.manager.restore(shardings=)`` against
the JAX reference's.

* ``logical_to_pspec``: the reference's three cases
  (``tests/test_substrate.py``) and random axes, rules, sizes and shapes
  (Hypothesis) against ``repro.nn.spec.logical_to_pspec``.
* Every arch (full and smoke, fp and under ``DEFAULT_RECIPE``): each
  param, cache and AdamW-state leaf's shape, dtype and logical axes equal
  the reference's without its leading "layers" axis (the port keeps one
  tree per layer), and its partition spec equals the reference's under
  ``train_rules`` and ``serve_rules``, single-pod and multi-pod.
* Placements on a ``DeviceMesh`` of 256 and 512 ranks over a ``"fake"``
  process group: each DTensor's local shape is ``local_shape``'s.
* ``restore(shardings=)`` on two gloo ranks (subprocesses): each rank
  holds the slice the reference's ``NamedSharding`` would give it.
* The kernel wrappers' device rule: ``meta`` and ``cpu`` tensors take the
  plain version, any other device raises.
* Every cache leaf of every family has ``cache_batch`` at axis 0, which
  the engine's ``index_copy_(0, slot, ...)`` splice assumes.

    PYTHONPATH=src python -m pytest tests/test_torch_sharding.py -q
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.recipe import DEFAULT_RECIPE as J_DEFAULT
from repro.distributed import sharding as jshard
from repro.models.registry import get_arch as jget_arch
from repro.models.registry import get_model as jget_model
from repro.nn import spec as JS
from repro.training import optimizer as JO
from repro_torch.core.recipe import DEFAULT_RECIPE
from repro_torch.distributed import sharding as shard
from repro_torch.models.registry import get_arch, get_model, list_archs
from repro_torch.nn import spec as S
from repro_torch.training import optimizer as O
from torch_sharding_common import (MULTI, SINGLE, port_flat, port_leaf,
                                   ref_flat, ref_leaf, ref_pspec)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_archs()


# ---------------------------------------------------------------------------
# logical_to_pspec and the rule tables
# ---------------------------------------------------------------------------


def test_logical_to_pspec_divisibility_drop():
    sizes = {"data": 16, "model": 16}
    # kv=1 head can't shard 16 ways -> replicated on that dim
    p = S.logical_to_pspec(("cache_batch", "cache_seq", "heads_kv", None),
                           shard.serve_rules(False), sizes,
                           (128, 32768, 1, 128))
    assert p == S.PartitionSpec("data", "model")
    # divisible case shards
    p2 = S.logical_to_pspec(("embed", "mlp"), shard.train_rules(False),
                            sizes, (6144, 24576))
    assert p2 == S.PartitionSpec("data", "model")


def test_mesh_axis_used_once():
    sizes = {"data": 4, "model": 4}
    rules = (("a", "model"), ("b", "model"))
    p = S.logical_to_pspec(("a", "b"), rules, sizes, (16, 16))
    assert p == S.PartitionSpec("model")  # second use dropped


def test_multi_pod_rules_compose_pod_axis():
    sizes = {"pod": 2, "data": 16, "model": 16}
    p = S.logical_to_pspec(("embed", "mlp"), shard.train_rules(True),
                           sizes, (8192, 29568))
    assert p == S.PartitionSpec(("pod", "data"), "model")


def test_the_rule_tables_are_the_references():
    for mp in (False, True):
        assert shard.train_rules(mp) == jshard.train_rules(mp)
        assert shard.serve_rules(mp) == jshard.serve_rules(mp)
        for mode in ("train", "prefill", "decode"):
            assert shard.rules_for(mode, mp) == jshard.rules_for(mode, mp)
        assert shard.batch_axes(mp) == jshard.batch_axes(mp)


def test_partition_spec_is_an_immutable_leaf():
    p = S.PartitionSpec(("pod", "data"), None, "model")
    assert p == (("pod", "data"), None, "model") and len(p) == 3
    assert p[0] == ("pod", "data") and hash(p) == hash(S.PartitionSpec(
        ("pod", "data"), None, "model"))
    assert S.PartitionSpec() == () and p != S.PartitionSpec("model")
    with pytest.raises(AttributeError):
        p.x = 1
    assert S.leaves({"a": [p, S.PartitionSpec()]}) == [p, ()]
    with pytest.raises(ValueError, match="rank"):
        S.ParamSpec((2, 3), torch.float32, "zeros", ("embed",))


_NAMES = ["embed", "mlp", "heads_q", "vocab", "experts", "cache_batch"]
_MESH = ["pod", "data", "model"]


@settings(max_examples=200, deadline=None)
@given(st.data())
def test_logical_to_pspec_matches_the_reference(data):
    rank = data.draw(st.integers(0, 4))
    axes = tuple(data.draw(st.lists(st.sampled_from(_NAMES + [None]),
                                    min_size=rank, max_size=rank)))
    target = st.one_of(st.none(), st.sampled_from(_MESH),
                       st.lists(st.sampled_from(_MESH), min_size=1,
                                max_size=3, unique=True).map(tuple))
    rules = tuple(data.draw(st.lists(st.tuples(st.sampled_from(_NAMES),
                                               target), max_size=8)))
    sizes = {a: data.draw(st.sampled_from([1, 2, 3, 4, 16]))
             for a in _MESH}
    shape = tuple(data.draw(st.lists(st.sampled_from([1, 2, 6, 8, 32, 48]),
                                     min_size=rank, max_size=rank)))
    for sz, shp in ((sizes, shape), (None, None)):
        got = S.logical_to_pspec(axes, rules, sz, shp)
        want = JS.logical_to_pspec(axes, rules, sz, shp)
        assert tuple(got) == tuple(want), (axes, rules, sz, shp)


# ---------------------------------------------------------------------------
# Every arch's specs against the reference's
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _trees(arch: str, smoke: bool, quant: bool):
    """(port, reference) param, cache and AdamW-state spec trees."""
    cfg, jcfg = get_arch(arch, smoke=smoke), jget_arch(arch, smoke=smoke)
    api, japi = get_model(cfg), jget_model(jcfg)
    p = api.param_specs(cfg, DEFAULT_RECIPE if quant else None)
    jp = japi.param_specs(jcfg, J_DEFAULT if quant else None)
    return {"params": (p, jp),
            "cache": (api.cache_specs(cfg, 4, 64),
                      japi.cache_specs(jcfg, 4, 64)),
            "opt": (O.state_specs(p), JO.state_specs(jp))}


def _compare(port_tree, ref_tree, rules_pairs):
    ours, theirs = port_flat(port_tree), ref_flat(ref_tree)
    assert sorted(ours) == sorted(theirs)
    for path, (spec, stacked) in theirs.items():
        assert port_leaf(ours[path]) == ref_leaf(spec, stacked), path
        for rules, jrules, sizes in rules_pairs:
            got = tuple(S.logical_to_pspec(ours[path].logical_axes, rules,
                                           sizes, ours[path].shape))
            assert got == ref_pspec(spec, stacked, jrules, sizes), path


_RULES = [(shard.train_rules(mp), jshard.train_rules(mp), sizes)
          for mp, sizes in ((False, SINGLE), (True, MULTI))] + [
          (shard.serve_rules(mp), jshard.serve_rules(mp), sizes)
          for mp, sizes in ((False, SINGLE), (True, MULTI))]


@pytest.mark.parametrize("what,quant", [
    ("params", False), ("params", True), ("opt", False), ("opt", True),
    ("cache", False)], ids=["params-fp", "params-w4a8-is", "opt-fp",
                            "opt-w4a8-is", "cache"])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_axes_and_pspecs_equal_the_reference(arch, smoke, quant, what):
    port, ref = _trees(arch, smoke, quant)[what]
    _compare(port, ref, _RULES)


# ---------------------------------------------------------------------------
# Placements on a real DeviceMesh (fake process group)
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_group():
    from repro_torch.launch import dryrun

    groups = []

    def open_group(world: int):
        cm = dryrun.fake_group(world)
        cm.__enter__()
        groups.append(cm)

    yield open_group
    for cm in groups:
        cm.__exit__(None, None, None)


def _sample_specs():
    """Leaves that cover every rule: a dense, a MoE and an MLA layer (fp
    and W4A8), embeddings, heads, caches and an AdamW moment."""
    out = []
    for arch in ("llama2-7b", "mixtral-8x7b", "deepseek-v2-236b",
                 "granite-34b", "minicpm3-4b", "whisper-tiny"):
        for quant in (False, True):
            trees = _trees(arch, False, quant)
            p = trees["params"][0]
            blocks = p["dec"]["blocks"] if "dec" in p else p["blocks"]
            out += S.leaves({k: v for k, v in p.items()
                             if k not in ("blocks", "enc", "dec")})
            out += S.leaves(blocks[-1])
            out += S.leaves(trees["cache"][0])[:4]
    return out


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_dtensor_local_shapes_equal_local_shape(fake_group, multi_pod):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import axis_sizes, make_production_mesh

    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    sizes = axis_sizes(mesh)
    assert sizes == (MULTI if multi_pod else SINGLE)
    assert tuple(mesh.mesh_dim_names) == tuple(sizes)
    specs = _sample_specs()
    seen = set()
    for rules in (shard.train_rules(multi_pod), shard.serve_rules(multi_pod)):
        for s in specs:
            p = S.logical_to_pspec(s.logical_axes, rules, sizes, s.shape)
            seen.update(p)
            d = distribute_tensor(s.abstract(), mesh, S.placements(p, mesh))
            assert tuple(d.shape) == s.shape
            assert tuple(d.to_local().shape) == S.local_shape(
                s.shape, p, sizes), (s, p)
    assert "model" in seen and (("pod", "data") in seen if multi_pod
                                else "data" in seen)
    specs = _trees("llama2-7b", False, False)["params"][0]
    rules = shard.train_rules(multi_pod)
    tree = shard.named_tree(mesh, specs, rules)
    S.tree_map(lambda s, pl: _same(pl, S.placements(S.logical_to_pspec(
        s.logical_axes, rules, sizes, s.shape), mesh)), specs, tree)
    inp = {"tokens": torch.empty((256, 8), device="meta"),
           "odd": torch.empty((3, 8), device="meta"),
           "pos": torch.empty((), device="meta")}
    ps = shard.input_pspecs(mesh, inp, multi_pod)
    assert ps["tokens"] == (shard.batch_axes(multi_pod), None)
    assert ps["odd"] == () and ps["pos"] == ()
    pl = shard.input_shardings(mesh, inp, multi_pod)
    assert pl == {k: S.placements(p, mesh) for k, p in ps.items()}
    assert shard.replicated(mesh) == S.placements(S.PartitionSpec(), mesh)


def _same(a, b):
    assert a == b, (a, b)


def test_placements_split_a_dim_pod_major():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert S.placements(S.PartitionSpec(("pod", "data"), None, "model"),
                        mesh) == [Shard(0), Shard(0), Shard(2)]
    assert S.placements(S.PartitionSpec(None, "data"), mesh) == [
        Replicate(), Shard(1), Replicate()]
    assert S.local_shape((8192, 7, 29568), S.PartitionSpec(
        ("pod", "data"), None, "model"), MULTI) == (256, 7, 1848)
    with pytest.raises(ValueError, match="pod"):
        S.placements(S.PartitionSpec("pod"), types.SimpleNamespace(
            mesh_dim_names=("data", "model")))


def test_importing_the_mesh_module_opens_no_group():
    code = ("import torch.distributed as dist, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun, repro_torch.distributed.sharding; "
            "print(dist.is_initialized())")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"


def test_host_mesh_needs_a_gpu():
    from repro_torch.launch.mesh import make_host_mesh

    if torch.cuda.is_available():
        pytest.skip("this check is of a host without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()


# ---------------------------------------------------------------------------
# restore(shardings=) on two gloo ranks
# ---------------------------------------------------------------------------

_RANK_CODE = r"""
import json, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed import sharding as shard
from repro_torch.models.registry import get_arch, get_model
from repro_torch.nn import spec as S
rank, ckdir, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", rank=rank, world_size=2,
                        store=dist.FileStore(store, 2))
try:
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    cfg = get_arch("llama2-7b", smoke=True)
    specs = get_model(cfg).param_specs(cfg)
    shardings = shard.named_tree(mesh, specs, shard.train_rules(False))
    tree, meta = CheckpointManager(ckdir).restore(
        3, specs, shardings=shardings, mesh=mesh)
    full, _ = CheckpointManager(ckdir).restore(3, specs, device="cpu")
    rows = []
    for path, t, f in zip(range(10**6), S.leaves(tree), S.leaves(full)):
        rows.append({"local": t.to_local().tolist(), "shape": list(t.shape),
                     "placements": [str(p) for p in t.placements],
                     "full_equal": bool(torch.equal(t.full_tensor(), f))})
    json.dump({"rank": rank, "coord": mesh.get_coordinate(), "meta": meta,
               "rows": rows}, open(out, "w"))
finally:
    dist.destroy_process_group()
"""


def test_restore_with_shardings_gives_each_rank_the_references_slice(
        tmp_path):
    import numpy as np

    from repro_torch.checkpoint.manager import CheckpointManager

    cfg = get_arch("llama2-7b", smoke=True)
    specs = get_model(cfg).param_specs(cfg)
    params = S.materialize(specs, torch.Generator().manual_seed(3),
                           device="cpu")
    CheckpointManager(str(tmp_path / "ck")).save(3, params, {"step": 3})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_CODE, str(r), str(tmp_path / "ck"),
         str(tmp_path / "store"), str(tmp_path / f"rank{r}.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    pspecs = S.leaves(S.partition_specs(specs, shard.train_rules(False),
                                        {"data": 2, "model": 1}))
    sharded = 0
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["coord"] == [r, 0] and got["meta"] == {"step": 3}
        for row, full, p in zip(got["rows"], S.leaves(params), pspecs):
            assert row["shape"] == list(full.shape) and row["full_equal"]
            # NamedSharding(P(...)) on a (2, 1) ("data", "model") mesh:
            # device (r, 0) holds block r of each dim split over "data"
            want = full.float().numpy()
            for i, e in enumerate(p):
                if e == "data":
                    n = want.shape[i] // 2
                    want = np.take(want, range(r * n, (r + 1) * n), axis=i)
                    sharded += 1
            np.testing.assert_array_equal(
                np.asarray(row["local"], dtype=np.float32), want)
    assert sharded > 0


# ---------------------------------------------------------------------------
# The kernel wrappers' device rule
# ---------------------------------------------------------------------------


def _wrapper_calls():
    """(name, wrapper, CPU args, kwargs) for each of the 13 branches."""
    from repro_torch.core import packing
    from repro_torch.kernels import (act_quant, flash_attention, moe_gemm,
                                     w4a8_gemm, w4a8_gemm_fscale, w4a16_gemm)

    g = torch.Generator().manual_seed(0)
    M, K, N, E, C, gs = 4, 256, 128, 3, 8, 128
    x = torch.randn(M, K, generator=g)
    xq = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    sa = torch.rand(M, 1, generator=g)
    qv = packing.pack_int4(torch.randint(-8, 8, (K, N), generator=g,
                                         dtype=torch.int8))
    iscale = torch.randint(1, 64, (K // gs, N), generator=g,
                           dtype=torch.int32)
    fscale = torch.rand(K // gs, N, generator=g)
    xe = torch.randn(E, C, K, generator=g)
    xqe = torch.randint(-127, 128, (E, C, K), generator=g, dtype=torch.int8)
    sae = torch.rand(E, C, 1, generator=g)
    qve = torch.stack([qv] * E)
    ise, fse = torch.stack([iscale] * E), torch.stack([fscale] * E)
    counts = torch.tensor([8, 3, 0], dtype=torch.int32)
    q = torch.randn(1, 32, 2, 64, generator=g)
    k = torch.randn(1, 32, 1, 64, generator=g)
    out, lse = flash_attention.flash_attention_fwd(q, k, k)
    calls = [
        ("act_quant", act_quant.act_quant, (x,), {}),
        ("act_quant_routed", act_quant.act_quant_routed, (xe, counts), {}),
        ("flash_attention", flash_attention.flash_attention, (q, k, k), {}),
        ("w4a8_gemm_is", w4a8_gemm.fg_gemm_integer_scale,
         (xq, sa, qv, iscale), {"group_size": gs}),
        ("w4a8_gemm_fs", w4a8_gemm_fscale.fg_gemm_float_scale,
         (xq, sa, qv, fscale), {"group_size": gs}),
        ("w4a16_gemm", w4a16_gemm.w4a16_gemm, (x, qv, fscale),
         {"group_size": gs}),
        ("moe_w4a8_is", moe_gemm.fg_grouped_gemm_integer_scale,
         (xqe, sae, qve, ise), {"group_size": gs, "row_counts": counts}),
        ("moe_w4a8_fs", moe_gemm.fg_grouped_gemm_float_scale,
         (xqe, sae, qve, fse), {"group_size": gs, "row_counts": counts}),
        ("moe_w4a8_is_ragged", moe_gemm.fg_grouped_gemm_integer_scale_ragged,
         (xe, counts, qve, ise), {"group_size": gs}),
        ("moe_w4a8_fs_ragged", moe_gemm.fg_grouped_gemm_float_scale_ragged,
         (xe, counts, qve, fse), {"group_size": gs}),
        ("moe_w4a16", moe_gemm.grouped_w4a16_gemm, (xe, qve, fse),
         {"group_size": gs}),
        ("moe_w4a16_ragged", moe_gemm.grouped_w4a16_gemm_ragged,
         (xe, counts, qve, fse), {"group_size": gs}),
        ("flash_attention_bwd", flash_attention.flash_attention_bwd,
         (q, k, k, out, lse, torch.randn_like(out)), {}),
    ]
    return calls


def _same_layout(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_layout(x, y)
        return
    assert a.device.type == "meta" and b.device.type == "cpu"
    assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("case", range(13))
def test_wrappers_take_the_plain_version_on_meta_and_cpu(case):
    from repro_torch.kernels import _build

    calls = _wrapper_calls()
    assert len(calls) == 13, [c[0] for c in calls]
    name, fn, args, kw = calls[case]
    before = dict(_build.LAUNCHES)
    cpu = fn(*args, **kw)
    meta = fn(*(a.to("meta") for a in args),
              **{k: v.to("meta") if isinstance(v, torch.Tensor) else v
                 for k, v in kw.items()})
    _same_layout(meta, cpu)
    assert dict(_build.LAUNCHES) == before  # no kernel was counted
    other = types.SimpleNamespace(device=torch.device("xpu"),
                                  requires_grad=False)
    with pytest.raises(ValueError, match="expected CUDA, CPU or meta"):
        fn(other, *args[1:], **kw)


def test_takes_plain_is_the_one_device_rule():
    from repro_torch.kernels import _build

    assert _build.takes_plain("k", torch.empty(1)) is True
    assert _build.takes_plain("k", torch.empty(1, device="meta")) is True
    assert _build.takes_plain("k", types.SimpleNamespace(
        device=torch.device("cuda", 0))) is False
    for dev in ("xpu", "mps", "hpu"):
        with pytest.raises(ValueError, match=dev):
            _build.takes_plain("k", types.SimpleNamespace(
                device=torch.device(dev)))
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        _build.require_cuda("k", torch.empty(1, device="meta"))


# ---------------------------------------------------------------------------
# The engine's cache splice: cache_batch at axis 0
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_cache_leaf_has_cache_batch_at_axis_0(arch, kv):
    """The engine splices a slot's prefill into the batched cache with
    ``index_copy_(0, slot, ...)`` on every leaf; the reference looks the
    batch axis up by name. Every leaf's ``cache_batch`` is axis 0."""
    for smoke in (False, True):
        cfg = dataclasses.replace(get_arch(arch, smoke=smoke),
                                  kv_cache_dtype=kv)
        leaves = S.leaves(get_model(cfg).cache_specs(cfg, 3, 32))
        assert leaves
        for s in leaves:
            assert s.logical_axes[0] == "cache_batch", (arch, s)
            assert s.shape[0] == 3 and "cache_batch" not in \
                s.logical_axes[1:], (arch, s)
