"""The 2-D ``(data, model)`` mesh's placement against the reference's pure
spec functions (``repro.sharding.specs``), and the mesh's own arithmetic.

``FedMesh`` values of shapes (2, 2), (1, 4) and (2, 16, 16) are built
without a process group (the specs read only their shape and axis
names); ``make_production_mesh`` and ``make_fed_mesh`` with a model axis
build over a ``fake`` world of 256 / 512 / 4 ranks made in a child
process, so this one keeps no process group.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.sharding import specs as jspecs
from repro_torch.fed import parallel
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.paper_models import mclr
from repro_torch.sharding import specs

SRC = Path(__file__).resolve().parents[1] / "src"
SHAPES = {"2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# the FEMNIST MLP-512 (784, 512, 62) and the mesh tests' mclr(16, 10),
# m-stacked
GROUP_LEAVES = {"w1": (5, 784, 512), "b1": (5, 512), "w2": (5, 512, 62),
                "b2": (5, 62), "w": (2, 16, 10), "b": (2, 10),
                "odd": (3, 7, 9)}


def _mesh(shape: dict, rank: int = 0) -> mesh_lib.FedMesh:
    world = int(np.prod(list(shape.values())))
    return mesh_lib.FedMesh(group=None, rank=rank, world=world,
                            shape=dict(shape), backend="gloo",
                            device=torch.device("cpu"),
                            axis_names=tuple(shape))


@pytest.mark.parametrize("name", list(SHAPES))
def test_specs_equal_the_reference(name):
    mesh = _mesh(SHAPES[name])
    axes = specs.data_axis_names(mesh)
    assert axes == jspecs.batch_axes(mesh) == tuple(
        a for a in ("pod", "data") if a in SHAPES[name])
    gp = {k: np.zeros(s, np.float32) for k, s in GROUP_LEAVES.items()}
    want = jspecs.group_param_specs(gp, mesh)
    got = specs.group_param_specs(gp, mesh)
    assert {k: tuple(v) for k, v in want.items()} == got
    for nd in (1, 2, 3, 4):
        assert specs.cohort_pspec(nd, axes) == tuple(
            jspecs.cohort_pspec(nd, axes))
        if nd >= 2:
            assert specs.block_staged_pspec(nd, axes) == tuple(
                jspecs.block_staged_pspec(nd, axes))
    assert parallel.mesh_data_shards(mesh) == np.prod(
        [SHAPES[name][a] for a in axes])


@pytest.mark.parametrize("name", list(SHAPES))
def test_model_dim_is_the_spec_s(name):
    M = SHAPES[name]["model"]
    for s in GROUP_LEAVES.values():
        spec = jspecs.group_param_pspec(s, M)
        d = specs.model_dim(s, M)
        assert (d is None) == ("model" not in tuple(spec))
        if d is not None:
            assert tuple(spec)[d] == "model"


def test_rank_places_and_rows_of_a_2x2_mesh():
    """Rank r sits at data slice r // 2 and model index r % 2; a cohort of
    8 is placed by slice (4 rows) and computed by rank (2 rows each);
    one the slices do not divide (7) is replicated."""
    got = []
    for r in range(4):
        m = _mesh(SHAPES["2x2"], r)
        got.append((m.data_index, m.model_index, m.cohort_rows(8),
                    m.compute_rows(8), m.compute_rows(7),
                    m.model_cols(4097)))
    assert got == [(0, 0, (0, 4), (0, 2), None, (0, 2048)),
                   (0, 1, (0, 4), (2, 4), None, (2048, 4097)),
                   (1, 0, (4, 8), (4, 6), None, (0, 2048)),
                   (1, 1, (4, 8), (6, 8), None, (2048, 4097))]
    m = _mesh(SHAPES["1x4"], 3)
    assert m.compute_rows(7) == (5, 7) and m.cohort_rows(7) == (0, 7)
    x = torch.arange(7)
    assert m.take_rows(x, 7).tolist() == [5, 6]
    m = _mesh(SHAPES["2x2"], 3)
    assert m.take_rows(torch.arange(8), 8).tolist() == [6, 7]
    assert m.take_rows(torch.arange(4, 8), 8).tolist() == [6, 7]   # slice


def test_param_layout_blocks_by_the_spec():
    """``ParamLayout.block`` keeps a rank's block of each divisible leaf,
    stacked or global, passes a leaf the spec leaves whole through, and
    refuses a leaf that is not whole (``whole`` one that is not a
    block)."""
    m = _mesh(SHAPES["2x16x16"], 17)              # model index 1
    lay = mesh_lib.ParamLayout(m, {"w1": (784, 512), "b1": (512,),
                                   "b2": (62,)})
    w1 = torch.arange(5 * 784 * 512, dtype=torch.float32).view(5, 784, 512)
    out = lay.block({"w1": w1, "b1": torch.zeros(5, 512),
                     "b2": torch.zeros(5, 62)})
    assert torch.equal(out["w1"], w1[:, 49:98])
    assert out["b1"].shape == (5, 32) and out["b2"].shape == (5, 62)
    with pytest.raises(ValueError, match="ParamLayout.block"):
        lay.block(out)
    with pytest.raises(ValueError, match="ParamLayout.whole"):
        lay.whole({"w1": w1})
    assert lay.block({"b2": out["b2"]})["b2"] is out["b2"]
    glob = lay.block({"w1": w1[0], "b1": torch.zeros(512)})
    assert glob["w1"].shape == (784, 32) and glob["b1"].shape == (512,)
    assert mesh_lib.param_layout(None, mclr(16, 10)) is None
    assert mesh_lib.param_layout(_mesh({"data": 2, "model": 1}),
                                 mclr(16, 10)) is None
    lay = mesh_lib.param_layout(_mesh({"data": 1, "model": 2}), mclr(16, 10))
    assert lay.shapes == {"w": (16, 10), "b": (10,)}


PROBE = """
import json, sys, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import mesh as mesh_lib
from repro_torch.fed import parallel
world, how = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("fake", store=FakeStore(), rank=int(sys.argv[3]),
                        world_size=world)
if how == "production":
    m = mesh_lib.make_production_mesh(multi_pod=world == 512, device="meta")
elif how == "env":
    m = parallel.default_fed_mesh(device="cpu")
else:
    m = mesh_lib.make_fed_mesh(world // 2, 2, device="cpu")
print(json.dumps({"shape": m.shape, "axes": list(m.axis_names),
                  "data": [m.data_index, dist.get_world_size(m.data_group)],
                  "model": [m.model_index, dist.get_world_size(m.model_group)],
                  "world": m.world}))
mesh_lib.destroy_process_group()
"""


def _probe(world: int, how: str, rank: int = 0, **env) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(world), how, str(rank)],
        env=dict(os.environ, PYTHONPATH=str(SRC), **env),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_is_the_reference_s(multi_pod):
    """``repro.launch.mesh.make_production_mesh``: (16, 16) as ("data",
    "model"), or (2, 16, 16) as ("pod", "data", "model")."""
    got = _probe(512 if multi_pod else 256, "production", rank=37)
    if multi_pod:
        assert got["shape"] == {"pod": 2, "data": 16, "model": 16}
        assert got["axes"] == ["pod", "data", "model"]
    else:
        assert got["shape"] == {"data": 16, "model": 16}
        assert got["axes"] == ["data", "model"]
    # rank 37: data slice 2, model index 5; the data group spans the
    # data axes (32 ranks over two pods), the model group 16
    assert got["data"] == [2, 32 if multi_pod else 16]
    assert got["model"] == [5, 16]


def test_make_fed_mesh_and_default_fed_mesh_take_a_model_axis():
    assert _probe(4, "fed", rank=3) == {
        "shape": {"data": 2, "model": 2}, "axes": ["data", "model"],
        "data": [1, 2], "model": [1, 2], "world": 4}
    assert _probe(8, "env", rank=5, REPRO_MODEL_AXIS="4")["shape"] == {
        "data": 2, "model": 4}
