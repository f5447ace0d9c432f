"""The second half of ``tests/test_torch_mesh2d_trainers_2x2.py``'s
scenarios on a ``(2, 2)`` (data, model) mesh of gloo ranks: FeSEM per
round and in blocks, the streamed runs (a rank stages its data slice's 4
rows of 8), the quarantine, the odd cohort of 7 (which two slices do not
divide: computed whole on every rank), the shift detector and LCFL.
"""
import pytest

from _torch_mesh2d import (assert_matches_one, assert_replicas,
                           reference_runs, run_of)
from _torch_mesh_driver import SCENARIOS, spawn_world
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

S, M = 4, 2
NAMES = list(SCENARIOS)[len(SCENARIOS) // 2:]


@pytest.fixture(scope="module")
def ref():
    return reference_runs(NAMES)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(S, tmp_path_factory.mktemp("mesh2x2b"), model=M,
                       names=NAMES)


@pytest.mark.parametrize("rank", range(S))
@pytest.mark.parametrize("name", NAMES)
def test_matches_world_of_one(ref, world, name, rank):
    assert_matches_one(run_of(world[rank], name), ref[name], M, rank % M)


@pytest.mark.parametrize("name", NAMES)
def test_replicas_equal_across_ranks(world, name):
    assert_replicas(world, M, name)


@pytest.mark.parametrize("name", ["fedgroup_streamed", "fesem_streamed"])
def test_streamed_rank_holds_its_data_slice(world, name):
    """A rank stages its data slice's rows: 4 of the 8."""
    for z in world:
        rows = run_of(z, name)["cohort_rows"]
        assert (rows[:, 0] == 4).all() and (rows[:, 1] == 8).all()
