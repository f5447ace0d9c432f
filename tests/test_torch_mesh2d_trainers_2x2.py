"""The synchronous trainers on a ``(2, 2)`` (data, model) mesh of gloo
ranks on the CPU: ``tests/test_torch_mesh2d_trainers.py``'s checks on
four ranks, two data slices of two model ranks each, over the first half
of the 1-D mesh tests' scenarios (``tests/test_torch_mesh2d_trainers_
2x2b.py`` runs the rest: a (2, 2) world over all of them outlasts a
test worker's share). A slice holds its half of each cohort (4 rows) and
its two ranks solve 2 each; the stored blocks are equal on the ranks of
one model index.
"""
import pytest

from _torch_mesh2d import (assert_matches_one, assert_replicas,
                           reference_runs, run_of)
from _torch_mesh_driver import SCENARIOS, spawn_world
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

S, M = 4, 2
NAMES = list(SCENARIOS)[:len(SCENARIOS) // 2]


@pytest.fixture(scope="module")
def ref():
    return reference_runs(NAMES)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(S, tmp_path_factory.mktemp("mesh2x2"), model=M,
                       names=NAMES)


@pytest.mark.parametrize("rank", range(S))
@pytest.mark.parametrize("name", NAMES)
def test_matches_world_of_one(ref, world, name, rank):
    assert_matches_one(run_of(world[rank], name), ref[name], M, rank % M)


@pytest.mark.parametrize("name", NAMES)
def test_replicas_equal_across_ranks(world, name):
    assert_replicas(world, M, name)
