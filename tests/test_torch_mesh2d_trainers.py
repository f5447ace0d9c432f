"""The synchronous trainers on a ``(1, 2)`` (data, model) mesh of gloo
ranks on the CPU.

Two ranks of ``tests/_torch_mesh_driver.py`` (one process a rank, one
torch thread each, a FileStore in ``tmp_path``) form one data slice split
over a model axis of 2 and run every scenario of the 1-D mesh tests at
the reference's small fixture: FedAvg, FedGroup with EDC and with MADC,
IFCA, FeSEM and LCFL, per round and in blocks, pinned; FedGroup and FeSEM
streamed; the quarantine, an odd cohort (7 clients split 3 / 4), the
shift detector. Each rank solves its half of the cohort with the group
parameters gathered whole; at rest it keeps its blocks of them.

Held against the run of one (``tests/_torch_mesh2d.py``): membership,
founders and labels equal, accuracy within 2e-3, mean loss and
discrepancy within rtol 1e-4, each stored leaf its block of the
one-device leaf (``group_param_pspec``) exactly in shape and within 1e-5
in the relative Frobenius norm; every rank's whole replicas equal.
"""
import pytest

from _torch_mesh2d import (assert_matches_one, assert_replicas,
                           reference_runs, run_of)
from _torch_mesh_driver import SCENARIOS, spawn_world
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

S, M = 2, 2


@pytest.fixture(scope="module")
def ref():
    return reference_runs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(S, tmp_path_factory.mktemp("mesh1x2"), model=M)


@pytest.mark.parametrize("rank", range(S))
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_matches_world_of_one(ref, world, name, rank):
    assert_matches_one(run_of(world[rank], name), ref[name], M, rank % M)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_replicas_equal_across_ranks(world, name):
    assert_replicas(world, M, name)


@pytest.mark.parametrize("name", ["fedgroup_streamed", "fesem_streamed"])
def test_streamed_rank_holds_its_data_slice(world, name):
    """One data slice: both ranks stage the whole cohort (8 rows) and
    each computes its half."""
    for z in world:
        rows = run_of(z, name)["cohort_rows"]
        assert (rows[:, 0] == rows[:, 1]).all() and rows[0, 1] == 8
