"""Process workers under a mesh: a 1-D data mesh of two gloo ranks and a
``(1, 2)`` (data, model) mesh, on the CPU.

Each rank of ``tests/_torch_mesh_driver.py`` spawns its own fleet of
worker processes (``transport="proc"``, built by the driver's
``proc_builder``, one torch thread each) and runs four rounds of FedGroup
with EDC through it (``tests/_torch_mesh_proc.py``). Held on both meshes:
a process fleet of one equals the thread fleet of one and ``run()`` bit
for bit; with the last rank's worker SIGKILLed in dispatch 1 every rank
recovers with deviation 0 and the same job counters. A worker runs no
collective, so no rank is ever held by a dead one; the spawn's own
timeout guards against a hang.
"""
import pytest

from _torch_mesh_driver import services_world
from _torch_mesh_proc import (NAMES, assert_proc_fleet_of_one,
                              assert_replicas, assert_sigkill_recovers)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

MESHES = {"2x1": (2, 1), "1x2": (2, 2)}


@pytest.fixture(scope="module", params=list(MESHES))
def world(request, tmp_path_factory):
    S, M = MESHES[request.param]
    d = tmp_path_factory.mktemp(f"proc{request.param}")
    return services_world(d, S, NAMES, model=M)[1], M


def test_process_fleet_of_one_equals_the_thread_fleet(world):
    assert_proc_fleet_of_one(world[0])


def test_sigkill_on_one_rank_recovers_bit_identically(world):
    assert_sigkill_recovers(world[0])


def test_replicas_equal_across_ranks(world):
    assert_replicas(*world)
