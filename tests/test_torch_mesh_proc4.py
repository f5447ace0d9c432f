"""Process workers under a 1-D data mesh of four gloo ranks on the CPU:
``tests/test_torch_mesh_proc.py``'s checks (``tests/_torch_mesh_proc.py``)
on a world of four, each rank with its own fleet of worker processes, the
last rank's worker SIGKILLed in dispatch 1."""
import pytest

from _torch_mesh_driver import services_world
from _torch_mesh_proc import (NAMES, assert_proc_fleet_of_one,
                              assert_replicas, assert_sigkill_recovers)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

S = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return services_world(tmp_path_factory.mktemp("proc4"), S, NAMES)[1]


def test_process_fleet_of_one_equals_the_thread_fleet(ranks):
    assert_proc_fleet_of_one(ranks)


def test_sigkill_on_one_rank_recovers_bit_identically(ranks):
    assert_sigkill_recovers(ranks)


def test_replicas_equal_across_ranks(ranks):
    assert_replicas(ranks, 1)
