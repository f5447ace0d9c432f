"""The async runtime, the population's scripted faults and straggler
deadline, and a fleet's worker faults on a data mesh of gloo ranks on the
CPU.

Worlds of S = 1, 2 and 4 ranks (``tests/_torch_mesh_driver.py``) run four
rounds of FedGroup with EDC at the reference's small fixture: async D = 1
and its synchronous reference (the block path), D = 2 with the first lease
scripted never ready on rank 0 alone, and a streamed run with a killed
client, two poisoned lanes (quarantined) and a deadline that fires in
round 2, inline (a decision before each chunk), one that fires in round 0
while prefetching (rank 0's consumer claims a prefix of its producer's
staging and every rank takes its length), and one that cuts round 2's
cohort to its first half while two of its lanes are poisoned (the
newcomers' cold start gathers its subset afresh on a rank); and a fleet
of two thread workers against its per-round reference: dispatch 1's
holder muted and declared dead (by rank 0) while its job is held,
dispatch 2's holder killed.

Held:
  (a) a world of one equals ``mesh=None`` bit for bit;
  (b) S = 2 and 4 against the world of one (``assert_sharded_close``):
      membership, counters, ``Population.stats`` and the async counters
      equal, each parameter leaf within 1e-5 in relative Frobenius norm,
      loss and discrepancy within rtol 1e-4, accuracy within 2e-3;
  (c) async D = 1 equals the synchronous run bit for bit; rank 0's expiry
      is every rank's; the deadline's prefix, membership and ``stats``
      agree across ranks; the fleet equals ``run()`` with the same job
      counters on every rank (each rank's worker is rank 0's pick); every
      rank's replicas equal.
"""
import json

import numpy as np
import pytest

from _torch_mesh_driver import (FLEET_COUNTERS, assert_sharded_close,
                                differing, run_of, services_world)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

K = 8
# name -> (the round the deadline fires in, the prefix it leaves)
DEADLINE = {"fedgroup_streamed_faults_deadline": (2, 2),
            "fedgroup_streamed_deadline_prefetch": (0, 2),
            "fedgroup_streamed_corrupt_deadline": (2, 4)}
NAMES = ["fedgroup_sync", "fedgroup_sync_block", "fedgroup_async_d1",
         "fedgroup_async_d2", "fedgroup_fleet2"] + list(DEADLINE)
STATS = ("corrupted_clients", "deadline_dropped_clients", "deadline_rounds",
         "killed_clients", "lease_expiries", "requeues", "writer_crashes",
         "writer_retries")


def _world(tmp_path_factory, S):
    return services_world(tmp_path_factory.mktemp(f"runtime{S}"), S, NAMES)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _world(tmp_path_factory, 1)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, 4)


def _async(run: dict) -> dict:
    return json.loads(bytes(run["async"]).decode())


@pytest.mark.parametrize("name", NAMES)
def test_mesh_of_one_equals_no_mesh(world1, name):
    z = world1[1][0]
    mesh, none = run_of(z, name), run_of(z, name + "@none")
    assert sorted(mesh) == sorted(none)
    assert differing(mesh, none) == []


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_sharded_matches_world_of_one(world1, request, S, name):
    assert_sharded_close(
        run_of(request.getfixturevalue(f"world{S}")[1][0], name),
        run_of(world1[1][0], name + "@none"))


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_replicas_equal_across_ranks(request, S, name):
    ranks = [run_of(z, name)
             for z in request.getfixturevalue(f"world{S}")[1]]
    for r, z in enumerate(ranks[1:], 1):
        assert sorted(z) == sorted(ranks[0])
        assert differing(z, ranks[0], skip=("cohort_rows",)) == [], r


@pytest.mark.parametrize("S", [1, 2, 4])
def test_async_depth_one_equals_the_synchronous_run(request, S):
    for z in request.getfixturevalue(f"world{S}")[1]:
        d1 = run_of(z, "fedgroup_async_d1")
        sync = run_of(z, "fedgroup_sync_block")
        assert differing(d1, sync,
                         skip=("async", "replays", "group_version")) == []
        st = _async(d1)
        assert st["dispatches"] == st["folds"] == 4
        assert st["max_in_flight"] == 1 and st["staleness_hist"] == {"0": 4}
        assert d1["replays"][0] == 0            # eager on the CPU


@pytest.mark.parametrize("S", [1, 2, 4])
def test_async_expiry_on_rank0_is_followed_by_every_rank(request, S):
    """Only rank 0's first lease was scripted never ready: every rank
    abandoned it at rank 0's deadline, requeued it and folded it last, by
    rank 0's backoff clock."""
    for z in request.getfixturevalue(f"world{S}")[1]:
        st = _async(run_of(z, "fedgroup_async_d2"))
        assert st["lease_expiries"] == st["requeues"] == 1
        assert st["dispatches"] == st["folds"] + 1 == 5
        assert st["max_in_flight"] == 2
        assert st["staleness_hist"] == {"0": 2, "1": 2}


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("name", list(DEADLINE))
def test_deadline_prefix_and_stats_agree(request, S, name):
    ranks = [run_of(z, name)
             for z in request.getfixturevalue(f"world{S}")[1]]
    rows = ranks[0]["cohort_rows"]
    t, k = DEADLINE[name]
    assert rows[t, 1] == k          # the straggling round: one chunk
    stats = dict(zip(STATS, ranks[0]["stats"].tolist()))
    assert stats["deadline_rounds"] == 1
    assert stats["deadline_dropped_clients"] == K - k
    if name == "fedgroup_streamed_faults_deadline":
        assert rows[1, 1] == K - 1                  # one client killed
        assert stats["killed_clients"] == 1
        assert stats["corrupted_clients"] == 2
        assert ranks[0]["hist"][1, 4] == 2          # both quarantined
    if name == "fedgroup_streamed_corrupt_deadline":
        # the poisoned lanes drawn over all 8 clients count in the prefix
        lanes = np.random.default_rng([0, 0xFA017, t]).choice(K, 2,
                                                              replace=False)
        assert stats["corrupted_clients"] == int(np.sum(lanes < k))
    for z in ranks[1:]:
        assert np.array_equal(z["stats"], ranks[0]["stats"])
        assert np.array_equal(z["cohort_rows"][:, 1:], rows[:, 1:])
        assert np.array_equal(z["membership"], ranks[0]["membership"])
    # a rank holds its rows of a prefix the ranks divide, all of it else
    assert [z["cohort_rows"][t, 0] for z in ranks] == \
        [k // S if k % S == 0 else k] * S


@pytest.mark.parametrize("S", [1, 2, 4])
def test_fleet_of_two_recovers_a_death_and_a_kill(request, S):
    for z in request.getfixturevalue(f"world{S}")[1]:
        fleet, plain = run_of(z, "fedgroup_fleet2"), run_of(z,
                                                            "fedgroup_sync")
        assert differing(fleet, plain, skip=("fleet", "replays")) == []
        got = dict(zip(FLEET_COUNTERS, fleet["fleet"].tolist()))
        # dispatch 1's held attempt came back stale on every rank, both
        # faulted dispatches were requeued to the other worker
        assert got == {"fleet.jobs": 6, "fleet.results": 4,
                       "fleet.lease_expiries": 2, "fleet.requeues": 2,
                       "fleet.msgs_dropped": 0, "fleet.msgs_duplicated": 0,
                       "fleet.msgs_reordered": 0, "fleet.stale_results": 1}
