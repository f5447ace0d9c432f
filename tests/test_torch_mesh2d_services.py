"""The runtime services under a model axis: a ``(1, 2)`` (data, model)
mesh of gloo ranks on the CPU.

Two ranks of ``tests/_torch_mesh_driver.py`` (``services`` mode with
``REPRO_MODEL_AXIS=2``: one data slice, its clients and its group
parameters split over the two) run four rounds of FedGroup with EDC at
the reference's small fixture: checkpoints pinned (in blocks of 2) and
streamed with the world SIGKILLed after round 2 and respawned from the
archive, telemetry, async D = 1 and D = 2 (the first lease scripted never
ready on rank 0 alone), a fleet of one thread worker with message chaos,
a streamed run with a killed client, two poisoned lanes and an inline
deadline, one whose deadline cuts a round with poisoned lanes, and their
synchronous references. The runs of one device are made in this process
(``tests/_torch_mesh2d.py``).

Held:
  (a) every run against the run of one: membership, counters,
      ``Population.stats`` and the async counters equal, each stored leaf
      its block of the one-device leaf within 1e-5 (relative Frobenius),
      loss and discrepancy within rtol 1e-4, accuracy within 2e-3; every
      rank's replicas equal;
  (b) kill-and-resume equals the uninterrupted run bit for bit; the
      archive holds whole leaves in the one-device archive's layout and
      resumes without a mesh;
  (c) telemetry on equals off (rank 0 alone writes, ``check_dir`` clean),
      async D = 1 equals the synchronous run, a fleet of one equals
      ``run()``, each bit for bit; rank 0's lease expiry and deadline
      prefix are every rank's.
"""
import json

import numpy as np
import pytest

import _torch_mesh_driver as drv
from _torch_mesh2d import (assert_service_matches_one,
                           assert_service_replicas, service_references)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.launch.inspect import check_dir

S, M = 2, 2
K = 8
NAMES = ["fedgroup_sync", "fedgroup_sync_block", "fedgroup_ckpt_resume",
         "fedgroup_streamed_ckpt_resume", "fedgroup_telemetry",
         "fedgroup_async_d1", "fedgroup_async_d2", "fedgroup_fleet1",
         "fedgroup_streamed_faults_deadline",
         "fedgroup_streamed_corrupt_deadline"]
# name -> (the round the deadline fires in, the prefix it leaves)
DEADLINE = {"fedgroup_streamed_faults_deadline": (2, 2),
            "fedgroup_streamed_corrupt_deadline": (2, 4)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return service_references(NAMES, tmp_path_factory.mktemp("one"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return drv.services_world(tmp_path_factory.mktemp("services1x2"), S,
                              NAMES, model=M)


def _async(run: dict) -> dict:
    return json.loads(bytes(run["async"]).decode())


@pytest.mark.parametrize("rank", range(S))
@pytest.mark.parametrize("name", NAMES)
def test_matches_world_of_one(ref, world, name, rank):
    assert_service_matches_one(drv.run_of(world[1][rank], name), ref[name],
                               M, rank % M)


@pytest.mark.parametrize("name", NAMES)
def test_replicas_equal_across_ranks(world, name):
    assert_service_replicas(world[1], M, name)


@pytest.mark.parametrize("name", drv.RESUMED)
def test_kill_and_resume_equals_the_uninterrupted_run(world, name):
    _, services, resumed = world
    for r in range(S):
        full = drv.run_of(services[r], name)
        back = drv.run_of(resumed[r], name)
        assert sorted(full) == sorted(back)
        assert drv.differing(full, back, skip=("cohort_rows",)) == [], r
        assert full["counters"][-1] == 2              # two archives each


@pytest.mark.parametrize("name", drv.RESUMED)
def test_archive_holds_whole_leaves_and_resumes_without_a_mesh(
        ref, world, name, tmp_path):
    """The round-2 archive of the (1, 2) world: the one-device archive's
    keys, shapes and dtypes (every leaf whole); resumed here without a
    mesh, its rounds 2-3 are the run of one's within the tolerances."""
    d = world[0]
    archive = drv.kill_archive(d, name)
    one = str(tmp_path / "one.npz")
    data, model = drv.fixture()
    tr, _ = drv.service_trainer(name, None, data, model, tmp_path / "w")
    tr.run(drv.KILL_AT)
    tr.save_checkpoint(one)
    tr.close()
    assert ckpt_io.saved_array_specs(archive) == \
        ckpt_io.saved_array_specs(one)
    back = drv.reload_half(name, None, data, model, tmp_path / "back",
                           archive)
    assert_service_matches_one(back, ref[name], 1, 0)


def test_telemetry_on_equals_off_and_rank0_writes(ref, world):
    d, services, _ = world
    for r, z in enumerate(services):
        on = drv.run_of(z, "fedgroup_telemetry")
        off = drv.run_of(z, "fedgroup_sync_block")
        assert drv.differing(on, off, skip=("obs",)) == []
        assert on["obs"].tolist() == [True, r == 0, r == 0]
    tel = d / "work" / "fedgroup_telemetry" / "tel"
    assert sorted(p.name for p in tel.iterdir()) == [
        "metrics.jsonl", "run_summary.json", "trace.json"]
    assert check_dir(str(tel)) == []
    recs = [json.loads(x) for x in
            (tel / "metrics.jsonl").read_text().splitlines()]
    assert [r["t"] for r in recs] == [0, 1, 2, 3]
    assert all(r["group_sizes"] for r in recs)


def test_async_depth_one_equals_the_synchronous_run(world):
    for z in world[1]:
        d1 = drv.run_of(z, "fedgroup_async_d1")
        sync = drv.run_of(z, "fedgroup_sync_block")
        assert drv.differing(d1, sync,
                             skip=("async", "replays", "group_version")) == []
        st = _async(d1)
        assert st["dispatches"] == st["folds"] == 4
        assert st["max_in_flight"] == 1 and st["staleness_hist"] == {"0": 4}


def test_async_expiry_on_rank0_is_followed_by_every_rank(world):
    """D = 2 folds with weights below 1: the mean of the folded groups is
    taken whole and blocked (``fed.rounds._group_mean``)."""
    for z in world[1]:
        st = _async(drv.run_of(z, "fedgroup_async_d2"))
        assert st["lease_expiries"] == st["requeues"] == 1
        assert st["dispatches"] == st["folds"] + 1 == 5
        assert st["max_in_flight"] == 2
        assert st["staleness_hist"] == {"0": 2, "1": 2}


@pytest.mark.parametrize("name", list(DEADLINE))
def test_deadline_prefix_and_stats_agree(world, name):
    ranks = [drv.run_of(z, name) for z in world[1]]
    rows = ranks[0]["cohort_rows"]
    t, k = DEADLINE[name]
    assert rows[t, 1] == k
    for z in ranks[1:]:
        assert np.array_equal(z["stats"], ranks[0]["stats"])
        assert np.array_equal(z["cohort_rows"], rows)
        assert np.array_equal(z["membership"], ranks[0]["membership"])
    # one data slice: both ranks stage the whole prefix
    assert [z["cohort_rows"][t, 0] for z in ranks] == [k] * S


def test_fleet_of_one_equals_run(world):
    for z in world[1]:
        fleet = drv.run_of(z, "fedgroup_fleet1")
        plain = drv.run_of(z, "fedgroup_sync")
        assert drv.differing(fleet, plain, skip=("fleet", "replays")) == []
        got = dict(zip(drv.FLEET_COUNTERS, fleet["fleet"].tolist()))
        assert got == {"fleet.jobs": 5, "fleet.results": 4,
                       "fleet.lease_expiries": 1, "fleet.requeues": 1,
                       "fleet.msgs_dropped": 1, "fleet.msgs_duplicated": 1,
                       "fleet.msgs_reordered": 1, "fleet.stale_results": 1}
