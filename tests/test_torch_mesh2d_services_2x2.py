"""The runtime services on a ``(2, 2)`` (data, model) mesh of gloo ranks on
the CPU, and their archives resumed on other mesh shapes.

Four ranks of ``tests/_torch_mesh_driver.py`` (``services`` mode with
``REPRO_MODEL_AXIS=2``: two data slices of two model indices) run four
rounds of FedGroup with EDC at the reference's small fixture:
checkpoints pinned (in blocks of 2) and streamed with the world SIGKILLed
after round 2 and respawned, telemetry, async D = 1, a fleet of one
thread worker with message chaos, a streamed run with a killed client,
two poisoned lanes and an inline deadline, and their synchronous
references. The round-2 archives of the (2, 2) world are then resumed by
a (1, 2) world (``reload`` mode) and here without a mesh.

Held: every run against the run of one made in this process
(``tests/_torch_mesh2d.py``: counts and host state equal, each stored
leaf its block within 1e-5, the histories at the 1-D mesh tolerances);
every rank's replicas equal; kill-and-resume, telemetry on / off, async
D = 1 against the synchronous run and a fleet of one against ``run()``
equal bit for bit; the deadline's prefix and ``stats`` the same on every
rank; an archive of (2, 2) resumed on (1, 2) and without a mesh within
the same tolerances of the run of one.
"""
import json

import numpy as np
import pytest

import _torch_mesh_driver as drv
from _torch_mesh2d import (assert_service_matches_one,
                           assert_service_replicas, service_references)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.launch.inspect import check_dir

S, M = 4, 2
NAMES = ["fedgroup_sync", "fedgroup_sync_block", "fedgroup_ckpt_resume",
         "fedgroup_streamed_ckpt_resume", "fedgroup_telemetry",
         "fedgroup_async_d1", "fedgroup_fleet1",
         "fedgroup_streamed_faults_deadline"]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return service_references(NAMES, tmp_path_factory.mktemp("one"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return drv.services_world(tmp_path_factory.mktemp("services2x2"), S,
                              NAMES, model=M)


@pytest.fixture(scope="module")
def reloaded(world, tmp_path_factory):
    """The (2, 2) world's round-2 archives resumed on a (1, 2) world."""
    d = tmp_path_factory.mktemp("reload1x2")
    return drv.spawn_world(2, d, extra=("reload", str(world[0])),
                           suffix=".reload", model=M)


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
        assert drv.differing(full, back, skip=("cohort_rows",)) == [], r


@pytest.mark.parametrize("rank", range(2))
@pytest.mark.parametrize("name", drv.RESUMED)
def test_archive_resumes_on_a_1x2_mesh(ref, world, reloaded, name, rank):
    got = drv.run_of(reloaded[rank], name)
    assert_service_matches_one(got, ref[name], M, rank % M)
    # the restored rounds are the (2, 2) run's, as its archive holds them
    np.testing.assert_array_equal(
        got["hist"][:drv.KILL_AT],
        drv.run_of(world[1][0], name)["hist"][:drv.KILL_AT])


@pytest.mark.parametrize("name", drv.RESUMED)
def test_archive_resumes_without_a_mesh(ref, world, name, tmp_path):
    data, model = drv.fixture()
    back = drv.reload_half(name, None, data, model, tmp_path,
                           drv.kill_archive(world[0], name))
    assert_service_matches_one(back, ref[name], 1, 0)


def test_telemetry_on_equals_off_and_rank0_writes(world):
    d, services, _ = world
    for r, z in enumerate(services):
        on = drv.run_of(z, "fedgroup_telemetry")
        off = drv.run_of(z, "fedgroup_sync_block")
        assert drv.differing(on, off, skip=("obs",)) == []
        assert on["obs"].tolist() == [True, r == 0, r == 0]
    tel = d / "work" / "fedgroup_telemetry" / "tel"
    assert check_dir(str(tel)) == []
    recs = [json.loads(x) for x in
            (tel / "metrics.jsonl").read_text().splitlines()]
    assert [r["t"] for r in recs] == [0, 1, 2, 3]


def test_async_depth_one_and_the_fleet_equal_their_references(world):
    for z in world[1]:
        sync = drv.run_of(z, "fedgroup_sync")
        block = drv.run_of(z, "fedgroup_sync_block")
        d1 = drv.run_of(z, "fedgroup_async_d1")
        fleet = drv.run_of(z, "fedgroup_fleet1")
        assert drv.differing(d1, block,
                             skip=("async", "replays", "group_version")) == []
        assert drv.differing(fleet, sync, skip=("fleet", "replays")) == []
        assert fleet["fleet"][:4].tolist() == [5, 4, 1, 1]


def test_deadline_prefix_and_stats_agree(world):
    ranks = [drv.run_of(z, "fedgroup_streamed_faults_deadline")
             for z in world[1]]
    rows = ranks[0]["cohort_rows"]
    assert rows[2, 1] == 2                     # the deadline's prefix
    for z in ranks[1:]:
        assert np.array_equal(z["stats"], ranks[0]["stats"])
        assert np.array_equal(z["cohort_rows"][:, 1:], rows[:, 1:])
    # a data slice's two ranks stage the slice's rows of the prefix
    assert [z["cohort_rows"][2, 0] for z in ranks] == [1] * S
