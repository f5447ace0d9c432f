"""Checkpoints, telemetry and the fleet on a data mesh of gloo ranks on the
CPU.

Worlds of S = 1, 2 and 4 ranks (``tests/_torch_mesh_driver.py``, one
process a rank, a FileStore in ``tmp_path``) run four rounds of FedGroup
with EDC at the reference's small fixture: checkpoints pinned (in blocks
of 2) and streamed, the world killed after round 2 (it SIGKILLs itself)
and respawned from the archive; telemetry; a fleet of one thread worker
with message chaos; and their synchronous references. One spawn a world
runs the scenarios, one more resumes. The async runtime and the
population's faults and deadline are ``tests/test_torch_mesh_runtime.py``.

Held:
  (a) a world of one equals ``mesh=None`` bit for bit;
  (b) S = 2 and 4 against the world of one (``assert_sharded_close``):
      membership, counters and the histories' counts equal, each parameter
      leaf within 1e-5 in relative Frobenius norm, loss and discrepancy
      within rtol 1e-4, accuracy within 2e-3;
  (c) kill-and-resume equals the uninterrupted run bit for bit, telemetry
      on equals off (rank 0 alone writes its directory, which
      ``check_dir`` passes, its records those of ``mesh=None``), a fleet of
      one equals ``run()``, on every rank; every rank's replicas equal.
A fleet of two workers with a death and a kill is in
``tests/test_torch_mesh_runtime.py``.
"""
import json

import numpy as np
import pytest

from _torch_mesh_driver import (ACC_ATOL, FLEET_COUNTERS, RESUMED, RTOL,
                                assert_sharded_close, differing, run_of,
                                services_world)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.launch.inspect import check_dir

K = 8
NAMES = ["fedgroup_sync", "fedgroup_sync_block", "fedgroup_ckpt_resume",
         "fedgroup_streamed_ckpt_resume", "fedgroup_telemetry",
         "fedgroup_fleet1"]
# per rank by design: the rows a rank holds; whether a bundle records
PER_RANK = ("cohort_rows", "obs")


def _world(tmp_path_factory, S):
    return services_world(tmp_path_factory.mktemp(f"services{S}"), S, NAMES)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _world(tmp_path_factory, 1)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, 4)


@pytest.mark.parametrize("name", NAMES + [n + "#resumed" for n in RESUMED])
def test_mesh_of_one_equals_no_mesh(world1, name):
    _, services, resumed = world1
    z = resumed[0] if name.endswith("#resumed") else services[0]
    name = name.split("#")[0]
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
        assert differing(z, ranks[0], skip=PER_RANK) == [], r
        if "cohort_rows" in z:
            # every rank consumed the same cohorts (clients, first id)
            assert np.array_equal(z["cohort_rows"][:, 1:],
                                  ranks[0]["cohort_rows"][:, 1:])


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("name", RESUMED)
def test_kill_and_resume_equals_the_uninterrupted_run(request, S, name):
    _, services, resumed = request.getfixturevalue(f"world{S}")
    tags = [name] + ([name + "@none"] if S == 1 else [])
    for r in range(S):
        for tag in tags:
            full, back = run_of(services[r], tag), run_of(resumed[r], tag)
            assert sorted(full) == sorted(back)
            assert differing(full, back, skip=("cohort_rows",)) == [], \
                (r, tag)
            assert full["counters"][-1] == 2          # two archives each


@pytest.mark.parametrize("S", [1, 2, 4])
def test_telemetry_on_equals_off_and_rank0_writes(world1, request, S):
    d, services, _ = request.getfixturevalue(f"world{S}")
    for r, z in enumerate(services):
        on = run_of(z, "fedgroup_telemetry")
        off = run_of(z, "fedgroup_sync_block")
        assert differing(on, off, skip=("obs",)) == []
        # the tracer is on everywhere; rank 0 alone records and writes
        assert on["obs"].tolist() == [True, r == 0, r == 0]
    tel = d / "work" / "fedgroup_telemetry" / "tel"
    assert sorted(p.name for p in tel.iterdir()) == [
        "metrics.jsonl", "run_summary.json", "trace.json"]
    assert check_dir(str(tel)) == []
    none = world1[0] / "work" / "fedgroup_telemetry@none" / "tel"
    recs, ref = ([json.loads(x) for x in (p / "metrics.jsonl").read_text()
                  .splitlines()] for p in (tel, none))
    assert [r["t"] for r in recs] == [0, 1, 2, 3]
    for a, b in zip(recs, ref, strict=True):
        assert sorted(a) == sorted(b)
        for k in a:
            if k in ("acc", "loss", "disc"):
                assert a[k] == pytest.approx(b[k], rel=RTOL, abs=ACC_ATOL)
            else:
                assert a[k] == b[k], k
    if S == 1:
        assert (tel / "metrics.jsonl").read_bytes() == \
            (none / "metrics.jsonl").read_bytes()


@pytest.mark.parametrize("S", [1, 2, 4])
def test_fleet_of_one_equals_run(request, S):
    for z in request.getfixturevalue(f"world{S}")[1]:
        fleet, plain = run_of(z, "fedgroup_fleet1"), run_of(z,
                                                            "fedgroup_sync")
        assert differing(fleet, plain, skip=("fleet", "replays")) == []
        got = dict(zip(FLEET_COUNTERS, fleet["fleet"].tolist()))
        # dispatch 1's result dropped (requeued, run again on every rank),
        # 2's duplicated (the copy stale), 3's held back
        assert got == {"fleet.jobs": 5, "fleet.results": 4,
                       "fleet.lease_expiries": 1, "fleet.requeues": 1,
                       "fleet.msgs_dropped": 1, "fleet.msgs_duplicated": 1,
                       "fleet.msgs_reordered": 1, "fleet.stale_results": 1}


@pytest.mark.parametrize("S", [2, 4])
def test_streamed_rank_stages_its_share(request, S):
    rows = run_of(request.getfixturevalue(f"world{S}")[1][0],
                  "fedgroup_streamed_ckpt_resume")["cohort_rows"]
    assert (rows[:, 0] == K // S).all() and (rows[:, 1] == K).all()
