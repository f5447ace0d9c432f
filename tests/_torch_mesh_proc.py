"""Shared checks of the process-fleet mesh tests
(``tests/test_torch_mesh_proc*.py``): a ``services`` world of
``tests/_torch_mesh_driver.py`` runs FedGroup's per-round reference, a
fleet of one thread worker, a process fleet of one spawned worker a rank,
and one of two a rank whose last rank's holder of dispatch 1 is
SIGKILLed (``PROC_FLEETS``); each spawned worker runs its rank's rows'
local solves and no collective (``fed.rounds``' ``local``), the rank's
coordinator the rest of the round."""
import numpy as np

import _torch_mesh_driver as drv

NAMES = ["fedgroup_sync", "fedgroup_fleet1", "fedgroup_proc1",
         "fedgroup_proc_kill"]
# what a process fleet's run records besides the training state
PROC_KEYS = ("proc", "proc_run_s", "proc_left", "fleet", "replays")


def assert_proc_fleet_of_one(ranks: list):
    """On every rank the process fleet of one equals the thread fleet of
    one and ``run()`` bit for bit; four jobs, four results, nothing
    requeued; every child stopped at close."""
    for z in ranks:
        proc = drv.run_of(z, "fedgroup_proc1")
        assert drv.differing(proc, drv.run_of(z, "fedgroup_fleet1"),
                             skip=PROC_KEYS) == []
        assert drv.differing(proc, drv.run_of(z, "fedgroup_sync"),
                             skip=PROC_KEYS) == []
        assert proc["proc"].tolist() == [4, 4, 0, 0, 0]
        assert proc["proc_left"][0] == 0


def assert_sigkill_recovers(ranks: list):
    """The last rank's worker SIGKILLed mid-dispatch: every rank requeued
    the job (the ranks' joint lease outcome) and the run equals ``run()``
    bit for bit; the job counters equal on every rank, the death only the
    last rank's; no rank waited out a lease (its timeout is 120 s)."""
    last = len(ranks) - 1
    for r, z in enumerate(ranks):
        run = drv.run_of(z, "fedgroup_proc_kill")
        assert drv.differing(run, drv.run_of(z, "fedgroup_sync"),
                             skip=PROC_KEYS) == [], r
        jobs, results, expiries, requeues, deaths = run["proc"].tolist()
        assert (jobs, results, expiries, requeues) == (5, 4, 1, 1), r
        assert deaths == (1 if r == last else 0), r
        assert run["proc_run_s"][0] < 120.0
        assert run["proc_left"][0] == 0


def assert_replicas(ranks: list, M: int):
    """Each process fleet's state equal on every rank (each stored block
    on the ranks of its model index)."""
    for name in ("fedgroup_proc1", "fedgroup_proc_kill"):
        runs = [drv.run_of(z, name) for z in ranks]
        for r, z in enumerate(runs[1:], 1):
            peer = runs[r % M]
            for k, v in z.items():
                if k in PROC_KEYS:
                    continue
                want = peer[k] if k.startswith(("gp/", "params/")) \
                    else runs[0][k]
                assert np.array_equal(v, want), (name, r, k)
