"""The port's process fleet (``ProcTransport``: spawned workers, pipes,
numpy payloads) on the CPU. Each spawned interpreter imports torch, so
this file keeps to three tests:

  * SIGKILL recovery: two worker processes built from a ``WorkerSpec``,
    the holder of round 1's lease killed mid-dispatch; the closed pipe
    detects it, the lease requeues to the survivor, and the run equals the
    single-process run bit for bit (the children run one torch thread, as
    the parent does here).
  * The proc transport's limits: a ``worker_spec`` is required, and only
    pinned trainers on the per-round path are taken.
  * A bad builder spec: no ``module:function`` is refused, and a builder
    that fails in the child surfaces with its traceback.
  * A job sent to a worker still busy with another, both payloads larger
    than the pipe's buffer: the worker's reader thread takes it off the
    pipe, so its result send never waits on a sender that waits on it.
"""
import pytest

from _torch_fleet import DATA_KW, assert_same_run, fleet_snap, fresh, state_of
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.data.generators import mnist_like
from repro_torch.fed.population import FaultConfig, FaultSpec
from repro_torch.launch.coordinator import Coordinator, FleetConfig
from repro_torch.launch.worker import (WorkerSpec, resolve_builder,
                                       synthetic_builder)

PROC_KW = dict(framework="fedgroup", n_clients=20, dim=8, seed=0,
               n_rounds=3, clients_per_round=6, device="cpu")
BUILDER = "repro_torch.launch.worker:synthetic_builder"


def test_sigkill_mid_dispatch_recovers_bit_identically(monkeypatch):
    # one intra-op thread in the children too: the same reductions as the
    # in-process run
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ref = synthetic_builder(**PROC_KW)
    ref.run()
    ref_state = state_of(ref)
    ref.close()

    tr = synthetic_builder(**PROC_KW)
    coord = Coordinator(tr, FleetConfig(
        n_workers=2, transport="proc",
        worker_spec=WorkerSpec(BUILDER, PROC_KW),
        faults=FaultConfig(rounds={1: FaultSpec(worker_kill=True)}),
        heartbeat_interval=0.1, heartbeat_miss=50,
        lease_timeout=300.0, join_timeout=300.0))
    try:
        h = coord.run()
        snap, state = fleet_snap(tr), state_of(tr)
    finally:
        coord.close()
    assert len(h.rounds) == 3
    assert_same_run(tr, ref, state, ref_state)
    assert snap["fleet.worker_deaths"] == 1
    assert snap["fleet.requeues"] == snap["fleet.lease_expiries"] == 1
    assert snap["fleet.workers"] == 1
    assert snap["fleet.jobs"] == 4 and snap["fleet.results"] == 3
    assert coord._transport._procs == {}       # every child stopped


def test_proc_mode_validates_its_limits():
    data = mnist_like(**DATA_KW)
    spec = WorkerSpec(BUILDER, PROC_KW)
    pinned = fresh("fedavg", data)
    with pytest.raises(ValueError, match="needs FleetConfig.worker_spec"):
        Coordinator(pinned, FleetConfig(transport="proc"))
    pinned.close()
    streamed = fresh("fedavg", data, streamed=True)
    with pytest.raises(ValueError, match="pinned trainers only"):
        Coordinator(streamed, FleetConfig(transport="proc", worker_spec=spec))
    streamed.close()
    for kw in (dict(async_depth=2), dict(block_size=2)):
        other = fresh("fedavg", data, **kw)
        with pytest.raises(ValueError, match="per-round path only"):
            Coordinator(other, FleetConfig(transport="proc",
                                           worker_spec=spec))
        other.close()


def test_bad_builder_spec_is_rejected():
    with pytest.raises(ValueError, match="module:function"):
        resolve_builder(WorkerSpec("no_colon_here"))
    assert resolve_builder(WorkerSpec(BUILDER)) is synthetic_builder
    # a builder that cannot be imported fails in the child, which reports
    # its traceback before any job
    tr = synthetic_builder(**PROC_KW)
    coord = Coordinator(tr, FleetConfig(
        n_workers=1, transport="proc",
        worker_spec=WorkerSpec("repro_torch.launch.worker:no_such_builder"),
        join_timeout=300.0))
    try:
        with pytest.raises(RuntimeError, match=r"(?s)failed job -1.*"
                           r"Traceback.*no_such_builder"):
            coord.run(1)
    finally:
        coord.close()


def test_a_job_sent_to_a_busy_worker_does_not_deadlock(monkeypatch):
    """Two ``local`` jobs of several MB each sent back to back while the
    worker computes the first (a coordinator re-dispatching to a worker
    that still runs a superseded attempt): both results come back."""
    import threading

    import numpy as np
    import torch

    from repro_torch.launch import worker as worker_lib
    from repro_torch.launch.transport import Message, ProcTransport

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    kw = dict(framework="fedavg", n_clients=16, dim=4096, seed=0,
              clients_per_round=8, local_epochs=2, device="cpu")
    tr = synthetic_builder(**kw)
    x, y, n = tr._client_batch(np.arange(8))
    ex = tr._round_executor()
    bidx = tr._batch_indices(n, ex.max_steps)
    _, args = ex.prepare(tr._stacked_group_params(),
                         torch.zeros(8, dtype=torch.long), x, y, n, bidx)
    payload = ("round", worker_lib._to_numpy(args))
    transport = ProcTransport()
    transport.add_worker("w0", worker_lib.worker_entry,
                         WorkerSpec(BUILDER, kw), 0.05)
    try:
        joined = False
        while not joined:
            msg = transport.recv(300.0)
            assert msg is not None and msg.kind != "error", msg
            joined = msg.kind == "join"
        sent = []
        sender = threading.Thread(target=lambda: sent.extend(
            transport.send("w0", Message("job", job_id=j, payload=payload))
            for j in range(2)), daemon=True)
        sender.start()
        sender.join(120.0)
        assert not sender.is_alive(), "the second send never completed"
        assert sent == [True, True]
        results = {}
        while len(results) < 2:
            msg = transport.recv(120.0)
            assert msg is not None and msg.kind != "error", msg
            if msg.kind == "result":
                results[msg.job_id] = msg.payload
        mem, deltas, finals = worker_lib._to_numpy(ex.local(*args))
        for got in results.values():
            assert np.array_equal(got[0], mem)
            for want, leaves in ((deltas, got[1]), (finals, got[2])):
                assert all(np.array_equal(leaves[k], v)
                           for k, v in want.items())
    finally:
        transport.close()
        tr.close()
