"""The port's elastic control plane (``repro_torch.launch``: transport,
worker, coordinator) on the CPU, in-process, at ``tests/test_fleet.py``'s
fixtures.

  * ``HeartbeatMonitor``, ``ChaosRouter`` and ``InProcTransport`` against
    the reference's (``repro.launch.transport``) on the same scripted
    inputs: equal outputs step for step.
  * Fleet-size 1: ``Coordinator(trainer).run()`` equals ``trainer.run()``
    bit for bit (history, params, groups, membership, local rows, comm
    accounting, both random streams) for the six trainers pinned and four
    streamed, and on the block and async paths; every train dispatch went
    through the fleet (``fleet.jobs == fleet.results``), and the proxies
    keep the executors' surface.
  * Chaos: a killed worker, dropped / duplicated / reordered results, a
    muted heartbeat (death, requeue, resurrection), a lease that expires,
    elastic join and leave — each run bit-identical to the unfaulted one;
    an unrecoverable job raises with the fleet's key names, a worker's
    exception with its traceback.

No test races on the wall clock (``tests/_torch_fleet.py``): a 5 s
heartbeat window wherever counts are exact, and a job that must expire
waits until ``fleet.lease_expiries`` (or ``heartbeat_misses``) reads 1.
"""
import numpy as np
import pytest

from _torch_fleet import (CALM, DATA_KW, TRAINER_IDS, TRAINERS, Gate,
                          assert_same_run, fleet_snap, fresh, state_of,
                          wait_for)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.fed.population import FaultSpec as JFaultSpec
from repro.launch import transport as jtransport
from repro_torch.data.generators import mnist_like
from repro_torch.fed.population import FaultConfig, FaultSpec
from repro_torch.launch import transport as ttransport
from repro_torch.launch.coordinator import Coordinator, FleetConfig


@pytest.fixture(scope="module")
def small_data():
    return mnist_like(**DATA_KW)


# ---------------------------------------------------------------------------
# transport primitives against the reference's
# ---------------------------------------------------------------------------
def _monitor_script(mod):
    m = mod.HeartbeatMonitor(interval=1.0, miss=3)
    out = []
    m.add("w0", now=0.0)
    m.add("w1", now=0.5)
    out.append(m.sweep(2.9))
    out.append(m.sweep(3.1))                  # w0 dead, w1 not yet
    out.append(m.sweep(3.2))                  # declared once
    out.append(m.is_dead("w0"))
    out.append(m.beat("w0", 3.3))             # late beat: resurrects
    out.append(m.beat("ghost", 3.3))          # never adopted
    out.append(m.sweep(3.6))                  # w1 now
    m.remove("w1")
    out.append(m.beat("w1", 9.0))             # departed, not dead
    out.append(m.sweep(100.0))
    return out


def test_heartbeat_monitor_equals_reference():
    assert _monitor_script(ttransport) == _monitor_script(jtransport)
    assert _monitor_script(ttransport) == [
        [], ["w0"], [], True, True, False, ["w1"], False, ["w0"]]


def _chaos_script(mod, fault_spec):
    c = mod.ChaosRouter()
    c.arm(fault_spec(msg_drop=True), job_id=7)
    c.arm(fault_spec(msg_dup=True), job_id=3)
    c.arm(fault_spec(msg_reorder=True), job_id=5)
    c.arm(fault_spec(msg_drop=True, msg_dup=True), job_id=9)
    c.arm(None, job_id=11)
    c.mute_heartbeats("w0", until=1.0)
    inputs = [("result", "w0", 7, 0.0), ("result", "w0", 8, 0.0),
              ("result", "w0", 3, 0.1), ("result", "w1", 5, 0.2),
              ("heartbeat", "w0", -1, 0.5), ("heartbeat", "w1", -1, 0.6),
              ("result", "w1", 9, 0.7), ("result", "w1", 9, 0.8),
              ("heartbeat", "w0", -1, 1.5), ("heartbeat", "w0", -1, 1.6),
              ("result", "w0", 11, 1.7)]
    out = []
    for kind, src, job, now in inputs:
        got = c.filter(mod.Message(kind, src, job, f"p{job}"), now=now)
        out.append([(m.kind, m.src, m.job_id, m.payload) for m in got])
    return out, sorted(c.dropped)


def test_chaos_router_equals_reference():
    ours = _chaos_script(ttransport, FaultSpec)
    assert ours == _chaos_script(jtransport, JFaultSpec)
    delivered, dropped = ours
    assert delivered[0] == [] and dropped == [7, 9]
    assert [m[2] for m in delivered[2]] == [3, 3]          # duplicated
    assert delivered[3] == []                              # held back
    assert delivered[4] == [("result", "w1", 5, "p5")]     # muted beat
    # lets the held result pass


def _transport_script(mod):
    tr = mod.InProcTransport()
    out = []
    ep = tr.add_worker("w0")
    out.append(tr.send("w0", mod.Message("job", job_id=1)))
    out.append(ep.recv(1.0).job_id)
    ep.send(mod.Message("result", "w0", 1, "r"))
    out.append(tr.recv(1.0).payload)
    out.append(tr.recv(0.0))
    out.append(ep.recv(0.0))
    tr.remove_worker("w0")
    out.append(tr.send("w0", mod.Message("job")))
    try:
        tr.add_worker("w1")
        tr.add_worker("w1")
    except ValueError as e:
        out.append(str(e))
    tr.close()
    out.append(tr.send("w1", mod.Message("job")))
    return out


def test_inproc_transport_equals_reference():
    assert _transport_script(ttransport) == _transport_script(jtransport)
    assert _transport_script(ttransport)[:4] == [True, 1, "r", None]
    ours, ref = ttransport.Message("job"), jtransport.Message("job")
    assert (ours.kind, ours.src, ours.job_id, ours.payload) == \
        (ref.kind, ref.src, ref.job_id, ref.payload)


# ---------------------------------------------------------------------------
# fleet-size-1 bit-identity
# ---------------------------------------------------------------------------
def _fleet_of_one(name, data, streamed, **cfg_kw):
    ref = fresh(name, data, streamed, **cfg_kw)
    ref.run()
    ref_state = state_of(ref)
    ref.close()
    tr = fresh(name, data, streamed, **cfg_kw)
    coord = Coordinator(tr, FleetConfig(n_workers=1, **CALM))
    coord.run()
    snap, state = fleet_snap(tr), state_of(tr)
    coord.close()
    assert_same_run(tr, ref, state, ref_state)
    assert snap["fleet.jobs"] == snap["fleet.results"] > 0
    assert snap["fleet.heartbeats"] > 0 and snap["fleet.joins"] == 1
    assert snap["fleet.lease_expiries"] == snap["fleet.worker_deaths"] == 0
    return tr, snap


@pytest.mark.parametrize("name,streamed", TRAINERS, ids=TRAINER_IDS)
def test_fleet_of_one_equals_engine_run(name, streamed, small_data):
    tr, snap = _fleet_of_one(name, small_data, streamed, n_rounds=3)
    # one dispatch a round on the per-round path
    assert snap["fleet.jobs"] == 3


# 4 rounds; jobs: one dispatch a block (FedGroup's round 0 runs its
# cold start per round, and a lone last round runs per round) or one a
# cohort
PATHS = {
    "fedavg-block": ("fedavg", False, dict(block_size=2), 2),
    "fedgroup-block": ("fedgroup", False, dict(block_size=2,
                                               pretrain_scale=14), 3),
    "fesem-block": ("fesem", False, dict(block_size=3), 2),
    "fedgroup-async2": ("fedgroup", False, dict(async_depth=2,
                                                async_alpha=0.8,
                                                async_beta=0.5), 4),
    "fesem-async2": ("fesem", False, dict(async_depth=2), 4),
    "fedavg-streamed-async2": ("fedavg", True, dict(async_depth=2,
                                                    async_alpha=0.5), 4),
}


@pytest.mark.parametrize("case", list(PATHS))
def test_block_and_async_paths_route_through_fleet(case, small_data):
    name, streamed, kw, jobs = PATHS[case]
    tr, snap = _fleet_of_one(name, small_data, streamed, **kw)
    assert snap["fleet.jobs"] == jobs
    if "async" in case:
        assert tr.history.async_stats["dispatches"] == jobs


def test_proxies_keep_the_executor_surface(small_data):
    tr = fresh("fedavg", small_data, async_depth=1)
    real = (tr._round_executor(), tr._block_executor(),
            tr._async_executor())
    coord = Coordinator(tr, FleetConfig(n_workers=1, **CALM))
    try:
        proxies = (tr._round_exec, tr._block_exec, tr._async_exec)
        assert all(p is not r for p, r in zip(proxies, real))
        assert tr._round_executor() is proxies[0]
        assert proxies[0].max_steps == real[0].max_steps
        assert proxies[1].replays == 0 and proxies[2].slots == 2
        carry = {"x": 1}
        assert proxies[2].bind(carry) is carry       # before any capture
        assert coord._table == {"round": real[0], "block": real[1],
                                "async": real[2]}
    finally:
        coord.close()


def test_rejects_unknown_transport(small_data):
    tr = fresh("fedavg", small_data)
    with pytest.raises(ValueError, match="unknown fleet transport"):
        Coordinator(tr, FleetConfig(transport="carrier-pigeon"))
    tr.close()


# ---------------------------------------------------------------------------
# chaos recovery (in-process fault domains)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def unfaulted(small_data):
    """FedAvg pinned, 6 rounds: the run every chaos case must reproduce."""
    ref = fresh("fedavg", small_data, n_rounds=6)
    ref.run()
    state = state_of(ref)
    ref.close()
    return ref, state


def _chaos_run(small_data, unfaulted, fleet: FleetConfig, patch=None,
               after=None):
    tr = fresh("fedavg", small_data, n_rounds=6)
    coord = Coordinator(tr, fleet)
    if patch is not None:
        patch(coord)
    try:
        coord.run()
        if after is not None:
            after(coord)
        snap, state = fleet_snap(tr), state_of(tr)
    finally:
        coord.close()
    ref, ref_state = unfaulted
    assert_same_run(tr, ref, state, ref_state)
    return coord, snap


def test_worker_kill_recovers_bit_identically(small_data, unfaulted):
    faults = FaultConfig(rounds={1: FaultSpec(worker_kill=True)})
    _, snap = _chaos_run(small_data, unfaulted, FleetConfig(
        n_workers=2, faults=faults, **CALM))
    assert snap["fleet.worker_deaths"] == 1
    assert snap["fleet.heartbeat_misses"] == 1
    assert snap["fleet.lease_expiries"] == snap["fleet.requeues"] == 1
    assert snap["fleet.workers"] == 1           # degraded, still finished
    assert snap["fleet.jobs"] == 7 and snap["fleet.results"] == 6


def test_message_chaos_is_bit_identical(small_data, unfaulted):
    # drop, duplicate and reorder the result message on three different
    # rounds of one run: every delivery fault is absorbed
    faults = FaultConfig(rounds={1: FaultSpec(msg_drop=True),
                                 2: FaultSpec(msg_dup=True),
                                 3: FaultSpec(msg_reorder=True)})
    _, snap = _chaos_run(small_data, unfaulted, FleetConfig(
        n_workers=2, faults=faults, **CALM))
    assert snap["fleet.msgs_dropped"] == 1
    assert snap["fleet.msgs_duplicated"] == 1
    assert snap["fleet.msgs_reordered"] == 1
    assert snap["fleet.requeues"] == 1          # only the drop requeues
    assert snap["fleet.stale_results"] == 1     # the dup's second copy
    assert snap["fleet.jobs"] == 7 and snap["fleet.results"] == 6
    assert snap["fleet.worker_deaths"] == 0


def test_heartbeat_delay_death_and_resurrection(small_data, unfaulted):
    # mute a healthy worker's beats while it works a held job: it is
    # declared dead, the lease requeues to the survivor; once the mute is
    # lifted its next beat resurrects it
    faults = FaultConfig(rounds={1: FaultSpec(heartbeat_delay=1e6)})
    state = {}

    def patch(coord):
        reg = coord.obs.registry
        state["gate"] = Gate(coord._table["round"], hold=lambda n: n == 2,
                             until=lambda: reg.get(
                                 "fleet.heartbeat_misses") >= 1)
        coord._table["round"] = state["gate"]

    def after(coord):
        # the mute outlived the window; lift it, and the next beat revives
        muted = list(coord._chaos._armed.hb_mute)
        assert len(muted) == 1
        coord._chaos.mute_heartbeats(muted[0], until=0.0)
        wait_for(lambda: len(coord._live) == 2, "the resurrection",
                 pump=coord._pump)

    coord, snap = _chaos_run(small_data, unfaulted, FleetConfig(
        n_workers=2, faults=faults, **CALM), patch=patch, after=after)
    assert state["gate"].held == 1
    assert snap["fleet.worker_deaths"] == 1
    assert snap["fleet.heartbeat_misses"] == 1
    assert snap["fleet.requeues"] == 1
    assert snap["fleet.joins"] == 3             # w0, w1, 1 resurrection
    assert snap["fleet.workers"] == 2


def test_lease_timeout_requeues_to_next_worker(small_data, unfaulted):
    # a worker that stalls (but does not die) past its lease: the lease
    # expires, requeues, and the re-dispatched job lands on the other
    # worker; the stalled job goes on only once the expiry is counted
    state = {}

    def patch(coord):
        reg = coord.obs.registry
        state["gate"] = Gate(coord._table["round"], hold=lambda n: n == 1,
                             until=lambda: reg.get(
                                 "fleet.lease_expiries") >= 1)
        coord._table["round"] = state["gate"]

    _, snap = _chaos_run(small_data, unfaulted, FleetConfig(
        n_workers=2, lease_timeout=2.0, **CALM), patch=patch)
    assert state["gate"].held == 1
    assert snap["fleet.lease_expiries"] >= 1
    assert snap["fleet.requeues"] >= 1
    assert snap["fleet.worker_deaths"] == 0


def test_elastic_join_and_leave(small_data, unfaulted):
    live = []

    def after(coord):
        # the leaver's goodbye may still be in flight when the run ends
        wait_for(lambda: coord.obs.registry.get("fleet.leaves") == 1,
                 "w0's leave", pump=coord._pump)
        live.extend(coord._live)

    coord, snap = _chaos_run(small_data, unfaulted, FleetConfig(
        n_workers=1, joins={2: ["newcomer"]}, leaves={4: ["w0"]}, **CALM),
        after=after)
    assert snap["fleet.joins"] == 2             # w0 + the newcomer
    assert snap["fleet.leaves"] == 1
    assert snap["fleet.workers"] == 1           # only the newcomer left
    assert snap["fleet.jobs"] == snap["fleet.results"] == 6
    assert live == ["newcomer"]


def test_unrecoverable_job_raises_with_fleet_keys(small_data):
    tr = fresh("fedavg", small_data, n_rounds=2)
    coord = Coordinator(tr, FleetConfig(n_workers=1, lease_timeout=0.1,
                                        max_retries=1, **CALM))
    gate = Gate(coord._table["round"], hold=lambda n: True)
    coord._table["round"] = gate
    try:
        with pytest.raises(RuntimeError, match=r"fleet job lease expired"
                           r".*lease_timeout=0.1s.*max_retries=1"):
            coord.run()
    finally:
        gate.release()
        coord.close()
    snap = fleet_snap(tr)
    assert snap["fleet.jobs"] == 2 and snap["fleet.results"] == 0


def test_worker_exception_surfaces_with_traceback(small_data):
    tr = fresh("fedavg", small_data, n_rounds=2)
    coord = Coordinator(tr, FleetConfig(n_workers=1, **CALM))

    def boom(*args):
        raise ValueError("kaboom in the executor")

    coord._table["round"] = boom
    try:
        with pytest.raises(RuntimeError, match=r"(?s)fleet worker 'w0' "
                           r"failed job 0.*Traceback.*ValueError: kaboom"):
            coord.run()
    finally:
        coord.close()


def test_async_result_slot_of_a_superseded_dispatch_is_released(
        small_data):
    # the card's dispatch executor hands out depth + 1 result slots: a
    # superseded async result gives its slot back on the coordinator
    tr = fresh("fedavg", small_data, async_depth=1)
    coord = Coordinator(tr, FleetConfig(n_workers=1, **CALM))
    released = []
    real = coord._real["async"]
    real.__dict__["release"] = released.append  # instance attribute
    try:
        coord._done.add(5)
        coord._async_jobs.add(5)
        coord._route(ttransport.Message("result", "w0", 5, "slot"), 0.0)
        coord._done.add(6)                      # a round job's late copy
        coord._route(ttransport.Message("result", "w0", 6, "x"), 0.0)
    finally:
        coord.close()
    assert released == ["slot"]
    assert fleet_snap(tr)["fleet.stale_results"] == 2
    assert np.isfinite(tr.history.max_acc)
