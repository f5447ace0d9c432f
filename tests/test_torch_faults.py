"""The port's failure domain (``repro_torch.fed.population``) on the CPU:
scripted faults, the straggler deadline, the state writer's retries and
crash hook, and the empty-cohort edge, at ``tests/test_robustness.py``'s
fixtures.

  * Port against port: a mid-round death drops the cohort's tail (floored
    at one survivor), a straggling round degrades to its staged prefix at
    the deadline (inline and on the producer thread) and no round is lost,
    a deadline that never fires leaves the run bit-identical to the
    pinned run, a killed writer thread is raised at the next drain and at
    close, and the quarantine keeps poisoned updates out.
  * Port against the JAX package (``repro.fed.population``): the same
    ``FaultConfig`` kills the same clients, poisons the same lanes with the
    same bytes, whole or in deadline chunks, and leaves equal ``stats``.
  * The writer's FIFO order, bounded drain, retries with backoff and the
    failure it raises once they are spent.
  * The fleet faults (``worker_kill``, ``heartbeat_delay``, ``msg_*``)
    are the coordinator's (``tests/test_torch_fleet.py``): a population
    takes a script that sets them and ignores them, as the reference's
    does.
"""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed import population as jpop
from repro.fed import store as jstore
from repro.fed.engine import FedConfig as JFedConfig
from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed import strategies
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.fed.population import (FaultConfig, FaultSpec, Population,
                                        PopulationConfig, Scheduler,
                                        _AsyncStateWriter)
from repro_torch.fed.store import ArrayClientStore
from repro_torch.models.paper_models import mclr

DATA_KW = dict(seed=0, n_clients=40, classes_per_client=2, total_train=2000,
               dim=16)


@pytest.fixture(scope="module")
def small_data():
    return mnist_like(**DATA_KW)


def _cfg(**kw):
    base = dict(n_rounds=4, clients_per_round=8, local_epochs=2,
                batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4, seed=0)
    base.update(kw)
    return FedConfig(**base)


def _streamed(cls, data, cfg=None, **pop_kw):
    pop = Population(ArrayClientStore(data), PopulationConfig(**pop_kw))
    return cls(mclr(16, 10), None, cfg or _cfg(), device="cpu",
               population=pop), pop


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in tree.values())


# ---------------------------------------------------------------------------
# faults and the deadline, port against port
# ---------------------------------------------------------------------------
def test_mid_round_client_death(small_data):
    tr, pop = _streamed(FedAvgTrainer, small_data,
                        faults=FaultConfig(rounds={1: FaultSpec(kill=5)}))
    h = tr.run(3)
    tr.close()
    assert pop.stats["killed_clients"] == 5
    assert len(h.rounds) == 3
    assert _finite(tr.params)


def test_kill_floors_at_one_survivor(small_data):
    tr, pop = _streamed(FedAvgTrainer, small_data, prefetch=0,
                        faults=FaultConfig(rounds={0: FaultSpec(kill=100)}))
    tr.run(1)
    tr.close()
    assert pop.stats["killed_clients"] == 7       # 8-client cohort -> 1


@pytest.mark.parametrize("prefetch", [2, 0], ids=["prefetch", "sync"])
def test_deadline_degrades_straggling_round(prefetch, small_data):
    # round 0 straggles: the consumer cannot run ahead of the first round,
    # so the deadline fires mid-gather deterministically
    faults = FaultConfig(rounds={0: FaultSpec(straggle=2.0)})
    tr, pop = _streamed(FedAvgTrainer, small_data, faults=faults,
                        prefetch=prefetch, deadline=0.3, stage_chunks=4)
    seen = []
    next_cohort = pop.next_cohort
    pop.next_cohort = lambda: seen.append(next_cohort()) or seen[-1]
    h = tr.run(3)
    tr.close()
    assert pop.stats["deadline_rounds"] >= 1
    assert pop.stats["deadline_dropped_clients"] >= 1
    assert len(h.rounds) == 3
    assert _finite(tr.params)
    # the degraded cohort is the staged prefix of round 0's cohort
    c0 = seen[0]
    assert 1 <= len(c0.idx) < 8 and c0.x.shape[0] == len(c0.idx)
    want = ArrayClientStore(small_data).gather_train(c0.idx)
    np.testing.assert_array_equal(c0.x.numpy(), want[0])


def test_deadline_race_keeps_every_cohort_whole(small_data):
    """Producer and consumer race for every round's staging record: a
    tiny deadline against straggling chunks, thread switches forced often.
    Every cohort is still its round's staged prefix, gathered intact, and
    ``stats`` counts exactly the dropped clients."""
    store = ArrayClientStore(small_data)
    faults = FaultConfig({t: FaultSpec(straggle=0.02 * (t % 3))
                          for t in range(40)})
    pop = Population(store, PopulationConfig(
        faults=faults, prefetch=2, deadline=0.005, stage_chunks=4))
    pop.attach(_cfg(), "cpu")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        dropped = 0
        for t in range(40):
            c = pop.next_cohort()
            assert c.t == t and 1 <= len(c.idx) <= 8
            x, y, n = store.gather_train(c.idx)
            np.testing.assert_array_equal(c.x.numpy(), x)
            np.testing.assert_array_equal(c.n.numpy(), n)
            dropped += 8 - len(c.idx)
    finally:
        sys.setswitchinterval(switch)
        pop.close()
    assert pop._thread is None
    assert pop.stats["deadline_dropped_clients"] == dropped
    assert pop.stats["deadline_rounds"] >= 1


def test_generous_deadline_is_bit_identical_to_pinned(small_data):
    pin = FedAvgTrainer(mclr(16, 10), small_data, _cfg(), device="cpu")
    h_pin = pin.run(3)
    for prefetch in (2, 0):
        st, pop = _streamed(FedAvgTrainer, small_data, deadline=60.0,
                            stage_chunks=4, prefetch=prefetch)
        h_st = st.run(3)
        st.close()
        assert pop.stats["deadline_rounds"] == 0
        assert h_st.rounds == h_pin.rounds
        for k in pin.params:
            assert torch.equal(st.params[k], pin.params[k])


def test_writer_thread_crash_is_surfaced(small_data):
    faults = FaultConfig(rounds={1: FaultSpec(writer_crash=True)})
    pop = Population(ArrayClientStore(small_data),
                     PopulationConfig(faults=faults))
    tr = strategies.make_trainer("fesem", mclr(16, 10), None, _cfg(),
                                 device="cpu", population=pop)
    with pytest.raises(RuntimeError, match="writer thread died"):
        tr.run(4)
    assert pop.stats["writer_crashes"] == 1
    pop._stop.set()                       # stop the producer ...
    with pytest.raises(RuntimeError, match="writer thread died"):
        pop.close()                       # ... shutdown reports, not hangs


def test_quarantine_keeps_params_finite_under_faults(small_data):
    faults = FaultConfig(rounds={
        1: FaultSpec(corrupt=3, corrupt_mode="nan"),
        2: FaultSpec(corrupt=2, corrupt_mode="inf"),
        3: FaultSpec(corrupt=2, corrupt_mode="scale")})
    tr, pop = _streamed(FedGroupTrainer, small_data, _cfg(quarantine=True),
                        faults=faults)
    h = tr.run(5)
    tr.close()
    assert _finite(tr.group_params) and _finite(tr.params)
    assert pop.stats["corrupted_clients"] == 7
    assert h.total_quarantined >= 5
    assert h.rounds[1].quarantined >= 1 and h.rounds[2].quarantined >= 1
    assert h.rounds[0].quarantined == 0
    # without the screen a NaN payload reaches the group params
    tr, _ = _streamed(FedGroupTrainer, small_data, faults=FaultConfig(
        rounds={1: FaultSpec(corrupt=3, corrupt_mode="nan")}))
    h = tr.run(5)
    tr.close()
    assert not _finite(tr.group_params) and h.total_quarantined == 0


# ---------------------------------------------------------------------------
# the same FaultConfig against the JAX package's population
# ---------------------------------------------------------------------------
FAULTS = {0: FaultSpec(kill=3, corrupt=2, corrupt_mode="nan"),
          1: FaultSpec(corrupt=4, corrupt_mode="scale"),
          2: FaultSpec(kill=100),
          3: FaultSpec(corrupt=3, corrupt_mode="inf", kill=2)}
POP_CASES = {"whole": dict(prefetch=0),
             "chunked": dict(prefetch=0, deadline=60.0, stage_chunks=3),
             "prefetch": dict(prefetch=2, initial_active=25,
                              arrival_rate=2.0)}


@pytest.mark.parametrize("case", sorted(POP_CASES))
def test_faults_match_the_reference(case, small_data):
    kw = POP_CASES[case]
    jp = jpop.Population(
        jstore.ArrayClientStore(j_mnist_like(**DATA_KW)),
        jpop.PopulationConfig(faults=jpop.FaultConfig(
            {t: jpop.FaultSpec(**vars(s)) for t, s in FAULTS.items()},
            seed=5), **kw))
    tp = Population(ArrayClientStore(small_data), PopulationConfig(
        faults=FaultConfig(FAULTS, seed=5), **kw))
    jp.attach(JFedConfig(clients_per_round=8, seed=1))
    tp.attach(_cfg(seed=1), "cpu")
    try:
        for t in range(len(FAULTS)):
            jc, tc = jp.next_cohort(), tp.next_cohort()
            np.testing.assert_array_equal(tc.idx, jc.idx)
            assert tc.n_new == jc.n_new
            np.testing.assert_array_equal(tc.x.numpy(), np.asarray(jc.x))
            np.testing.assert_array_equal(tc.y.numpy(), np.asarray(jc.y))
            np.testing.assert_array_equal(tc.n.numpy(), np.asarray(jc.n))
        assert tp.stats == dict(jp.stats)
        assert tp.stats["killed_clients"] == 3 + 7 + 2
        assert tp.stats["corrupted_clients"] > 0
    finally:
        jp.close()
        tp.close()


def test_fault_spec_fields_equal_the_reference():
    for ours, ref in ((FaultSpec, jpop.FaultSpec),
                      (FaultConfig, jpop.FaultConfig),
                      (PopulationConfig, jpop.PopulationConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(ref)]
    assert dict(jpop._STATS_ZERO) == \
        Population(ArrayClientStore(mnist_like(**DATA_KW))).stats


@pytest.mark.parametrize("field,value", [
    ("worker_kill", True), ("heartbeat_delay", 0.5), ("msg_drop", True),
    ("msg_dup", True), ("msg_reorder", True),
])
def test_fleet_faults_are_refused(field, value, small_data):
    # the coordinator reads these from FleetConfig.faults on its dispatch
    # clock (launch.coordinator); a population takes the script and
    # ignores them, as the reference's does: the run equals one whose
    # script lacks them
    runs = []
    for fleet in ({field: value}, {}):
        faults = FaultConfig({0: FaultSpec(kill=1), 2: FaultSpec(**fleet)})
        tr, pop = _streamed(FedAvgTrainer, small_data, faults=faults)
        h = tr.run(3)
        tr.close()
        runs.append((h.rounds, dict(pop.stats),
                     {k: v.numpy() for k, v in tr.params.items()}))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    assert runs[0][1]["killed_clients"] == 1
    for k in runs[0][2]:
        np.testing.assert_array_equal(runs[0][2][k], runs[1][2][k])


# ---------------------------------------------------------------------------
# the empty-cohort edge: selection always yields >= 1 client
# ---------------------------------------------------------------------------
def test_full_dropout_keeps_one_client(small_data):
    sched = Scheduler(ArrayClientStore(small_data), PopulationConfig(),
                      seed=0)
    idx, _ = sched.select(0, 8, dropout_rate=1.0)
    assert len(idx) == 1


def test_all_asleep_wakes_one_active(small_data):
    sched = Scheduler(ArrayClientStore(small_data),
                      PopulationConfig(availability="diurnal", duty=0.0,
                                       initial_active=10), seed=0)
    for t in range(3):
        idx, _ = sched.select(t, 8)
        assert len(idx) == 1 and sched.active[idx[0]]


def test_no_active_clients_is_an_error(small_data):
    sched = Scheduler(ArrayClientStore(small_data),
                      PopulationConfig(initial_active=0), seed=0)
    with pytest.raises(RuntimeError, match="no active clients"):
        sched.select(0, 8)


def test_pinned_select_keeps_one_client(small_data):
    tr = FedAvgTrainer(mclr(16, 10), small_data, _cfg(dropout_rate=1.0),
                       device="cpu")
    assert len(tr._select()) == 1


def test_streamed_run_survives_empty_rounds(small_data):
    tr, _ = _streamed(FedAvgTrainer, small_data, availability="diurnal",
                      duty=0.0, initial_active=10, prefetch=0)
    h = tr.run(2)
    tr.close()
    assert len(h.rounds) == 2 and _finite(tr.params)


# ---------------------------------------------------------------------------
# the state writer
# ---------------------------------------------------------------------------
def test_writes_land_in_order():
    w, out = _AsyncStateWriter(), []
    for i in range(5):
        w.submit(out.append, i)
    w.drain()
    assert out == [0, 1, 2, 3, 4]
    w.close()


def test_drain_timeout_names_the_write_in_flight():
    w = _AsyncStateWriter()
    gate = threading.Event()
    w.submit(gate.wait, 5.0, label="slow-write")
    with pytest.raises(RuntimeError,
                       match=r"did not complete within 0\.2s.*slow-write"):
        w.drain(timeout=0.2)
    gate.set()
    w.drain(timeout=5.0)                  # the write lands after all
    w.close()


def test_dead_thread_is_surfaced_not_awaited():
    w, out = _AsyncStateWriter(), []
    w.submit(out.append, 1)
    w.drain()
    w.inject_thread_crash()
    w.submit(out.append, 2)               # queued behind the crash
    with pytest.raises(RuntimeError, match=r"writer thread died with 2 write"):
        w.drain(timeout=2.0)
    with pytest.raises(RuntimeError, match="writer thread died"):
        w.close(timeout=0.5)
    assert out == [1]


def test_transient_failures_recover_with_backoff():
    w = _AsyncStateWriter(timeout=5.0, max_retries=3, backoff=0.001,
                          backoff_cap=0.01)
    assert _AsyncStateWriter().max_retries == 3   # the default retries
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise OSError("transient")

    t0 = time.monotonic()
    w.submit(flaky, label="flaky-scatter")
    w.drain()                             # recovers: nothing raised
    w.close()
    assert calls["n"] == 3 and w.retries == 2
    assert time.monotonic() - t0 >= 0.001 + 0.002     # backoff slept


def test_exhausted_retries_surface_in_drain():
    w = _AsyncStateWriter(timeout=5.0, max_retries=1, backoff=0.001)
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise OSError("disk gone")

    w.submit(broken)
    with pytest.raises(RuntimeError, match="write failed") as ei:
        w.drain()
    w.close()
    assert calls["n"] == 2                # the attempt and one retry
    assert isinstance(ei.value.__cause__, OSError)
    assert w.retries == 0


def test_writer_retries_reach_population_stats(small_data):
    pop = Population(ArrayClientStore(small_data),
                     PopulationConfig(prefetch=0))
    pop.attach(_cfg(), "cpu")
    pop._writer.backoff = 0.001
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("transient")

    pop._writer.submit(flaky)
    _, meta = pop.ckpt_state()            # drains, then syncs the count
    assert meta["stats"]["writer_retries"] == 1
    assert pop.stats["writer_retries"] == 1
    pop.close()
