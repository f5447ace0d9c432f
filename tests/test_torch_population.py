"""The port's streamed populations (``repro_torch.fed.population`` and the
trainers' ``population=`` mode) on the CPU.

  * Scheduler, ``apply_shift`` and the staged cohorts against the JAX
    package's on the same inputs: the same cohorts round for round, the
    same arrays (both are numpy until the copy).
  * Streamed against pinned, port against port: all six trainers (FedAvg,
    FedGroup with EDC and MADC and with the shift detector, IFCA, FeSEM,
    FedClust, LCFL) with ``prefetch`` 0 and 2 give the pinned run's
    history, params and membership bit for bit.
  * Port against the JAX package, both streamed: FedGroup with newcomer
    arrivals and FeSEM, with the reference's draws replayed
    (``ReplayDraws``) and its params carried over; membership equal every
    round, loss and discrepancy within rtol 1e-3, accuracy within 0.01,
    ``local_flat`` within rtol 1e-4, atol 1e-6 (as
    ``tests/test_torch_strategies.py``).
  * Plumbing: producer errors raise, one attach, ``device_batch`` slices
    the live cohort, ``close()`` joins the thread, the state writer's
    errors surface at ``drain()``, the card is the default device.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from _torch_parity import ReplayDraws, tnp
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core.fedgroup import FedGroupTrainer as JFedGroup
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed import population as jpop
from repro.fed import store as jstore
from repro.fed.engine import FedConfig as JFedConfig
from repro.fed.fesem import FeSEMTrainer as JFeSEM
from repro.models import paper_models as jpm
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed import population as tpop
from repro_torch.fed import store as tstore
from repro_torch.fed import strategies
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.models import paper_models as tpm

ROUNDS = 3
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def small_data():
    kw = dict(seed=0, n_clients=40, classes_per_client=2, total_train=2000,
              dim=16)
    return j_mnist_like(**kw), mnist_like(**kw)


def _cfg(**kw):
    base = dict(n_rounds=ROUNDS, clients_per_round=8, local_epochs=1,
                batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4, seed=0)
    base.update(kw)
    return FedConfig(**base)


def _stores(small_data):
    jdata, tdata = small_data
    return jstore.ArrayClientStore(jdata), tstore.ArrayClientStore(tdata)


# ---------------------------------------------------------------------------
# Scheduler and shift against the reference
# ---------------------------------------------------------------------------
SCHEDULES = {
    "uniform": (dict(), 8, 0.0),
    "size": (dict(sampler="size", initial_active=40), 5, 0.0),
    "diurnal": (dict(availability="diurnal", period=8, duty=0.25), 50, 0.0),
    "arrivals": (dict(initial_active=10, arrival_rate=5.0, seed=1), 6, 0.0),
    "arrivals_stay_out": (dict(initial_active=10, arrival_rate=3.0,
                               newcomers_join=False), 6, 0.0),
    "scripted": (dict(sampler="scripted",
                      script=[np.array([1, 2, 3]), np.array([4, 5])]), 3,
                 0.0),
    "dropout": (dict(), 8, 0.4),
    "dropout_arrivals": (dict(initial_active=20, arrival_rate=2.0), 8, 0.9),
    "all_asleep": (dict(availability="diurnal", period=10, duty=0.1,
                        initial_active=2, seed=5), 6, 0.0),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_scheduler_matches_reference(case, small_data):
    kw, k, dropout = SCHEDULES[case]
    js, ts = _stores(small_data)
    jsch = jpop.Scheduler(js, jpop.PopulationConfig(**kw), seed=3)
    tsch = tpop.Scheduler(ts, tpop.PopulationConfig(**kw), seed=3)
    np.testing.assert_array_equal(tsch.active, jsch.active)
    for t in range(12):
        ti, tn = tsch.select(t, k, dropout)
        ji, jn = jsch.select(t, k, dropout)
        np.testing.assert_array_equal(ti, ji)
        assert tn == jn and len(ti) >= 1
        np.testing.assert_array_equal(tsch.last_arrivals, jsch.last_arrivals)
        np.testing.assert_array_equal(tsch.available_mask(t),
                                      jsch.available_mask(t))
    np.testing.assert_array_equal(tsch.active_ids(), jsch.active_ids())
    assert tsch.rounds_scheduled == jsch.rounds_scheduled == 12


def test_scheduler_with_no_active_clients_raises_like_reference(small_data):
    js, ts = _stores(small_data)
    for mod, store in ((jpop, js), (tpop, ts)):
        sch = mod.Scheduler(store, mod.PopulationConfig(initial_active=0),
                            seed=0)
        sch.active[:] = False
        with pytest.raises(RuntimeError, match="no active clients"):
            sch.select(0, 5)


def test_scheduler_snapshot_restore_replays(small_data):
    _, ts = _stores(small_data)
    cfg = tpop.PopulationConfig(initial_active=10, arrival_rate=3.0)
    a = tpop.Scheduler(ts, cfg, seed=0)
    for t in range(3):
        a.select(t, 6)
    snap = a.snapshot()
    ahead = [a.select(t, 6)[0] for t in range(3, 6)]
    b = tpop.Scheduler(ts, cfg, seed=0)
    b.restore(snap)
    for t, want in zip(range(3, 6), ahead):
        np.testing.assert_array_equal(b.select(t, 6)[0], want)


SHIFTS = [
    [dict(at=2, classes=(0, 2))],
    [dict(at=0, classes=None, frac=0.5)],
    [dict(at=1, kind="drift", duration=3, classes=(1, 3, 5), frac=0.7)],
    [dict(at=1, classes=(0, 1)), dict(at=2, kind="drift", duration=0)],
]


@pytest.mark.parametrize("specs", range(len(SHIFTS)))
def test_apply_shift_matches_reference(specs):
    rng = np.random.default_rng(specs)
    y = rng.integers(0, 10, (12, 9)).astype(np.int32)
    idx = rng.choice(50, 12, replace=False)
    jcfg = jpop.ShiftConfig([jpop.ShiftSpec(**s) for s in SHIFTS[specs]],
                            seed=4)
    tcfg = tpop.ShiftConfig([tpop.ShiftSpec(**s) for s in SHIFTS[specs]],
                            seed=4)
    for t in (None, -1, 0, 1, 2, 3, 5):
        got = tpop.apply_shift(tcfg, 50, 10, t, idx, y)
        want = jpop.apply_shift(jcfg, 50, 10, t, idx, y)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpop.shift_client_mask(50, 4, 1, 0.3),
                                  jpop.shift_client_mask(50, 4, 1, 0.3))
    np.testing.assert_array_equal(tpop.shift_label_map(6, (4, 1)),
                                  jpop.shift_label_map(6, (4, 1)))
    with pytest.raises(ValueError, match="unknown shift kind"):
        tpop.apply_shift(tpop.ShiftConfig([tpop.ShiftSpec(0, kind="x")]),
                         50, 10, 1, idx, y)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_staged_cohorts_match_reference(prefetch, small_data):
    """The port's cohorts, ad-hoc gathers and eval blocks hold the
    reference population's arrays (shifted labels included), as float32 /
    int64 tensors."""
    js, ts = _stores(small_data)
    kw = dict(initial_active=12, arrival_rate=2.0, prefetch=prefetch,
              eval_clients=15, eval_batch=4)
    shift = [dict(at=1, classes=(0, 1, 2), frac=0.6)]
    jp = jpop.Population(js, jpop.PopulationConfig(
        shift=jpop.ShiftConfig([jpop.ShiftSpec(**s) for s in shift]), **kw))
    tp = tpop.Population(ts, tpop.PopulationConfig(
        shift=tpop.ShiftConfig([tpop.ShiftSpec(**s) for s in shift]), **kw))
    jp.attach(JFedConfig(clients_per_round=6, dropout_rate=0.2, seed=1))
    tp.attach(_cfg(clients_per_round=6, dropout_rate=0.2, seed=1), "cpu")
    try:
        for _ in range(4):
            jc, tc = jp.next_cohort(), tp.next_cohort()
            assert tc.t == jc.t and tc.n_new == jc.n_new
            np.testing.assert_array_equal(tc.idx, jc.idx)
            assert (tc.x.dtype, tc.y.dtype, tc.n.dtype) == \
                (torch.float32, torch.int64, torch.int64)
            for a, b in ((tc.x, jc.x), (tc.y, jc.y), (tc.n, jc.n)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert tc.stage_ms >= 0.0
        other = np.setdiff1d(np.arange(40), tc.idx)[:5]
        for a, b in zip(tp.device_batch(other), jp.device_batch(other)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(tp.eval_ids(), jp.eval_ids())
        for tb, jb in zip(tp.eval_batches(), jp.eval_batches(), strict=True):
            np.testing.assert_array_equal(tb[0], jb[0])
            for a, b in zip(tb[1:], jb[1:]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    finally:
        jp.close()
        tp.close()


# ---------------------------------------------------------------------------
# Streamed against pinned, port against port, bit for bit
# ---------------------------------------------------------------------------
TRAINERS = {
    "fedavg": lambda: (FedAvgTrainer, _cfg()),
    "fedprox": lambda: (FedAvgTrainer, _cfg(mu=0.01)),
    "fedgroup": lambda: (FedGroupTrainer, _cfg()),
    "fedgroup_madc": lambda: (FedGroupTrainer, _cfg(measure="madc")),
    "fedgroup_shift": lambda: (FedGroupTrainer, _cfg(shift_threshold=0.0)),
    "ifca": lambda: ("ifca", _cfg()),
    "fesem": lambda: ("fesem", _cfg()),
    "fedclust": lambda: ("fedclust", _cfg()),
    "lcfl": lambda: ("lcfl", _cfg()),
}


def _make(kind, model, data, cfg, **kw):
    if isinstance(kind, str):
        return strategies.make_trainer(kind, model, data, cfg, device="cpu",
                                       **kw)
    return kind(model, data, cfg, device="cpu", **kw)


def _assert_equal_dicts(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def pinned_runs(small_data):
    """Each trainer's pinned run, made once for both prefetch depths."""
    runs = {}

    def get(name):
        if name not in runs:
            kind, cfg = TRAINERS[name]()
            tr = _make(kind, tpm.mclr(16, 10), small_data[1], cfg)
            runs[name] = (tr, tr.run(ROUNDS))
        return runs[name]

    return get


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_streamed_equals_pinned(name, prefetch, small_data, pinned_runs):
    _, tdata = small_data
    kind, cfg = TRAINERS[name]()
    model = tpm.mclr(16, 10)
    pinned, h_pin = pinned_runs(name)
    pop = tpop.Population(tstore.ArrayClientStore(tdata),
                          tpop.PopulationConfig(prefetch=prefetch,
                                                eval_batch=7))
    streamed = _make(kind, model, None, cfg, population=pop)
    h_st = streamed.run(ROUNDS)
    streamed.close()
    assert h_st.rounds == h_pin.rounds            # acc, loss, disc, exactly
    assert streamed.comm_params == pinned.comm_params
    assert streamed.counters == pinned.counters
    _assert_equal_dicts(streamed.params, pinned.params)
    if name.startswith("fedavg") or name == "fedprox":
        return
    _assert_equal_dicts(streamed.group_params, pinned.group_params)
    np.testing.assert_array_equal(streamed.membership, pinned.membership)
    assert streamed.membership is pop.state.membership
    touched = np.flatnonzero(streamed.membership >= 0)
    if name in ("fesem", "fedclust"):
        rows = pop.gather_local_flat(touched)
        assert rows.device.type == "cpu" and streamed.local_flat is None
        assert torch.equal(rows, pinned.local_flat[touched])
    if name.startswith("fedgroup"):
        # every cold-started client left its eq.-9 direction on the host
        assert pop.state.has_pretrain_dir(touched).all()
        dirs = pop.state.get_pretrain_dir(touched)
        assert dirs.device.type == "cpu" and torch.isfinite(dirs).all()
    if name == "fedgroup_shift":
        assert streamed.counters["rounds.shift_checks"] > 0


def test_streamed_eval_equals_pinned(small_data):
    _, tdata = small_data
    model = tpm.mclr(16, 10)
    pinned = FedAvgTrainer(model, tdata, _cfg(), device="cpu")
    pop = tpop.Population(tstore.ArrayClientStore(tdata),
                          tpop.PopulationConfig(eval_batch=7))
    streamed = FedAvgTrainer(model, None, _cfg(), device="cpu",
                             population=pop)
    assert streamed.evaluate() == pinned.evaluate()
    sub = np.array([1, 5, 9])
    assert streamed.evaluate(client_idx=sub) == \
        pinned.evaluate(client_idx=sub)
    assert streamed.evaluate(client_idx=[]) == 0.0
    streamed.close()


def test_eval_subsample_is_the_reference(small_data):
    js, ts = _stores(small_data)
    jp = jpop.Population(js, jpop.PopulationConfig(eval_clients=11))
    tp = tpop.Population(ts, tpop.PopulationConfig(eval_clients=11))
    jp.attach(JFedConfig(seed=7))
    tp.attach(_cfg(seed=7), "cpu")
    np.testing.assert_array_equal(tp.eval_ids(), jp.eval_ids())
    assert len(tp.eval_ids()) == 11
    jp.close()
    tp.close()


def test_streamed_run_stays_per_round(small_data):
    """``block_size > 1`` with a population runs per round, as the
    reference's (``Population.block_stageable`` is False)."""
    _, tdata = small_data
    model = tpm.mclr(16, 10)
    pinned = FedAvgTrainer(model, tdata, _cfg(), device="cpu")
    pop = tpop.Population(tstore.ArrayClientStore(tdata))
    streamed = FedAvgTrainer(model, None, _cfg(block_size=4), device="cpu",
                             population=pop)
    assert tpop.Population.block_stageable is False
    assert streamed.run(ROUNDS).rounds == pinned.run(ROUNDS).rounds
    assert streamed._block_exec is None
    streamed.close()


def test_arrivals_route_newcomers_every_round(small_data):
    _, tdata = small_data
    pop = tpop.Population(tstore.ArrayClientStore(tdata),
                          tpop.PopulationConfig(initial_active=15,
                                                arrival_rate=4.0, seed=2))
    tr = FedGroupTrainer(tpm.mclr(16, 10), None, _cfg(seed=2), device="cpu",
                         population=pop)
    cold = []
    for t in range(4):
        tr.round(t)
        cold.append(tr.last_cold)
    tr.close()
    assert sum(cold[1:]) > 0
    arrived = pop.scheduler.active_ids()
    assert (tr.membership[np.setdiff1d(np.arange(40), arrived)] < 0).all()


# ---------------------------------------------------------------------------
# Port against the JAX package, both streamed
# ---------------------------------------------------------------------------
def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_round_agrees(jm, tm):
    np.testing.assert_allclose(tm.mean_loss, jm.mean_loss, rtol=1e-3)
    np.testing.assert_allclose(tm.discrepancy, jm.discrepancy, rtol=1e-3)
    assert abs(tm.weighted_acc - jm.weighted_acc) <= 0.01


def test_fedgroup_with_arrivals_matches_reference(small_data):
    jdata, tdata = small_data
    jcfg = JFedConfig(n_rounds=4, clients_per_round=8, local_epochs=1,
                      batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4,
                      seed=2)
    pkw = dict(initial_active=15, arrival_rate=4.0, eval_batch=6)
    jp = jpop.Population(jstore.ArrayClientStore(jdata),
                         jpop.PopulationConfig(**pkw))
    tp = tpop.Population(tstore.ArrayClientStore(tdata),
                         tpop.PopulationConfig(**pkw))
    jtr = JFedGroup(jpm.mlp(16, 12, 10), None, jcfg, population=jp)
    ttr = FedGroupTrainer(
        tpm.mlp(16, 12, 10), None, FedConfig(**dataclasses.asdict(jcfg)),
        device="cpu", population=tp,
        init_params=params_from_numpy(_np_tree(jtr.params)),
        draws=ReplayDraws(jcfg.seed))
    cold = 0
    try:
        for t in range(4):
            jm, tm = jtr.round(t), ttr.round(t)
            assert np.array_equal(ttr.membership, jtr.membership), t
            assert ttr.last_cold == jtr.last_cold
            cold += ttr.last_cold
            _assert_round_agrees(jm, tm)
        assert ttr.comm_params == jtr.comm_params
        assert cold > 0
        np.testing.assert_array_equal(tp.scheduler.active_ids(),
                                      jp.scheduler.active_ids())
        ids = np.flatnonzero(ttr.membership >= 0)
        np.testing.assert_allclose(tnp(tp.state.get_pretrain_dir(ids)),
                                   jp.state.get_pretrain_dir(ids), **TOL)
    finally:
        jtr.close()
        ttr.close()


def test_fesem_streamed_matches_reference(small_data):
    jdata, tdata = small_data
    jcfg = JFedConfig(n_rounds=ROUNDS, clients_per_round=8, local_epochs=1,
                      batch_size=5, lr=0.05, n_groups=3, seed=0)
    jp = jpop.Population(jstore.ArrayClientStore(jdata),
                         jpop.PopulationConfig())
    tp = tpop.Population(tstore.ArrayClientStore(tdata),
                         tpop.PopulationConfig())
    jtr = JFeSEM(jpm.mlp(16, 12, 10), None, jcfg, population=jp)
    ttr = strategies.make_trainer(
        "fesem", tpm.mlp(16, 12, 10), None,
        FedConfig(**dataclasses.asdict(jcfg)), device="cpu", population=tp,
        init_params=params_from_numpy(_np_tree(jtr.params)),
        init_group_params=params_from_numpy(_np_tree(jtr.group_params)),
        draws=ReplayDraws(jcfg.seed))
    try:
        for t in range(ROUNDS):
            jm, tm = jtr.round(t), ttr.round(t)
            assert np.array_equal(ttr.membership, jtr.membership), t
            _assert_round_agrees(jm, tm)
            ids = np.flatnonzero(ttr.membership >= 0)
            np.testing.assert_allclose(tp.gather_local_flat(ids).numpy(),
                                       jp.gather_local_flat(ids), **TOL)
        assert ttr.comm_params == jtr.comm_params
    finally:
        jtr.close()
        ttr.close()


# ---------------------------------------------------------------------------
# Plumbing
# ---------------------------------------------------------------------------
def test_producer_failure_raises_instead_of_hanging(small_data):
    _, ts = _stores(small_data)

    def boom(split, idx):
        raise OSError("disk gone")

    ts._gather = boom
    pop = tpop.Population(ts, tpop.PopulationConfig(prefetch=1))
    pop.attach(_cfg(), "cpu")
    with pytest.raises(RuntimeError, match="prefetch thread failed") as e:
        pop.next_cohort()
    assert isinstance(e.value.__cause__, OSError)
    pop.close()
    with pytest.raises(RuntimeError, match="close"):
        pop.next_cohort()


def test_population_attaches_once(small_data):
    _, tdata = small_data
    pop = tpop.Population(tstore.ArrayClientStore(tdata))
    tr = FedAvgTrainer(tpm.mclr(16, 10), None, _cfg(), device="cpu",
                       population=pop)
    with pytest.raises(RuntimeError, match="already attached"):
        FedAvgTrainer(tpm.mclr(16, 10), None, _cfg(), device="cpu",
                      population=pop)
    tr.close()
    with pytest.raises(ValueError, match="population="):
        FedAvgTrainer(tpm.mclr(16, 10), None, _cfg(), device="cpu")
    with pytest.raises(RuntimeError, match="attach"):
        tpop.Population(tstore.ArrayClientStore(tdata)).next_cohort()


def test_device_batch_slices_the_live_cohort(small_data):
    _, ts = _stores(small_data)
    pop = tpop.Population(ts, tpop.PopulationConfig(prefetch=0))
    pop.attach(_cfg(), "cpu")
    c = pop.next_cohort()
    x, y, n = pop.device_batch(c.idx[[2, 0]])
    assert torch.equal(x, c.x[[2, 0]]) and torch.equal(n, c.n[[2, 0]])
    assert all(a is b for a, b in zip(pop.device_batch(c.idx),
                                      (c.x, c.y, c.n)))
    other = np.setdiff1d(np.arange(40), c.idx)[:3]
    x, y, n = pop.device_batch(other)
    want = ts.gather_train(other)
    np.testing.assert_array_equal(x.numpy(), want[0])
    np.testing.assert_array_equal(y.numpy(), want[1])
    assert c.positions([other[0]]) is None
    pop.close()


def test_close_joins_the_prefetch_thread(small_data):
    _, ts = _stores(small_data)
    pop = tpop.Population(ts, tpop.PopulationConfig(prefetch=2))
    pop.attach(_cfg(), "cpu")
    pop.next_cohort()
    thread = pop._thread
    assert thread.is_alive()
    pop.close()
    assert pop._thread is None and not thread.is_alive()
    pop.close()                                   # a second close is a no-op


def test_what_is_not_ported_raises(small_data):
    """Faults, the deadline and the writer's retries are ported (held by
    ``tests/test_torch_faults.py``); what stays: ``stats`` starts at the
    reference's zeros, and the card is the default device."""
    _, ts = _stores(small_data)
    pop = tpop.Population(ts)
    assert pop.stats == dict.fromkeys(jpop._STATS_ZERO, 0)
    assert tpop._AsyncStateWriter().max_retries == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pop.attach(_cfg())                    # the default is the card


def test_state_writer_is_fifo_and_raises_at_drain():
    w = tpop._AsyncStateWriter(timeout=5.0)
    seen = []
    gate = threading.Event()
    w.submit(gate.wait, 5.0)
    for i in range(20):
        w.submit(seen.append, i)
    gate.set()
    w.drain()
    assert seen == list(range(20))

    def fail():
        raise OSError("disk full")

    w.submit(fail)
    w.submit(seen.append, 20)                     # later writes still land
    with pytest.raises(RuntimeError, match="write failed") as e:
        w.drain()
    assert isinstance(e.value.__cause__, OSError) and seen[-1] == 20
    w.drain()                                     # the error is raised once
    w.close()
    assert w._thread is None


def test_state_writer_drain_is_bounded():
    w = tpop._AsyncStateWriter()
    gate = threading.Event()
    w.submit(gate.wait, 10.0, label="slow write")
    with pytest.raises(RuntimeError, match="slow write"):
        w.drain(timeout=0.2)
    gate.set()
    w.close()
