"""Round blocks in the port (``FedConfig.block_size > 1``): the port's
block path against its own per-round path, and against the JAX package's
block path (``tests/test_round_block.py`` holds the reference to the same
properties).

On the CPU a block runs ``fed.rounds.make_block_executor``'s step eagerly,
so block == per-round holds bit for bit (history, group params,
membership, FedGroup's ``group_delta``, FeSEM / FedClust's ``local_flat``,
``comm_params`` and counters) for all six pinned trainers, with
``block_size=4`` over 6 rounds: a full block, a partial tail and, for
FedGroup, per-round breaks on cold newcomers. The one counter that may
differ is ``rounds.migrations``: block rounds write membership without
counting migrations, as the reference's block path does. Dropout cohorts
pad to K with zero-weight lanes and agree with the variable-size
per-round path within rtol 1e-6 (sums of another length).

Against JAX (``ReplayDraws``, the JAX trainer's params carried over):
loss and discrepancy within rtol 1e-3, membership equal, accuracy within
0.01, ``local_flat`` within rtol 1e-4, atol 1e-6 — the tolerances of the
per-round parity tests.

``tests/test_torch_round_block_gpu.py`` holds the captured graphs against
the eager per-round run on the card.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from _torch_parity import ReplayDraws, tnp
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core.fedgroup import FedGroupTrainer as JFedGroupTrainer
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed.engine import FedAvgTrainer as JFedAvgTrainer
from repro.fed.engine import FedConfig as JFedConfig
from repro.fed.fesem import FeSEMTrainer as JFeSEMTrainer
from repro.fed.ifca import IFCATrainer as JIFCATrainer
from repro.models import paper_models as jpm
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed import graphs, strategies
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.models import paper_models as tpm

ALL = ["fedavg", "fedgroup", "ifca", "fesem", "fedclust", "lcfl"]
DATA_KW = dict(seed=0, n_clients=40, classes_per_client=2, total_train=2000,
               dim=16)
LF_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def tdata():
    return mnist_like(**DATA_KW)


def _cfg(**kw):
    # pretrain_scale 8: 24 of the 40 clients are Alg.-3 founders, so a
    # FedGroup run has both cohorts with cold newcomers (per-round breaks)
    # and blocks within 6 rounds
    base = dict(n_rounds=6, clients_per_round=8, local_epochs=2,
                batch_size=5, lr=0.05, n_groups=3, pretrain_scale=8, seed=0)
    base.update(kw)
    return FedConfig(**base)


def _make(name, data, cfg, device="cpu", **kw):
    model = tpm.mclr(16, 10)
    if name == "fedavg":
        return FedAvgTrainer(model, data, cfg, device=device, **kw)
    if name == "fedgroup":
        return FedGroupTrainer(model, data, cfg, device=device, **kw)
    return strategies.make_trainer(name, model, data, cfg, device=device,
                                   **kw)


def _run_both(name, data, rounds=6, device="cpu", **cfg_kw):
    """Same seed, same config — only block_size differs."""
    a = _make(name, data, _cfg(**cfg_kw), device)
    a.run(rounds)
    b = _make(name, data, _cfg(block_size=4, **cfg_kw), device)
    b.executor = b._block_executor()
    b.blocks = _counting(b)
    b.run(rounds)
    return a, b


def _assert_equal(x, y):
    if isinstance(x, dict):
        assert sorted(x) == sorted(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k
    else:
        assert torch.equal(x, y)


def _counting(tr):
    """Wrap the trainer's block executor; returns the list of its calls'
    block lengths."""
    calls = []
    real = tr._block_executor()
    tr._block_exec = lambda *a: (calls.append(len(a[3])), real(*a))[1]
    return calls


def _without_migrations(counters):
    return {k: v for k, v in counters.items() if k != "rounds.migrations"}


# ---------------------------------------------------------------------------
# Block == per-round on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ALL)
def test_block_equals_per_round_bit_for_bit(name, tdata):
    a, b = _run_both(name, tdata)
    assert a.history.rounds == b.history.rounds
    assert len(b.history.rounds) == 6 and len(b.blocks) >= 1
    if name in ("fedavg", "fedgroup"):
        # the dynamic-assignment trainers' per-round path leaves params at
        # their init; the block carry's is the mean of the groups, as in
        # the reference
        _assert_equal(a.params, b.params)
    if name != "fedavg":
        _assert_equal(a.group_params, b.group_params)
        np.testing.assert_array_equal(a.membership, b.membership)
    if name == "fedgroup":
        # the latest update directions came out of the block carry, and
        # eq. 9 between blocks read them
        _assert_equal(a.group_delta, b.group_delta)
        assert b.counters["rounds.cold_started"] > 0
    if name in ("fesem", "fedclust"):
        _assert_equal(a.local_flat, b.local_flat)
        assert b.local_flat.shape == (tdata.n_clients, b.model_size)
    assert a.comm_params == b.comm_params
    assert _without_migrations(a.counters) == _without_migrations(b.counters)
    assert b.counters["rounds.completed"] == 6
    assert b.counters["rounds.migrations"] <= a.counters["rounds.migrations"]


@pytest.mark.parametrize("name", ["fedavg", "fedgroup"])
def test_dropout_padded_block_equals_variable_size_rounds(name, tdata):
    a, b = _run_both(name, tdata, dropout_rate=0.3)
    ha, hb = a.history.rounds, b.history.rounds
    assert [r.weighted_acc for r in ha] == [r.weighted_acc for r in hb]
    np.testing.assert_allclose([r.mean_loss for r in ha],
                               [r.mean_loss for r in hb], rtol=1e-6)
    np.testing.assert_allclose([r.discrepancy for r in ha],
                               [r.discrepancy for r in hb], rtol=1e-6)
    for k in a.params:
        np.testing.assert_allclose(tnp(a.params[k]), tnp(b.params[k]),
                                   rtol=1e-6, atol=1e-7)
    # comm accounting counts only the alive clients
    assert a.comm_params == b.comm_params


def test_fesem_padded_lanes_touch_only_the_trash_row(tdata):
    a, b = _run_both("fesem", tdata, dropout_rate=0.3)
    np.testing.assert_array_equal(a.membership, b.membership)
    np.testing.assert_allclose(tnp(a.local_flat), tnp(b.local_flat),
                               rtol=1e-6, atol=1e-7)
    # the trash row took the padded lanes' scatters; the trainer's view
    # stops before it
    assert b.local_flat.data_ptr() == b._local_flat_rows.data_ptr()
    assert b._local_flat_rows.shape[0] == tdata.n_clients + 1


def test_eval_cadence_matches_per_round(tdata):
    a, b = _run_both("fedavg", tdata, eval_every=2)
    pattern = [math.isnan(r.weighted_acc) for r in b.history.rounds]
    assert pattern == [True, False] * 3
    assert pattern == [math.isnan(r.weighted_acc) for r in a.history.rounds]
    evals = [[r.weighted_acc for r in tr.history.rounds
              if not math.isnan(r.weighted_acc)] for tr in (a, b)]
    assert evals[0] == evals[1] and len(evals[1]) == 3
    assert [r.mean_loss for r in a.history.rounds] == \
        [r.mean_loss for r in b.history.rounds]


def test_four_staged_rounds_go_through_the_executor_once(tdata):
    tr = _make("fedavg", tdata, _cfg(block_size=4))
    calls = _counting(tr)
    tr.run(4)
    assert calls == [4]
    assert len(tr.history.rounds) == 4


def test_shift_detector_pins_fedgroup_to_the_per_round_path(tdata):
    kw = dict(shift_threshold=0.35, shift_check_every=1)
    a = _make("fedgroup", tdata, _cfg(**kw))
    a.run(6)
    b = _make("fedgroup", tdata, _cfg(block_size=4, **kw))
    calls = _counting(b)
    b.run(6)
    assert calls == []
    assert a.history.rounds == b.history.rounds
    assert a.counters == b.counters
    assert b.counters["rounds.shift_checks"] > 0


def test_cpu_executor_runs_the_plain_block():
    """On CPU tensors the executor is the eager block_fn: no graph is
    captured or replayed."""
    calls = []

    def block_fn(*args):
        calls.append(args)
        return "carry", "metrics"

    ex = graphs.GraphBlockExecutor(block_fn)
    out = ex({}, (torch.zeros(1),), None, torch.zeros((1, 1)), None, None,
             [True])
    assert out == ("carry", "metrics") and len(calls) == 1
    assert (ex.captures, ex.replays) == (0, 0)


# ---------------------------------------------------------------------------
# The port's block path against the JAX package's
# ---------------------------------------------------------------------------
JAX_TRAINERS = {"fedavg": JFedAvgTrainer, "fedgroup": JFedGroupTrainer,
                "ifca": JIFCATrainer, "fesem": JFeSEMTrainer}


@pytest.fixture(scope="module")
def jdata():
    return j_mnist_like(**DATA_KW)


@pytest.mark.parametrize("name,dropout", [
    ("fedavg", 0.0), ("fedavg", 0.3), ("fedgroup", 0.0), ("ifca", 0.0),
    ("fesem", 0.0)])
def test_block_path_matches_reference_block_path(name, dropout, jdata,
                                                 tdata):
    jcfg = JFedConfig(**dataclasses.asdict(_cfg(block_size=4,
                                                dropout_rate=dropout)))
    jtr = JAX_TRAINERS[name](jpm.mclr(16, 10), jdata, jcfg)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    kw = dict(init_params=params_from_numpy(np_tree(jtr.params)),
              draws=ReplayDraws(jcfg.seed))
    if name in ("ifca", "fesem"):
        kw["init_group_params"] = params_from_numpy(
            np_tree(jtr.group_params))
    ttr = _make(name, tdata, FedConfig(**dataclasses.asdict(jcfg)), **kw)
    calls = _counting(ttr)
    jh, th = jtr.run(6), ttr.run(6)
    assert len(calls) >= 1
    for jm, tm in zip(jh.rounds, th.rounds):
        assert tm.round == jm.round
        np.testing.assert_allclose(tm.mean_loss, jm.mean_loss, rtol=1e-3)
        np.testing.assert_allclose(tm.discrepancy, jm.discrepancy,
                                   rtol=1e-3)
        assert abs(tm.weighted_acc - jm.weighted_acc) <= 0.01
        assert tm.quarantined == jm.quarantined
    assert len(th.rounds) == len(jh.rounds) == 6
    if name != "fedavg":
        np.testing.assert_array_equal(ttr.membership, jtr.membership)
    if name == "fesem":
        np.testing.assert_allclose(tnp(ttr.local_flat),
                                   np.asarray(jtr.local_flat), **LF_TOL)
    assert ttr.comm_params == jtr.comm_params
    reg = jtr.obs.registry
    for key, value in ttr.counters.items():
        assert value == int(reg.get(key)), key
