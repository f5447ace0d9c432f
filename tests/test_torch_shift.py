"""The port's shift detector (``FedGroupTrainer._maybe_shift``) and its
direction cache (``repro_torch.fed.store._LazyRows``) against the JAX
package's, on pinned FedGroup with the initial params carried over and
every draw replayed (``ReplayDraws``: one ``batch_indices`` call per
probe, then one per eq.-9 cold segment, then one per round).

Probe and migration counts, the migrated ids and membership must be equal;
loss and discrepancy within rtol 1e-3, the cached directions within rtol
1e-4, atol 1e-6 (float sums over many SGD steps); the drift, which the
reference computes in numpy and the port in torch, within 1e-6.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import ReplayDraws, tnp
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core.fedgroup import FedGroupTrainer as JFedGroup
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed.engine import FedConfig as JFedConfig
from repro.fed.store import _LazyRows as JLazyRows
from repro.models.paper_models import mlp as j_mlp
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedgroup import FedGroupTrainer, shift_drift
from repro_torch.data.generators import mnist_like
from repro_torch.draws import TorchDraws
from repro_torch.fed.engine import FedConfig
from repro_torch.fed.store import _LazyRows
from repro_torch.models.paper_models import mlp

ROUNDS = 3


def _cfg(**kw):
    base = dict(n_rounds=ROUNDS, clients_per_round=8, local_epochs=2,
                batch_size=10, lr=0.05, n_groups=3, pretrain_scale=4,
                seed=0)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def fed_data():
    kw = dict(seed=0, n_clients=30, classes_per_client=2, total_train=1000,
              dim=32)
    return j_mnist_like(**kw), mnist_like(**kw)


class RecordingDraws(TorchDraws):
    """``TorchDraws`` that logs every call with its shapes."""

    def __init__(self, seed):
        super().__init__(seed)
        self.log = []

    def batch_indices(self, n, max_steps, batch_size):
        self.log.append(("batch_indices", int(n.shape[0]), max_steps))
        return super().batch_indices(n, max_steps, batch_size)

    def svd_omega(self, n, k, device):
        self.log.append(("svd_omega", n, k))
        return super().svd_omega(n, k, device)

    def kmeans_seeds(self, X, k):
        self.log.append(("kmeans_seeds", int(X.shape[0]), k))
        return super().kmeans_seeds(X, k)


@pytest.mark.parametrize("threshold", [0.0, 0.35])
def test_detector_matches_reference(threshold, fed_data):
    jdata, tdata = fed_data
    jcfg = JFedConfig(**_cfg(shift_threshold=threshold))
    jtr = JFedGroup(j_mlp(32, 16, 10), jdata, jcfg)
    ttr = FedGroupTrainer(
        mlp(32, 16, 10), tdata, FedConfig(**dataclasses.asdict(jcfg)),
        device="cpu", draws=ReplayDraws(jcfg.seed),
        init_params=params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jtr.params)))
    probed = 0
    for t in range(ROUNDS):
        jm, tm = jtr.round(t), ttr.round(t)
        assert np.array_equal(ttr._last_shifted, jtr._last_shifted), t
        assert ttr._shift_last == jtr._shift_last, t
        assert np.array_equal(ttr.membership, jtr.membership), t
        np.testing.assert_allclose(tm.mean_loss, jm.mean_loss, rtol=1e-3)
        np.testing.assert_allclose(tm.discrepancy, jm.discrepancy,
                                   rtol=1e-3)
        assert abs(tm.weighted_acc - jm.weighted_acc) <= 0.01
        assert ttr.comm_params == jtr.comm_params
        probed += ttr._shift_last[0]
    for name in ("rounds.shift_checks", "rounds.migrations",
                 "rounds.cold_started"):
        assert ttr.counters[name] == int(jtr.obs.registry.get(name)), name
    assert probed == ttr.counters["rounds.shift_checks"] > 0
    ids = np.arange(tdata.n_clients)
    has = ttr._has_dirs(ids)
    assert np.array_equal(has, jtr._has_dirs(ids))
    np.testing.assert_allclose(tnp(ttr._get_dirs(ids[has])),
                               jtr._get_dirs(ids[has]), rtol=1e-4,
                               atol=1e-6)
    if threshold == 0.0:
        # every probed client drifts past 0: the invalidate, cache and
        # eq.-9 re-route steps all ran
        assert len(ttr._last_shifted) == ttr._shift_last[0] > 0


def test_drift_matches_the_reference_formula():
    rng = np.random.default_rng(0)
    fresh = rng.standard_normal((7, 300)).astype(np.float32)
    cached = fresh + rng.standard_normal((7, 300)).astype(np.float32) * \
        np.linspace(0.0, 3.0, 7, dtype=np.float32)[:, None]
    cached[3] = 0.0                                   # the 1e-12 guard
    dot = np.sum(fresh * cached, axis=1)
    den = np.linalg.norm(fresh, axis=1) * np.linalg.norm(cached, axis=1)
    want = (1.0 - dot / np.maximum(den, 1e-12)) / 2.0
    got = shift_drift(torch.as_tensor(fresh), torch.as_tensor(cached))
    np.testing.assert_allclose(tnp(got), want, atol=1e-6)
    assert float(got[3]) == 0.5


def _run_recorded(tdata, rounds=ROUNDS, **kw):
    tr = FedGroupTrainer(mlp(32, 16, 10), tdata, FedConfig(**_cfg(**kw)),
                         device="cpu", draws=RecordingDraws(0))
    hist = tr.run(rounds)
    return tr, hist


def test_threshold_none_is_byte_identical_to_the_default_path(fed_data):
    """``shift_threshold=None`` asks ``draws`` for nothing more, caches
    nothing, and leaves ``comm_params`` and ``group_params`` bit for bit
    as the default config's; the detector's own knobs are then inert."""
    _, tdata = fed_data
    a, ha = _run_recorded(tdata)
    b, hb = _run_recorded(tdata, shift_threshold=None, shift_check_every=3)
    assert a.draws.log == b.draws.log
    assert a.comm_params == b.comm_params
    assert ha.rounds == hb.rounds
    for k in a.group_params:
        assert torch.equal(a.group_params[k], b.group_params[k])
    assert torch.equal(a.group_delta, b.group_delta)
    assert a._pin_dirs is None and b._pin_dirs is None
    assert "rounds.shift_checks" not in a.counters
    # the detector, when on, does ask for more
    c, _ = _run_recorded(tdata, shift_threshold=0.35)
    assert len(c.draws.log) > len(a.draws.log)


def test_check_every_throttles_probes(fed_data):
    _, tdata = fed_data
    dense, _ = _run_recorded(tdata, rounds=4, shift_threshold=0.35,
                             shift_check_every=1)
    sparse, _ = _run_recorded(tdata, rounds=4, shift_threshold=0.35,
                              shift_check_every=3)
    assert 0 < sparse.counters["rounds.shift_checks"] < \
        dense.counters["rounds.shift_checks"]
    # ticks 1 and 2 probe nobody and ask draws for nothing: 2 fewer calls
    assert len(dense.draws.log) - len(sparse.draws.log) == 2
    assert sparse._shift_tick == dense._shift_tick == 4


def test_lazy_rows_match_the_reference():
    rng = np.random.default_rng(0)
    default = rng.standard_normal(5).astype(np.float32)
    ref, ours = JLazyRows(default), _LazyRows(torch.as_tensor(default))
    rows = rng.standard_normal((4, 5)).astype(np.float32)

    def agree(idx):
        assert np.array_equal(ours.has(idx), ref.has(idx))
        assert np.array_equal(tnp(ours.gather(idx)), ref.gather(idx))
        assert len(ours) == len(ref)

    probe = [0, 3, 7, 9, 3]
    agree(probe)
    for table in (ref, ours):
        table.scatter([3, 7, 9], rows[:3])
    agree(probe)
    for table in (ref, ours):
        table.delete([7, 11])                   # 11 was never touched
    agree(probe)
    assert not ours.has([7])[0]
    assert np.array_equal(tnp(ours.gather([7]))[0], default)
    for table in (ref, ours):
        table.scatter([7], rows[3:])
    agree(probe)
    agree([])
    got, want = ours.ckpt_arrays(), ref.ckpt_arrays()
    for k in ("ids", "rows", "default"):
        assert np.array_equal(got[k], want[k]), k
    back = _LazyRows.from_ckpt(want)
    assert np.array_equal(tnp(back.gather(probe)), ref.gather(probe))
    # a scatter copies: later writes to the source do not leak in
    src = torch.ones(1, 5)
    ours.scatter([0], src)
    src += 1
    assert torch.equal(ours.gather([0]), torch.ones(1, 5))
