"""Trainer checkpoints across the two packages: a checkpoint that the JAX
package's trainer wrote resumes in the port, and one the port wrote
resumes in the JAX trainer, on the CPU at ``tests/test_robustness.py``'s
fixtures.

The port replays the JAX trainer's draws (``ReplayDraws``, whose state is
the JAX key, ``model/key`` in the archive), so the resumed run is held to
the JAX package's uninterrupted run at the trainer parity tolerances of
``tests/test_torch_population.py``: membership equal, loss and
discrepancy within rtol 1e-3, accuracy within 0.01, parameters within
rtol 1e-4, atol 1e-6.

  * a JAX FedGroup checkpoint (pinned, EDC) resumed by the port;
  * a JAX FeSEM checkpoint (streamed, newcomer arrivals, ``prefetch=2``)
    resumed by the port, host ``local_flat`` rows included;
  * a port FedGroup checkpoint (pinned, replayed draws) that the JAX
    trainer's ``load_checkpoint`` accepts and continues.
"""
import dataclasses

import jax
import numpy as np
import pytest

from _torch_parity import ReplayDraws, tnp
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.checkpoint import io as jckpt
from repro.core.fedgroup import FedGroupTrainer as JFedGroup
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed import population as jpop
from repro.fed import store as jstore
from repro.fed.engine import FedAvgTrainer as JFedAvg
from repro.fed.engine import FedConfig as JFedConfig
from repro.fed.fesem import FeSEMTrainer as JFeSEM
from repro.models import paper_models as jpm
from repro_torch.checkpoint import io as tckpt
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed import population as tpop
from repro_torch.fed import store as tstore
from repro_torch.fed import strategies
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.models import paper_models as tpm

DATA_KW = dict(seed=0, n_clients=40, classes_per_client=2, total_train=2000,
               dim=16)
STREAM_KW = dict(initial_active=30, arrival_rate=2.0, prefetch=2)
TOL = dict(rtol=1e-4, atol=1e-6)
ROUNDS = 4


def _jcfg(**kw):
    base = dict(n_rounds=ROUNDS, clients_per_round=8, local_epochs=2,
                batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4, seed=0)
    base.update(kw)
    return JFedConfig(**base)


def _tcfg(jcfg):
    return FedConfig(**dataclasses.asdict(jcfg))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_rounds_agree(t_rounds, j_rounds):
    assert [r.round for r in t_rounds] == [r.round for r in j_rounds]
    for tm, jm in zip(t_rounds, j_rounds):
        np.testing.assert_allclose(tm.mean_loss, jm.mean_loss, rtol=1e-3)
        np.testing.assert_allclose(tm.discrepancy, jm.discrepancy,
                                   rtol=1e-3)
        assert abs(tm.weighted_acc - jm.weighted_acc) <= 0.01


def _assert_params_close(tparams, jparams):
    j = _np_tree(jparams)
    assert sorted(tparams) == sorted(j)
    for k in j:
        np.testing.assert_allclose(tnp(tparams[k]), j[k], **TOL)


@pytest.fixture(scope="module")
def data():
    return j_mnist_like(**DATA_KW), mnist_like(**DATA_KW)


@pytest.fixture(scope="module")
def jax_fedgroup(data, tmp_path_factory):
    """The JAX FedGroup run, pinned, EDC, ROUNDS rounds, checkpointing
    every 2 (its t = 2 archive is the port's resume point), and its
    initial params (for the port's own run from round 0)."""
    d = str(tmp_path_factory.mktemp("jax_fedgroup"))
    jcfg = _jcfg(checkpoint_every=2, checkpoint_dir=d)
    tr = JFedGroup(jpm.mclr(16, 10), data[0], jcfg)
    init = _np_tree(tr.params)
    tr.run(ROUNDS)
    return jcfg, d, tr, init


def test_jax_fedgroup_checkpoint_resumes_in_the_port(data, jax_fedgroup):
    jcfg, d, jtr, _ = jax_fedgroup
    ttr = FedGroupTrainer(tpm.mclr(16, 10), data[1], _tcfg(jcfg),
                          device="cpu", draws=ReplayDraws(jcfg.seed))
    assert ttr.load_checkpoint(jckpt.checkpoint_path(d, 2)) == 2
    assert ttr.cold_started                     # Alg. 3 does not run again
    ttr.run(ROUNDS - 2)
    assert [dataclasses.astuple(r) for r in ttr.history.rounds[:2]] == \
        [dataclasses.astuple(r) for r in jtr.history.rounds[:2]]
    _assert_rounds_agree(ttr.history.rounds[2:], jtr.history.rounds[2:])
    np.testing.assert_array_equal(ttr.membership, jtr.membership)
    _assert_params_close(ttr.group_params, jtr.group_params)
    _assert_params_close(ttr.params, jtr.params)
    assert ttr.comm_params == jtr.comm_params
    np.testing.assert_array_equal(ttr.draws.get_state(), np.asarray(jtr.key))


def test_port_fedgroup_checkpoint_resumes_in_jax(data, jax_fedgroup,
                                                 tmp_path):
    jcfg, _, jref, init = jax_fedgroup
    tcfg = dataclasses.replace(_tcfg(jcfg), checkpoint_dir=str(tmp_path))
    ttr = FedGroupTrainer(tpm.mclr(16, 10), data[1], tcfg, device="cpu",
                          init_params=params_from_numpy(init),
                          draws=ReplayDraws(jcfg.seed))
    ttr.run(2)
    path = tckpt.checkpoint_path(str(tmp_path), 2)
    jtr = JFedGroup(jpm.mclr(16, 10), data[0], _jcfg())
    assert jtr.load_checkpoint(path) == 2
    jtr.run(ROUNDS - 2)
    _assert_rounds_agree(jtr.history.rounds, jref.history.rounds)
    np.testing.assert_array_equal(jtr.membership, jref.membership)
    _assert_params_close(params_from_numpy(_np_tree(jtr.group_params)),
                         jref.group_params)
    assert jtr.comm_params == jref.comm_params
    np.testing.assert_array_equal(np.asarray(jtr.key), np.asarray(jref.key))


def test_port_archive_of_its_own_draws_is_refused_by_jax(data, tmp_path):
    """A ``TorchDraws`` archive is the port's own random stream: the JAX
    trainer's strict load refuses its ``model/key``."""
    ttr = FedAvgTrainer(tpm.mclr(16, 10), data[1], _tcfg(_jcfg()),
                        device="cpu")
    ttr.run(1)
    path = ttr.save_checkpoint(str(tmp_path / "own.npz"))
    with pytest.raises(ValueError, match="shape mismatch at model/key"):
        JFedAvg(jpm.mclr(16, 10), data[0], _jcfg()).load_checkpoint(path)


def test_jax_fesem_streamed_checkpoint_resumes_in_the_port(data, tmp_path):
    jcfg = _jcfg(checkpoint_every=2, checkpoint_dir=str(tmp_path))
    jp = jpop.Population(jstore.ArrayClientStore(data[0]),
                         jpop.PopulationConfig(**STREAM_KW))
    jtr = JFeSEM(jpm.mclr(16, 10), None, jcfg, population=jp)
    jtr.run(ROUNDS)
    tp = tpop.Population(tstore.ArrayClientStore(data[1]),
                         tpop.PopulationConfig(**STREAM_KW))
    ttr = strategies.make_trainer(
        "fesem", tpm.mclr(16, 10), None, _tcfg(jcfg), device="cpu",
        population=tp, draws=ReplayDraws(jcfg.seed))
    try:
        assert ttr.load_checkpoint(
            jckpt.checkpoint_path(str(tmp_path), 2)) == 2
        ttr.run(ROUNDS - 2)
        _assert_rounds_agree(ttr.history.rounds[2:], jtr.history.rounds[2:])
        np.testing.assert_array_equal(ttr.membership, jtr.membership)
        np.testing.assert_array_equal(tp.scheduler.active_ids(),
                                      jp.scheduler.active_ids())
        _assert_params_close(ttr.group_params, jtr.group_params)
        ids = np.flatnonzero(ttr.membership >= 0)
        np.testing.assert_allclose(tp.gather_local_flat(ids).numpy(),
                                   jp.gather_local_flat(ids), **TOL)
        assert ttr.comm_params == jtr.comm_params
    finally:
        ttr.close()
        jtr.close()
