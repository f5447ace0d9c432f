"""The slice as a whole: the port's FedGroup trainer against the JAX
package's on a tiny ``mnist_like``, with the initial params carried over
and every random draw replayed from the reference's key chain
(``ReplayDraws``). Cold-start labels must be equal; per-round mean_loss
and discrepancy within rtol 1e-3 (float sums drift over the rounds' many
SGD steps); weighted accuracy within 0.01 absolute (an argmax can flip at
a near-tie)."""
import dataclasses

import jax
import numpy as np
import pytest

from _torch_parity import ReplayDraws
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core.fedgroup import FedGroupTrainer as JFedGroup
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed.engine import FedConfig as JFedConfig
from repro.models.paper_models import mlp as j_mlp
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed.engine import FedConfig
from repro_torch.models.paper_models import mlp

ROUNDS = 2


def _cfg(**kw):
    base = dict(n_rounds=ROUNDS, clients_per_round=8, local_epochs=2,
                batch_size=10, lr=0.05, n_groups=3, pretrain_scale=4,
                seed=0)
    base.update(kw)
    return JFedConfig(**base)


def _data_kw():
    return dict(seed=0, n_clients=30, classes_per_client=2,
                total_train=2000, dim=32)


def _pair(jcfg, trainer=FedGroupTrainer):
    jtr = JFedGroup(j_mlp(32, 16, 10), j_mnist_like(**_data_kw()), jcfg)
    ttr = trainer(mlp(32, 16, 10), mnist_like(**_data_kw()),
                  FedConfig(**dataclasses.asdict(jcfg)), device="cpu",
                  init_params=params_from_numpy(
                      jax.tree_util.tree_map(np.asarray, jtr.params)),
                  draws=ReplayDraws(jcfg.seed))
    return jtr, ttr


def _assert_rounds_agree(jtr, ttr):
    for t in range(ROUNDS):
        jm, tm = jtr.round(t), ttr.round(t)
        assert np.array_equal(ttr.membership, jtr.membership), t
        np.testing.assert_allclose(tm.mean_loss, jm.mean_loss, rtol=1e-3)
        np.testing.assert_allclose(tm.discrepancy, jm.discrepancy,
                                   rtol=1e-3)
        assert abs(tm.weighted_acc - jm.weighted_acc) <= 0.01
        assert tm.quarantined == jm.quarantined
    assert ttr.comm_params == jtr.comm_params


@pytest.mark.parametrize("measure,eta_g", [("edc", 0.0), ("madc", 0.05)])
def test_fedgroup_matches_reference(measure, eta_g):
    jtr, ttr = _pair(_cfg(measure=measure, eta_g=eta_g))
    jpre, jlab = jtr.group_cold_start()
    tpre, tlab = ttr.group_cold_start()
    assert np.array_equal(tpre, jpre)
    assert np.array_equal(np.asarray(tlab), np.asarray(jlab))
    np.testing.assert_allclose(ttr.group_delta.numpy(),
                               np.asarray(jtr.group_delta),
                               rtol=1e-4, atol=1e-6)
    _assert_rounds_agree(jtr, ttr)
    assert ttr.counters["rounds.cold_started"] > 0     # eq. 9 newcomers ran
