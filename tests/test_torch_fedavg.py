"""The consensus trainers of the port (FedAvg / FedProx) against the JAX
package's, with the initial params carried over and the solver's draws
replayed. Per-round mean_loss and discrepancy within rtol 1e-3 (float
sums drift over many SGD steps); weighted accuracy within 0.01 absolute
(an argmax can flip at a near-tie); cohorts exactly equal."""
import dataclasses

import jax
import numpy as np
import pytest

from _torch_parity import ReplayDraws
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed.engine import FedAvgTrainer as JFedAvg
from repro.fed.engine import FedConfig as JFedConfig
from repro.fed.engine import FedProxTrainer as JFedProx
from repro.models.paper_models import mclr as j_mclr
from repro_torch.convert import params_from_numpy
from repro_torch.data.generators import mnist_like
from repro_torch.fed.engine import FedAvgTrainer, FedConfig, FedProxTrainer
from repro_torch.models.paper_models import mclr

ROUNDS = 2


@pytest.mark.parametrize("jcls,tcls,extra", [
    (JFedAvg, FedAvgTrainer, {}),
    (JFedProx, FedProxTrainer, {"dropout_rate": 0.3, "quarantine": True}),
])
def test_consensus_trainer_matches_reference(jcls, tcls, extra):
    dkw = dict(seed=1, n_clients=25, classes_per_client=2, total_train=1500,
               dim=32)
    jcfg = JFedConfig(n_rounds=ROUNDS, clients_per_round=6, local_epochs=2,
                      batch_size=10, lr=0.05, seed=3, **extra)
    jtr = jcls(j_mclr(32, 10), j_mnist_like(**dkw), jcfg)
    ttr = tcls(mclr(32, 10), mnist_like(**dkw),
               FedConfig(**dataclasses.asdict(jcfg)), device="cpu",
               init_params=params_from_numpy(
                   jax.tree_util.tree_map(np.asarray, jtr.params)),
               draws=ReplayDraws(jcfg.seed))
    for t in range(ROUNDS):
        jm, tm = jtr.round(t), ttr.round(t)
        np.testing.assert_allclose(tm.mean_loss, jm.mean_loss, rtol=1e-3)
        np.testing.assert_allclose(tm.discrepancy, jm.discrepancy,
                                   rtol=1e-3)
        assert abs(tm.weighted_acc - jm.weighted_acc) <= 0.01
    for k in ttr.params:
        np.testing.assert_allclose(ttr.params[k].numpy(),
                                   np.asarray(jtr.params[k]),
                                   rtol=1e-3, atol=1e-5)
    assert ttr.comm_params == jtr.comm_params
    assert len(ttr.history.rounds) == ROUNDS
    np.testing.assert_allclose(ttr.evaluate(), jtr.evaluate(), atol=0.01)
