"""The port's gate-weighted group-model combination (``core.gating``)
against the JAX package's: the gates within 1e-6 on the same inputs, the
gate-mixed correct counts equal, and ``evaluate_gated`` on trainers run
side by side (params carried over, draws replayed, so the probe trains on
the same minibatches) within 0.01 (an argmax may flip at a near-tie)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ReplayDraws, tnp
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core import gating as jgating
from repro.core.fedgroup import FedGroupTrainer as JFedGroup
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed.engine import FedConfig as JFedConfig
from repro.models import paper_models as jpm
from repro_torch.convert import params_from_numpy
from repro_torch.core import gating as tgating
from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed.engine import FedConfig
from repro_torch.models import paper_models as tpm


@pytest.mark.parametrize("temperature", [0.1, 1e-9, 10.0])
def test_gate_weights_match_reference(temperature):
    rng = np.random.default_rng(0)
    dpre = rng.standard_normal((6, 50)).astype(np.float32)
    G = rng.standard_normal((3, 50)).astype(np.float32)
    dpre[0] = G[1] * 2.0                       # one client on a group
    got = tgating.gate_weights(torch.as_tensor(dpre), torch.as_tensor(G),
                               temperature)
    want = jgating.gate_weights(jnp.asarray(dpre), jnp.asarray(G),
                                temperature)
    np.testing.assert_allclose(tnp(got), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(tnp(got).sum(1), 1.0, atol=1e-6)


def test_mixture_correct_counts_match_reference():
    rng = np.random.default_rng(1)
    jm, tm = jpm.mlp(8, 6, 4), tpm.mlp(8, 6, 4)
    groups = [jm.init(k) for k in jax.random.split(jax.random.PRNGKey(2), 3)]
    x = rng.standard_normal((5, 9, 8)).astype(np.float32)
    y = rng.integers(0, 4, (5, 9)).astype(np.int32)
    n = np.array([9, 3, 1, 7, 9], np.int32)
    w = rng.dirichlet(np.ones(3), 5).astype(np.float32)
    want = jgating.mixture_correct_counts(jm, groups, jnp.asarray(w),
                                          jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(n))
    got = tgating.mixture_correct_counts(
        tm, [params_from_numpy(jax.tree_util.tree_map(np.asarray, g))
             for g in groups], torch.as_tensor(w), torch.as_tensor(x),
        torch.as_tensor(y).long(), torch.as_tensor(n).long())
    assert np.array_equal(tnp(got), np.asarray(want))


@pytest.fixture(scope="module")
def trained_pair():
    kw = dict(seed=0, n_clients=30, classes_per_client=2, total_train=1000,
              dim=32)
    jcfg = JFedConfig(n_rounds=2, clients_per_round=8, local_epochs=2,
                      batch_size=10, lr=0.05, n_groups=3, pretrain_scale=4,
                      seed=0)
    jtr = JFedGroup(jpm.mlp(32, 16, 10), j_mnist_like(**kw), jcfg)
    ttr = FedGroupTrainer(
        tpm.mlp(32, 16, 10), mnist_like(**kw),
        FedConfig(**dataclasses.asdict(jcfg)), device="cpu",
        draws=ReplayDraws(jcfg.seed), init_params=params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jtr.params)))
    for t in range(2):
        jtr.round(t)
        ttr.round(t)
    assert np.array_equal(ttr.membership, jtr.membership)
    return jtr, ttr


def test_evaluate_gated_matches_reference(trained_pair):
    jtr, ttr = trained_pair
    for tau in (0.1, 1e-4):
        want = jgating.evaluate_gated(jtr, tau)
        got = tgating.evaluate_gated(ttr, tau)
        assert abs(got - want) <= 0.01, tau
    some = np.where(ttr.membership >= 0)[0][:4]
    assert abs(tgating.evaluate_gated(ttr, 0.1, some)
               - jgating.evaluate_gated(jtr, 0.1, some)) <= 0.01
    assert tgating.evaluate_gated(ttr, 0.1, []) == 0.0


def test_evaluate_gated_at_low_temperature_is_hard_assignment(trained_pair):
    """τ → 0 puts each client's whole gate on its nearest group direction,
    so the gated accuracy is that of eq. 9's hard routing of the probe."""
    _, ttr = trained_pair
    assert 0.0 <= tgating.evaluate_gated(ttr, 1e-6) <= 1.0
    w = tgating.gate_weights(ttr.group_delta[:2] * 3.0, ttr.group_delta,
                             1e-6)
    assert torch.equal(torch.argmax(w, 1), torch.arange(2))
    np.testing.assert_allclose(tnp(w.max(1).values), 1.0, atol=1e-6)
