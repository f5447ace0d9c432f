"""FedGroup on a data mesh of two gloo ranks against the JAX package's
single-device run from the same draws.

The JAX trainer (``repro.core.fedgroup``) runs Alg. 3 and two rounds at
the mesh tests' fixture (``tests/_torch_mesh_driver.py``). The port's
trainer runs the same in this process with ``ReplayDraws`` (the
reference's key chain) and the JAX trainer's initial parameters, and
records every draw it is handed; the two ranks then replay those draws
(their processes import no JAX). Held at ``tests/test_torch_fedgroup.py``'s
tolerances: founders, labels and membership equal, mean loss and
discrepancy within rtol 1e-3, weighted accuracy within 0.01.
"""
import jax
import numpy as np
import pytest
import torch

import _torch_mesh_driver as drv
from _torch_parity import ReplayDraws
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core.fedgroup import FedGroupTrainer as JFedGroup
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed.engine import FedConfig as JFedConfig
from repro.models.paper_models import mclr as j_mclr
from repro_torch.convert import params_from_numpy

NAME = "fedgroup_edc_round"


class RecordingDraws:
    """``ReplayDraws`` that keeps every value it hands out, by kind."""

    def __init__(self, seed: int):
        self.inner = ReplayDraws(seed)
        self.rec = {"batch": [], "omega": [], "seeds": []}

    def get_state(self):
        return self.inner.get_state()

    def set_state(self, state):
        self.inner.set_state(state)

    def _keep(self, kind, v):
        self.rec[kind].append(v.detach().cpu().numpy().copy())
        return v

    def batch_indices(self, n, max_steps, batch_size):
        return self._keep("batch", self.inner.batch_indices(
            n, max_steps, batch_size))

    def svd_omega(self, n, k, device):
        return self._keep("omega", self.inner.svd_omega(n, k, device))

    def kmeans_seeds(self, X, k):
        return self._keep("seeds", self.inner.kmeans_seeds(X, k))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = drv.base_cfg()
    jcfg = JFedConfig(**{f: getattr(cfg, f) for f in (
        "n_rounds", "clients_per_round", "local_epochs", "batch_size", "lr",
        "n_groups", "pretrain_scale", "seed")})
    jtr = JFedGroup(j_mclr(16, 10), j_mnist_like(
        seed=0, n_clients=16, classes_per_client=2, total_train=1200,
        dim=16), jcfg)
    init = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtr.params))
    jpre, jlab = jtr.group_cold_start()
    jh = jtr.run(drv.ROUNDS)
    jax_run = {"pre_idx": np.asarray(jpre), "labels": np.asarray(jlab),
               "membership": np.asarray(jtr.membership),
               "hist": np.array([[r.weighted_acc, r.mean_loss,
                                  r.discrepancy] for r in jh.rounds])}
    data, model = drv.fixture()
    rec = RecordingDraws(cfg.seed)
    one = drv.run_scenario(NAME, None, data, model, draws=rec,
                           init_params=init)
    d = tmp_path_factory.mktemp("mesh_jax")
    arrays = {f"{kind}_{i}": v for kind, vals in rec.rec.items()
              for i, v in enumerate(vals)}
    arrays.update({f"init/{k}": v.numpy() for k, v in init.items()})
    np.savez(d / "draws.npz", **arrays)
    ranks = drv.spawn_world(2, d, extra=(str(d / "draws.npz"),))
    return jax_run, one, [{k[len(NAME) + 1:]: v for k, v in z.items()}
                          for z in ranks]


def _assert_agrees(got, ref):
    for k in ("pre_idx", "labels", "membership"):
        assert np.array_equal(got[k], ref[k]), k
    h, hr = got["hist"][:, :3], ref["hist"]
    np.testing.assert_allclose(h[:, 1:3], hr[:, 1:3], rtol=1e-3)
    assert np.nanmax(np.abs(h[:, 0] - hr[:, 0])) <= 0.01


def test_world_of_one_matches_jax(runs):
    jax_run, one, _ = runs
    _assert_agrees(one, jax_run)


@pytest.mark.parametrize("rank", [0, 1])
def test_two_ranks_match_jax(runs, rank):
    jax_run, _, ranks = runs
    _assert_agrees(ranks[rank], jax_run)


def test_two_ranks_replay_the_recorded_draws_as_one(runs):
    """The ranks consumed the same draws as the run of one (labels and
    membership equal), within the mesh tests' own tolerances of it."""
    _, one, ranks = runs
    for k in ("labels", "membership"):
        assert np.array_equal(ranks[0][k], one[k])
    np.testing.assert_allclose(ranks[0]["hist"][:, 1:3], one["hist"][:, 1:3],
                               rtol=1e-4)
    for k in (k for k in one if k.startswith("gp/")):
        t = torch.as_tensor(one[k])
        err = float(torch.linalg.norm(torch.as_tensor(ranks[0][k]) - t)
                    / torch.linalg.norm(t))
        assert err <= 1e-5, (k, err)
