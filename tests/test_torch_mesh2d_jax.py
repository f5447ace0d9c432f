"""FedGroup on a ``(1, 2)`` (data, model) mesh of two gloo ranks against
the JAX package's single-device run from the same draws.

As ``tests/test_torch_mesh_jax.py`` does on a data mesh: the JAX trainer
(``repro.core.fedgroup``) runs Alg. 3 and two rounds at the mesh tests'
fixture; the port's trainer runs the same in this process with
``ReplayDraws`` (the reference's key chain) and the JAX trainer's initial
parameters, recording every draw; the two ranks then replay those draws
on a model axis of 2 (each solves half of each cohort, keeps its blocks
of the group parameters, and runs Alg. 3 on its half of ΔW's d_w).
Held at ``tests/test_torch_fedgroup.py``'s tolerances: founders, labels
and membership equal, mean loss and discrepancy within rtol 1e-3,
weighted accuracy within 0.01; against the run of one in this process at
the mesh tests' own (rtol 1e-4, each stored leaf its block within 1e-5).
"""
import numpy as np
import pytest

import _torch_mesh_driver as drv
from _torch_mesh2d import block_of, rel_err
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_mesh_jax import NAME, RecordingDraws, _assert_agrees

M = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.core.fedgroup import FedGroupTrainer as JFedGroup
    from repro.data.generators import mnist_like as j_mnist_like
    from repro.fed.engine import FedConfig as JFedConfig
    from repro.models.paper_models import mclr as j_mclr
    from repro_torch.convert import params_from_numpy
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
    d = tmp_path_factory.mktemp("mesh2d_jax")
    arrays = {f"{kind}_{i}": v for kind, vals in rec.rec.items()
              for i, v in enumerate(vals)}
    arrays.update({f"init/{k}": v.numpy() for k, v in init.items()})
    np.savez(d / "draws.npz", **arrays)
    ranks = drv.spawn_world(2, d, extra=(str(d / "draws.npz"),), model=M)
    return jax_run, one, [{k[len(NAME) + 1:]: v for k, v in z.items()}
                          for z in ranks]


@pytest.mark.parametrize("rank", [0, 1])
def test_model_ranks_match_jax(runs, rank):
    jax_run, _, ranks = runs
    _assert_agrees(ranks[rank], jax_run)


@pytest.mark.parametrize("rank", [0, 1])
def test_model_ranks_replay_the_recorded_draws_as_one(runs, rank):
    _, one, ranks = runs
    got = ranks[rank]
    for k in ("labels", "membership"):
        assert np.array_equal(got[k], one[k])
    np.testing.assert_allclose(got["hist"][:, 1:3], one["hist"][:, 1:3],
                               rtol=1e-4)
    for k in (k for k in one if k.startswith("gp/")):
        want = block_of(one[k], M, rank)
        assert got[k].shape == want.shape
        assert rel_err(got[k], want) <= 1e-5, k
