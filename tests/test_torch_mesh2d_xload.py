"""A JAX-package archive resumed on a ``(1, 2)`` (data, model) mesh of
gloo ranks, as ``tests/test_torch_mesh_xload.py`` resumes one on a data
mesh of two.

The JAX trainer (``repro.core.fedgroup``, pinned, EDC) runs two rounds at
the mesh tests' fixture (``tests/_torch_mesh_driver.py``) and checkpoints
(whole leaves: one controller). The port's trainer resumes that archive
without a mesh in this process, replaying the JAX key chain and
recording every draw it is handed; two ranks of one data slice, whose
group parameters are split over the model axis, then resume the same
archive with those draws (each keeps its blocks of its whole leaves) and
run the same two rounds. Held: the restored rounds equal the JAX
history; membership and counts equal, each stored leaf its block of the
continuation's within 1e-5 (relative Frobenius), loss and discrepancy
rtol 1e-4, accuracy 2e-3; both ranks' replicas equal.
"""
import dataclasses

import numpy as np
import pytest

import _torch_mesh_driver as drv
from _torch_mesh2d import assert_service_matches_one, assert_service_replicas
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.checkpoint import io as jckpt
from repro.core.fedgroup import FedGroupTrainer as JFedGroup
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed.engine import FedConfig as JFedConfig
from repro.models.paper_models import mclr as j_mclr
from repro_torch.core.fedgroup import FedGroupTrainer
from test_torch_mesh_jax import RecordingDraws

KILL_AT, M = drv.KILL_AT, 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh2d_xload")
    cfg = drv.base_cfg(n_rounds=drv.SERVICE_ROUNDS)
    jcfg = JFedConfig(**{f.name: getattr(cfg, f.name) for f in
                         dataclasses.fields(JFedConfig)
                         if hasattr(cfg, f.name)})
    jcfg = dataclasses.replace(jcfg, checkpoint_every=KILL_AT,
                               checkpoint_dir=str(d / "jax"))
    jtr = JFedGroup(j_mclr(16, 10), j_mnist_like(
        seed=0, n_clients=16, classes_per_client=2, total_train=1200,
        dim=16), jcfg)
    jtr.run(KILL_AT)
    archive = jckpt.checkpoint_path(str(d / "jax"), KILL_AT)
    data, model = drv.fixture()
    rec = RecordingDraws(cfg.seed)
    tr = FedGroupTrainer(model, data, cfg, device="cpu", draws=rec)
    assert tr.load_checkpoint(archive) == KILL_AT
    key = rec.get_state()
    tr.run(drv.SERVICE_ROUNDS - KILL_AT)
    one = drv.service_state(tr, None, [])
    tr.close()
    arrays = {f"{kind}_{i}": v for kind, vals in rec.rec.items()
              for i, v in enumerate(vals)}
    arrays["state"] = np.zeros_like(key)       # the load sets the key
    np.savez(d / "draws.npz", **arrays)
    ranks = drv.spawn_world(2, d, extra=("xload", archive,
                                         str(d / "draws.npz")),
                            suffix=".xload", model=M)
    jhist = np.array([[r.round, r.weighted_acc, r.mean_loss, r.discrepancy,
                       r.quarantined] for r in jtr.history.rounds])
    return jhist, one, ranks


def test_resumed_rounds_start_from_the_jax_history(runs):
    jhist, one, ranks = runs
    for run in [one] + [drv.run_of(z, "xload") for z in ranks]:
        np.testing.assert_array_equal(run["hist"][:KILL_AT], jhist)
        assert run["hist"].shape[0] == drv.SERVICE_ROUNDS


@pytest.mark.parametrize("rank", [0, 1])
def test_ranks_match_the_continuation_without_a_mesh(runs, rank):
    _, one, ranks = runs
    got = {k: v for k, v in drv.run_of(ranks[rank], "xload").items()
           if k != "draws"}
    assert_service_matches_one(got, {k: v for k, v in one.items()
                                     if k != "draws"}, M, rank % M)


def test_ranks_replicas_equal(runs):
    assert_service_replicas(runs[2], M, "xload")
