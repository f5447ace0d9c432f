"""A JAX-package archive resumed on a data mesh of two gloo ranks.

The JAX trainer (``repro.core.fedgroup``, pinned, EDC) runs two rounds at
the mesh tests' fixture (``tests/_torch_mesh_driver.py``) and checkpoints.
The port's trainer resumes that archive without a mesh in this process
(read as ``tests/test_torch_checkpoint_xload.py`` reads one: the draws
replay the JAX key chain, ``ReplayDraws``, whose state is the archive's
key) and records every draw it is handed; two ranks then resume the same
archive with those draws (their processes import no JAX) and run the same
two rounds. Held: the restored rounds equal, membership and the
histories' counts equal, each parameter leaf within 1e-5 in relative
Frobenius norm of the continuation without a mesh (loss and discrepancy
rtol 1e-4, accuracy 2e-3), and the two ranks' replicas equal.
"""
import dataclasses

import numpy as np
import pytest

import _torch_mesh_driver as drv
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.checkpoint import io as jckpt
from repro.core.fedgroup import FedGroupTrainer as JFedGroup
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed.engine import FedConfig as JFedConfig
from repro.models.paper_models import mclr as j_mclr
from repro_torch.core.fedgroup import FedGroupTrainer
from test_torch_mesh_jax import RecordingDraws

KILL_AT = drv.KILL_AT


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_xload")
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
                            suffix=".xload")
    jhist = np.array([[r.round, r.weighted_acc, r.mean_loss, r.discrepancy,
                       r.quarantined] for r in jtr.history.rounds])
    return jhist, one, [drv.run_of(z, "xload") for z in ranks]


def test_resumed_rounds_start_from_the_jax_history(runs):
    jhist, one, ranks = runs
    for run in [one] + ranks:
        np.testing.assert_array_equal(run["hist"][:KILL_AT], jhist)
        assert run["hist"].shape[0] == drv.SERVICE_ROUNDS


@pytest.mark.parametrize("rank", [0, 1])
def test_two_ranks_match_the_continuation_without_a_mesh(runs, rank):
    _, one, ranks = runs
    got = {k: v for k, v in ranks[rank].items() if k != "draws"}
    drv.assert_sharded_close(got, {k: v for k, v in one.items()
                                   if k != "draws"})


def test_two_ranks_replicas_equal(runs):
    _, _, ranks = runs
    assert drv.differing(ranks[1], ranks[0]) == []
