"""Checkpoints through the port's coordinator, on the CPU at
``tests/test_fleet.py``'s fixtures.

  * A coordinator restart resumes bit for bit: FedGroup streamed behind a
    fleet of two is "killed" after 3 rounds, a fresh coordinator loads the
    round-2 archive (whose ``fleet`` metadata carries the dispatch clock)
    and finishes; the run equals an uninterrupted plain run exactly.
  * A plain trainer reads a fleet checkpoint, and a coordinator reads a
    plain one.
  * A JAX coordinator's archive (``repro.launch.coordinator``, FedGroup
    pinned) resumes in the port's coordinator, which replays the JAX
    trainer's draws (``ReplayDraws``): the dispatch clock resumes, and the
    run is held to the JAX run at ``tests/test_torch_checkpoint_xload.py``'s
    tolerances (membership equal, loss and discrepancy rtol 1e-3, accuracy
    0.01, parameters rtol 1e-4, atol 1e-6).
"""
import dataclasses
import os

import jax
import numpy as np
import pytest

from _torch_fleet import (CALM, DATA_KW, assert_same_run, fleet_snap, fresh,
                          state_of)
from _torch_parity import ReplayDraws, tnp
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.checkpoint import io as jckpt
from repro.core.fedgroup import FedGroupTrainer as JFedGroup
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed.engine import FedConfig as JFedConfig
from repro.launch.coordinator import Coordinator as JCoordinator
from repro.launch.coordinator import FleetConfig as JFleetConfig
from repro.models import paper_models as jpm
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed.engine import FedConfig
from repro_torch.launch.coordinator import Coordinator, FleetConfig
from repro_torch.models import paper_models as tpm


@pytest.fixture(scope="module")
def small_data():
    return mnist_like(**DATA_KW)


def test_restart_resumes_bit_identically(small_data, tmp_path):
    ref = fresh("fedgroup", small_data, True)
    ref.run(4)
    ref_state = state_of(ref)
    ref.close()

    ck = dict(checkpoint_every=2, checkpoint_dir=str(tmp_path))
    killed = fresh("fedgroup", small_data, True, **ck)
    c1 = Coordinator(killed, FleetConfig(n_workers=2, **CALM))
    c1.run(3)                              # "killed" after 3 rounds
    c1.close()
    path = ckpt_io.checkpoint_path(str(tmp_path), 2)
    assert os.path.exists(path)
    fm = ckpt_io.load_metadata(path)["fleet"]
    assert fm["transport"] == "inproc"
    assert fm["n_workers"] == 2 and fm["live"] == ["w0", "w1"]
    assert fm["dispatch_clock"] == fm["next_job_id"] == 2

    resumed = fresh("fedgroup", small_data, True, **ck)
    c2 = Coordinator(resumed, FleetConfig(n_workers=2, **CALM))
    t = c2.load_checkpoint(str(tmp_path))      # dir -> latest archive
    assert t == 2
    assert c2._clock == fm["dispatch_clock"]   # the script clock resumes
    assert c2._job_id == fm["next_job_id"]
    h_res = c2.run(4 - t)
    snap, state = fleet_snap(resumed), state_of(resumed)
    c2.close()

    assert h_res.rounds == ref.history.rounds
    assert_same_run(resumed, ref, state, ref_state)
    # cumulative: the archive's counters came back with it
    assert snap["fleet.jobs"] == snap["fleet.results"] == 4
    assert c2._clock == 4


def test_plain_trainer_reads_fleet_checkpoint(small_data, tmp_path):
    tr = fresh("fedavg", small_data)
    coord = Coordinator(tr, FleetConfig(n_workers=1, **CALM))
    coord.run(2)
    path = coord.save_checkpoint(str(tmp_path / "ck.npz"))
    coord.close()
    assert ckpt_io.load_metadata(path)["obs"]["fleet.jobs"] == 2

    solo = fresh("fedavg", small_data)
    assert solo.load_checkpoint(path) == 2
    solo.run(1)
    assert len(solo.history.rounds) == 3
    # the fleet's counters ride along harmlessly
    assert solo.registry.get("fleet.jobs") == 2
    solo.close()

    # and the other way: a plain archive into a coordinator
    plain = str(tmp_path / "plain.npz")
    solo.save_checkpoint(plain)
    again = fresh("fedavg", small_data)
    c = Coordinator(again, FleetConfig(n_workers=1, **CALM))
    assert c.load_checkpoint(plain) == 3
    assert c._clock == 0                       # no fleet metadata
    c.run(1)
    c.close()
    assert len(again.history.rounds) == 4


def test_jax_coordinator_archive_resumes_in_the_port(tmp_path):
    jdata, tdata = j_mnist_like(**DATA_KW), mnist_like(**DATA_KW)
    jcfg = JFedConfig(n_rounds=4, clients_per_round=8, local_epochs=2,
                      batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4,
                      seed=0, checkpoint_every=2,
                      checkpoint_dir=str(tmp_path / "jck"))
    jtr = JFedGroup(jpm.mclr(16, 10), jdata, jcfg)
    jc = JCoordinator(jtr, JFleetConfig(n_workers=1, heartbeat_interval=0.05,
                                        heartbeat_miss=100))
    try:
        jc.run(4)
    finally:
        jc.close()
    path = jckpt.checkpoint_path(jcfg.checkpoint_dir, 2)
    fm = jckpt.load_metadata(path)["fleet"]
    assert fm["dispatch_clock"] == 2

    tcfg = dataclasses.replace(FedConfig(**dataclasses.asdict(jcfg)),
                               checkpoint_dir=str(tmp_path / "tck"))
    ttr = FedGroupTrainer(tpm.mclr(16, 10), tdata, tcfg, device="cpu",
                          draws=ReplayDraws(jcfg.seed))
    tc = Coordinator(ttr, FleetConfig(n_workers=1, **CALM))
    try:
        assert tc.load_checkpoint(path) == 2
        assert tc._clock == 2 and tc._job_id == fm["next_job_id"]
        assert ttr.cold_started
        tc.run(2)
        snap = fleet_snap(ttr)
    finally:
        tc.close()
    assert [dataclasses.astuple(r) for r in ttr.history.rounds[:2]] == \
        [dataclasses.astuple(r) for r in jtr.history.rounds[:2]]
    for tm, jm in zip(ttr.history.rounds[2:], jtr.history.rounds[2:]):
        assert tm.round == jm.round
        np.testing.assert_allclose(tm.mean_loss, jm.mean_loss, rtol=1e-3)
        np.testing.assert_allclose(tm.discrepancy, jm.discrepancy,
                                   rtol=1e-3)
        assert abs(tm.weighted_acc - jm.weighted_acc) <= 0.01
    np.testing.assert_array_equal(ttr.membership, jtr.membership)
    jg = jax.tree_util.tree_map(np.asarray, jtr.group_params)
    for k in jg:
        np.testing.assert_allclose(tnp(ttr.group_params[k]), jg[k],
                                   rtol=1e-4, atol=1e-6)
    assert ttr.comm_params == jtr.comm_params
    np.testing.assert_array_equal(ttr.draws.get_state(), np.asarray(jtr.key))
    assert snap["fleet.jobs"] == snap["fleet.results"] == 4
    assert tc._clock == 4
