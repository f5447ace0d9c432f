"""The port's async runtime port against port, on the CPU at
``tests/test_async.py``'s fixtures (``mnist_like(n_clients=40, dim=16)``,
``mclr(16, 10)``, K = 8, E = 2).

  * The equivalence mode (D = 1, α = 1, β = 0) is bit for bit the block
    path for all six pinned trainers and the per-round path for FedAvg,
    FedGroup, IFCA and FeSEM streamed (newcomer arrivals, ``prefetch=2``):
    history, params, group params, membership, ``local_flat``,
    ``comm_params`` and the draws' state; ``staleness_hist == {"0": n}``,
    ``max_in_flight == 1``.
  * Leases: a scripted expiry folds later, an exhausted retry budget
    raises naming ``async_lease_timeout``, a ready result never expires.
  * Kill-and-resume mid-async (D = 2, a checkpoint every 3 rounds, the
    crossing drains the window) is bit for bit, pinned FedGroup and
    streamed FeSEM; a JAX async archive resumes in the port with its
    ``group_version`` and ``async.*`` counters.
"""
import dataclasses
import os

import numpy as np
import pytest

from _torch_parity import ReplayDraws
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.checkpoint import io as jckpt
from repro.core.fedgroup import FedGroupTrainer as JFedGroup
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed.engine import FedConfig as JFedConfig
from repro.models import paper_models as jpm
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed import strategies
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.fed.population import Population, PopulationConfig
from repro_torch.fed.store import ArrayClientStore
from repro_torch.models.paper_models import mclr

N_CLIENTS = 40
STREAM_KW = dict(initial_active=30, arrival_rate=2.0, prefetch=2)
ALL = ["fedavg", "fedgroup", "ifca", "fesem", "fedclust", "lcfl"]


@pytest.fixture(scope="module")
def small_data():
    return mnist_like(seed=0, n_clients=N_CLIENTS, classes_per_client=2,
                      total_train=2000, dim=16)


def _cfg(**kw):
    base = dict(n_rounds=4, clients_per_round=8, local_epochs=2,
                batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4, seed=0)
    base.update(kw)
    return FedConfig(**base)


def _fresh(name, data, streamed, draws=None, **cfg_kw):
    cfg = _cfg(**cfg_kw)
    pop = (Population(ArrayClientStore(data), PopulationConfig(**STREAM_KW))
           if streamed else None)
    kw = dict(device="cpu", population=pop, draws=draws)
    data = None if streamed else data
    if name == "fedavg":
        return FedAvgTrainer(mclr(16, 10), data, cfg, **kw)
    if name == "fedgroup":
        return FedGroupTrainer(mclr(16, 10), data, cfg, **kw)
    return strategies.make_trainer(name, mclr(16, 10), data, cfg, **kw)


def _state(tr) -> dict:
    """Everything the equivalence mode must reproduce bit for bit, as
    numpy."""
    s = {f"params/{k}": v.numpy() for k, v in tr.params.items()}
    for name in ("group_params",):
        for k, v in (getattr(tr, name, None) or {}).items():
            s[f"{name}/{k}"] = v.numpy()
    if getattr(tr, "group_delta", None) is not None:
        s["group_delta"] = tr.group_delta.numpy()
    if hasattr(tr, "membership"):
        s["membership"] = np.array(tr.membership)
    if tr.population is not None:
        if tr.population.state._local_flat is not None:
            s["local_flat"] = tr.population.gather_local_flat(
                np.arange(N_CLIENTS)).numpy()
    elif getattr(tr, "local_flat", None) is not None:
        s["local_flat"] = tr.local_flat.numpy().copy()
    s["comm"] = np.asarray(tr.comm_params)
    s["draws"] = tr.draws.get_state()
    return s


def _assert_state_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape and \
            a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------------------
# the equivalence mode: D = 1, α = 1, β = 0
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ALL)
def test_depth1_pinned_is_the_block_path(name, small_data):
    sync = _fresh(name, small_data, False, block_size=4)
    h_sync = sync.run(4)
    asy = _fresh(name, small_data, False, async_depth=1)
    h_asy = asy.run(4)
    assert h_asy.rounds == h_sync.rounds
    _assert_state_equal(_state(asy), _state(sync))
    assert asy.counters == sync.counters
    st = h_asy.async_stats
    assert st["dispatches"] == st["folds"] == 4
    assert st["max_in_flight"] == 1
    assert st["lease_expiries"] == 0 and st["requeues"] == 0
    assert st["staleness_hist"] == {"0": 4}


@pytest.mark.parametrize("name", ["fedavg", "fedgroup", "ifca", "fesem"])
def test_depth1_streamed_is_the_per_round_path(name, small_data):
    sync = _fresh(name, small_data, True)
    h_sync = sync.run(4)
    s_sync, stats_sync = _state(sync), dict(sync.population.stats)
    sync.close()
    asy = _fresh(name, small_data, True, async_depth=1)
    h_asy = asy.run(4)
    s_asy = _state(asy)
    asy.close()
    assert h_asy.rounds == h_sync.rounds
    _assert_state_equal(s_asy, s_sync)
    assert dict(asy.population.stats) == stats_sync
    assert h_asy.async_stats["staleness_hist"] == {"0": 4}
    assert h_asy.async_stats["max_in_flight"] == 1
    np.testing.assert_array_equal(asy.group_version,
                                  asy.population.state.group_version)


def test_depth2_runs_every_trainer_pinned_and_streamed(small_data):
    for name in ALL:
        for streamed in (False, True):
            tr = _fresh(name, small_data, streamed, async_depth=2,
                        async_alpha=0.8, async_beta=0.5)
            h = tr.run(5)
            tr.close()
            assert [r.round for r in h.rounds] == list(range(5))
            assert h.async_stats["folds"] == 5
            assert h.async_stats["max_in_flight"] == 2
            assert all(np.isfinite(v.numpy()).all()
                       for v in tr.params.values()), (name, streamed)


# ---------------------------------------------------------------------------
# leases
# ---------------------------------------------------------------------------
def test_scripted_expiry_requeues_and_folds_later(small_data):
    tr = _fresh("fedavg", small_data, False, async_depth=2,
                async_lease_timeout=0.05, async_backoff=0.01,
                async_backoff_cap=0.02)
    real = tr._lease_ready
    doomed = []

    def scripted(lease):
        # the first lease never reports ready: it expires at its deadline
        if not doomed:
            doomed.append(lease)
        return False if lease is doomed[0] else real(lease)

    tr._lease_ready = scripted
    h = tr.run(4)
    st = h.async_stats
    assert st["lease_expiries"] == 1 and st["requeues"] == 1
    assert st["dispatches"] == st["folds"] + 1 == 5
    assert [r.round for r in h.rounds] == [0, 1, 2, 3]
    # the first cohort, requeued, folded after the second
    assert st["staleness_hist"] != {"0": 4}


def test_exhausted_retries_raise_naming_the_knobs(small_data):
    tr = _fresh("fedavg", small_data, False, async_depth=1,
                async_lease_timeout=0.001, async_max_retries=1,
                async_backoff=0.001, async_backoff_cap=0.002)
    tr._lease_ready = lambda lease: False          # never completes
    with pytest.raises(RuntimeError, match="async_lease_timeout") as ei:
        tr.run(2)
    assert "unrecoverable" in str(ei.value)
    assert "async_max_retries=1" in str(ei.value)
    assert tr.history.async_stats["lease_expiries"] >= 2


def test_ready_result_is_never_expired(small_data):
    # readiness is checked before the deadline: a finished dispatch folds
    # even under a lease timeout that has always passed
    tr = _fresh("fedavg", small_data, False, async_depth=1,
                async_lease_timeout=-1.0)
    h = tr.run(2)
    assert h.async_stats["lease_expiries"] == 0
    assert len(h.rounds) == 2


# ---------------------------------------------------------------------------
# kill-and-resume mid-async: the checkpoint crossing drains the window
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,streamed", [("fedgroup", False),
                                           ("fesem", True)],
                         ids=["fedgroup-pinned", "fesem-streamed"])
def test_mid_async_resume_is_bit_identical(name, streamed, small_data,
                                           tmp_path):
    kw = dict(async_depth=2, async_alpha=0.8, async_beta=0.5,
              checkpoint_every=3)
    ref = _fresh(name, small_data, streamed,
                 checkpoint_dir=str(tmp_path / "ref"), **kw)
    h_ref = ref.run(8)
    s_ref = _state(ref)
    ref.close()

    kill_dir = str(tmp_path / "kill")
    killed = _fresh(name, small_data, streamed, checkpoint_dir=kill_dir,
                    **kw)
    killed.run(5)                      # "killed" after 5 folded rounds
    killed.close()
    # the crossing at t = 3 drains the other dispatch in flight first, so
    # the quiescent archive is t = 4
    assert os.path.exists(ckpt_io.checkpoint_path(kill_dir, 4))
    meta = ckpt_io.load_metadata(ckpt_io.checkpoint_path(kill_dir, 4))
    assert meta["group_version"] is not None
    assert sum(meta["obs"]["async.staleness_hist"].values()) == 4

    resumed = _fresh(name, small_data, streamed, checkpoint_dir=kill_dir,
                     **kw)
    assert resumed.load_checkpoint(kill_dir) == 4
    h_res = resumed.run(4)
    s_res = _state(resumed)
    resumed.close()
    assert h_res.rounds == h_ref.rounds
    assert h_res.async_stats == h_ref.async_stats
    _assert_state_equal(s_res, s_ref)
    np.testing.assert_array_equal(resumed.group_version, ref.group_version)
    assert resumed.counters == ref.counters


def test_jax_async_archive_resumes_in_the_port(tmp_path):
    kw = dict(seed=0, n_clients=N_CLIENTS, classes_per_client=2,
              total_train=2000, dim=16)
    jcfg = JFedConfig(n_rounds=5, clients_per_round=8, local_epochs=2,
                      batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4,
                      seed=0, async_depth=2, async_alpha=0.8,
                      async_beta=0.5, checkpoint_every=3,
                      checkpoint_dir=str(tmp_path))
    jtr = JFedGroup(jpm.mclr(16, 10), j_mnist_like(**kw), jcfg)
    jtr.run(5)
    path = jckpt.checkpoint_path(str(tmp_path), 4)
    ttr = FedGroupTrainer(mclr(16, 10), mnist_like(**kw),
                          FedConfig(**dataclasses.asdict(jcfg)),
                          device="cpu", draws=ReplayDraws(jcfg.seed))
    assert ttr.load_checkpoint(path) == 4
    meta = jckpt.load_metadata(path)
    np.testing.assert_array_equal(ttr.group_version, meta["group_version"])
    assert ttr.history.async_stats == {
        k[len("async."):]: v for k, v in meta["obs"].items()
        if k.startswith("async.")}
    assert ttr.history.async_stats["folds"] == 4
    assert ttr.cold_started
    with np.load(path) as z:                 # the JAX key, replayed on
        np.testing.assert_array_equal(ttr.draws.get_state(), z["model/key"])
    h = ttr.run(2)
    assert [r.round for r in h.rounds] == list(range(6))
    assert h.async_stats["folds"] == 6
    assert all(np.isfinite(v.numpy()).all() for v in ttr.params.values())


def test_async_stats_and_counters_are_registry_views(small_data):
    tr = _fresh("fedgroup", small_data, False, async_depth=2)
    tr.run(3)
    reg = tr.registry
    assert tr.history.async_stats["folds"] == reg.get("async.folds") == 3
    assert tr.counters["rounds.completed"] == reg.get("rounds.completed")
    assert "rounds.checkpoints" not in tr.counters      # zero: left out
