"""The port's trainer checkpoints (``repro_torch.fed.engine``
``save_checkpoint`` / ``load_checkpoint``) and the round-checkpoint
helpers of ``repro_torch.checkpoint``, port against port, on the CPU, at
``tests/test_robustness.py``'s fixtures.

  * The archive helpers: atomic write at the exact path, the strict load
    against a template (keys, shapes, dtypes; numpy leaves stay numpy,
    tensor leaves land on the template's device), ``latest_checkpoint``,
    ``saved_array_specs``, ``prune_checkpoints``.
  * Kill-and-resume is bit-identical: a run killed after 3 rounds (last
    checkpoint at t = 2), restored into a fresh trainer, replays rounds
    2-3 with the uninterrupted run's history, params, group params,
    membership, ``local_flat``, comm accounting and draws state — FedAvg,
    FedGroup, IFCA and FeSEM pinned and streamed (newcomer arrivals,
    ``prefetch=2``), FedClust, LCFL and FedGroup with the shift detector
    pinned, a blocked run whose blocks cross the cadence, and a blocked
    FedGroup run checkpointed at a block that stops on a cohort of cold
    newcomers.
  * ``run(a); run(b) == run(a + b)``, the refusals, an explicit earlier
    checkpoint, retention, and the population's ``stats`` lifecycle.
"""
import os

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed import strategies
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.fed.population import (FaultConfig, FaultSpec, Population,
                                        PopulationConfig)
from repro_torch.fed.store import ArrayClientStore
from repro_torch.models.paper_models import mclr

N_CLIENTS = 40
STREAM_KW = dict(initial_active=30, arrival_rate=2.0, prefetch=2)


@pytest.fixture(scope="module")
def small_data():
    return mnist_like(seed=0, n_clients=N_CLIENTS, classes_per_client=2,
                      total_train=2000, dim=16)


def _cfg(**kw):
    base = dict(n_rounds=4, clients_per_round=8, local_epochs=2,
                batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4, seed=0)
    base.update(kw)
    return FedConfig(**base)


def _make(name, data, cfg, population=None):
    kw = dict(device="cpu", population=population)
    model = mclr(16, 10)
    if name == "fedavg":
        return FedAvgTrainer(model, data, cfg, **kw)
    if name == "fedgroup":
        return FedGroupTrainer(model, data, cfg, **kw)
    return strategies.make_trainer(name, model, data, cfg, **kw)


def _fresh(name, data, streamed, **cfg_kw):
    cfg = _cfg(**cfg_kw)
    if streamed:
        pop = Population(ArrayClientStore(data),
                         PopulationConfig(**STREAM_KW))
        return _make(name, None, cfg, pop)
    return _make(name, data, cfg)


def _assert_tree_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k].cpu().numpy(), b[k].cpu().numpy())


def _local_flat(tr):
    if tr.population is not None:
        if tr.population.state._local_flat is None:
            return None
        return tr.population.gather_local_flat(np.arange(N_CLIENTS))
    return getattr(tr, "local_flat", None)


def _assert_same_state(res, ref):
    assert res.history.rounds == ref.history.rounds
    _assert_tree_equal(res.params, ref.params)
    if hasattr(ref, "group_params"):
        _assert_tree_equal(res.group_params, ref.group_params)
        np.testing.assert_array_equal(res.membership, ref.membership)
    lf_ref, lf_res = _local_flat(ref), _local_flat(res)
    if lf_ref is not None:
        np.testing.assert_array_equal(lf_res.numpy(), lf_ref.numpy())
    assert res.comm_params == ref.comm_params
    np.testing.assert_array_equal(res.draws.get_state(),
                                  ref.draws.get_state())


# ---------------------------------------------------------------------------
# archive helpers (checkpoint/io.py)
# ---------------------------------------------------------------------------
def test_save_is_atomic_and_path_exact(tmp_path):
    path = str(tmp_path / "snap")                 # no ".npz" appended
    tree = {"a": torch.arange(4.0), "b": {"c": torch.ones(2, 3)}}
    ckpt_io.save_pytree(path, tree, {"note": "x"})
    assert os.path.exists(path)
    assert not list(tmp_path.glob("*.tmp-*"))
    back = ckpt_io.load_pytree(path, tree)
    _assert_tree_equal(back["b"], tree["b"])
    assert torch.equal(back["a"], tree["a"])
    assert ckpt_io.load_metadata(path) == {"note": "x"}


def test_template_keeps_numpy_on_host_and_tensors_on_their_device(tmp_path):
    path = str(tmp_path / "ints.npz")
    tree = {"ids": np.arange(5, dtype=np.int64),
            "dev": torch.ones(3, dtype=torch.float32)}
    ckpt_io.save_pytree(path, tree)
    back = ckpt_io.load_pytree(path, tree)
    assert isinstance(back["ids"], np.ndarray)
    assert back["ids"].dtype == np.int64
    assert isinstance(back["dev"], torch.Tensor)
    assert back["dev"].device == tree["dev"].device


def test_strict_load_rejects_key_shape_and_dtype_mismatch(tmp_path):
    path = str(tmp_path / "ck.npz")
    ckpt_io.save_pytree(path, {"a": np.zeros((2, 3)), "b": np.zeros(3)})
    with pytest.raises(ValueError, match="extra keys.*'b'"):
        ckpt_io.load_pytree(path, {"a": np.zeros((2, 3))})
    with pytest.raises(ValueError, match="missing keys.*'c'"):
        ckpt_io.load_pytree(path, {"a": np.zeros((2, 3)), "b": np.zeros(3),
                                   "c": np.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch at a"):
        ckpt_io.load_pytree(path, {"a": np.zeros((3, 2)), "b": np.zeros(3)})
    with pytest.raises(ValueError, match="dtype mismatch at b"):
        ckpt_io.load_pytree(path, {"a": np.zeros((2, 3)),
                                   "b": torch.zeros(3)})


def test_latest_checkpoint_and_specs(tmp_path):
    assert ckpt_io.latest_checkpoint(str(tmp_path)) is None
    assert ckpt_io.latest_checkpoint(str(tmp_path / "missing")) is None
    for t in (2, 10, 4):
        ckpt_io.save_pytree(ckpt_io.checkpoint_path(str(tmp_path), t),
                            {"t": np.asarray(t)})
    (tmp_path / "not_a_ckpt.npz").write_bytes(b"x")
    assert ckpt_io.latest_checkpoint(str(tmp_path)) == \
        ckpt_io.checkpoint_path(str(tmp_path), 10)
    path = str(tmp_path / "specs.npz")
    ckpt_io.save_pytree(path, {"a": np.zeros((2, 3), np.float32),
                               "b": np.zeros(5, np.int64)})
    specs = ckpt_io.saved_array_specs(path)
    assert specs["a"] == ((2, 3), np.dtype(np.float32))
    assert specs["b"] == ((5,), np.dtype(np.int64))


def test_prune_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    for t in (1, 2, 3, 4):
        ckpt_io.save_pytree(ckpt_io.checkpoint_path(d, t),
                            {"t": np.asarray(t)})
    (tmp_path / "notes.txt").write_text("kept")
    removed = ckpt_io.prune_checkpoints(d, 2)
    assert sorted(removed) == [ckpt_io.checkpoint_path(d, t) for t in (1, 2)]
    assert sorted(os.listdir(d)) == ["ckpt_00000003.npz",
                                     "ckpt_00000004.npz", "notes.txt"]
    assert ckpt_io.prune_checkpoints(d, 0) == []


# ---------------------------------------------------------------------------
# kill-and-resume, bit-identical
# ---------------------------------------------------------------------------
RESUME_CASES = ([(n, s) for n in ("fedavg", "fedgroup", "ifca", "fesem")
                 for s in (False, True)]
                + [("fedclust", False), ("lcfl", False)])


def _kill_and_resume(name, data, streamed, tmp_path, **cfg_kw):
    ref = _fresh(name, data, streamed, **cfg_kw)
    ref.run(4)
    ref.close()
    ck = dict(cfg_kw, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    killed = _fresh(name, data, streamed, **ck)
    killed.run(3)
    killed.close()
    assert os.path.exists(ckpt_io.checkpoint_path(str(tmp_path), 2))
    resumed = _fresh(name, data, streamed, **ck)
    t = resumed.load_checkpoint(str(tmp_path))   # a directory: the latest
    assert t == 2
    resumed.run(4 - t)
    resumed.close()
    _assert_same_state(resumed, ref)
    return ref, resumed


@pytest.mark.parametrize("name,streamed", RESUME_CASES,
                         ids=[f"{n}-{'streamed' if s else 'pinned'}"
                              for n, s in RESUME_CASES])
def test_resume_is_bit_identical(name, streamed, small_data, tmp_path):
    ref, resumed = _kill_and_resume(name, small_data, streamed, tmp_path)
    if name == "fedgroup":
        assert resumed.cold_started
        torch.testing.assert_close(resumed.group_delta, ref.group_delta,
                                   rtol=0, atol=0)
        if streamed:
            # the membership array is still the state table's
            assert resumed.membership is resumed.population.state.membership
    # checkpoints counted before each snapshot: t = 2 and t = 4
    assert resumed.counters["rounds.checkpoints"] == 2
    assert resumed.counters["rounds.completed"] == \
        ref.counters["rounds.completed"] == 4


def test_resume_with_the_shift_detector_keeps_the_direction_cache(
        small_data, tmp_path):
    ref, resumed = _kill_and_resume("fedgroup", small_data, False, tmp_path,
                                    shift_threshold=0.0)
    assert ref.counters["rounds.shift_checks"] > 0
    ids = np.arange(N_CLIENTS)
    np.testing.assert_array_equal(resumed._pin_dirs.has(ids),
                                  ref._pin_dirs.has(ids))
    have = ids[ref._pin_dirs.has(ids)]
    np.testing.assert_array_equal(resumed._pin_dirs.gather(have).numpy(),
                                  ref._pin_dirs.gather(have).numpy())
    assert resumed._shift_tick == ref._shift_tick


def test_block_crossing_the_cadence_checkpoints_at_its_end(small_data,
                                                           tmp_path):
    kw = dict(block_size=3, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    full = _make("ifca", small_data, _cfg(**kw))
    full.run(6)                        # blocks [0, 3) and [3, 6)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000003.npz",
                                            "ckpt_00000006.npz"]
    resumed = _make("ifca", small_data, _cfg(**kw))
    assert resumed.load_checkpoint(
        ckpt_io.checkpoint_path(str(tmp_path), 3)) == 3
    resumed.run(3)
    _assert_same_state(resumed, full)


def test_block_ending_on_a_newcomer_cohort_resumes_exactly(small_data,
                                                           tmp_path):
    # FedGroup's block [13, 14) stops at round 14, whose cohort holds cold
    # newcomers (host work), and checkpoints at its end: the archive must
    # hold select_rng from before round 14's draw
    kw = dict(block_size=3, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    full = _make("fedgroup", small_data, _cfg(**kw))
    full.run(16)
    assert "ckpt_00000013.npz" in os.listdir(tmp_path)   # a block crossed 12
    resumed = _make("fedgroup", small_data, _cfg(**kw))
    assert resumed.load_checkpoint(
        ckpt_io.checkpoint_path(str(tmp_path), 14)) == 14
    peek = np.random.default_rng()
    peek.bit_generator.state = resumed.select_rng.bit_generator.state
    nxt = peek.choice(N_CLIENTS, 8, replace=False)
    assert (resumed.membership[nxt] < 0).any()     # round 14 needs the host
    resumed.run(2)
    _assert_same_state(resumed, full)


def test_run_counts_more_rounds_from_history(small_data):
    a = _make("fedavg", small_data, _cfg())
    a.run(2)
    a.run(2)
    b = _make("fedavg", small_data, _cfg())
    b.run(4)
    assert a.history.rounds == b.history.rounds
    assert [r.round for r in a.history.rounds] == [0, 1, 2, 3]


def test_load_checkpoint_refusals(small_data, tmp_path):
    tr = _make("fedavg", small_data, _cfg())
    tr.run(2)
    path = tr.save_checkpoint(str(tmp_path / "ck.npz"))
    with pytest.raises(ValueError, match="framework"):
        _make("fedgroup", small_data, _cfg()).load_checkpoint(path)
    busy = _make("fedavg", small_data, _cfg())
    busy.run(1)
    with pytest.raises(RuntimeError, match="fresh trainer"):
        busy.load_checkpoint(path)
    pop = Population(ArrayClientStore(small_data),
                     PopulationConfig(prefetch=0))
    st = _make("fedavg", None, _cfg(), pop)
    with pytest.raises(ValueError, match="pinned run"):
        st.load_checkpoint(path)
    st.run(1)
    spath = st.save_checkpoint(str(tmp_path / "streamed.npz"))
    st.close()
    with pytest.raises(ValueError, match="streamed-population"):
        _make("fedavg", small_data, _cfg()).load_checkpoint(spath)
    fewer = mnist_like(seed=0, n_clients=30, classes_per_client=2,
                       total_train=1500, dim=16)
    with pytest.raises(ValueError, match="clients"):
        _make("fedavg", fewer, _cfg()).load_checkpoint(path)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        _make("fedavg", small_data, _cfg()).load_checkpoint(str(empty))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tr.save_checkpoint()


def test_explicit_earlier_checkpoint_replays_forward(small_data, tmp_path):
    ck = dict(checkpoint_every=2, checkpoint_dir=str(tmp_path),
              checkpoint_keep=0)
    full = _make("fedavg", small_data, _cfg(**ck))
    full.run(4)                                   # checkpoints at 2 and 4
    resumed = _make("fedavg", small_data, _cfg(**ck))
    assert resumed.load_checkpoint(
        ckpt_io.checkpoint_path(str(tmp_path), 2)) == 2
    resumed.run(2)
    _assert_same_state(resumed, full)


def test_checkpoint_keep_prunes_after_each_write(small_data, tmp_path):
    ck = dict(checkpoint_every=1, checkpoint_dir=str(tmp_path),
              checkpoint_keep=2)
    _make("fedavg", small_data, _cfg(**ck)).run(4)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000003.npz",
                                            "ckpt_00000004.npz"]


def test_prefetching_population_needs_checkpointing_on(small_data):
    pop = Population(ArrayClientStore(small_data), PopulationConfig())
    tr = _make("fedavg", None, _cfg(), pop)
    tr.run(2)
    with pytest.raises(RuntimeError, match="without checkpointing"):
        pop.ckpt_state()
    tr.close()


# ---------------------------------------------------------------------------
# Population.stats: reset per run(), checkpointed, restored
# ---------------------------------------------------------------------------
def test_stats_reset_between_runs(small_data):
    faults = FaultConfig(rounds={1: FaultSpec(kill=5)})
    pop = Population(ArrayClientStore(small_data),
                     PopulationConfig(faults=faults))
    tr = _make("fedavg", None, _cfg(), pop)
    tr.run(2)
    assert pop.stats["killed_clients"] == 5
    tr.run(2)                        # rounds 2-3: no faults scripted there
    tr.close()
    assert pop.stats["killed_clients"] == 0


def test_reset_stats_zeroes_every_counter(small_data):
    pop = Population(ArrayClientStore(small_data), PopulationConfig())
    pop.stats["lease_expiries"] = 7
    pop.stats["requeues"] = 3
    pop._writer.retries = 2
    pop.reset_stats()
    assert all(v == 0 for v in pop.stats.values())
    assert pop._writer.retries == 0
    pop.close()


def test_restored_stats_survive_resume(small_data, tmp_path):
    faults = FaultConfig(rounds={1: FaultSpec(kill=4)})
    ck = dict(checkpoint_every=2, checkpoint_dir=str(tmp_path))
    pop = Population(ArrayClientStore(small_data),
                     PopulationConfig(faults=faults))
    tr = _make("fedavg", None, _cfg(**ck), pop)
    tr.run(2)
    tr.close()
    meta = ckpt_io.load_metadata(ckpt_io.checkpoint_path(str(tmp_path), 2))
    assert meta["obs"]["pop.killed_clients"] == 4
    assert meta["obs"]["rounds.checkpoints"] == 1

    pop2 = Population(ArrayClientStore(small_data),
                      PopulationConfig(faults=faults))
    tr2 = _make("fedavg", None, _cfg(**ck), pop2)
    assert tr2.load_checkpoint(str(tmp_path)) == 2
    assert pop2.stats["killed_clients"] == 4
    tr2.run(2)                       # the resumed run keeps the totals
    tr2.close()
    assert pop2.stats["killed_clients"] == 4
