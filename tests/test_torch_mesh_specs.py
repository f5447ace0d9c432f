"""The port's mesh helpers against the reference's, on one process.

``sharding/specs.py``'s federated specs against the JAX package's
``PartitionSpec``s; ``shard_cohort_slices`` and ``ShardedClientStore``
against ``repro.fed.store``'s (a sharded store's gather equals the plain
store's bit for bit); ``launch/mesh.py`` and ``fed/parallel.py``'s mesh
half on a gloo world of one rank made in this process (a FileStore in a
temporary directory); the runtime services of 16b (the async executors,
checkpoints, telemetry, a thread-worker fleet, a population's deadline
and faults) and a process fleet (16b′) on a mesh of one, and
``FedMesh.agree``, ``barrier`` and the byte check.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.data import generators as jgen
from repro.fed import store as jstore
from repro.sharding import specs as jspecs
from repro_torch.data import generators as tgen
from repro_torch.fed import parallel
from repro_torch.fed import store as tstore
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.paper_models import mclr
from repro_torch.sharding import specs

SHAPES = [(3,), (3, 8), (5, 16, 6), (2, 12, 10), (4, 7, 9, 8), (1, 64)]


@pytest.mark.parametrize("ndim", [1, 2, 3, 4])
@pytest.mark.parametrize("axes", [("data",), ("pod", "data")])
def test_cohort_and_block_pspecs_match_reference(ndim, axes):
    assert specs.cohort_pspec(ndim, axes) == tuple(
        jspecs.cohort_pspec(ndim, axes))
    if ndim >= 2:
        assert specs.block_staged_pspec(ndim, axes) == tuple(
            jspecs.block_staged_pspec(ndim, axes))


@pytest.mark.parametrize("model_size", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_group_param_pspec_matches_reference(shape, model_size):
    assert specs.group_param_pspec(shape, model_size) == tuple(
        jspecs.group_param_pspec(shape, model_size))


@pytest.mark.parametrize("names", [("data",), ("data", "model"),
                                   ("pod", "data", "model"), ("x",)])
def test_data_axis_names_match_reference(names):
    m = types.SimpleNamespace(axis_names=names)
    assert specs.data_axis_names(m) == jspecs.data_axis_names(m)


def test_group_param_specs_match_reference():
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4},
                                 axis_names=("data", "model"))
    params = {"w": torch.zeros(3, 16, 10), "b": torch.zeros(3, 10)}
    want = jspecs.group_param_specs(
        {k: np.zeros(v.shape) for k, v in params.items()}, mesh)
    got = specs.group_param_specs(params, mesh)
    assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("K", [0, 1, 6, 7, 8, 12, 20])
@pytest.mark.parametrize("S", [0, 1, 2, 3, 4])
def test_shard_cohort_slices_match_reference(K, S):
    assert tstore.shard_cohort_slices(K, S) == \
        jstore.shard_cohort_slices(K, S)


@pytest.fixture(scope="module")
def stores():
    kw = dict(seed=0, n_clients=40, classes_per_client=2, total_train=2000,
              dim=16)
    return (jstore.ArrayClientStore(jgen.mnist_like(**kw)),
            tstore.ArrayClientStore(tgen.mnist_like(**kw)))


def _same(a, b):
    for u, v in zip(a, b, strict=True):
        assert u.dtype == v.dtype and u.shape == v.shape
        assert u.tobytes() == v.tobytes()


@pytest.mark.parametrize("S", [1, 2, 4, 3])
@pytest.mark.parametrize("split", ["train", "test"])
def test_sharded_store_matches_reference_and_plain(stores, S, split):
    jinner, tinner = stores
    js, ts = jstore.ShardedClientStore(jinner, S), \
        tstore.ShardedClientStore(tinner, S)
    assert ts.name == js.name and ts.n_shards == S
    for attr in ("n_clients", "n_classes", "max_train", "max_test", "feat"):
        assert getattr(ts, attr) == getattr(js, attr)
    idx = np.array([3, 17, 0, 39, 5, 22, 11, 30])
    parts_t = getattr(ts, f"gather_{split}_shards")(idx)
    parts_j = getattr(js, f"gather_{split}_shards")(idx)
    if 8 % S:
        assert parts_t is None and parts_j is None
    else:
        for pt, pj in zip(parts_t, parts_j, strict=True):
            _same(pt, pj)
    # the round trip: a sharded store's gather is the plain store's
    _same(getattr(ts, f"gather_{split}")(idx),
          getattr(tinner, f"gather_{split}")(idx))
    _same(getattr(ts, f"gather_{split}")(idx),
          getattr(js, f"gather_{split}")(idx))


def test_sharded_store_rejects_no_shards(stores):
    with pytest.raises(ValueError):
        tstore.ShardedClientStore(stores[1], 0)


def test_no_process_group_means_no_mesh(monkeypatch):
    monkeypatch.delenv("REPRO_MODEL_AXIS", raising=False)
    assert parallel.default_data_mesh() is None
    assert parallel.default_fed_mesh() is None
    assert parallel.mesh_data_shards(None) == 1
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_fed_mesh(1)


def test_model_axis_raises_16c(monkeypatch):
    """Ported (16c): a model axis builds over a process group (``tests/
    test_torch_mesh2d_specs.py``); without one each constructor asks for
    it, and the trainers' default is no mesh (the name is the refusal's
    it replaced)."""
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_fed_mesh(1, 2)
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_production_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_production_mesh(multi_pod=True)
    monkeypatch.setenv("REPRO_MODEL_AXIS", "2")
    assert parallel.default_fed_mesh() is None


@pytest.mark.parametrize("dev,local_world,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cpu", 1, 8, "gloo"), ("cuda", 2, 2, "nccl"),
    ("cuda", 1, 1, "nccl"), ("cuda", 2, 1, "gloo"), ("cuda", 8, 4, "gloo")])
def test_choose_backend(dev, local_world, cards, want):
    assert mesh_lib.choose_backend(dev, local_world, cards) == want


def test_rank_device():
    assert mesh_lib.rank_device("cpu", 3) == torch.device("cpu")
    assert mesh_lib.rank_device("cuda", 3, cards=2) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.rank_device("cuda", 0, cards=0)


@pytest.mark.parametrize("rank,K,want", [(0, 8, (0, 4)), (1, 8, (4, 8)),
                                         (1, 7, None), (0, 0, (0, 0))])
def test_cohort_rows_of_a_rank(rank, K, want):
    m = mesh_lib.FedMesh(group=None, rank=rank, world=2,
                         shape={"data": 2, "model": 1}, backend="gloo",
                         device=torch.device("cpu"))
    assert m.cohort_rows(K) == want
    assert parallel.mesh_data_shards(m) == 2


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    d = tmp_path_factory.mktemp("pg")
    mesh_lib.init_process_group("cpu", init_method=f"file://{d / 'store'}",
                                rank=0, world_size=1)
    try:
        yield mesh_lib.make_fed_mesh(1, device="cpu")
    finally:
        mesh_lib.destroy_process_group()


def test_world_of_one(mesh1):
    assert (mesh1.rank, mesh1.world, mesh1.backend) == (0, 1, "gloo")
    assert mesh1.shape == {"data": 1, "model": 1}
    assert mesh1.device == torch.device("cpu")
    assert mesh_lib.make_local_mesh(device="cpu").shape == mesh1.shape
    # a world of one is no mesh for the trainers' default
    assert parallel.default_data_mesh(device="cpu") is None
    with pytest.raises(ValueError, match="does not cover"):
        mesh_lib.make_fed_mesh(2, device="cpu")


def test_collectives_on_a_world_of_one(mesh1):
    t = torch.tensor([[1.0, -0.0], [2.0, 3.0]])
    assert torch.equal(mesh1.all_reduce(t.clone()), t)
    assert torch.equal(mesh1.broadcast(t.clone()), t)
    g = mesh1.gather_rows(t, 2)
    assert g.numpy().tobytes() == t.numpy().tobytes()   # -0.0 kept
    mesh1.same_on_every_rank("t", t)


def test_shard_client_axis_and_put_sharded_cohort(mesh1):
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    tree = {"x": x, "n": np.arange(6), "s": None}
    out = parallel.shard_client_axis(mesh1, tree)
    assert out["s"] is None and torch.equal(out["x"], torch.as_tensor(x))
    none = parallel.shard_client_axis(None, (x,))
    assert isinstance(none, tuple) and torch.equal(none[0],
                                                   torch.as_tensor(x))
    parts = [(x[:3], np.arange(3)), (x[3:], np.arange(3, 6))]
    merged = parallel.put_sharded_cohort(mesh1, parts)     # 2 parts, 1 shard
    assert torch.equal(merged[0], torch.as_tensor(x))
    one = parallel.put_sharded_cohort(mesh1, [(x, np.arange(6))])
    assert torch.equal(one[0], torch.as_tensor(x))
    g = parallel.gather_client_axis(mesh1, {"a": torch.as_tensor(x)}, 6)
    assert torch.equal(g["a"], torch.as_tensor(x))


def test_sharded_executors_check_their_mesh(mesh1):
    from repro_torch.fed import rounds
    kw = dict(epochs=1, batch_size=5, lr=0.1, mu=0.0, n_groups=2,
              max_samples=10)
    fn = rounds.make_round_executor(mclr(4, 3), **kw)
    assert parallel.make_sharded_executor(fn, None) is fn
    with pytest.raises(ValueError, match="another mesh"):
        parallel.make_sharded_executor(fn, mesh1)
    on = rounds.make_round_executor(mclr(4, 3), mesh=mesh1, **kw)
    ex = parallel.make_sharded_executor(on, mesh1)
    assert ex.mesh is mesh1 and ex.max_steps == on.max_steps
    bfn = rounds.make_block_executor(mclr(4, 3), mesh=mesh1, **kw)
    assert parallel.make_sharded_block_executor(bfn, mesh1).mesh is mesh1
    with pytest.raises(ValueError, match="another mesh"):
        parallel.make_sharded_block_executor(bfn, None)


def test_async_executors_raise_16b_under_a_mesh(mesh1):
    """Ported (16b): the dispatch executor takes a dispatch built for its
    mesh, the fold is replicated as it is (the name is the refusal's it
    replaced)."""
    from repro_torch.fed import rounds
    kw = dict(epochs=1, batch_size=5, lr=0.1, mu=0.0, n_groups=2,
              max_samples=10)
    on = rounds.make_async_dispatch_executor(mclr(4, 3), mesh=mesh1, **kw)
    ex = parallel.make_async_dispatch_executor(on, mesh1, 2)
    # gloo: a dispatch runs eagerly on the card (no graph holds gloo's
    # collectives)
    assert ex.mesh is mesh1 and ex.slots == 3 and ex.eager_on_card
    with pytest.raises(ValueError, match="another mesh"):
        parallel.make_async_dispatch_executor(on, None)
    fold = object()
    assert parallel.make_async_fold(fold) is fold
    assert parallel.make_async_fold(fold, mesh1) is fold


def _data():
    return tgen.synthetic(seed=0, n_clients=4)


# the ids of the refusals these cases replaced (each named item 16b)
@pytest.mark.parametrize("field,value", [
    pytest.param(f, v, id=f"{f}-{v}-16b") for f, v in (
        ("async_depth", 1), ("checkpoint_every", 2),
        ("checkpoint_dir", "ckpt"), ("telemetry_dir", "tel"))])
def test_trainer_refuses_under_a_mesh(mesh1, tmp_path, field, value):
    """Ported (16b): each service's option builds a trainer on the mesh
    that runs a round (the name is the refusal's it replaced)."""
    if isinstance(value, str):
        value = str(tmp_path / value)
    cfg = dataclasses.replace(FedConfig(clients_per_round=2, local_epochs=1),
                              **{field: value})
    tr = FedAvgTrainer(mclr(60, 10), _data(), cfg, device="cpu", mesh=mesh1)
    assert tr.mesh is mesh1
    assert len(tr.run(1).rounds) == 1
    tr.close()


def test_foreign_mesh_and_device_mismatch(mesh1):
    with pytest.raises(TypeError, match="FedMesh"):
        FedAvgTrainer(mclr(60, 10), _data(), FedConfig(), device="cpu",
                      mesh=object())
    with pytest.raises(ValueError, match="rank device"):
        FedAvgTrainer(mclr(60, 10), _data(), FedConfig(), device="cuda",
                      mesh=mesh1)


def test_checkpoints_and_fleet_raise_16b_under_a_mesh(mesh1, tmp_path,
                                                     monkeypatch):
    """Checkpoints, a thread-worker fleet (16b) and a process fleet (16b′)
    run on the mesh; the process fleet's round equals the thread fleet's
    bit for bit (the name is the refusals' it replaced)."""
    from repro_torch.data.generators import mnist_like
    from repro_torch.launch.coordinator import Coordinator, FleetConfig
    from repro_torch.launch.worker import WorkerSpec

    def fresh():
        return FedAvgTrainer(mclr(60, 10), _data(), FedConfig(
            clients_per_round=2, local_epochs=1), device="cpu", mesh=mesh1)
    tr = fresh()
    assert tr.mesh is mesh1 and tr.device == torch.device("cpu")
    tr.run(1)
    path = tr.save_checkpoint(str(tmp_path / "ckpt_000001.npz"))
    back = fresh()
    assert back.load_checkpoint(str(tmp_path)) == 1
    assert all(torch.equal(back.params[k], v) for k, v in tr.params.items())
    coord = Coordinator(back)
    coord.run(1)
    coord.close()
    assert path.endswith("ckpt_000001.npz")
    # synthetic_builder's fedavg trainer on the mesh, its replica in the
    # spawned worker (one torch thread there too)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    kw = dict(framework="fedavg", n_clients=8, dim=8, seed=0,
              clients_per_round=4, local_epochs=1, device="cpu")

    def on_mesh():
        data = mnist_like(seed=0, n_clients=8, classes_per_client=2,
                          total_train=400, dim=8)
        return FedAvgTrainer(mclr(8, 10), data, FedConfig(
            n_rounds=4, clients_per_round=4, local_epochs=1, batch_size=5,
            lr=0.05, n_groups=3, pretrain_scale=4, seed=0), device="cpu",
            mesh=mesh1)
    runs = []
    for fleet in (FleetConfig(), FleetConfig(
            transport="proc", join_timeout=300.0, worker_spec=WorkerSpec(
                "repro_torch.launch.worker:synthetic_builder", kw))):
        coord = Coordinator(on_mesh(), fleet)
        try:
            coord.run(1)
            runs.append({k: v.clone() for k, v in
                         coord.trainer.params.items()})
        finally:
            coord.close()
    assert all(torch.equal(runs[1][k], v) for k, v in runs[0].items())


@pytest.mark.parametrize("kw", [{"deadline": 0.5}, {"faults": "kill"}])
def test_population_deadline_and_faults_raise_16b(mesh1, kw):
    """Ported (16b): a population with a deadline or scripted faults
    attaches to the mesh and streams its cohorts (the name is the
    refusal's it replaced)."""
    from repro_torch.fed.population import (FaultConfig, FaultSpec,
                                            Population, PopulationConfig)
    if "faults" in kw:
        kw = {"faults": FaultConfig({0: FaultSpec(kill=1)})}
    pop = Population(tstore.ArrayClientStore(_data()),
                     PopulationConfig(prefetch=0, **kw))
    pop.attach(FedConfig(clients_per_round=2), mesh1)
    assert pop.mesh is mesh1
    c = pop.next_cohort()
    assert len(c.idx) == (1 if "faults" in kw else 2)
    pop.close()


def test_agree_barrier_and_byte_check_on_a_world_of_one(mesh1):
    assert mesh1.agree(7) == 7 and mesh1.agree(True) is True
    mesh1.barrier()
    mesh1.same_on_every_rank("x", {"a": np.arange(3), "t": torch.ones(2)})
    assert mesh1.host is mesh_lib.host_group()
