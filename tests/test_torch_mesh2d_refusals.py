"""What runs on the 2-D ``(data, model)`` layout, and what stays refused.

Each runtime service builds under a model axis and runs on it:
checkpoints, telemetry, the async runtime, a population's deadline and
scripted faults, and a fleet of thread workers (a trainer or coordinator
built here on ``FedMesh`` values without a process group, none of which
makes a collective at construction; the run on a (1, 2) world of two gloo
ranks of ``tests/_torch_mesh_driver.py``), and a process fleet builds
under a 1-D mesh and a model axis. The zoo's flags that shard a train
state or batch are ported (16d-ii) and refused only without a mesh; a
mesh that is not a ``FedMesh`` is a TypeError.
"""
import dataclasses
import json
import signal

import pytest
import torch

import _torch_mesh_driver as drv
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.data import generators as tgen
from repro_torch.fed import store as tstore
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.fed.population import (FaultConfig, FaultSpec, Population,
                                        PopulationConfig)
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.launch.coordinator import Coordinator, FleetConfig
from repro_torch.launch.worker import WorkerSpec
from repro_torch.models.paper_models import mclr


def _mesh(data=1, model=2):
    return mesh_lib.FedMesh(group=None, rank=0, world=data * model,
                            shape={"data": data, "model": model},
                            backend="gloo", device=torch.device("cpu"))


def _trainer(mesh, population=None, **cfg):
    data = tgen.synthetic(seed=0, n_clients=4)
    return FedAvgTrainer(mclr(60, 10), None if population else data,
                         dataclasses.replace(FedConfig(clients_per_round=2),
                                             **cfg),
                         device="cpu", mesh=mesh, population=population)


# the services world's scenario that runs each option
RUNS = {"async_depth": "fedgroup_async_d1",
        "checkpoint_every": "fedgroup_ckpt_resume",
        "checkpoint_dir": "fedgroup_ckpt_resume",
        "telemetry_dir": "fedgroup_telemetry",
        "deadline": "fedgroup_streamed_faults_deadline",
        "faults": "fedgroup_streamed_faults_deadline",
        "fleet": "fedgroup_fleet1"}
STATS = ("corrupted_clients", "deadline_dropped_clients", "deadline_rounds",
         "killed_clients", "lease_expiries", "requeues", "writer_crashes",
         "writer_retries")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two ranks as a (1, 2) mesh running each option's scenario for four
    rounds (``tests/_torch_mesh_driver.py``'s ``services`` mode)."""
    d = tmp_path_factory.mktemp("options1x2")
    names = ",".join(sorted(set(RUNS.values())))
    return d, drv.spawn_world(2, d, extra=("services", names),
                              rc=-signal.SIGKILL, suffix=".services", model=2)


def _ran(world, option) -> list:
    """Each rank's run of ``option``'s scenario: four rounds, on both."""
    runs = [drv.run_of(z, RUNS[option]) for z in world[1]]
    for run in runs:
        assert run["hist"].shape[0] == drv.SERVICE_ROUNDS
        assert run["counters"][0] == drv.SERVICE_ROUNDS    # completed
    return runs


@pytest.mark.parametrize("field,value", [
    ("async_depth", 1), ("checkpoint_every", 2), ("checkpoint_dir", "ck"),
    ("telemetry_dir", "tel")])
def test_services_run_under_a_model_axis(tmp_path, world, field, value):
    if isinstance(value, str):
        value = str(tmp_path / value)
    tr = _trainer(_mesh(), **{field: value})           # builds
    assert getattr(tr.cfg, field) == value
    tr.close()
    runs = _ran(world, field)
    if field == "async_depth":
        st = json.loads(bytes(runs[0]["async"]).decode())
        assert st["dispatches"] == st["folds"] == drv.SERVICE_ROUNDS
    elif field == "telemetry_dir":
        tel = world[0] / "work" / RUNS[field] / "tel"
        assert (tel / "metrics.jsonl").read_text().count("\n") == 4
    else:
        # archives of whole leaves every two rounds
        ckpt = world[0] / "work" / RUNS[field] / "ckpt"
        assert sorted(p.name for p in ckpt.iterdir()) == [
            "ckpt_00000002.npz", "ckpt_00000004.npz"]
        assert runs[0]["counters"][-1] == 2


@pytest.mark.parametrize("kw", [{"deadline": 0.5},
                                {"faults": FaultConfig({0: FaultSpec(
                                    kill=1)})}])
def test_population_services_run_under_a_model_axis(world, kw):
    pop = Population(tstore.ArrayClientStore(tgen.synthetic(
        seed=0, n_clients=4)), PopulationConfig(prefetch=0, **kw))
    tr = _trainer(_mesh(2, 2), population=pop)         # builds
    assert tr.population is pop
    tr.close()
    option, = kw
    runs = _ran(world, option)
    stats = dict(zip(STATS, runs[0]["stats"].tolist()))
    if option == "deadline":
        assert stats["deadline_rounds"] == 1
    else:
        assert stats["killed_clients"] == 1
    assert (runs[1]["stats"] == runs[0]["stats"]).all()


def test_fleet_runs_under_a_model_axis(world):
    tr = _trainer(_mesh())
    assert tr.mesh.model_shards == 2
    # the stored consensus model: its block of w (60, 10) over 2; b's one
    # dim stands where the group axis would (group_param_pspec): whole
    assert tuple(tr.params["w"].shape) == (60, 5)
    assert tuple(tr.params["b"].shape) == (10,)
    Coordinator(tr).close()                            # builds
    for run in _ran(world, "fleet"):
        assert run["fleet"][:2].tolist() == [5, 4]      # jobs, results


def test_process_fleet_builds_on_both_meshes():
    """A process fleet builds under a 1-D mesh and a model axis (no worker
    spawned here); it runs in ``tests/test_torch_mesh_proc*.py``."""
    for mesh in (_mesh(2, 1), _mesh(1, 2)):
        coord = Coordinator(_trainer(mesh), FleetConfig(
            n_workers=0, transport="proc", worker_spec=WorkerSpec("m:f")))
        assert coord._joint and coord._real["round"].local is not None
        coord.close()


@pytest.mark.parametrize("flag", list(dryrun.SHARDING_FLAGS))
def test_zoo_sharding_flags_need_a_mesh(flag):
    """Every zoo flag that shards over a mesh is ported: the mesh flags
    (the multi-pod mesh, the slot-split cache; 16d-i) and those of a train
    state or batch (16d-ii) pass on the production mesh and are refused
    without one."""
    dryrun.check_flags("production", **{flag: True})
    with pytest.raises(ValueError, match="--mesh 1"):
        dryrun.check_flags("1", **{flag: True})


def test_a_foreign_mesh_is_a_type_error():
    with pytest.raises(TypeError, match="FedMesh"):
        _trainer(object())
