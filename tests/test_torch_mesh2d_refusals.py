"""What stays refused on the 2-D ``(data, model)`` layout, and what 16c
lifted.

Refused under a model axis, naming ROADMAP.md item 16c′ (the runtime
services): checkpoints, telemetry, the async runtime, a population's
deadline and scripted faults, and the fleet. Still refused elsewhere:
process workers under any mesh (16b′) and the zoo's sharding flags
(16d). A trainer under a model axis without those builds; a mesh that is
not a ``FedMesh`` is a TypeError. The meshes here are ``FedMesh`` values
without a process group: every refusal is raised before a collective.
"""
import dataclasses

import pytest
import torch

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


@pytest.mark.parametrize("field,value", [
    ("async_depth", 1), ("checkpoint_every", 2), ("checkpoint_dir", "ck"),
    ("telemetry_dir", "tel")])
def test_services_under_a_model_axis_raise_16c_prime(tmp_path, field, value):
    if isinstance(value, str):
        value = str(tmp_path / value)
    with pytest.raises(NotImplementedError, match="item 16c′"):
        _trainer(_mesh(), **{field: value})


@pytest.mark.parametrize("kw", [{"deadline": 0.5},
                                {"faults": FaultConfig({0: FaultSpec(
                                    kill=1)})}])
def test_population_services_under_a_model_axis_raise_16c_prime(kw):
    pop = Population(tstore.ArrayClientStore(tgen.synthetic(
        seed=0, n_clients=4)), PopulationConfig(prefetch=0, **kw))
    with pytest.raises(NotImplementedError, match="item 16c′"):
        _trainer(_mesh(2, 2), population=pop)


def test_fleet_under_a_model_axis_raises_16c_prime():
    tr = _trainer(_mesh())
    assert tr.mesh.model_shards == 2
    # the stored consensus model: its block of w (60, 10) over 2; b's one
    # dim stands where the group axis would (group_param_pspec): whole
    assert tuple(tr.params["w"].shape) == (60, 5)
    assert tuple(tr.params["b"].shape) == (10,)
    with pytest.raises(NotImplementedError, match="item 16c′"):
        Coordinator(tr)


def test_process_workers_still_raise_16b_prime():
    for mesh in (_mesh(2, 1), _mesh(1, 2)):
        with pytest.raises(NotImplementedError, match="item 16b′"):
            Coordinator(_trainer(mesh), FleetConfig(
                transport="proc", worker_spec=WorkerSpec("m:f")))


@pytest.mark.parametrize("flag", list(dryrun.SHARDING_FLAGS))
def test_zoo_sharding_flags_still_raise_16d(flag):
    with pytest.raises(NotImplementedError, match="item 16d"):
        dryrun.refuse_sharding(**{flag: True})


def test_a_foreign_mesh_is_a_type_error():
    with pytest.raises(TypeError, match="FedMesh"):
        _trainer(object())
