"""The PyTorch port's package rules: import hygiene, the device rule, the
copied config and data, and the weight carry."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.data import generators as jgen
from repro.fed.engine import FedConfig as JFedConfig
from repro_torch import resolve_device
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data import generators as tgen
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.models.paper_models import mclr

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

SLICE_MODULES = [
    "repro_torch", "repro_torch.convert", "repro_torch.draws",
    "repro_torch.data.federated", "repro_torch.data.generators",
    "repro_torch.models.modules", "repro_torch.models.paper_models",
    "repro_torch.fed.client", "repro_torch.fed.server",
    "repro_torch.fed.rounds", "repro_torch.fed.engine",
    "repro_torch.kernels.ref", "repro_torch.kernels.build",
    "repro_torch.kernels.edc_cosine", "repro_torch.kernels.madc",
    "repro_torch.kernels.ops", "repro_torch.core.svd",
    "repro_torch.core.measures", "repro_torch.core.cluster",
    "repro_torch.core.fedgroup", "repro_torch.launch.train",
    "repro_torch.kernels.swa_attention", "repro_torch.kernels.ssd_chunk",
    "repro_torch.models.attention", "repro_torch.models.ssm",
    "repro_torch.models.zoo", "repro_torch.configs.registry",
    "repro_torch.configs.zamba2_1p2b", "repro_torch.launch.serve",
    "repro_torch.fed.store", "repro_torch.fed.ifca", "repro_torch.fed.fesem",
    "repro_torch.fed.strategies", "repro_torch.core.gating",
    "repro_torch.fed.population", "repro_torch.checkpoint",
    "repro_torch.checkpoint.io", "repro_torch.optim",
    "repro_torch.optim.solvers", "repro_torch.fed.leases",
    "repro_torch.obs", "repro_torch.obs.metrics", "repro_torch.fed.graphs",
    "repro_torch.obs.trace", "repro_torch.obs.telemetry",
    "repro_torch.launch.inspect", "repro_torch.launch.transport",
    "repro_torch.launch.worker", "repro_torch.launch.coordinator",
    "repro_torch.models.moe", "repro_torch.configs.shapes",
    "repro_torch.configs.gemma_2b", "repro_torch.configs.glm4_9b",
    "repro_torch.configs.granite_20b", "repro_torch.configs.nemotron_4_15b",
    "repro_torch.configs.internvl2_1b", "repro_torch.configs.hubert_xlarge",
    "repro_torch.configs.granite_moe_1b", "repro_torch.models.xlstm",
    "repro_torch.configs.deepseek_v3_671b", "repro_torch.configs.xlstm_350m",
    "repro_torch.launch.dryrun", "repro_torch.fed.parallel",
    "repro_torch.launch.fed_dryrun", "repro_torch.launch.mesh",
    "repro_torch.sharding", "repro_torch.sharding.specs",
]


def test_import_leaves_no_jax_and_no_reference_package():
    # a subprocess: this test process already imported jax (conftest.py)
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'repro.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    data = tgen.synthetic(seed=0, n_clients=4)
    with pytest.raises(RuntimeError, match="cuda"):
        FedAvgTrainer(mclr(60, 10), data, FedConfig(), device="cuda")
    assert resolve_device("cpu").type == "cpu"
    tr = FedAvgTrainer(mclr(60, 10), data, FedConfig(), device="cpu")
    assert tr.params["w"].device.type == "cpu"


def test_serve_on_cuda_without_a_card_raises(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--smoke", "--device", "cuda"])


@pytest.mark.parametrize("field,value", [
    ("telemetry_dir", "/nonexistent"),
])
def test_unported_options_raise(field, value, tmp_path):
    # telemetry is ported now: the option opens its stream under the given
    # name (made relative to a scratch dir); a mesh that is not a FedMesh
    # is refused (a model axis is ported: what stays refused under one is
    # tests/test_torch_mesh2d_refusals.py's)
    data = tgen.synthetic(seed=0, n_clients=4)
    value = str(tmp_path) + value
    cfg = dataclasses.replace(FedConfig(), **{field: value})
    tr = FedAvgTrainer(mclr(60, 10), data, cfg, device="cpu")
    assert tr.obs.recording and os.path.isdir(value)
    with pytest.raises(TypeError, match="FedMesh"):
        FedAvgTrainer(mclr(60, 10), data, cfg, device="cpu", mesh=object())


def test_a_mesh_raises():
    """A mesh that is not a ``launch.mesh.FedMesh`` is refused (the 2-D
    layout is a FedMesh with a model axis, ported)."""
    data = tgen.synthetic(seed=0, n_clients=4)
    with pytest.raises(TypeError, match="FedMesh"):
        FedAvgTrainer(mclr(60, 10), data, FedConfig(), device="cpu",
                      mesh=object())


def test_async_depth_runs_on_the_cpu():
    data = tgen.synthetic(seed=0, n_clients=4)
    cfg = FedConfig(n_rounds=2, clients_per_round=2, local_epochs=1,
                    async_depth=1)
    tr = FedAvgTrainer(mclr(60, 10), data, cfg, device="cpu")
    h = tr.run()
    assert len(h.rounds) == 2
    assert h.async_stats["folds"] == h.async_stats["dispatches"] == 2


@pytest.mark.parametrize("module", [
    "repro_torch.fed.leases", "repro_torch.obs", "repro_torch.obs.trace",
    "repro_torch.obs.telemetry", "repro_torch.launch.inspect",
    "repro_torch.launch.transport", "repro_torch.launch.worker",
    "repro_torch.launch.coordinator", "repro_torch.models.moe",
    "repro_torch.configs.shapes"])
def test_reference_copies_import_no_jax_and_no_reference(module):
    # the port's own copies of reference modules that never import JAX
    code = (f"import importlib, sys; importlib.import_module({module!r})\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'repro.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("field,value", [
    ("checkpoint_dir", "ckpts"), ("checkpoint_every", 1),
    ("checkpoint_keep", 2),
])
def test_checkpoint_options_are_ported(field, value, tmp_path):
    data = tgen.synthetic(seed=0, n_clients=4)
    if field == "checkpoint_dir":
        value = str(tmp_path / value)
    cfg = dataclasses.replace(FedConfig(), **{field: value})
    tr = FedAvgTrainer(mclr(60, 10), data, cfg, device="cpu")
    assert getattr(tr.cfg, field) == value


def test_fedconfig_fields_and_defaults_equal_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(FedConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JFedConfig)]
    assert ours == ref


@pytest.mark.parametrize("name,kw", [
    ("mnist_like", dict(seed=3, n_clients=12, total_train=600, dim=16)),
    ("femnist_like", dict(seed=1, n_clients=8, total_train=400, dim=16,
                          n_classes=26)),
    ("synthetic", dict(seed=2, n_clients=6)),
    ("sent140_like", dict(seed=4, n_clients=5, total_train=120, vocab=200)),
])
def test_generators_give_reference_bytes(name, kw):
    a = getattr(jgen, name)(**kw)
    b = getattr(tgen, name)(**kw)
    assert a.name == b.name and a.n_classes == b.n_classes
    for f in ("x_train", "y_train", "n_train", "x_test", "y_test", "n_test"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y), f


def test_weight_carry_roundtrip():
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "inner": {"b": np.ones(3, np.float32)}}
    params = params_from_numpy(tree)
    assert isinstance(params["inner"]["b"], torch.Tensor)
    back = params_to_numpy(params)
    assert np.array_equal(back["w"], tree["w"])
    assert np.array_equal(back["inner"]["b"], tree["inner"]["b"])
