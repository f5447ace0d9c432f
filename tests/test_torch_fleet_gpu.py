"""The in-process fleet on the card: a worker thread runs the trainer's
own executors on the coordinator's stream, so a fleet of one equals the
plain run with deviation 0, and a fleet-routed block is replays of one
captured graph (captured on the worker thread). Marked ``gpu``: without a
card every test skips (decided in the ``cuda`` fixture, never at import).
It imports nothing of JAX, so it runs on a GPU machine with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_fleet_gpu.py

The CPU cases are in ``tests/test_torch_fleet.py`` and its siblings.
"""
import threading

import pytest
import torch

from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed import strategies
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.launch.coordinator import Coordinator, FleetConfig
from repro_torch.models import paper_models as tpm

pytestmark = pytest.mark.gpu

CALM = dict(heartbeat_interval=0.05, heartbeat_miss=100)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); tests/test_torch_fleet.py covers the fleet on "
                    "the CPU")
    return mnist_like(seed=0, n_clients=40, classes_per_client=2,
                      total_train=2000, dim=16)


def _make(name, data, **kw):
    cfg = FedConfig(n_rounds=6, clients_per_round=8, local_epochs=2,
                    batch_size=5, lr=0.05, n_groups=3, pretrain_scale=14,
                    seed=0, **kw)
    model = tpm.mclr(16, 10)
    if name == "fedavg":
        return FedAvgTrainer(model, data, cfg, device="cuda")
    if name == "fedgroup":
        return FedGroupTrainer(model, data, cfg, device="cuda")
    return strategies.make_trainer(name, model, data, cfg, device="cuda")


def _state(tr) -> dict:
    out = {f"p/{k}": v for k, v in tr.params.items()}
    out.update({f"g/{k}": v for k, v in
                (getattr(tr, "group_params", None) or {}).items()})
    if getattr(tr, "local_flat", None) is not None:
        out["local_flat"] = tr.local_flat
    return out


def _deviation(a, b) -> float:
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    return max(float((sa[k].double() - sb[k].double()).abs().max())
               for k in sa)


CASES = {
    "fedgroup-round": ("fedgroup", {}),
    "fesem-round": ("fesem", {}),
    "fedgroup-async2": ("fedgroup", dict(async_depth=2, async_alpha=0.8,
                                         async_beta=0.5)),
    "fesem-async2": ("fesem", dict(async_depth=2)),
    "fedavg-async1": ("fedavg", dict(async_depth=1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fleet_of_one_deviation_zero(case, cuda):
    name, kw = CASES[case]
    ref = _make(name, cuda, **kw)
    ref.run()
    tr = _make(name, cuda, **kw)
    coord = Coordinator(tr, FleetConfig(n_workers=1, **CALM))
    try:
        coord.run()
        reg = tr.registry
        jobs, results = reg.get("fleet.jobs"), reg.get("fleet.results")
    finally:
        coord.close()
    assert tr.history.rounds == ref.history.rounds
    assert _deviation(tr, ref) == 0.0
    if hasattr(ref, "membership"):
        assert (tr.membership == ref.membership).all()
    assert jobs == results == 6
    if "async" in case:
        ex = tr._async_exec
        assert ex.captures == 1 and ex.replays == 6


def test_fleet_routed_block_is_replays(cuda):
    ref = _make("fedgroup", cuda, block_size=4)
    ref.run()
    tr = _make("fedgroup", cuda, block_size=4)
    coord = Coordinator(tr, FleetConfig(n_workers=1, **CALM))
    try:
        coord.run()
        jobs = tr.registry.get("fleet.jobs")
    finally:
        coord.close()
    assert tr.history.rounds == ref.history.rounds
    assert _deviation(tr, ref) == 0.0
    ex = tr._block_exec
    # captured once (on the worker thread), then replayed: round 0 is the
    # cold start, rounds 1-4 one block, round 5 alone
    assert ex.captures == 1 and ex.replays == ref._block_exec.replays == 4
    assert jobs == 3


def test_jobs_run_on_the_dispatching_stream(cuda):
    tr = _make("fedavg", cuda)
    coord = Coordinator(tr, FleetConfig(n_workers=1, **CALM))
    seen = []
    real = coord._table["round"]

    def spy(*args):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_stream().cuda_stream,
                     torch.cuda.current_device()))
        return real(*args)

    coord._table["round"] = spy
    side = torch.cuda.Stream()
    try:
        with torch.cuda.stream(side):
            coord.run(2)
        torch.cuda.synchronize()
    finally:
        coord.close()
    assert [s[0] for s in seen] == ["fleet-worker-w0"] * 2
    assert {s[1] for s in seen} == {side.cuda_stream}
    assert {s[2] for s in seen} == {torch.cuda.current_device()}
    assert all(torch.isfinite(v).all() for v in tr.params.values())
