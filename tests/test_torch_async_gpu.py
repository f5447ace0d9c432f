"""The async runtime on the card: each pinned dispatch a replay of one
captured CUDA graph (``fed.graphs.GraphDispatchExecutor``), leases ready by
their events. Marked ``gpu``: without a card every test skips (decided in
the ``cuda`` fixture, never at import). It imports nothing of JAX, so it
runs on a GPU machine with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_async_gpu.py

The CPU cases are in ``tests/test_torch_async.py`` and
``tests/test_torch_async_resume.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed import strategies
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.models import paper_models as tpm

pytestmark = pytest.mark.gpu
ALL = ["fedavg", "fedgroup", "ifca", "fesem", "fedclust", "lcfl"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); tests/test_torch_async_resume.py covers the "
                    "async runtime on the CPU")
    return mnist_like(seed=0, n_clients=40, classes_per_client=2,
                      total_train=2000, dim=16)


def _make(name, data, device="cuda", **kw):
    cfg = FedConfig(n_rounds=6, clients_per_round=8, local_epochs=2,
                    batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4,
                    seed=0, **kw)
    model = tpm.mclr(16, 10)
    if name == "fedavg":
        return FedAvgTrainer(model, data, cfg, device=device)
    if name == "fedgroup":
        return FedGroupTrainer(model, data, cfg, device=device)
    return strategies.make_trainer(name, model, data, cfg, device=device)


def _params(tr) -> dict:
    out = {f"p/{k}": v for k, v in tr.params.items()}
    out.update({f"g/{k}": v for k, v in
                (getattr(tr, "group_params", None) or {}).items()})
    if getattr(tr, "local_flat", None) is not None:
        out["local_flat"] = tr.local_flat
    return out


@pytest.mark.parametrize("name", ALL)
def test_graph_dispatch_equals_the_blocked_run(name, cuda):
    blocked = _make(name, cuda, block_size=4)
    blocked.run(6)
    asy = _make(name, cuda, async_depth=1)
    asy.run(6)
    ex = asy._async_exec
    st = asy.history.async_stats
    assert ex.captures == 1 and ex.replays == st["dispatches"] == 6
    assert asy._round_exec is None               # no eager round ran
    assert asy.history.rounds == blocked.history.rounds
    a, b = _params(asy), _params(blocked)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    if hasattr(asy, "membership"):
        np.testing.assert_array_equal(asy.membership, blocked.membership)
    assert st["staleness_hist"] == {"0": 6}


@pytest.mark.parametrize("name", ["fedgroup", "fesem"])
def test_depth2_on_the_card_agrees_with_the_cpu(name, cuda):
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = _make(name, cuda, device=dev, async_depth=2, async_alpha=0.8,
                   async_beta=0.5)
        runs[dev] = (tr.run(6), tr.membership.copy(), tr.group_version)
    (hc, mc, vc), (hg, mg, vg) = runs["cpu"], runs["cuda"]
    np.testing.assert_array_equal(mc, mg)
    np.testing.assert_array_equal(vc, vg)
    assert hc.async_stats == hg.async_stats
    for rc, rg in zip(hc.rounds, hg.rounds, strict=True):
        assert math.isclose(rc.mean_loss, rg.mean_loss, rel_tol=1e-3)
        assert math.isclose(rc.discrepancy, rg.discrepancy, rel_tol=1e-3)
        assert abs(rc.weighted_acc - rg.weighted_acc) <= 0.01


def test_lease_readiness_is_the_dispatch_event(cuda):
    tr = _make("fedavg", cuda, async_depth=2)
    tr.run(1)                                    # capture
    _, staged = tr._stage_async(1)
    carry = tr._async_carry()
    d = tr._async_exec(carry, tr._train_stack, *staged)
    ev = tr._ready_event()

    class Lease:                                 # what _lease_ready reads
        metrics = ev
        deadline = float("inf")

    assert isinstance(ev, torch.cuda.Event)
    assert tr._wait_ready(Lease)
    assert tr._lease_ready(Lease) and ev.query()
    assert np.isfinite(d.metrics.numpy()).all()
    tr._async_exec.release(d)


def test_the_async_loop_never_calls_synchronize(cuda, monkeypatch):
    tr = _make("fedavg", cuda, async_depth=2)
    tr.run(2)                                    # capture outside the check

    def refuse(*a, **kw):
        raise AssertionError("torch.cuda.synchronize() in the async loop")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    h = tr.run(4)
    assert [r.round for r in h.rounds] == list(range(6))
    assert h.async_stats["max_in_flight"] == 2


@pytest.mark.parametrize("name", ["fedgroup", "fesem"])
def test_a_later_run_reuses_the_captured_inputs(name, cuda):
    """The second run binds its carry to the graph's input buffers: the
    split run equals one run of the same length, and nothing is captured
    again."""
    split = _make(name, cuda, async_depth=1)
    split.run(3)
    inputs = split._async_exec._g["inputs"]
    split.run(3)
    whole = _make(name, cuda, async_depth=1)
    whole.run(6)
    assert split._async_exec.captures == 1
    assert split.history.rounds == whole.history.rounds
    a, b = _params(split), _params(whole)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k, t in inputs["group_params"].items():
        assert split.group_params[k] is t
