"""The fault-tolerant runtime on the card (``repro_torch.fed.engine``
checkpoints, ``repro_torch.fed.population`` deadline): kill-and-resume
bit-identical on the card, and a deadline-degraded cohort that is exactly
the staged prefix of its pinned slot, copied alone. Marked ``gpu``:
without a card every test skips (decided in the ``cuda`` fixture, never
at import). It imports nothing of JAX, so it runs on a GPU machine with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_faults_gpu.py

The CPU cases are in ``tests/test_torch_checkpoint_resume.py`` and
``tests/test_torch_faults.py``.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed import strategies
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.fed.population import (FaultConfig, FaultSpec, Population,
                                        PopulationConfig)
from repro_torch.fed.store import ArrayClientStore
from repro_torch.kernels import ops
from repro_torch.models import paper_models as tpm

pytestmark = pytest.mark.gpu
K = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); tests/test_torch_checkpoint_resume.py and "
                    "tests/test_torch_faults.py cover the CPU")
    return mnist_like(seed=0, n_clients=40, classes_per_client=2,
                      total_train=2000, dim=16)


def _cfg(**kw):
    base = dict(n_rounds=4, clients_per_round=K, local_epochs=2,
                batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4, seed=0)
    base.update(kw)
    return FedConfig(**base)


def _make(name, data, streamed, **cfg_kw):
    pop = (Population(ArrayClientStore(data), PopulationConfig(
        initial_active=30, arrival_rate=2.0, prefetch=2))
        if streamed else None)
    kw = dict(device="cuda", population=pop)
    model, cfg = tpm.mclr(16, 10), _cfg(**cfg_kw)
    data = None if streamed else data
    if name == "fedgroup":
        return FedGroupTrainer(model, data, cfg, **kw)
    return strategies.make_trainer(name, model, data, cfg, **kw)


@pytest.mark.parametrize("name,streamed", [("fedgroup", False),
                                           ("fesem", True)],
                         ids=["fedgroup-pinned", "fesem-streamed"])
def test_resume_is_bit_identical_on_the_card(name, streamed, cuda,
                                             tmp_path):
    ops.reset_launch_counts()
    ref = _make(name, cuda, streamed)
    ref.run(4)
    ref.close()
    ck = dict(checkpoint_every=2, checkpoint_dir=str(tmp_path))
    killed = _make(name, cuda, streamed, **ck)
    killed.run(3)
    killed.close()
    resumed = _make(name, cuda, streamed, **ck)
    assert resumed.load_checkpoint(str(tmp_path)) == 2
    assert all(v.device.type == "cuda" for v in resumed.group_params.values())
    resumed.run(2)
    resumed.close()
    if name == "fedgroup":
        # two cold starts (ref, killed); the resumed run does not redo it
        assert ops.launch_counts()["edc_cosine"] == 2
    assert resumed.history.rounds == ref.history.rounds
    for k in ref.group_params:
        assert torch.equal(resumed.group_params[k], ref.group_params[k])
    for k in ref.params:
        assert torch.equal(resumed.params[k], ref.params[k])
    np.testing.assert_array_equal(resumed.membership, ref.membership)
    if streamed:
        ids = np.arange(40)
        assert torch.equal(resumed.population.gather_local_flat(ids),
                           ref.population.gather_local_flat(ids))


def _h2d_bytes(trace) -> list:
    """Bytes of each host-to-device copy in a torch.profiler chrome
    trace."""
    events = json.loads(trace.read_text())["traceEvents"]
    return [int(e["args"]["bytes"]) for e in events
            if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]


@pytest.mark.parametrize("prefetch", [2, 0], ids=["prefetch", "sync"])
def test_degraded_cohort_is_the_slot_prefix(prefetch, cuda, tmp_path):
    store = ArrayClientStore(cuda)
    # rounds 0 and 1 straggle: slot 0 is not refilled while we look
    faults = FaultConfig(rounds={0: FaultSpec(straggle=2.0),
                                 1: FaultSpec(straggle=2.0)})
    pop = Population(store, PopulationConfig(
        faults=faults, prefetch=prefetch, deadline=0.3, stage_chunks=4))
    pop.attach(_cfg(), "cuda")
    torch.cuda.synchronize()
    # a warm-up step first: capture then starts at the traced step (a cold
    # start in a process that profiled before can miss the first copies)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(
                     str(tmp_path / "trace.json"))) as prof:
        prof.step()
        c = pop.next_cohort()
        torch.cuda.synchronize()
        prof.step()
    k = len(c.idx)
    assert 1 <= k < K
    assert pop.stats["deadline_rounds"] == 1
    assert pop.stats["deadline_dropped_clients"] == K - k
    slot = pop._rings["train"].slots[0]
    slot.event.synchronize()
    for got, host in zip((c.x, c.y, c.n), (slot.x, slot.y, slot.n)):
        assert got.device.type == "cuda" and got.shape[0] == k
        assert torch.equal(got.cpu(), host[:k])
    x, y, n = store.gather_train(c.idx)
    np.testing.assert_array_equal(c.x.cpu().numpy(), x)
    np.testing.assert_array_equal(c.n.cpu().numpy(), n)
    # the transfer itself: three copies (x, y, n) of the k staged rows, not
    # of the slot's K (round 1 is still straggling: nothing else is copied)
    row = sum(t[0].numel() * t.element_size() for t in (c.x, c.y, c.n))
    copies = _h2d_bytes(tmp_path / "trace.json")
    assert len(copies) == 3 and sum(copies) == k * row
    pop.close()


def test_faulted_streamed_run_stays_finite_with_quarantine(cuda):
    faults = FaultConfig(rounds={0: FaultSpec(straggle=2.0),
                                 1: FaultSpec(kill=5),
                                 2: FaultSpec(corrupt=3, corrupt_mode="nan")})
    pop = Population(ArrayClientStore(cuda), PopulationConfig(
        faults=faults, prefetch=2, deadline=0.3, stage_chunks=4))
    tr = FedAvgTrainer(tpm.mclr(16, 10), None, _cfg(quarantine=True),
                       device="cuda", population=pop)
    h = tr.run(4)
    tr.close()
    assert pop.stats["killed_clients"] == 5
    assert pop.stats["corrupted_clients"] == 3
    assert pop.stats["deadline_rounds"] >= 1
    assert h.rounds[2].quarantined >= 1
    assert all(bool(torch.isfinite(v).all()) for v in tr.params.values())
