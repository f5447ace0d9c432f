"""The streamed population's prefetcher on the card: pinned host slots, a
copy stream of the population's own and the event the compute stream
waits on (``repro_torch.fed.population``). Marked ``gpu``: without a card
every test skips (decided in the ``cuda`` fixture, never at import). It
imports nothing of JAX, so it runs on a GPU machine with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_population_gpu.py

The CPU cases (streamed == pinned bit for bit, the port against the JAX
package) are in ``tests/test_torch_population.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.data.generators import mnist_like
from repro_torch.fed import strategies
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.fed.population import Population, PopulationConfig
from repro_torch.fed.store import ArrayClientStore
from repro_torch.models import paper_models as tpm

pytestmark = pytest.mark.gpu
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); tests/test_torch_population.py covers the "
                    "streamed path on the CPU")
    return mnist_like(seed=0, n_clients=40, classes_per_client=2,
                      total_train=2000, dim=16)


def _cfg(**kw):
    base = dict(n_rounds=10, clients_per_round=8, local_epochs=2,
                batch_size=5, lr=0.05, n_groups=3, seed=0)
    base.update(kw)
    return FedConfig(**base)


def _assert_is_gather(store, cohort):
    x, y, n = store.gather_train(cohort.idx)
    assert cohort.x.device.type == "cuda"
    assert (cohort.x.dtype, cohort.y.dtype, cohort.n.dtype) == \
        (torch.float32, torch.int64, torch.int64)
    np.testing.assert_array_equal(cohort.x.cpu().numpy(), x)
    np.testing.assert_array_equal(cohort.y.cpu().numpy(), y)
    np.testing.assert_array_equal(cohort.n.cpu().numpy(), n)


def test_prefetched_cohort_equals_the_host_gather(cuda):
    store = ArrayClientStore(cuda)
    pop = Population(store, PopulationConfig(prefetch=2))
    pop.attach(_cfg(), "cuda")
    ring = pop._rings["train"]
    assert len(ring.slots) == 3
    assert all(s.x.is_pinned() and s.y.is_pinned() for s in ring.slots)
    assert pop._copy_stream != torch.cuda.current_stream()
    c = pop.next_cohort()
    assert c._event is not None
    _assert_is_gather(store, c)
    other = np.setdiff1d(np.arange(40), c.idx)[:12]  # > K: the batch ring
    x, y, n = pop.device_batch(other)
    np.testing.assert_array_equal(x.cpu().numpy(),
                                  store.gather_train(other)[0])
    for block, xe, ye, ne in pop.eval_batches():
        want = store.gather_test(block)
        np.testing.assert_array_equal(xe.cpu().numpy(), want[0])
        np.testing.assert_array_equal(ne.cpu().numpy(), want[2])
    pop.close()


@pytest.mark.parametrize("name", ["fedavg", "fesem"])
def test_reused_slots_keep_streamed_equal_to_pinned(name, cuda):
    """Ten rounds through three slots (``prefetch=2``): every cohort kept
    alive still holds its host gather, and the run equals the pinned run
    (membership equal, metrics within rtol 1e-5)."""
    model = tpm.mclr(16, 10)
    store = ArrayClientStore(cuda)
    pop = Population(store, PopulationConfig(prefetch=2))

    def make(data, **kw):
        if name == "fedavg":
            return FedAvgTrainer(model, data, _cfg(), device="cuda", **kw)
        return strategies.make_trainer(name, model, data, _cfg(),
                                       device="cuda", **kw)

    pinned, streamed = make(cuda), make(None, population=pop)
    cohorts = []
    next_cohort = pop.next_cohort

    def keep():
        cohorts.append(next_cohort())
        return cohorts[-1]

    pop.next_cohort = keep
    h_pin, h_st = pinned.run(10), streamed.run(10)
    streamed.close()
    assert len(cohorts) == 10
    for c in cohorts:
        _assert_is_gather(store, c)
    for a, b in zip(h_pin.rounds, h_st.rounds, strict=True):
        for f in ("weighted_acc", "mean_loss", "discrepancy"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=RTOL)
    if name != "fedavg":
        np.testing.assert_array_equal(streamed.membership, pinned.membership)


def test_copy_stream_tensors_are_safe_on_the_compute_stream(cuda):
    """A cohort read on the compute stream behind a long kernel keeps its
    memory until that read ran (``record_stream``): a tensor allocated
    and filled on the copy stream right after the cohort is dropped must
    not land in its block while the compute stream still reads it."""
    store = ArrayClientStore(cuda)
    pop = Population(store, PopulationConfig(prefetch=0))
    pop.attach(_cfg(), "cuda")
    c = pop.next_cohort()
    want = float(np.sum(store.gather_train(c.idx)[0], dtype=np.float64))
    torch.cuda._sleep(200_000_000)          # keep the compute stream busy
    got = c.x.double().sum()                # queued behind the sleep
    shape = c.x.shape
    del c
    pop._cohort = None
    with torch.cuda.stream(pop._copy_stream):
        junk = torch.full(shape, 7.0, device="cuda")
    torch.cuda.synchronize()
    assert junk.sum().item() == 7.0 * junk.numel()
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    pop.close()
