"""Round blocks on the card: the captured CUDA graphs (``fed.graphs``)
against the eager per-round path, for all six pinned trainers. Marked
``gpu``: without a card every test skips (decided in the ``cuda`` fixture,
never at import). It imports nothing of JAX, so it runs on a GPU machine
with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_round_block_gpu.py

The graph and the eager round need not be bit-identical (cuBLAS may pick
other algorithms under capture): loss, discrepancy and accuracy within
rtol 1e-5, membership equal. The CPU cases are in
``tests/test_torch_round_block.py``.
"""
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
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); tests/test_torch_round_block.py covers the "
                    "plain block on the CPU")
    return mnist_like(seed=0, n_clients=40, classes_per_client=2,
                      total_train=2000, dim=16)


def _make(name, data, block_size, **kw):
    cfg = FedConfig(n_rounds=6, clients_per_round=8, local_epochs=2,
                    batch_size=5, lr=0.05, n_groups=3, pretrain_scale=8,
                    seed=0, block_size=block_size, **kw)
    model = tpm.mclr(16, 10)
    if name == "fedavg":
        return FedAvgTrainer(model, data, cfg, device="cuda")
    if name == "fedgroup":
        return FedGroupTrainer(model, data, cfg, device="cuda")
    return strategies.make_trainer(name, model, data, cfg, device="cuda")


def _run_both(name, data, **kw):
    a = _make(name, data, 1, **kw)
    a.run(6)
    b = _make(name, data, 4, **kw)
    ex = b._block_executor()
    blocks = []
    b._block_exec = lambda *args: (blocks.append(len(args[3])),
                                   ex(*args))[1]
    b.run(6)
    assert ex.captures == 1 and ex.replays == sum(blocks) >= 1
    return a, b


def _assert_close(a, b):
    if hasattr(a, "membership"):
        np.testing.assert_array_equal(a.membership, b.membership)
    for ra, rb in zip(a.history.rounds, b.history.rounds, strict=True):
        for f in ("weighted_acc", "mean_loss", "discrepancy"):
            np.testing.assert_allclose(getattr(rb, f), getattr(ra, f),
                                       rtol=RTOL)
    assert a.comm_params == b.comm_params


@pytest.mark.parametrize("name", ALL)
def test_graph_block_matches_eager_per_round(name, cuda):
    a, b = _run_both(name, cuda)
    _assert_close(a, b)
    if name in ("fesem", "fedclust"):
        np.testing.assert_allclose(a.local_flat.cpu().numpy(),
                                   b.local_flat.cpu().numpy(), rtol=RTOL,
                                   atol=1e-7)


def test_graph_block_with_padding_cadence_and_quarantine(cuda):
    """Zero-weight padded lanes, an eval every third round and the
    quarantine's median (``torch.nanquantile``) inside the captured
    round."""
    a, b = _run_both("fedgroup", cuda, dropout_rate=0.3, eval_every=3,
                     quarantine=True)
    _assert_close(a, b)


def test_capture_failure_raises(cuda):
    """A host sync inside the round fails the capture; the executor raises
    instead of running the block eagerly. (Last in the file: a failed
    capture may leave the context unusable.)"""
    tr = _make("fedavg", cuda, 4)
    ex = tr._block_executor()
    step = ex.block_fn.step

    def syncing_step(carry, *args):
        new, metrics = step(carry, *args)
        float(metrics[0])                      # a host sync
        return new, metrics

    ex.block_fn.step = syncing_step
    with pytest.raises(RuntimeError, match="capture"):
        tr.run(4)
    assert ex.replays == 0


def _capture_doubling(x):
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(g):
        y = x * 2
    return g, y


def test_capture_under_gc_paused_survives_forced_collections(cuda):
    """A graph left in a reference cycle is destroyed by the next cyclic
    collection, which CUDA does not permit while a stream captures. Both
    executors capture under ``fed.graphs.gc_paused`` (collect first, then
    no collection until the capture ends): with a collection forced at
    every allocation, a capture after such a cycle is dropped still
    replays right."""
    import gc

    from repro_torch.fed.graphs import gc_paused

    x = torch.ones(1024, device="cuda")
    old, _ = _capture_doubling(x)
    cycle = {"graph": old}
    cycle["self"] = cycle
    del old, cycle
    thresholds = gc.get_threshold()
    gc.set_threshold(1)              # a collection at every allocation
    try:
        with gc_paused():
            g, y = _capture_doubling(x)
    finally:
        gc.set_threshold(*thresholds)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, x * 2)
