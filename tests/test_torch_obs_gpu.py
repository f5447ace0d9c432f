"""Telemetry on the card: spans read the host clock only, so a traced run
is the untraced run bit for bit, and round blocks stay replays of one
captured graph. Marked ``gpu``: without a card every test skips (decided
in the ``cuda`` fixture, never at import). It imports nothing of JAX, so
it runs on a GPU machine with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_obs_gpu.py

The CPU cases are in ``tests/test_torch_obs.py`` and
``tests/test_torch_obs_run.py``.
"""
import os

import pytest
import torch

from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed.engine import FedConfig
from repro_torch.launch import inspect as tinspect
from repro_torch.models import paper_models as tpm

pytestmark = pytest.mark.gpu

# FedGroup with every client a founder (pretrain_scale * m >= N), so no
# newcomer breaks a block
PATHS = {"round": {}, "block": dict(block_size=4),
         "async2": dict(async_depth=2, async_alpha=0.8, async_beta=0.5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); tests/test_torch_obs_run.py covers telemetry "
                    "on the CPU")
    return mnist_like(seed=0, n_clients=40, classes_per_client=2,
                      total_train=2000, dim=16)


def _make(data, **kw):
    cfg = FedConfig(n_rounds=6, clients_per_round=8, local_epochs=2,
                    batch_size=5, lr=0.05, n_groups=3, pretrain_scale=14,
                    seed=0, **kw)
    return FedGroupTrainer(tpm.mclr(16, 10), data, cfg, device="cuda")


def _state(tr) -> dict:
    out = {f"p/{k}": v for k, v in tr.params.items()}
    out.update({f"g/{k}": v for k, v in tr.group_params.items()})
    return out


@pytest.mark.parametrize("path", list(PATHS))
def test_telemetry_on_equals_off(path, cuda, tmp_path):
    off = _make(cuda, **PATHS[path])
    on = _make(cuda, telemetry_dir=str(tmp_path), **PATHS[path])
    off.run()
    on.run()
    on.close()
    assert on.history.rounds == off.history.rounds
    a, b = _state(on), _state(off)
    for k in a:
        assert float((a[k] - b[k]).abs().max()) == 0.0, k
    assert (on.membership == off.membership).all()
    assert tinspect.check_dir(str(tmp_path)) == []
    kinds = {r.kind for r in on.obs.tracer.records()}
    # a pinned per-round run stages inside round(), unspanned, as the
    # reference's does
    assert "dispatch" in kinds and ("stage" in kinds) == (path != "round")
    if path == "block":
        ex_on, ex_off = on._block_exec, off._block_exec
        # a traced block is still replays of the one captured graph
        assert ex_on.captures == ex_off.captures == 1
        assert ex_on.replays == ex_off.replays > 0
        blocks = [r for r in on.obs.tracer.records()
                  if r.kind == "dispatch" and r.attrs["exec"] == "block"]
        rounds = [r for r in on.obs.tracer.records()
                  if r.kind == "dispatch" and r.attrs["exec"] == "round"]
        assert ex_on.replays + len(rounds) == 6 and len(blocks) >= 1
    if path == "async2":
        assert on._async_exec.replays == \
            on.history.async_stats["dispatches"]


def test_profile_window_attributes_device_time_to_spans(cuda, tmp_path):
    tr = _make(cuda, telemetry_dir=str(tmp_path))
    tr.run(1)
    tr.obs.tracer.annotate = True
    with tr.obs.profile() as p:
        tr.run(2)
        torch.cuda.synchronize()
    tr.close()
    by_name = {e.key: e for e in p.prof.key_averages()}
    assert {"dispatch", "eval"} <= set(by_name)
    assert by_name["dispatch"].count == 2
    assert by_name["dispatch"].device_time_total > 0
    assert os.path.exists(os.path.join(p.log_dir, "profile_trace.json"))
