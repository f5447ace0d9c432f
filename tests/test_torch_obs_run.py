"""Telemetry through the port's trainers, on the CPU at
``tests/test_obs.py``'s fixtures (``mnist_like(n_clients=40, dim=16)``,
``mclr(16, 10)``, K = 8, E = 2; streamed with ``initial_active=30,
arrival_rate=2.0, prefetch=2``).

  * The reference's acceptance run, as the port: FedGroup streamed at
    D = 1 with checkpoints writes ``metrics.jsonl``, ``trace.json`` and
    ``run_summary.json``; the trace holds the six span kinds; the round
    records carry the group series; the port's inspector renders and
    lints the dir, and flags a corrupted copy.
  * Against the JAX package (``repro.obs``, ``repro.launch.inspect``):
    the same run of the JAX trainer, the port replaying its draws from its
    initial params, gives records with equal keys, ``t``, ``group_sizes``,
    ``cold``, ``migrations``, ``group_version``, staleness and weights, and
    loss / discrepancy within rtol 1e-3, accuracy within 0.01; both
    packages' ``check_dir`` return ``[]`` on the port's dir and the same
    list on a corrupted copy; both ``render``s give the same text.
  * Port against port: ``metrics.jsonl`` is byte-identical across
    kill-and-resume; telemetry on equals telemetry off (histories and
    model state bit for bit).
"""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_parity import ReplayDraws
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core.fedgroup import FedGroupTrainer as JFedGroup
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed import population as jpop
from repro.fed import store as jstore
from repro.fed.engine import FedConfig as JFedConfig
from repro.launch import inspect as jinspect
from repro.models import paper_models as jpm
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed import strategies
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.fed.population import Population, PopulationConfig
from repro_torch.fed.store import ArrayClientStore
from repro_torch.launch import inspect as tinspect
from repro_torch.models.paper_models import mclr

STREAM_KW = dict(initial_active=30, arrival_rate=2.0, prefetch=2)
DATA_KW = dict(seed=0, n_clients=40, classes_per_client=2, total_train=2000,
               dim=16)
SPAN_FLOOR = {"stage", "h2d", "dispatch", "fold", "eval", "checkpoint"}
GROUP_KEYS = {"acc", "loss", "disc", "quarantined", "group_sizes",
              "group_version", "staleness", "weights", "cold", "eta_g",
              "migrations"}


@pytest.fixture(scope="module")
def small_data():
    return mnist_like(**DATA_KW)


def _cfg(**kw):
    base = dict(n_rounds=4, clients_per_round=8, local_epochs=2,
                batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4, seed=0)
    base.update(kw)
    return FedConfig(**base)


def _fresh(name, data, streamed, **cfg_kw):
    cfg = _cfg(**cfg_kw)
    kw = dict(device="cpu")
    if streamed:
        kw["population"] = Population(ArrayClientStore(data),
                                      PopulationConfig(**STREAM_KW))
        data = None
    if name == "fedgroup":
        return FedGroupTrainer(mclr(16, 10), data, cfg, **kw)
    if name == "fedavg":
        return FedAvgTrainer(mclr(16, 10), data, cfg, **kw)
    return strategies.make_trainer(name, mclr(16, 10), data, cfg, **kw)


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _corrupt_copy(run_dir, dst):
    shutil.copytree(run_dir, dst)
    with open(os.path.join(dst, "metrics.jsonl"), "a") as f:
        # a duplicate round index, an unparsable line, a record short of
        # keys
        f.write('{"kind":"round","t":0,"acc":1.0,"loss":0.1,'
                '"disc":0.0,"quarantined":0}\n')
        f.write("not json\n")
        f.write('{"kind":"round","t":99}\n')
    with open(os.path.join(dst, "run_summary.json"), "w") as f:
        json.dump({"format": 1}, f)
    return dst


# ---------------------------------------------------------------------------
# the acceptance run, as the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def run_dir(small_data, tmp_path_factory):
    tdir = str(tmp_path_factory.mktemp("fedgroup_tel"))
    tr = _fresh("fedgroup", small_data, True, async_depth=1,
                checkpoint_every=2,
                checkpoint_dir=str(tmp_path_factory.mktemp("ck")),
                telemetry_dir=tdir)
    tr.run(4)
    tr.close()
    return tdir


def test_streamed_fedgroup_emits_all_artifacts(run_dir):
    files = set(os.listdir(run_dir))
    assert {"metrics.jsonl", "trace.json", "run_summary.json"} <= files
    with open(os.path.join(run_dir, "trace.json")) as f:
        doc = json.load(f)
    assert jinspect.validate_chrome_trace(doc) == []
    kinds = {ev["name"] for ev in doc["traceEvents"]}
    assert SPAN_FLOOR <= kinds
    # the producer thread's h2d nests in its stage span
    with open(os.path.join(run_dir, "run_summary.json")) as f:
        summary = json.load(f)
    assert summary["counters"]["rounds.completed"] == 4
    assert summary["counters"]["rounds.checkpoints"] == 2
    assert summary["framework"] == "fedgroup" and summary["rounds"] == 4


def test_round_records_carry_group_series(run_dir):
    rounds = [r for r in _records(run_dir) if r["kind"] == "round"]
    assert [r["t"] for r in rounds] == [0, 1, 2, 3]
    for r in rounds:
        assert GROUP_KEYS <= set(r)
        assert r["staleness"] == 0 and r["weights"] == [1.0, 1.0, 1.0]
        assert sum(r["group_sizes"]) > 0


def test_inspector_renders_and_checks_clean(run_dir):
    out = tinspect.render(run_dir, tinspect.load_dir(run_dir), spark=True)
    assert "per-stage time breakdown" in out
    assert "dispatch" in out and "rounds streamed: 4" in out
    assert tinspect.check_dir(run_dir) == []
    assert tinspect.main([run_dir, "--check"]) == 0
    assert tinspect.main([run_dir, "--top", "2"]) == 0


def test_inspectors_agree_with_reference(run_dir, tmp_path):
    assert jinspect.check_dir(run_dir) == tinspect.check_dir(run_dir) == []
    bad = _corrupt_copy(run_dir, str(tmp_path / "bad"))
    errors = tinspect.check_dir(bad)
    assert errors == jinspect.check_dir(bad)
    assert any("increasing" in e for e in errors)
    assert any("invalid JSON" in e for e in errors)
    assert any("missing key" in e for e in errors)
    assert tinspect.main([bad, "--check"]) == 1
    assert tinspect.check_dir(str(tmp_path / "nowhere")) == \
        jinspect.check_dir(str(tmp_path / "nowhere"))
    assert tinspect.render(run_dir, tinspect.load_dir(run_dir), top_k=3,
                           spark=True) == \
        jinspect.render(run_dir, jinspect.load_dir(run_dir), top_k=3,
                        spark=True)
    # a live dir (no summary yet): the breakdown comes from trace.json
    live = str(tmp_path / "live")
    shutil.copytree(run_dir, live)
    os.remove(os.path.join(live, "run_summary.json"))
    text = tinspect.render(live, tinspect.load_dir(live))
    assert "[live" in text and "per-stage time breakdown" in text
    assert text == jinspect.render(live, jinspect.load_dir(live))
    assert tinspect.sparkline([]) == jinspect.sparkline([]) == "(no data)"
    assert tinspect.sparkline(list(range(100)), width=10) == \
        jinspect.sparkline(list(range(100)), width=10)


# ---------------------------------------------------------------------------
# against the JAX package, draws replayed
# ---------------------------------------------------------------------------
def test_round_records_match_reference(tmp_path):
    jdata, tdata = j_mnist_like(**DATA_KW), mnist_like(**DATA_KW)
    jcfg = JFedConfig(n_rounds=4, clients_per_round=8, local_epochs=2,
                      batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4,
                      seed=0, async_depth=1, checkpoint_every=2,
                      checkpoint_dir=str(tmp_path / "jck"),
                      telemetry_dir=str(tmp_path / "jtel"))
    tcfg = dataclasses.replace(
        FedConfig(**dataclasses.asdict(jcfg)),
        checkpoint_dir=str(tmp_path / "tck"),
        telemetry_dir=str(tmp_path / "ttel"))
    jp = jpop.Population(jstore.ArrayClientStore(jdata),
                         jpop.PopulationConfig(**STREAM_KW))
    jtr = JFedGroup(jpm.mclr(16, 10), None, jcfg, population=jp)
    ttr = FedGroupTrainer(
        mclr(16, 10), None, tcfg, device="cpu",
        population=Population(ArrayClientStore(tdata),
                              PopulationConfig(**STREAM_KW)),
        init_params=params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jtr.params)),
        draws=ReplayDraws(jcfg.seed))
    try:
        jtr.run(4)
        ttr.run(4)
    finally:
        jtr.close()
        ttr.close()
    jrecs, trecs = _records(jcfg.telemetry_dir), _records(tcfg.telemetry_dir)
    assert len(trecs) == len(jrecs) == 4
    exact = ("kind", "t", "quarantined", "group_sizes", "group_version",
             "staleness", "weights", "cold", "eta_g", "migrations")
    for tr_, jr in zip(trecs, jrecs):
        assert set(tr_) == set(jr)
        for k in exact:
            assert tr_[k] == jr[k], (tr_["t"], k)
        np.testing.assert_allclose(tr_["loss"], jr["loss"], rtol=1e-3)
        np.testing.assert_allclose(tr_["disc"], jr["disc"], rtol=1e-3)
        assert abs(tr_["acc"] - jr["acc"]) <= 0.01
    for d in (jcfg.telemetry_dir, tcfg.telemetry_dir):
        assert tinspect.check_dir(d) == jinspect.check_dir(d) == []
    with open(os.path.join(tcfg.telemetry_dir, "run_summary.json")) as f:
        tsum = json.load(f)
    with open(os.path.join(jcfg.telemetry_dir, "run_summary.json")) as f:
        jsum = json.load(f)
    assert set(tsum) == set(jsum)
    assert tsum["counters"] == jsum["counters"]
    assert set(tsum["span_kinds"]) == set(jsum["span_kinds"])


# ---------------------------------------------------------------------------
# port against port
# ---------------------------------------------------------------------------
RESUME_CASES = {
    "fesem-streamed-async2": ("fesem", True, dict(async_depth=2,
                                                  checkpoint_every=3)),
    "fedgroup-pinned-blocks": ("fedgroup", False, dict(block_size=2,
                                                       checkpoint_every=3,
                                                       pretrain_scale=10)),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_jsonl_byte_identical_across_kill_and_resume(case, small_data,
                                                     tmp_path):
    name, streamed, kw = RESUME_CASES[case]
    ref = _fresh(name, small_data, streamed,
                 checkpoint_dir=str(tmp_path / "ref_ck"),
                 telemetry_dir=str(tmp_path / "ref_tel"), **kw)
    h_ref = ref.run(8)
    ref.close()

    kill_ck, kill_tel = str(tmp_path / "kill_ck"), str(tmp_path / "kill_tel")
    killed = _fresh(name, small_data, streamed, checkpoint_dir=kill_ck,
                    telemetry_dir=kill_tel, **kw)
    killed.run(5)                    # "killed" after 5 rounds
    killed.close()
    assert len(_records(kill_tel)) == 5

    resumed = _fresh(name, small_data, streamed, checkpoint_dir=kill_ck,
                     telemetry_dir=kill_tel, **kw)
    t = resumed.load_checkpoint(kill_ck)
    assert 3 <= t < 5
    assert len(_records(kill_tel)) == t      # truncated at the resume
    h_res = resumed.run(8 - t)
    resumed.close()

    assert h_res.rounds == h_ref.rounds
    with open(os.path.join(str(tmp_path / "ref_tel"),
                           "metrics.jsonl"), "rb") as f:
        ref_bytes = f.read()
    with open(os.path.join(kill_tel, "metrics.jsonl"), "rb") as f:
        res_bytes = f.read()
    assert ref_bytes == res_bytes
    assert resumed.registry.get("rounds.completed") == 8
    assert tinspect.check_dir(kill_tel) == []


ON_OFF_CASES = {
    "fedgroup-pinned": ("fedgroup", False, {}),
    "fedavg-blocks": ("fedavg", False, dict(block_size=2)),
    "fedgroup-pinned-async2": ("fedgroup", False, dict(async_depth=2,
                                                       async_alpha=0.8,
                                                       async_beta=0.5)),
    "fesem-streamed": ("fesem", True, {}),
}


def _state(tr):
    out = {f"params/{k}": v for k, v in tr.params.items()}
    for k, v in getattr(tr, "group_params", {}).items():
        out[f"group_params/{k}"] = v
    return out


@pytest.mark.parametrize("case", list(ON_OFF_CASES))
def test_telemetry_on_equals_off(case, small_data, tmp_path):
    name, streamed, kw = ON_OFF_CASES[case]
    off = _fresh(name, small_data, streamed, **kw)
    on = _fresh(name, small_data, streamed, telemetry_dir=str(tmp_path),
                **kw)
    h_off, h_on = off.run(), on.run()
    off.close()
    on.close()
    assert h_on.rounds == h_off.rounds
    assert dict(h_on.async_stats) == dict(h_off.async_stats)
    a, b = _state(on), _state(off)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    if hasattr(off, "membership"):
        np.testing.assert_array_equal(on.membership, off.membership)
    assert not off.obs.tracer.records()
    assert "dispatch" in {r.kind for r in on.obs.tracer.records()}
    assert len(_records(str(tmp_path))) == len(h_on.rounds)
