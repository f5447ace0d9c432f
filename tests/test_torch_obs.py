"""The port's telemetry layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU at ``tests/test_obs.py``'s fixtures.

  * The span tracer: disabled tracing is the no-op singleton, nesting
    depth, the bounded ring buffer, per-thread stacks, ``wrap`` checking
    ``enabled`` per call and forwarding an executor object's attributes;
    the same span script gives the same kinds, depths, attributes,
    ``stage_totals`` counts and ``round_totals`` keys in both packages.
  * ``JsonlSink``: ``encode`` of the same records gives the same bytes in
    both packages; rotation and ``truncate_from`` leave the same files
    with the same bytes.
  * Chrome traces: the reference's ``validate_chrome_trace`` accepts the
    port's ``trace.json``, and both validators return the same list for
    broken documents.
  * ``from_config``: a fresh registry, the process default's tracer.
  * The registry's snapshot rides the checkpoint and comes back on load.
  * ``Telemetry.profile``: spans appear as ``record_function`` ranges in
    the ``torch.profiler`` capture.
  * A round whose every alive update was quarantined counts
    ``rounds.empty_folds``, as the reference's round hook does.
"""
import copy
import json
import os
import threading

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.obs import telemetry as jtel
from repro.obs import trace as jtrace
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.data.generators import mnist_like
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.models.paper_models import mclr
from repro_torch.obs import telemetry as ttel
from repro_torch.obs import trace as ttrace


@pytest.fixture(scope="module")
def small_data():
    return mnist_like(seed=0, n_clients=40, classes_per_client=2,
                      total_train=2000, dim=16)


def _cfg(**kw):
    base = dict(n_rounds=4, clients_per_round=8, local_epochs=2,
                batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4, seed=0)
    base.update(kw)
    return FedConfig(**base)


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------
def test_disabled_tracer_is_the_null_span():
    tr = ttrace.Tracer(enabled=False)
    assert tr.span("stage", t=0) is ttrace.NULL_SPAN
    with tr.span("dispatch"):
        pass
    assert tr.records() == [] and tr.open_depth() == 0
    assert ttrace.SPAN_KINDS == jtrace.SPAN_KINDS


def _span_script(mod):
    """The same spans through either package's tracer: nesting, a second
    thread, round attributes and a ring of capacity 6."""
    tr = mod.Tracer(enabled=True, capacity=6)
    with tr.span("stage", t=0):
        with tr.span("h2d", rows=8):
            pass

    def worker():
        with tr.span("state-write", label="x"):
            pass

    with tr.span("fold", t=0):
        th = threading.Thread(target=worker)
        th.start()
        th.join()
    for t in range(1, 4):
        with tr.span("eval", t=t):
            pass
    return tr


def test_tracer_equals_reference():
    ours, ref = _span_script(ttrace), _span_script(jtrace)
    key = [(r.kind, r.depth, r.attrs) for r in ours.records()]
    assert key == [(r.kind, r.depth, r.attrs) for r in ref.records()]
    # the ring kept the newest 6 of 7 spans, in completion order
    assert [k[0] for k in key] == ["stage", "state-write", "fold", "eval",
                                   "eval", "eval"]
    assert {k: v["count"] for k, v in ours.stage_totals().items()} == \
        {k: v["count"] for k, v in ref.stage_totals().items()}
    assert sorted(ours.round_totals()) == sorted(ref.round_totals()) \
        == [0, 1, 2, 3]
    assert ours.open_depth() == 0
    assert all(r.dur_ns >= 0 for r in ours.records())


def test_per_thread_stacks():
    tr = ttrace.Tracer(enabled=True)
    seen = {}

    def worker():
        with tr.span("state-write"):
            seen["depth"] = tr.open_depth()

    with tr.span("stage"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["depth"] == 1
    assert {r.kind: r.depth for r in tr.records()} == \
        {"state-write": 0, "stage": 0}


class _Executor:
    """An executor object: callable, with attributes the engine reads."""
    max_steps = 7

    def __init__(self):
        self.released = []

    def __call__(self, x):
        return x + 1

    def release(self, d):
        self.released.append(d)


def test_wrap_checks_enabled_per_call_and_forwards_attributes():
    tr = ttrace.Tracer(enabled=False)
    ex = _Executor()
    f = tr.wrap("dispatch", ex, exec="round")
    assert f(1) == 2 and tr.records() == []
    tr.enabled = True                  # enabled AFTER the wrap was built
    assert f(2) == 3
    assert [r.kind for r in tr.records()] == ["dispatch"]
    assert tr.records()[0].attrs["exec"] == "round"
    assert f.max_steps == 7 and f.__wrapped__ is ex
    f.release("d0")
    assert ex.released == ["d0"]
    with pytest.raises(AttributeError):
        f.no_such_attribute


# ---------------------------------------------------------------------------
# JSONL sink
# ---------------------------------------------------------------------------
RECORDS = [
    {"kind": "round", "t": 0, "acc": 0.5, "loss": 1.25, "disc": 0.0,
     "quarantined": 0, "group_sizes": [3, 0, 5], "weights": [1.0, 0.5]},
    {"b": 1, "a": 2, "nested": {"z": [1, 2], "y": None}, "s": "é"},
    {"kind": "round", "t": 1, "acc": float("nan"), "loss": 1e-30,
     "disc": 123456789.125, "quarantined": 2, "staleness": 1},
]


def test_encode_gives_reference_bytes():
    for rec in RECORDS:
        assert ttel.JsonlSink.encode(rec) == jtel.JsonlSink.encode(rec)
    assert ttel.JsonlSink.encode({"b": 1, "a": 2}) == '{"a":2,"b":1}'


def _dir_bytes(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def test_rotation_and_truncate_like_reference(tmp_path):
    dirs = {}
    for tag, mod in (("port", ttel), ("ref", jtel)):
        d = str(tmp_path / tag)
        sink = mod.JsonlSink(d, max_bytes=96)
        for t in range(6):
            sink.emit({"kind": "round", "t": t, "acc": 0.5 + t})
        sink.emit({"kind": "note", "t": 9})
        sink.close()
        rotated = _dir_bytes(d)
        segs = len(sink.segment_paths())
        sink.truncate_from(3)
        truncated = _dir_bytes(d)
        sink.emit({"kind": "round", "t": 3, "acc": 0.6})
        sink.close()
        dirs[tag] = (rotated, segs, truncated, _dir_bytes(d),
                     [r["t"] for r in sink.records()])
    assert dirs["port"] == dirs["ref"]
    rotated, segs, truncated, _, ts = dirs["port"]
    assert segs > 1 and len(truncated) == 1
    assert ts == [0, 1, 2, 9, 3]       # non-round records survive


# ---------------------------------------------------------------------------
# Chrome traces
# ---------------------------------------------------------------------------
def test_reference_validator_accepts_port_trace(tmp_path):
    tel = ttel.Telemetry(enabled=True, directory=str(tmp_path))
    with tel.span("stage", t=0):
        with tel.span("fold", t=0):
            pass
    tel.finalize({"framework": "x"})
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    assert jtrace.validate_chrome_trace(doc) == []
    assert ttrace.validate_chrome_trace(doc) == []
    assert {ev["name"] for ev in doc["traceEvents"]} == {"stage", "fold"}
    with open(tmp_path / "run_summary.json") as f:
        summary = json.load(f)
    assert summary["span_kinds"] == ["fold", "stage"]
    assert summary["framework"] == "x"


def test_validators_agree_on_broken_docs():
    tr = ttrace.Tracer(enabled=True)
    with tr.span("eval", t=1):
        pass
    good = ttrace.chrome_trace_doc(tr.chrome_events())
    broken = []
    d = copy.deepcopy(good)
    del d["traceEvents"][0]["ts"]
    broken.append(d)
    d = copy.deepcopy(good)
    d["traceEvents"][0].update(ph="Q", dur=-1.0, args=[1])
    broken.append(d)
    d = copy.deepcopy(good)
    d["traceEvents"].append("not an event")
    del d["traceEvents"][0]["dur"]
    broken.append(d)
    broken += [{"not": "a trace"}, {"traceEvents": {}}, []]
    for doc in broken:
        ours = ttrace.validate_chrome_trace(doc)
        assert ours and ours == jtrace.validate_chrome_trace(doc)


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------
def test_from_config_fresh_registry_shared_tracer():
    default = ttel.Telemetry(enabled=True)
    ttel.set_default(default)
    try:
        a = ttel.from_config(None)
        b = ttel.from_config(None)
        assert a.tracer is default.tracer is b.tracer
        assert a.registry is not b.registry
        assert a.registry is not default.registry
        a.registry.inc("async.dispatches")
        assert b.registry.get("async.dispatches") == 0
        assert ttel.get_default() is default
    finally:
        ttel.set_default(None)
    c = ttel.from_config(None)
    assert not c.enabled and c.tracer is not default.tracer
    assert not c.recording and c.finalize() is None


def test_trainer_shares_its_population_bundle(small_data):
    from repro_torch.fed.population import Population, PopulationConfig
    from repro_torch.fed.store import ArrayClientStore
    pop = Population(ArrayClientStore(small_data), PopulationConfig())
    tr = FedAvgTrainer(mclr(16, 10), None, _cfg(), device="cpu",
                       population=pop)
    assert tr.obs is pop.obs and tr.registry is pop.obs.registry
    assert pop.registry is pop.obs.registry
    tr.close()
    solo = FedAvgTrainer(mclr(16, 10), small_data, _cfg(), device="cpu")
    assert solo.registry is solo.obs.registry and not solo.obs.enabled


def test_registry_snapshot_rides_the_checkpoint(small_data, tmp_path):
    tr = FedAvgTrainer(mclr(16, 10), small_data,
                       _cfg(async_depth=1, checkpoint_every=2,
                            checkpoint_dir=str(tmp_path)), device="cpu")
    tr.run(4)
    tr.close()
    path = ckpt_io.latest_checkpoint(str(tmp_path))
    meta = ckpt_io.load_metadata(path)
    assert "obs" in meta and "async_stats" not in meta
    assert meta["fleet"] is None
    resumed = FedAvgTrainer(mclr(16, 10), small_data,
                            _cfg(async_depth=1, checkpoint_every=2,
                                 checkpoint_dir=str(tmp_path)), device="cpu")
    resumed.load_checkpoint(str(tmp_path))
    snap = resumed.obs.registry.snapshot()
    for k, v in meta["obs"].items():
        assert snap[k] == v, k
    assert snap["rounds.checkpoints"] == 2
    assert snap["async.staleness_hist"] == {"0": 4}
    resumed.close()


def test_profile_window_shows_the_spans(small_data, tmp_path):
    tr = FedAvgTrainer(mclr(16, 10), small_data,
                       _cfg(telemetry_dir=str(tmp_path)), device="cpu")
    tr.obs.tracer.annotate = True
    with tr.obs.profile() as p:
        tr.run(2)
    tr.close()
    names = {e.key for e in p.prof.key_averages()}
    assert {"dispatch", "eval"} <= names
    assert os.path.exists(os.path.join(p.log_dir, ttrace.PROFILE_TRACE))
    assert ttrace.stop_profiler() is None          # idempotent
    assert np.isfinite(tr.history.rounds[-1].mean_loss)


def test_all_screened_round_counts_an_empty_fold(small_data):
    # the reference's round record hook counts a round whose every alive
    # update was quarantined (the fold is the identity)
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.fed.population import (FaultConfig, FaultSpec,
                                            Population, PopulationConfig)
    from repro_torch.fed.store import ArrayClientStore
    faults = FaultConfig(rounds={1: FaultSpec(corrupt=8, corrupt_mode="nan")})
    pop = Population(ArrayClientStore(small_data), PopulationConfig(
        faults=faults, initial_active=30, arrival_rate=2.0, prefetch=2))
    tr = FedGroupTrainer(mclr(16, 10), None, _cfg(quarantine=True),
                         device="cpu", population=pop)
    tr.run(1)
    before = {k: v.clone() for k, v in tr.group_params.items()}
    h = tr.run(1)                        # round 1: the whole cohort NaN
    assert h.rounds[1].quarantined == 8
    for k in before:
        assert np.array_equal(tr.group_params[k].numpy(),
                              before[k].numpy()), k
    assert tr.registry.get("rounds.empty_folds") == 1
    tr.run(2)                            # healthy rounds keep training
    assert tr.registry.get("rounds.empty_folds") == 1
    tr.close()
