"""One rank of the port's data-mesh tests (``tests/test_torch_mesh_*.py``).

    python tests/_torch_mesh_driver.py RANK WORLD STORE OUT [DRAWS]
    python tests/_torch_mesh_driver.py RANK WORLD STORE OUT services|resume
    python tests/_torch_mesh_driver.py RANK WORLD STORE OUT reload ROOT
    python tests/_torch_mesh_driver.py RANK WORLD STORE OUT xload ARCHIVE \
        DRAWS
    python tests/_torch_mesh_driver.py RANK WORLD STORE OUT coldstart INPUTS

joins a gloo world of WORLD ranks through the FileStore at STORE (no
ports, so no races between test workers) as a ``(WORLD / M, M)`` mesh,
M the model axis of ``REPRO_MODEL_AXIS`` (1 unless set), runs every
scenario (or those named in ``MESH_SCENARIOS``) of
``SCENARIOS`` at the reference's small fixture (``tests/
test_trainer_sharding.py``: ``mnist_like(n_clients=16, dim=16)``,
``mclr(16, 10)``, K = 8, E = 3, m = 2) on the CPU with one torch thread,
and writes everything a test compares into OUT (``rank<r>.npz``): each
run's history, membership, cold-start labels, group parameters, and the
host state (FeSEM's rows, a streamed population's table). A world of one
also runs each scenario without a mesh (``<name>@none``). With DRAWS (an
``.npz`` of draws recorded from the JAX package's key chain and its
initial parameters, ``init/<leaf>``) only ``fedgroup_edc_round`` runs,
replaying them.

``services`` runs the runtime services' scenarios (``SERVICES``: four
rounds of FedGroup with EDC at the same fixture; the process fleets'
workers built by ``proc_builder``) into ``rank<r>.services.npz``, then
the first two rounds of each kill-and-resume scenario (an archive at
round 2 in OUT/work), and then kills its own process (SIGKILL: the world
dies). ``resume`` is the respawned world: each kill-and-resume scenario
from its archive to round 4, into ``rank<r>.resume.npz``. ``reload
ROOT`` resumes the round-2 archives another world left under ROOT (a
mesh of another shape) into ``rank<r>.reload.npz``. ``xload`` resumes
the JAX trainer's archive ARCHIVE with the draws recorded in DRAWS (``ListDraws``, whose
state is the archive's key) into ``rank<r>.xload.npz``. A world of one
also runs each scenario without a mesh (``<name>@none``). ``coldstart``
runs Alg. 3 (``fed.parallel.edc_embedding_distributed`` and one
``kmeans_step``) on this rank's d_w block of the ΔW in INPUTS (an
``.npz`` of ``dW``, ``m`` and an ``omega`` per name), with each QR, into
``rank<r>.coldstart.npz``.

Imports no JAX: a rank is a process of the port.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

DRIVER = Path(__file__).resolve()
SRC = DRIVER.parents[1] / "src"
ROUNDS = 2
BLOCK_ROUNDS = 3       # FedGroup's first round is its cold start
K_ODD = 7              # a cohort neither 2 nor 4 divides


class ListDraws:
    """Replays recorded draws in the order a trainer asks for them: each
    call returns the next array recorded for its kind."""

    def __init__(self, path: str):
        z = np.load(path)
        self._q = {kind: [z[k] for k in sorted(
            (k for k in z.files if k.startswith(kind + "_")),
            key=lambda k: int(k.rsplit("_", 1)[1]))]
            for kind in ("batch", "omega", "seeds")}
        # a replayed key chain's state (an archive's ``model/key``)
        self._state = z["state"] if "state" in z.files else None

    def _next(self, kind):
        return torch.as_tensor(self._q[kind].pop(0))

    def get_state(self):
        if self._state is None:
            return np.zeros(1, np.uint8)
        return self._state.copy()

    def set_state(self, state):
        if self._state is None:
            raise NotImplementedError
        self._state = np.asarray(state, self._state.dtype).copy()

    def batch_indices(self, n, max_steps: int, batch_size: int):
        return self._next("batch").to(n.device)

    def svd_omega(self, n: int, k: int, device):
        return self._next("omega").to(device)

    def kmeans_seeds(self, X, k: int):
        return self._next("seeds")


def fixture():
    from repro_torch.data.generators import mnist_like
    from repro_torch.models.paper_models import mclr
    data = mnist_like(seed=0, n_clients=16, classes_per_client=2,
                      total_train=1200, dim=16)
    return data, mclr(16, 10)


def base_cfg(**kw):
    from repro_torch.fed.engine import FedConfig
    cfg = FedConfig(n_rounds=ROUNDS, clients_per_round=8, local_epochs=3,
                    batch_size=10, lr=0.05, n_groups=2, pretrain_scale=2,
                    seed=0)
    return dataclasses.replace(cfg, **kw)


# name -> (framework, cfg overrides, rounds, streamed)
SCENARIOS = {
    "fedavg_round": ("fedavg", {}, ROUNDS, False),
    "fedavg_block": ("fedavg", {"block_size": 2}, BLOCK_ROUNDS, False),
    "fedgroup_edc_round": ("fedgroup", {}, ROUNDS, False),
    # α = 8: all 16 clients are founders, so no newcomer breaks a block
    "fedgroup_edc_block": ("fedgroup", {"block_size": 2, "pretrain_scale": 8},
                           BLOCK_ROUNDS, False),
    "fedgroup_madc_round": ("fedgroup", {"measure": "madc"}, ROUNDS, False),
    "fedgroup_madc_block": ("fedgroup", {"measure": "madc", "block_size": 2,
                                         "pretrain_scale": 8},
                            BLOCK_ROUNDS, False),
    "ifca_round": ("ifca", {}, ROUNDS, False),
    "ifca_block": ("ifca", {"block_size": 2}, BLOCK_ROUNDS, False),
    "fesem_round": ("fesem", {}, ROUNDS, False),
    "fesem_block": ("fesem", {"block_size": 2}, BLOCK_ROUNDS, False),
    "fedgroup_streamed": ("fedgroup", {}, ROUNDS, True),
    "fesem_streamed": ("fesem", {}, ROUNDS, True),
    # a tight screen: the cohort median decides who is quarantined
    "fedgroup_quarantine": ("fedgroup", {"quarantine": True,
                                         "quarantine_mult": 1.2},
                            ROUNDS, False),
    "fedgroup_odd_cohort": ("fedgroup", {"clients_per_round": K_ODD},
                            ROUNDS, False),
    # eq. 9 re-routing of drifted clients (threshold 0: every probe moves)
    "fedgroup_shift": ("fedgroup", {"shift_threshold": 0.0}, ROUNDS, False),
    # a tensor assignment state (the cohort's membership rows)
    "lcfl_round": ("lcfl", {}, ROUNDS, False),
    "lcfl_block": ("lcfl", {"block_size": 2}, BLOCK_ROUNDS, False),
}


def run_scenario(name, mesh, data, model, draws=None,
                 init_params=None) -> dict:
    """One scenario -> {key: numpy array} (keys without the name)."""
    from repro_torch.fed.population import Population, PopulationConfig
    from repro_torch.fed.store import ArrayClientStore, ShardedClientStore
    from repro_torch.fed.strategies import make_trainer
    fw, over, rounds, streamed = SCENARIOS[name]
    cfg = base_cfg(**over)
    kw = {"device": "cpu", "mesh": mesh}
    if draws is not None:
        kw["draws"] = draws
    if init_params is not None:
        kw["init_params"] = init_params
    pop = None
    shards = 1 if mesh is None else mesh.data_shards
    if streamed:
        pop = Population(ShardedClientStore(ArrayClientStore(data), shards),
                         PopulationConfig(prefetch=2))
        kw["population"] = pop
    names = {"fedavg": None, "fedgroup": "static", "ifca": "ifca",
             "fesem": "fesem", "lcfl": "lcfl"}
    if fw == "fedavg":
        from repro_torch.fed.engine import FedAvgTrainer
        tr = FedAvgTrainer(model, None if streamed else data, cfg, **kw)
    else:
        tr = make_trainer(names[fw], model, None if streamed else data, cfg,
                          **kw)
    out = {}
    rows = []
    if pop is not None:
        nxt = pop.next_cohort

        def seen():
            c = nxt()
            rows.append((c.x.shape[0], len(c.idx)))
            return c
        pop.next_cohort = seen
    if fw == "fedgroup":
        pre, labels = tr.group_cold_start()
        out["pre_idx"] = np.asarray(pre)
        out["labels"] = np.asarray(labels)
    h = tr.run(rounds)
    out["hist"] = np.array([[r.weighted_acc, r.mean_loss, r.discrepancy,
                             r.quarantined] for r in h.rounds], np.float64)
    out["comm"] = np.array([tr.comm_params], np.int64)
    out["counters"] = np.array([tr.counters[k] for k in (
        "rounds.cold_started", "rounds.migrations", "rounds.shift_checks")],
        np.int64)
    if fw == "fedavg":
        # the consensus model's eval: all clients, then a few (a rank's
        # share of them when its test stack holds its block of clients)
        out["eval"] = np.array([tr.evaluate(), tr.evaluate(
            client_idx=np.array([1, 5, 9, 14]))])
    params = getattr(tr, "group_params", None) or tr.params
    for k, v in params.items():
        out[f"gp/{k}"] = v.detach().cpu().numpy()
    if fw != "fedavg":
        out["membership"] = np.asarray(tr.membership).copy()
    if fw == "fedgroup" and tr.group_delta is not None:
        out["group_delta"] = tr.group_delta.detach().cpu().numpy()
    if fw == "fesem" and not streamed:
        out["local_flat"] = tr.local_flat.detach().cpu().numpy()
    if pop is not None:
        ids = np.arange(data.n_clients)
        st = pop.state
        out["table/membership"] = np.asarray(st.membership).copy()
        if fw == "fesem":
            out["table/local_flat"] = pop.gather_local_flat(ids).numpy()
        if fw == "fedgroup":
            has = st.has_pretrain_dir(ids)
            out["table/has_dir"] = has
            out["table/dirs"] = st.get_pretrain_dir(ids[has]).numpy()
        out["cohort_rows"] = np.array(rows, np.int64)
    blk = tr._block_exec
    out["blocks"] = np.array([blk is not None], bool)
    out["replays"] = np.array([0 if blk is None else blk.replays], np.int64)
    tr.close()
    return out


# ---------------------------------------------------------------------------
# the runtime services on the mesh: FedGroup (EDC), SERVICE_ROUNDS rounds
# ---------------------------------------------------------------------------
SERVICE_ROUNDS, KILL_AT = 4, 2
STREAM_KW = dict(prefetch=2, initial_active=12, arrival_rate=1.0)
# a straggle of 2 s over 4 chunks of 2 clients (0.5 s a chunk) against a
# 0.25 s deadline: it fires before the second chunk, on any clock
DEADLINE_KW = dict(deadline=0.25, stage_chunks=4)
STRAGGLE = dict(straggle=2.0)
# name -> (FedConfig overrides, PopulationConfig overrides or None)
SERVICES = {
    # the synchronous references: per round (the fleet's) and in blocks of
    # 4 (async D = 1's and telemetry's: D = 1 equals the block path)
    "fedgroup_sync": ({}, None),
    "fedgroup_sync_block": ({"block_size": 4}, None),
    "fedgroup_ckpt_resume": ({"block_size": 2, "checkpoint_every": KILL_AT},
                             None),
    "fedgroup_streamed_ckpt_resume": ({"checkpoint_every": KILL_AT},
                                      STREAM_KW),
    "fedgroup_telemetry": ({"block_size": 4, "telemetry_dir": "tel"}, None),
    # round 1: one client killed, two lanes poisoned (NaN) and quarantined;
    # round 2: the deadline fires (inline staging: a decision a chunk)
    "fedgroup_streamed_faults_deadline": (
        {"quarantine": True},
        dict(STREAM_KW, prefetch=0, **DEADLINE_KW,
             faults=("faults", {1: dict(kill=1, corrupt=2), 2: STRAGGLE}))),
    # prefetching: rank 0's consumer claims its producer's first chunk
    # after the deadline and every rank takes its length; round 0, whose
    # staging starts with the consumer's wait (the producer cannot have
    # run ahead into the straggle)
    "fedgroup_streamed_deadline_prefetch": (
        {}, dict(STREAM_KW, **DEADLINE_KW,
                 faults=("faults", {0: STRAGGLE}))),
    # round 2: two lanes of all 8 poisoned (scaled) and the deadline cuts
    # the cohort to its first chunk of 4 (1 s a chunk); a rank gathers the
    # newcomers' cold-start subset afresh, poisoned as the whole cohort's
    # lanes were
    "fedgroup_streamed_corrupt_deadline": (
        {"quarantine": True},
        dict(STREAM_KW, prefetch=0, deadline=0.25, stage_chunks=2,
             faults=("faults", {2: dict(corrupt=2, corrupt_mode="scale",
                                        **STRAGGLE)}))),
    "fedgroup_async_d1": ({"async_depth": 1}, None),
    # the first lease never reports ready on rank 0: it expires, every rank
    # requeues it, and it folds last (rank 0 holds its retry until the
    # other cohorts have folded, ``_script_expiry``)
    "fedgroup_async_d2": ({"async_depth": 2, "async_alpha": 0.8,
                           "async_beta": 0.5, "async_lease_timeout": 0.05,
                           "async_backoff": 1.0, "async_backoff_cap": 1.0},
                          None),
    # a fleet of one worker with message chaos on dispatches 1, 2 and 3
    "fedgroup_fleet1": ({}, None),
    # two workers: dispatch 1's holder muted and declared dead while its
    # job is held (its late result stale), dispatch 2's holder killed
    "fedgroup_fleet2": ({}, None),
    # process fleets (``transport="proc"``): one spawned worker a rank;
    # two a rank, the last rank's holder of dispatch 1 SIGKILLed
    "fedgroup_proc1": ({}, None),
    "fedgroup_proc_kill": ({}, None),
}
RESUMED = ("fedgroup_ckpt_resume", "fedgroup_streamed_ckpt_resume")
FLEET_FAULTS = {
    "fedgroup_fleet1": {1: dict(msg_drop=True), 2: dict(msg_dup=True),
                        3: dict(msg_reorder=True)},
    "fedgroup_fleet2": {1: dict(heartbeat_delay=1.5),
                        2: dict(worker_kill=True)}}
# a worker is declared dead after 0.5 s without a beat
FLEET_KW = {"fedgroup_fleet1": dict(n_workers=1, heartbeat_interval=0.05,
                                    heartbeat_miss=100),
            "fedgroup_fleet2": dict(n_workers=2, heartbeat_interval=0.05,
                                    heartbeat_miss=10, lease_timeout=20.0)}
FLEET_COUNTERS = ("fleet.jobs", "fleet.results", "fleet.lease_expiries",
                  "fleet.requeues", "fleet.msgs_dropped",
                  "fleet.msgs_duplicated", "fleet.msgs_reordered",
                  "fleet.stale_results")
# process fleets: name -> workers a rank; the kill hits the last rank only
PROC_FLEETS = {"fedgroup_proc1": 1, "fedgroup_proc_kill": 2}
PROC_KILL = {1: dict(worker_kill=True)}
# a process fleet's counters, then the killed rank's own
PROC_COUNTERS = ("fleet.jobs", "fleet.results", "fleet.lease_expiries",
                 "fleet.requeues", "fleet.worker_deaths")


def _faults(spec):
    from repro_torch.fed.population import FaultConfig, FaultSpec
    return FaultConfig({t: FaultSpec(**kw) for t, kw in spec[1].items()},
                       seed=0)


def service_trainer(name, mesh, data, model, work: Path, draws=None):
    """A fresh trainer of service scenario ``name`` (its telemetry and
    checkpoints under ``work``) -> (trainer, population or None)."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.fed.population import Population, PopulationConfig
    from repro_torch.fed.store import ArrayClientStore, ShardedClientStore
    over, pop_kw = SERVICES[name]
    over = dict(over)
    if "telemetry_dir" in over:
        over["telemetry_dir"] = str(work / over["telemetry_dir"])
    if over.get("checkpoint_every"):
        over["checkpoint_dir"] = str(work / "ckpt")
    cfg = dataclasses.replace(base_cfg(n_rounds=SERVICE_ROUNDS), **over)
    pop = None
    if pop_kw is not None:
        pop_kw = {k: (_faults(v) if k == "faults" else v)
                  for k, v in pop_kw.items()}
        shards = 1 if mesh is None else mesh.data_shards
        pop = Population(ShardedClientStore(ArrayClientStore(data), shards),
                         PopulationConfig(**pop_kw))
    tr = FedGroupTrainer(model, None if pop else data, cfg, device="cpu",
                         mesh=mesh, population=pop, draws=draws)
    return tr, pop


def proc_builder(name: str):
    """A process worker's trainer replica of service scenario ``name``:
    the scenario's trainer on one device (a spawned worker is in no
    process group), built as every rank builds its own."""
    data, model = fixture()
    tr, _ = service_trainer(name, None, data, model, Path("."))
    return tr


def proc_fleet_config(name, mesh):
    """Scenario ``name``'s process fleet on this rank: its workers built by
    ``proc_builder``; the kill scripted on the last rank alone (every
    other rank's workers live). A 5 s heartbeat window: a death is found
    by its closed pipe."""
    from repro_torch.fed.population import FaultConfig, FaultSpec
    from repro_torch.launch.coordinator import FleetConfig
    from repro_torch.launch.worker import WorkerSpec
    last = mesh is None or mesh.rank == mesh.world - 1
    faults = (FaultConfig({t: FaultSpec(**kw) for t, kw in PROC_KILL.items()})
              if name == "fedgroup_proc_kill" and last else None)
    return FleetConfig(n_workers=PROC_FLEETS[name], transport="proc",
                       worker_spec=WorkerSpec(
                           "_torch_mesh_driver:proc_builder", {"name": name}),
                       heartbeat_interval=0.05, heartbeat_miss=100,
                       lease_timeout=120.0, join_timeout=200.0, faults=faults)


def _watch_cohorts(pop, rows: list):
    """Record each consumed cohort's (rows held, clients, first id)."""
    nxt = pop.next_cohort

    def seen():
        c = nxt()
        rows.append((c.x.shape[0], len(c.idx), int(c.idx[0])))
        return c
    pop.next_cohort = seen


class _HeldUntilDeath:
    """The round executor with its second call (dispatch 1's first
    attempt) held until this rank's coordinator declared a worker dead, so
    that attempt's result comes back only after its lease was given up."""

    def __init__(self, real, registry):
        self.real, self.registry, self.calls = real, registry, 0

    def __call__(self, *args):
        import time
        self.calls += 1
        end = time.monotonic() + 60.0
        while self.calls == 2 and not self.registry.get(
                "fleet.worker_deaths"):
            assert time.monotonic() < end, "no worker was declared dead"
            time.sleep(0.005)
        return self.real(*args)


def _script_expiry(tr):
    """The first lease this trainer dispatches never reports ready, and its
    requeued retry waits until the other SERVICE_ROUNDS - 1 cohorts have
    folded: its backoff outlasts them on any clock, however long their
    dispatches take."""
    real, doomed = tr._lease_ready, []

    def scripted(lease):
        if not doomed:
            doomed.append(lease)
        return False if lease is doomed[0] else real(lease)
    tr._lease_ready = scripted
    real_index = tr._requeued_index

    def held(requeued):
        if tr.history.async_stats["folds"] < SERVICE_ROUNDS - 1:
            return -1
        return real_index(requeued)
    tr._requeued_index = held


def service_state(tr, pop, rows) -> dict:
    """What a service scenario compares, as numpy."""
    reg = tr.registry
    out = {"hist": np.array([[r.round, r.weighted_acc, r.mean_loss,
                              r.discrepancy, r.quarantined]
                             for r in tr.history.rounds], np.float64),
           "membership": np.asarray(tr.membership).copy(),
           "comm": np.array([tr.comm_params], np.int64),
           "draws": np.asarray(tr.draws.get_state()).copy(),
           "group_delta": tr.group_delta.detach().cpu().numpy(),
           "counters": np.array([reg.get(k) for k in (
               "rounds.completed", "rounds.evals", "rounds.cold_started",
               "rounds.migrations", "rounds.quarantined",
               "rounds.checkpoints")], np.int64),
           "async": np.frombuffer(json.dumps(
               dict(tr.history.async_stats), sort_keys=True).encode(),
               np.uint8)}
    for k, v in tr.group_params.items():
        out[f"gp/{k}"] = v.detach().cpu().numpy()
    for k, v in tr.params.items():
        out[f"params/{k}"] = v.detach().cpu().numpy()
    if tr.group_version is not None:
        out["group_version"] = np.asarray(tr.group_version).copy()
    if pop is not None:
        ids = np.arange(pop.store.n_clients)
        st = pop.state
        out["stats"] = np.array([pop.stats[k] for k in sorted(pop.stats)],
                                np.int64)
        out["table/membership"] = np.asarray(st.membership).copy()
        has = st.has_pretrain_dir(ids)
        out["table/has_dir"] = has
        out["table/dirs"] = st.get_pretrain_dir(ids[has]).numpy()
        out["cohort_rows"] = np.array(rows, np.int64).reshape(-1, 3)
    if tr._async_exec is not None:
        out["replays"] = np.array([tr._async_exec.replays], np.int64)
    obs = tr.obs
    out["obs"] = np.array([obs.enabled, obs.recording,
                           obs.directory is not None], bool)
    return out


def run_service(name, mesh, data, model, work: Path) -> dict:
    """Service scenario ``name`` whole (SERVICE_ROUNDS rounds) on ``mesh``
    (None: one device) -> {key: numpy array}."""
    from repro_torch.launch.coordinator import Coordinator, FleetConfig
    tr, pop = service_trainer(name, mesh, data, model, work)
    rows = []
    if pop is not None:
        _watch_cohorts(pop, rows)
    if name == "fedgroup_async_d2" and (mesh is None or mesh.rank == 0):
        _script_expiry(tr)
    fleet = None
    if name in PROC_FLEETS:
        fleet = Coordinator(tr, proc_fleet_config(name, mesh))
        t0 = time.monotonic()
        fleet.run(SERVICE_ROUNDS)
        run_s = time.monotonic() - t0
    elif name in FLEET_FAULTS:
        from repro_torch.fed.population import FaultConfig, FaultSpec
        fleet = Coordinator(tr, FleetConfig(
            **FLEET_KW[name], faults=FaultConfig(
                {t: FaultSpec(**kw) for t, kw in FLEET_FAULTS[name].items()})))
        if name == "fedgroup_fleet2" and (mesh is None or mesh.rank == 0):
            # rank 0 decides the death; the other ranks' attempts wait for
            # its attempt in their collectives
            fleet._table["round"] = _HeldUntilDeath(fleet._table["round"],
                                                    tr.registry)
        fleet.run(SERVICE_ROUNDS)
    else:
        tr.run(SERVICE_ROUNDS)
    out = service_state(tr, pop, rows)
    if name in PROC_FLEETS:
        out["proc"] = np.array([tr.registry.get(k) for k in PROC_COUNTERS],
                               np.int64)
        out["proc_run_s"] = np.array([run_s])
        fleet.close()
        out["proc_left"] = np.array([len(fleet._transport._procs)], np.int64)
    elif fleet is not None:
        # after close: a stale result has come back by then
        fleet.close()
        out["fleet"] = np.array([tr.registry.get(k) for k in FLEET_COUNTERS],
                                np.int64)
    else:
        tr.close()
    return out


def kill_half(name, mesh, data, model, work: Path):
    """A kill-and-resume scenario's first KILL_AT rounds: the archive at
    round KILL_AT lands in ``work``; the trainer is then abandoned."""
    tr, _ = service_trainer(name, mesh, data, model, work)
    tr.run(KILL_AT)


def resume_half(name, mesh, data, model, work: Path) -> dict:
    """A fresh trainer of scenario ``name`` resumed from ``work``'s latest
    archive to SERVICE_ROUNDS rounds."""
    tr, pop = service_trainer(name, mesh, data, model, work)
    rows = []
    if pop is not None:
        _watch_cohorts(pop, rows)
    assert tr.load_checkpoint(str(work / "ckpt")) == KILL_AT
    tr.run(SERVICE_ROUNDS - KILL_AT)
    out = service_state(tr, pop, rows)
    tr.close()
    return out


def reload_half(name, mesh, data, model, work: Path, archive: str) -> dict:
    """A fresh trainer of scenario ``name`` (its own checkpoints under
    ``work``) resumed from ``archive``, another world's file of round
    KILL_AT, to SERVICE_ROUNDS rounds."""
    tr, pop = service_trainer(name, mesh, data, model, work)
    rows = []
    if pop is not None:
        _watch_cohorts(pop, rows)
    assert tr.load_checkpoint(archive) == KILL_AT
    tr.run(SERVICE_ROUNDS - KILL_AT)
    out = service_state(tr, pop, rows)
    tr.close()
    return out


def kill_archive(root: Path, name: str) -> str:
    """The round-KILL_AT archive a ``services`` world left for ``name``."""
    return str(root / "work" / (name + "@kill") / "ckpt"
               / f"ckpt_{KILL_AT:08d}.npz")


def xload_run(mesh, data, model, archive: str, draws: str) -> dict:
    """The JAX trainer's archive resumed to SERVICE_ROUNDS rounds, the
    continuation's draws replayed."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    cfg = base_cfg(n_rounds=SERVICE_ROUNDS)
    tr = FedGroupTrainer(model, data, cfg, device="cpu", mesh=mesh,
                         draws=ListDraws(draws))
    t = tr.load_checkpoint(archive)
    tr.run(SERVICE_ROUNDS - t)
    out = service_state(tr, None, [])
    tr.close()
    return out


def coldstart_run(mesh, inputs: str) -> dict:
    """Alg. 3 on this rank's d_w block of ``inputs``' ΔW, for each QR and
    each Ω of ``inputs`` (``omega/<name>``) -> {"<qr>/<name>/E" | V | assign}."""
    from repro_torch.fed import parallel as fp
    z = np.load(inputs)
    dW, m = torch.as_tensor(z["dW"]), int(z["m"])
    lo, hi = mesh.model_cols(dW.shape[1])
    mine = dW[:, lo:hi].contiguous()
    out = {}
    for qr in ("householder", "cholesky"):
        for key in (k for k in z.files if k.startswith("omega/")):
            E, V = fp.edc_embedding_distributed(
                mine, m, omega=torch.as_tensor(z[key]), qr_impl=qr,
                mesh=mesh)
            assign, _ = fp.kmeans_step(E, E[:m])
            tag = f"{qr}/{key[6:]}"
            out[f"{tag}/E"] = E.numpy()
            out[f"{tag}/V"] = V.numpy()
            out[f"{tag}/assign"] = assign.numpy()
    return out


def _tagged(res: dict, tag: str, out: dict):
    for k, v in out.items():
        res[f"{tag}/{k}"] = v


def run_services(rank, world, mesh, data, model, outdir: Path, names):
    """The ``services`` mode: the scenarios ``names`` whole, the kill
    halves of those among them that resume, then SIGKILL (the world dies
    after its archives are written)."""
    work = outdir / "work"
    res = {}
    for name in names:
        _tagged(res, name, run_service(name, mesh, data, model,
                                       work / name))
        if world == 1:
            _tagged(res, name + "@none", run_service(
                name, None, data, model, work / (name + "@none")))
    np.savez(outdir / f"rank{rank}.services.npz", **res)
    for name in (n for n in RESUMED if n in names):
        kill_half(name, mesh, data, model, work / (name + "@kill"))
        if world == 1:
            kill_half(name, None, data, model, work / (name + "@none@kill"))
    sys.stdout.flush()
    os.kill(os.getpid(), signal.SIGKILL)


def run_resumed(rank, world, mesh, data, model, outdir: Path):
    """The ``resume`` mode: the respawned world from the archives."""
    work = outdir / "work"
    res = {}
    for name in RESUMED:
        _tagged(res, name, resume_half(name, mesh, data, model,
                                       work / (name + "@kill")))
        if world == 1:
            _tagged(res, name + "@none", resume_half(
                name, None, data, model, work / (name + "@none@kill")))
    np.savez(outdir / f"rank{rank}.resume.npz", **res)


def services_world(d: Path, S: int, names, model: int = 1) -> tuple:
    """Spawn the ``services`` world of S ranks (an (S / model, model)
    mesh) over ``names`` and, when any of them resumes, the respawned
    ``resume`` world -> (d, each rank's services arrays, each rank's
    resumed arrays or None)."""
    services = spawn_world(S, d, extra=("services", ",".join(names)),
                           rc=-signal.SIGKILL, suffix=".services",
                           model=model)
    resumed = (spawn_world(S, d, extra=("resume",), suffix=".resume",
                           model=model)
               if any(n in RESUMED for n in names) else None)
    return d, services, resumed


def run_of(z: dict, name: str) -> dict:
    """Scenario ``name``'s arrays of a rank's file (keys without it)."""
    pre = name + "/"
    return {k[len(pre):]: v for k, v in z.items() if k.startswith(pre)}


def differing(a: dict, b: dict, skip=()) -> list:
    """Keys of ``a`` whose arrays differ from ``b``'s bit for bit."""
    return [k for k in a if k not in skip and not (
        k in b and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes())]


# a sharded run against the world of one: the reference's own accuracy
# bound (tests/test_trainer_sharding.py), loss and discrepancy relative,
# each parameter leaf in the relative Frobenius norm
ACC_ATOL, RTOL, LEAF_RTOL = 2e-3, 1e-4, 1e-5


def assert_sharded_close(got: dict, ref: dict):
    """A service scenario on S ranks against the world of one: counts and
    replicated host state equal, floats (the parameters and a streamed
    population's cached pre-training directions) at the tolerances
    above."""
    for k in ("membership", "comm", "counters", "stats", "async", "fleet",
              "table/membership", "table/has_dir", "group_version", "draws"):
        if k in ref:
            assert np.array_equal(got[k], ref[k]), k
    h, hr = got["hist"], ref["hist"]
    assert h.shape == hr.shape
    np.testing.assert_array_equal(h[:, [0, 4]], hr[:, [0, 4]])
    np.testing.assert_allclose(h[:, 1], hr[:, 1], atol=ACC_ATOL, rtol=0)
    np.testing.assert_allclose(h[:, 2:4], hr[:, 2:4], rtol=RTOL)
    leaves = [k for k in ref if k.startswith(("gp/", "params/"))]
    assert leaves
    for k in leaves:
        err = np.linalg.norm(got[k] - ref[k]) / np.linalg.norm(ref[k])
        assert err <= LEAF_RTOL, (k, err)
    if "table/dirs" in ref:
        # the cached pre-training directions (a poisoned lane's may be NaN)
        a, b = got["table/dirs"], ref["table/dirs"]
        assert a.shape == b.shape
        assert np.array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(b)
        err = np.linalg.norm(a[ok] - b[ok]) / np.linalg.norm(b[ok])
        assert err <= LEAF_RTOL, ("table/dirs", err)


def spawn_world(S: int, outdir: Path, extra=(), rc: int = 0,
                suffix: str = "", model: int = 1, names=None) -> list:
    """Run the driver on S ranks as an (S / model, model) mesh (the
    default mode over ``names`` of ``SCENARIOS``, all of them by default);
    every rank must exit with ``rc`` (0; the ``services`` mode kills
    itself, -SIGKILL) and a failed rank fails the world (the others are
    killed) -> each rank's ``rank<r><suffix>.npz``."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               REPRO_MODEL_AXIS=str(model),
               MESH_SCENARIOS=",".join(names or SCENARIOS))
    store = outdir / f"store{suffix}"      # a fresh FileStore a world
    procs = [subprocess.Popen(
        [sys.executable, str(DRIVER), str(r), str(S), str(store),
         str(outdir), *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(S)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert rcs == [rc] * S, "\n".join(log[-3000:] for log in logs)
    return [dict(np.load(outdir / f"rank{r}{suffix}.npz")) for r in range(S)]


def main(argv) -> int:
    rank, world, store, outdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    mode = argv[4] if len(argv) > 4 and argv[4] in (
        "services", "resume", "reload", "xload", "coldstart") else None
    draws_path = argv[4] if len(argv) > 4 and mode is None else None
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_process_group("cpu", init_method=f"file://{store}",
                                rank=rank, world_size=world)
    try:
        M = int(os.environ.get("REPRO_MODEL_AXIS", "1"))
        mesh = mesh_lib.make_fed_mesh(world // M, M, device="cpu")
        data, model = fixture()
        out = Path(outdir)
        if mode == "services":
            run_services(rank, world, mesh, data, model, out,
                         argv[5].split(",") if len(argv) > 5 else
                         list(SERVICES))
        if mode == "resume":
            run_resumed(rank, world, mesh, data, model, out)
            return 0
        if mode == "reload":
            res = {}
            for name in RESUMED:
                _tagged(res, name, reload_half(
                    name, mesh, data, model, out / "work" / (name + "@reload"),
                    kill_archive(Path(argv[5]), name)))
            np.savez(out / f"rank{rank}.reload.npz", **res)
            return 0
        if mode == "coldstart":
            np.savez(out / f"rank{rank}.coldstart.npz",
                     **coldstart_run(mesh, argv[5]))
            return 0
        if mode == "xload":
            res = {}
            _tagged(res, "xload", xload_run(mesh, data, model, argv[5],
                                            argv[6]))
            np.savez(out / f"rank{rank}.xload.npz", **res)
            return 0
        res = {}
        names = (os.environ.get("MESH_SCENARIOS", ",".join(SCENARIOS))
                 .split(",") if draws_path is None
                 else ["fedgroup_edc_round"])
        init = None
        if draws_path:
            z = np.load(draws_path)
            init = {k[5:]: torch.as_tensor(z[k]) for k in z.files
                    if k.startswith("init/")}
        for name in names:
            draws = ListDraws(draws_path) if draws_path else None
            for k, v in run_scenario(name, mesh, data, model, draws,
                                     init).items():
                res[f"{name}/{k}"] = v
            if world == 1 and draws_path is None:
                for k, v in run_scenario(name, None, data, model).items():
                    res[f"{name}@none/{k}"] = v
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
    finally:
        mesh_lib.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
