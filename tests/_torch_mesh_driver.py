"""One rank of the port's data-mesh tests (``tests/test_torch_mesh_*.py``).

    python tests/_torch_mesh_driver.py RANK WORLD STORE OUT [DRAWS]

joins a gloo world of WORLD ranks through the FileStore at STORE (no
ports, so no races between test workers), runs every scenario of
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

Imports no JAX: a rank is a process of the port.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
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

    def _next(self, kind):
        return torch.as_tensor(self._q[kind].pop(0))

    def get_state(self):
        return np.zeros(1, np.uint8)

    def set_state(self, state):
        raise NotImplementedError

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


def spawn_world(S: int, outdir: Path, extra=()) -> list:
    """Run the driver on S ranks; every rank must exit 0 (a failed rank
    fails the world: the others are killed) -> each rank's arrays."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    store = outdir / "store"
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
    assert rcs == [0] * S, "\n".join(log[-3000:] for log in logs)
    return [dict(np.load(outdir / f"rank{r}.npz")) for r in range(S)]


def main(argv) -> int:
    rank, world, store, outdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    draws_path = argv[4] if len(argv) > 4 else None
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_process_group("cpu", init_method=f"file://{store}",
                                rank=rank, world_size=world)
    try:
        mesh = mesh_lib.make_fed_mesh(world, device="cpu")
        data, model = fixture()
        res = {}
        names = (list(SCENARIOS) if draws_path is None
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
