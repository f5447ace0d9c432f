"""Round-based federated training engines: FedAvg / FedProx base trainer
and the grouped-trainer machinery (``repro.fed.engine``), synchronous:
per round, or in round blocks (``block_size > 1``).

Two ways to feed a trainer. Pinned (``data=``): the padded per-client
train/eval stacks are placed on the device once at init and selection is
a device gather. Streamed (``population=``, ``fed.population``): the
population stays in a host store, each round's cohort comes from the
population's scheduler and prefetcher (``next_cohort()``), eval runs over
blocks of the store's test data, and the grouped trainers' membership is
the population's state-table column. A same-seed streamed run equals its
pinned run bit for bit on the CPU. Cohort *selection* draws from a
dedicated numpy stream ``default_rng([seed, 0x5E1EC7])`` and the cold-start
/ ablation draws from ``default_rng(seed)``, exactly as the reference does,
so cohorts match it. Every other random draw goes through a draws object
(``repro_torch.draws``) that a parity test can replace.

Round blocks: ``run`` stages up to ``block_size`` upcoming rounds on the
host (selection and draws never depend on device results) and runs them
through ``fed.rounds.make_block_executor`` — eagerly on the CPU, as
replays of one captured CUDA graph on the card (``fed.graphs``) — with one
device fetch per block. A round that needs host work first (FedGroup's
group cold start, cold newcomers in a cohort, an enabled shift detector)
breaks back to the per-round path; a cohort already drawn for it is
given back by rewinding ``select_rng``, so every random stream matches a
per-round run and a checkpoint at the block's end. (The reference carries
that cohort over as ``pending`` instead, and its checkpoint at such a
block's end holds ``select_rng`` one draw past the round.) A streamed
population always runs per round (``Population.block_stageable`` is
False).

Checkpoints: with ``checkpoint_every`` / ``checkpoint_dir`` an atomic
``ckpt_<t>.npz`` lands each time a multiple of ``checkpoint_every``
completed rounds is crossed (a block that crosses one checkpoints at its
end), in the reference's archive layout (``save_checkpoint``). A fresh
same-config trainer resumes from it bit for bit (``load_checkpoint``): the
model and group state, the draws object's state (``model/key``), both
numpy streams, the history, the counters and, when streaming, the
population's scheduler stream, state table and ``stats``.

Not yet ported, and refused with ``NotImplementedError`` (``ROADMAP.md``):
the async runtime (``async_depth > 0``), a device mesh and telemetry
(``telemetry_dir``).
"""
from __future__ import annotations

import dataclasses
import math
import os
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.data.federated import FederatedData
from repro_torch.draws import TorchDraws
from repro_torch.fed import client as client_lib
from repro_torch.fed import graphs as graphs_lib
from repro_torch.fed import rounds as rounds_lib
from repro_torch.fed import server as server_lib
from repro_torch.models.modules import param_count
from repro_torch.models.paper_models import ModelSpec

# seed-derivation tag of the cohort-selection stream (``repro.fed.store``)
SELECT_STREAM = 0x5E1EC7


@dataclass
class FedConfig:
    n_rounds: int = 50
    clients_per_round: int = 20          # K
    local_epochs: int = 20               # E
    batch_size: int = 10                 # B
    lr: float = 0.03
    mu: float = 0.0                      # FedProx proximal weight (0 = FedAvg)
    seed: int = 0
    # CFL knobs
    n_groups: int = 3                    # m
    pretrain_scale: int = 20             # alpha (pre-train alpha*m clients)
    eta_g: float = 0.0                   # inter-group aggregation lr
    measure: str = "edc"                 # edc | madc
    rcc: bool = False                    # ablation: random cluster centers
    rac: bool = False                    # ablation: randomly assign cold clients
    svd_iters: int = 4
    dropout_rate: float = 0.0            # per-round client drop probability
                                         # (network jitter, paper §3.3)
    eval_every: int = 1                  # evaluate every e-th round (1 =
                                         # every round, the paper's tables)
    block_size: int = 1                  # rounds fused per dispatch
    # in-program update quarantine: screen non-finite / norm-outlier client
    # updates into the zero-weight path (fed.rounds); counts surface in
    # RoundMetrics.quarantined
    quarantine: bool = False
    quarantine_mult: float = 10.0        # outlier threshold: mult x median
                                         # cohort update norm
    # checkpoint/restore: every `checkpoint_every` completed rounds write an
    # atomic ckpt_<t>.npz into `checkpoint_dir` (0 / None = off), keeping
    # the newest `checkpoint_keep` (0 = all); a fresh same-config trainer
    # resumes bit for bit via load_checkpoint()
    checkpoint_every: int = 0
    checkpoint_dir: str | None = None
    checkpoint_keep: int = 0
    # asynchronous runtime (not yet ported: async_depth > 0 raises)
    async_depth: int = 0
    async_alpha: float = 1.0
    async_beta: float = 0.0
    async_lease_timeout: float = 30.0
    async_max_retries: int = 3
    async_backoff: float = 0.05
    async_backoff_cap: float = 1.0
    # distribution-shift migration (core.fedgroup, FedGroup trainers): None
    # = off; else probe every shift_check_every-th round and migrate the
    # clients whose drift (1 - cos)/2 exceeds the threshold
    shift_threshold: float | None = None
    shift_check_every: int = 1
    # strategy-zoo knobs (fed.strategies): FedClust's trailing-head share
    # of the flattened weights, LCFL's hysteresis margin
    fedclust_frac: float = 0.25
    lcfl_margin: float = 0.1
    # telemetry (not yet ported: a directory raises)
    telemetry_dir: str | None = None


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not yet ported to repro_torch (see ROADMAP.md, "
        "queue 1); use the JAX package repro for it")


def _check_ported(cfg: FedConfig, mesh):
    if cfg.async_depth > 0:
        _not_ported("the async runtime (async_depth > 0)")
    if mesh is not None:
        _not_ported("a device mesh")
    if cfg.telemetry_dir:
        _not_ported("telemetry (telemetry_dir)")


@dataclass
class RoundMetrics:
    round: int
    weighted_acc: float
    mean_loss: float
    discrepancy: float
    quarantined: int = 0        # clients screened out by the update
                                # quarantine this round (0 when off)


@dataclass
class History:
    """Per-round metrics. Rounds skipped by the ``eval_every`` cadence
    record ``weighted_acc = nan``; the aggregates below ignore them."""

    rounds: list = field(default_factory=list)

    def add(self, m: RoundMetrics):
        self.rounds.append(m)

    @property
    def max_acc(self) -> float:
        return max((r.weighted_acc for r in self.rounds
                    if not math.isnan(r.weighted_acc)), default=0.0)

    @property
    def total_quarantined(self) -> int:
        return sum(r.quarantined for r in self.rounds)

    def rounds_to_reach(self, target: float):
        for r in self.rounds:
            if r.weighted_acc >= target:
                return r.round
        return None


class FedAvgTrainer:
    """FedAvg (mu=0) / FedProx (mu>0) with a consensus global model.

    ``init_params`` replaces ``model.init`` (parity tests carry the JAX
    package's params over); ``draws`` replaces the default
    ``TorchDraws(cfg.seed)``. ``counters`` counts the reference's registry
    events (cold starts, migrations, completed rounds, checkpoints).

    ``population=`` (a ``fed.population.Population``) streams the cohorts
    from a host store instead; ``data`` may then be None. The population
    is attached to this trainer and runs on its device; ``close()`` stops
    its prefetcher and state writer."""

    framework = "fedavg"

    def __init__(self, model: ModelSpec, data: FederatedData | None,
                 cfg: FedConfig, device="cuda", mesh=None, population=None,
                 init_params=None, draws=None):
        _check_ported(cfg, mesh)
        self.device = resolve_device(device)
        self.model, self.cfg, self.data = model, cfg, data
        self.population = population
        self.rng = np.random.default_rng(cfg.seed)
        self.select_rng = np.random.default_rng([cfg.seed, SELECT_STREAM])
        self.draws = TorchDraws(cfg.seed) if draws is None else draws
        if population is not None:
            store = population.store
            self.n_clients = store.n_clients
            self._max_samples = store.max_train
            self._n_train = store.n_train
        else:
            if data is None:
                raise ValueError("pass data= (pinned) or population=")
            self.n_clients = data.n_clients
            self._max_samples = data.x_train.shape[1]
            self._n_train = data.n_train
        self.solver = client_lib.make_batch_solver(
            model, epochs=cfg.local_epochs, batch_size=cfg.batch_size,
            lr=cfg.lr, mu=cfg.mu, max_samples=self._max_samples)
        if init_params is None:
            init_params = model.init(
                torch.Generator().manual_seed(cfg.seed + 1), self.device)
        self.params = {k: v.to(self.device, torch.float32)
                       for k, v in init_params.items()}
        self.history = History()
        self.counters = Counter()
        self.model_size = param_count(self.params)
        self.comm_params = 0        # cumulative parameters transferred
        self._resumed = False       # load_checkpoint ran; run() keeps stats
        self._round_exec = None     # lazily-built fused round
        self._block_exec = None     # lazily-built round-block executor
        self._grouped_eval = client_lib.grouped_eval_correct(model)
        self._eval_fn = client_lib.make_eval_fn(model)
        if population is not None:
            population.attach(cfg, self.device)
            self._train_stack = self._test_stack = None
        else:
            # pin the padded per-client stacks on the device once —
            # selection is a device gather, not an upload every round
            dev = self.device
            self._train_stack = (
                torch.as_tensor(data.x_train, device=dev),
                torch.as_tensor(data.y_train, device=dev).long(),
                torch.as_tensor(data.n_train, device=dev).long())
            self._test_stack = (
                torch.as_tensor(data.x_test, device=dev),
                torch.as_tensor(data.y_test, device=dev).long(),
                torch.as_tensor(data.n_test, device=dev).long())
            self._eval_zero_mem = torch.zeros(
                self.n_clients, dtype=torch.long, device=dev)

    # -- fused round executor ----------------------------------------------
    def _exec_spec(self) -> dict:
        """Executor grouping: one group for the consensus trainers;
        FedGroup overrides with m + η_G."""
        return {"n_groups": 1, "eta_g": 0.0}

    def _round_executor(self):
        if self._round_exec is None:
            cfg = self.cfg
            self._round_exec = rounds_lib.make_round_executor(
                self.model, epochs=cfg.local_epochs,
                batch_size=cfg.batch_size, lr=cfg.lr, mu=cfg.mu,
                max_samples=self._max_samples, quarantine=cfg.quarantine,
                quarantine_mult=cfg.quarantine_mult, **self._exec_spec())
        return self._round_exec

    # -- round blocks ------------------------------------------------------
    def _block_kwargs(self) -> dict:
        """make_block_executor extras: the executor grouping plus the
        framework's carry <-> assignment-state adapters (FeSEM, LCFL
        override)."""
        return dict(self._exec_spec())

    def _block_executor(self):
        if self._block_exec is None:
            cfg = self.cfg
            fn = rounds_lib.make_block_executor(
                self.model, epochs=cfg.local_epochs,
                batch_size=cfg.batch_size, lr=cfg.lr, mu=cfg.mu,
                max_samples=self._max_samples, quarantine=cfg.quarantine,
                quarantine_mult=cfg.quarantine_mult, **self._block_kwargs())
            self._block_exec = graphs_lib.GraphBlockExecutor(fn)
        return self._block_exec

    def _host_round_pre(self) -> bool:
        """True when the NEXT round must run on the per-round path for
        host work that precedes selection (FedGroup: group cold start)."""
        return False

    def _needs_host(self, idx) -> bool:
        """True when the selected cohort needs host work before the round
        (FedGroup: cold newcomers routed through eq. 9)."""
        return False

    def _stage_comm(self, k: int):
        """Per-staged-round communication accounting (k = alive clients)."""
        self.comm_params += 2 * k * self.model_size

    def _stage_round(self, t: int, idx):
        """One staged round: cohort ids padded to K, the minibatch rows
        (drawn for the alive prefix only — exactly the per-round draw —
        with zero rows for the padding), the zero-weight alive mask, and
        the eval-cadence flag."""
        K = min(self.cfg.clients_per_round, self.n_clients)
        idx = np.asarray(idx, np.int64)
        k = len(idx)
        n = torch.as_tensor(self._n_train[idx]).long()
        bidx = self._batch_indices(n, self.solver.max_steps).cpu()
        if k < K:
            idx = np.concatenate([idx, np.full(K - k, idx[0], np.int64)])
            bidx = torch.cat([bidx, bidx.new_zeros(
                (K - k,) + tuple(bidx.shape[1:]))])
        alive = np.zeros(K, np.float32)
        alive[:k] = 1.0
        self._stage_comm(k)
        return idx, bidx, alive, self._should_eval(t)

    def _stage_block(self, t0: int, max_b: int):
        """Stage up to ``max_b`` upcoming rounds. Stops at the first round
        that needs the host; the cohort drawn for that round is given back
        (``select_rng`` rewound to before the draw), so a checkpoint at the
        block's end holds the stream of the round it labels and the
        per-round path draws the same cohort again."""
        staged = []
        for b in range(max_b):
            if self._host_round_pre():
                break
            before = self.select_rng.bit_generator.state
            idx = self._select()
            if self._needs_host(idx):
                self.select_rng.bit_generator.state = before
                break
            staged.append(self._stage_round(t0 + b, idx))
        return staged

    # carry construction / teardown — overridden down the trainer hierarchy
    def _membership_host(self):
        return np.zeros(self.n_clients, np.int64)    # consensus: one group

    def _stacked_group_params(self):
        return {k: p[None] for k, p in self.params.items()}

    def _carry_group_delta(self):
        m = self._exec_spec()["n_groups"]
        return torch.zeros((m, self.model_size), device=self.device)

    def _carry_aux(self):
        return None

    def _carry_in(self) -> dict:
        """The block's carry: the model state on the device, the (N+1,)
        membership column (row N: the trash row) as a host tensor."""
        mem = np.append(self._membership_host(), -1).astype(np.int64)
        return dict(group_params=self._stacked_group_params(),
                    global_params=self.params,
                    group_delta=self._carry_group_delta(),
                    membership=torch.as_tensor(mem), aux=self._carry_aux())

    def _carry_refs(self, carry: dict):
        """Point the trainer's model state at the carry (no host fetch)."""
        self.params = carry["global_params"]

    def _carry_out(self, carry: dict, membership: np.ndarray):
        """``_carry_refs`` plus the fetched (N,) membership column.
        Membership written here counts no migrations, as the
        reference's block path."""
        self._carry_refs(carry)

    def _run_block(self, t0: int, staged):
        idx = torch.as_tensor(np.stack([s[0] for s in staged]))
        bidx = torch.stack([s[1] for s in staged])
        alive = torch.as_tensor(np.stack([s[2] for s in staged]))
        do_eval = [s[3] for s in staged]
        carry, ys = self._block_executor()(
            self._carry_in(), self._train_stack, self._test_stack, idx, bidx,
            alive, do_eval)
        # ONE device fetch for the block's stacked metrics and membership
        B = len(staged)
        host = torch.cat([ys.reshape(-1),
                          carry["membership"].double()]).cpu().numpy()
        ys = host[:5 * B].reshape(B, 5)
        self._carry_out(carry, host[5 * B:-1].astype(np.int64))
        for b in range(B):
            loss, disc, correct, total, n_quar = ys[b]
            acc = (int(correct) / max(int(total), 1) if do_eval[b]
                   else float("nan"))
            self._record(t0 + b, acc, float(loss), float(disc), int(n_quar))

    # -- helpers -----------------------------------------------------------
    def _select(self):
        if self.population is not None:
            return self.population.next_cohort().idx
        idx = self.select_rng.choice(self.n_clients,
                                     min(self.cfg.clients_per_round,
                                         self.n_clients), replace=False)
        if self.cfg.dropout_rate > 0.0:
            # stragglers drop out before completing the round (the server
            # aggregates whoever finished within the time budget, Alg. 1)
            alive = self.select_rng.random(len(idx)) >= self.cfg.dropout_rate
            if not alive.any():
                alive[self.select_rng.integers(len(idx))] = True
            idx = idx[alive]
        return idx

    def _client_batch(self, idx):
        if self.population is not None:
            # the live cohort's tensors (or a slice of them, e.g. the
            # cold-start subset); a fresh store gather otherwise
            return self.population.device_batch(idx)
        sel = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        x, y, n = self._train_stack
        return x[sel], y[sel], n[sel]

    def _batch_indices(self, n, max_steps: int):
        return self.draws.batch_indices(n, max_steps, self.cfg.batch_size)

    @torch.no_grad()
    def _solve(self, params, idx, solver=None):
        solver = self.solver if solver is None else solver
        x, y, n = self._client_batch(idx)
        bidx = self._batch_indices(n, solver.max_steps)
        deltas, finals = solver(params, x, y, n, bidx)
        return deltas, finals, n

    def _should_eval(self, t: int) -> bool:
        e = self.cfg.eval_every
        return e <= 1 or (t + 1) % e == 0

    @torch.no_grad()
    def _fused_eval_acc(self, group_params, membership) -> float:
        """Weighted accuracy in one pass regardless of m: integer
        correct/total counts, divided on the host."""
        xt, yt, nt = self._test_stack
        c, tot = self._grouped_eval(group_params, membership, xt, yt, nt)
        return int(c) / max(int(tot), 1)

    @torch.no_grad()
    def _eval_correct(self, params, client_idx=None):
        """Streamed eval: (correct, total) summed over blocks of at most
        ``eval_batch`` clients (no whole-population device allocation);
        one device fetch at the end."""
        pop = self.population
        idx = pop.eval_ids() if client_idx is None else np.asarray(client_idx)
        if len(idx) == 0:
            return 0, 0
        correct = torch.zeros((), dtype=torch.long, device=self.device)
        total = 0
        for block, x, y, n in pop.eval_batches(idx):
            correct += torch.sum(self._eval_fn(params, x, y, n))
            total += int(pop.store.n_test[block].sum())
        return int(correct), total

    def _round_eval(self, t: int) -> float:
        if not self._should_eval(t):
            return float("nan")
        if self.population is not None:
            return self.evaluate()
        return self._fused_eval_acc({k: p[None] for k, p in
                                     self.params.items()},
                                    self._eval_zero_mem)

    @torch.no_grad()
    def evaluate(self, params=None, client_idx=None) -> float:
        params = self.params if params is None else params
        if self.population is not None:
            correct, total = self._eval_correct(params, client_idx)
            return correct / max(total, 1)
        xt, yt, nt = self._test_stack
        if client_idx is None:
            idx = np.arange(self.n_clients)
        else:
            idx = np.asarray(client_idx)
            if len(idx) == 0:
                return 0.0
            sel = torch.as_tensor(idx.astype(np.int64), device=self.device)
            xt, yt, nt = xt[sel], yt[sel], nt[sel]
        correct = self._eval_fn(params, xt, yt, nt)
        total = self.data.n_test[idx].sum()
        return float(int(torch.sum(correct)) / max(total, 1))

    def _add_round(self, t, acc, out) -> RoundMetrics:
        return self._record(t, acc, float(out.mean_loss),
                            float(out.discrepancy), int(out.n_quarantined))

    def _record(self, t, acc, loss, disc, n_quar) -> RoundMetrics:
        m = RoundMetrics(t, acc, loss, disc, n_quar)
        self.history.add(m)
        self.counters["rounds.completed"] += 1
        if m.quarantined:
            self.counters["rounds.quarantined"] += m.quarantined
        return m

    # -- main loop ---------------------------------------------------------
    def round(self, t: int, idx=None) -> RoundMetrics:
        if idx is None:
            idx = self._select()
        x, y, n = self._client_batch(idx)
        ex = self._round_executor()
        bidx = self._batch_indices(n, ex.max_steps)
        # downlink: 1 model per client; uplink: 1 update per client
        self.comm_params += 2 * len(idx) * self.model_size
        out = ex({k: p[None] for k, p in self.params.items()},
                 torch.zeros(len(idx), dtype=torch.long, device=self.device),
                 x, y, n, bidx)
        self.params = out.global_params
        return self._add_round(t, self._round_eval(t), out)

    def run(self, n_rounds=None) -> History:
        """Runs ``n_rounds`` MORE rounds, labelled from the current history
        length. With ``block_size > 1`` upcoming rounds are staged on the
        host and run as one block; a round that needs the host breaks back
        to the per-round path (its cohort, if already drawn, is drawn
        again there), as does a lone last round; so does every
        round of a streamed population.

        A fresh run zeroes the population's ``stats``; the first run after
        ``load_checkpoint`` keeps the restored totals. With checkpointing
        on, a checkpoint lands each time a multiple of
        ``checkpoint_every`` completed rounds is crossed."""
        if self.population is not None:
            if self._resumed:
                self._resumed = False
            else:
                self.population.reset_stats()
        t = len(self.history.rounds)
        total = t + (n_rounds or self.cfg.n_rounds)
        blocks = self.cfg.block_size > 1 and (
            self.population is None or self.population.block_stageable)
        while t < total:
            prev = t
            staged = (self._stage_block(t, min(self.cfg.block_size,
                                               total - t))
                      if blocks and total - t >= 2 else [])
            if staged:
                self._run_block(t, staged)
                t += len(staged)
            else:
                self.round(t)
                t += 1
            self._maybe_checkpoint(prev, t)
        return self.history

    # -- checkpoint / restore ----------------------------------------------
    def _maybe_checkpoint(self, prev_t: int, t: int):
        e = self.cfg.checkpoint_every
        if e > 0 and self.cfg.checkpoint_dir and t // e > prev_t // e:
            self.save_checkpoint()

    def _ckpt_model_tree(self) -> dict:
        """The model state a checkpoint holds; also the strict load's
        template (a fresh same-config trainer has the same shapes)."""
        return {"params": self.params, "key": self.draws.get_state()}

    def _ckpt_load_model(self, tree: dict):
        self.params = tree["params"]
        self.draws.set_state(tree["key"])

    def _ckpt_meta_extra(self) -> dict:
        """Framework scalars for the metadata (FedGroup: cold-start
        flags)."""
        return {}

    def _ckpt_apply_extra(self, extra: dict):
        pass

    def _ckpt_state_arrays(self) -> dict:
        """Framework host arrays of save-time shape for the ``state``
        sub-tree, beside the population's (FedGroup: the pinned direction
        cache); the load template comes from the archive."""
        return {}

    def _ckpt_apply_state(self, arrays: dict):
        pass

    def save_checkpoint(self, path: str | None = None) -> str:
        """Atomically write the state after ``len(history.rounds)``
        completed rounds to ``path`` (default: ``checkpoint_dir``'s
        ``ckpt_<t>.npz``), in the reference's layout: ``model/*`` (params,
        ``key`` = the draws' state, group state), ``state/*`` (the
        population's scheduler arrays and table rows, framework arrays) and
        the metadata (both numpy streams, history, comm accounting,
        ``extra``, ``obs`` = the counters under the reference's registry
        names, ``population``). Then prunes to ``checkpoint_keep``."""
        t = len(self.history.rounds)
        if path is None:
            if not self.cfg.checkpoint_dir:
                raise ValueError("pass a path or set FedConfig"
                                 ".checkpoint_dir")
            path = ckpt_io.checkpoint_path(self.cfg.checkpoint_dir, t)
        # counted before the snapshot, so a resumed run's total matches an
        # uninterrupted run's
        self.counters["rounds.checkpoints"] += 1
        state, pop_meta = {}, None
        obs = {k: int(v) for k, v in self.counters.items()}
        if self.population is not None:
            # drains the writer and syncs writer_retries into stats first
            state, pop_meta = self.population.ckpt_state()
            obs.update({f"pop.{k}": int(v)
                        for k, v in self.population.stats.items()})
        state = dict(state, **self._ckpt_state_arrays())
        meta = {"framework": self.framework, "t": t,
                "n_clients": int(self.n_clients),
                "rng": self.rng.bit_generator.state,
                "select_rng": self.select_rng.bit_generator.state,
                "comm_params": int(self.comm_params),
                "history": [[r.round, r.weighted_acc, r.mean_loss,
                             r.discrepancy, r.quarantined]
                            for r in self.history.rounds],
                "extra": self._ckpt_meta_extra(),
                "group_version": None,      # the async runtime's clocks
                "obs": obs,
                "fleet": None,              # a coordinator's snapshot
                "population": pop_meta}
        ckpt_io.save_pytree(path, {"model": self._ckpt_model_tree(),
                                   "state": state}, meta)
        if self.cfg.checkpoint_keep > 0 and self.cfg.checkpoint_dir:
            # after the atomic write: the newest archive always survives
            ckpt_io.prune_checkpoints(self.cfg.checkpoint_dir,
                                      self.cfg.checkpoint_keep)
        return path

    def load_checkpoint(self, path_or_dir: str) -> int:
        """Restore a ``save_checkpoint`` archive (a file, or a directory's
        latest ``ckpt_*.npz``) into this fresh trainer of the same config
        and population construction; returns the completed-round count,
        after which ``run(n)`` continues as the uninterrupted run would.
        Refuses another framework, another client count, a trainer that
        has trained, and a pinned archive in a streamed trainer or the
        reverse. The tensors land on this trainer's device."""
        path = path_or_dir
        if os.path.isdir(path):
            path = ckpt_io.latest_checkpoint(path)
            if path is None:
                raise FileNotFoundError(
                    f"no ckpt_*.npz checkpoints in {path_or_dir}")
        if self.history.rounds:
            raise RuntimeError("load_checkpoint needs a fresh trainer — "
                               "this one has already trained")
        meta = ckpt_io.load_metadata(path)
        if meta["framework"] != self.framework:
            raise ValueError(
                f"checkpoint was written by framework "
                f"{meta['framework']!r}, this trainer is {self.framework!r}")
        if int(meta["n_clients"]) != self.n_clients:
            raise ValueError(
                f"checkpoint population has {meta['n_clients']} clients, "
                f"this trainer has {self.n_clients}")
        if meta["population"] is not None and self.population is None:
            raise ValueError("checkpoint came from a streamed-population "
                             "run — construct the trainer with the same "
                             "population")
        if meta["population"] is None and self.population is not None:
            raise ValueError("checkpoint came from a pinned run — "
                             "construct the trainer without population")
        # the model template is this fresh trainer's state; the state
        # sub-tree's sizes are known only at save time
        state_tmpl = {
            k[len("state/"):]: np.zeros(shape, dtype)
            for k, (shape, dtype) in ckpt_io.saved_array_specs(path).items()
            if k.startswith("state/")}
        tree = ckpt_io.load_pytree(
            path, {"model": self._ckpt_model_tree(), "state": state_tmpl})
        self._ckpt_load_model(tree["model"])
        self._ckpt_apply_extra(meta.get("extra") or {})
        self.rng.bit_generator.state = meta["rng"]
        self.select_rng.bit_generator.state = meta["select_rng"]
        self.comm_params = int(meta["comm_params"])
        self.history = History([RoundMetrics(int(r[0]), float(r[1]),
                                             float(r[2]), float(r[3]),
                                             int(r[4]))
                                for r in meta["history"]])
        if self.population is not None:
            self.population.ckpt_restore(tree["state"], meta["population"])
        self._ckpt_apply_state(tree["state"])
        # the registry's counters; pop.* came back with the population
        self.counters = Counter({k: v for k, v in (meta.get("obs") or {})
                                 .items() if isinstance(v, int)
                                 and not k.startswith("pop.")})
        self._resumed = True
        return int(meta["t"])

    def close(self):
        """Stop the population's prefetch thread and state writer (a no-op
        when pinned)."""
        if self.population is not None:
            self.population.close()


class FedProxTrainer(FedAvgTrainer):
    framework = "fedprox"

    def __init__(self, model, data, cfg: FedConfig, **kw):
        if cfg.mu <= 0:
            cfg = dataclasses.replace(cfg, mu=0.01)
        super().__init__(model, data, cfg, **kw)


class GroupedTrainer(FedAvgTrainer):
    """Shared machinery for the clustered trainers: m group models kept as
    an m-stacked param dict, per-client membership bookkeeping, and
    group-wise weighted-accuracy evaluation."""

    def __init__(self, model, data, cfg: FedConfig, **kw):
        super().__init__(model, data, cfg, **kw)
        self.m = cfg.n_groups
        if self.population is not None:
            # the state table's column, shared: every write is in place
            self.membership = self.population.state.membership
        else:
            self.membership = np.full(self.n_clients, -1, np.int64)

    def _random_groups(self, offset: int, given=None) -> dict:
        """m-stacked group params for the trainers that start from m random
        centres (IFCA, FeSEM, LCFL): ``given`` when passed (parity tests
        carry the JAX trainer's over — ``jax.random`` draws cannot be
        reproduced), else m successive ``model.init`` draws from one CPU
        generator seeded ``cfg.seed + offset``, the reference's offset."""
        if given is None:
            gen = torch.Generator().manual_seed(self.cfg.seed + offset)
            given = rounds_lib.stack_trees(
                [self.model.init(gen, "cpu") for _ in range(self.m)])
        return {k: v.to(self.device, torch.float32) for k, v in given.items()}

    def _adopt_membership(self, idx, new):
        """Write a cohort's new group assignments, counting migrations
        (previously-assigned clients switching groups)."""
        new = np.asarray(new)
        old = self.membership[idx]
        mig = int(np.sum((old >= 0) & (old != new)))
        if mig:
            self.counters["rounds.migrations"] += mig
        self.membership[idx] = new

    def group_param(self, j: int) -> dict:
        """The j-th group's parameters (views into the stacked state)."""
        return server_lib.tree_index(self.group_params, j)

    def evaluate_groups(self) -> float:
        """Weighted accuracy: each group model on the test data of all
        clients assigned to it (paper §5.1 metric), in one fused pass when
        pinned; streamed, group by group over blocks of the eval ids'
        members."""
        if self.population is not None:
            eval_ids = self.population.eval_ids()
            mem = self.membership[eval_ids]
            correct = total = 0
            for j in range(self.m):
                members = eval_ids[mem == j]
                if len(members):
                    c, tot = self._eval_correct(self.group_param(j), members)
                    correct += c
                    total += tot
            return correct / max(total, 1)
        return self._fused_eval_acc(
            self.group_params,
            torch.as_tensor(self.membership, device=self.device))

    def _round_eval(self, t: int) -> float:
        if not self._should_eval(t):
            return float("nan")
        return self.evaluate_groups()

    # -- round-block carry: m-stacked groups + membership ------------------
    def _membership_host(self):
        return self.membership

    def _stacked_group_params(self):
        return self.group_params

    def _carry_refs(self, carry: dict):
        super()._carry_refs(carry)
        self.group_params = carry["group_params"]

    def _carry_out(self, carry: dict, membership: np.ndarray):
        self._carry_refs(carry)
        self.membership[:] = membership

    # -- checkpoint: m-stacked groups + membership -------------------------
    def _ckpt_model_tree(self) -> dict:
        tree = super()._ckpt_model_tree()
        tree["group_params"] = self.group_params
        tree["membership"] = np.asarray(self.membership)
        return tree

    def _ckpt_load_model(self, tree: dict):
        super()._ckpt_load_model(tree)
        self.group_params = tree["group_params"]
        # in place: a population's state table shares this array
        self.membership[:] = tree["membership"]
