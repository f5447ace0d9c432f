"""Round-based federated training engines: FedAvg / FedProx base trainer
and the grouped-trainer machinery (``repro.fed.engine``): per round, in
round blocks (``block_size > 1``) or asynchronous (``async_depth >= 1``).

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

Async runtime: ``FedConfig.async_depth >= 1`` switches ``run()`` to
``_run_async``, which keeps up to ``async_depth`` cohort dispatches in
flight against the live state and folds each completed one FIFO into it
with FedAsync staleness weights α·(s+1)^(-β), the staleness s counted per
group (``group_version``). Pinned, a dispatch is one
``fed.rounds.make_async_dispatch_executor`` step against a snapshot of the
carry (on the card a replay of its captured graph, ``fed.graphs``) and
the fold (``make_staleness_fold``) writes the live carry in place; on the
card, stream order gives every dispatch its snapshot. Streamed, a dispatch
is the fused round on the group parameters of the moment and the fold
(``make_param_fold``) mixes the parameters only. Every dispatch holds a
lease (``fed.leases``): one not ready by ``async_lease_timeout`` is
requeued with capped backoff, at most ``async_max_retries`` times. Depth 1
with α = 1, β = 0 equals the block path (pinned) and the per-round path
(streamed) bit for bit on the CPU.

Telemetry (``repro_torch.obs``): a trainer owns one bundle, ``obs`` (a
population's when streaming), whose registry holds the counters
(``History.async_stats`` and ``Population.stats`` are views of it, and
its snapshot is the checkpoint's ``obs``). Spans mark the host seams
(stage, h2d, dispatch, fold, eval, state-write, checkpoint); with
``telemetry_dir`` the tracer is on and every round appends a
deterministic record to ``metrics.jsonl``, truncated at a resume so the
stream stays byte-identical to an uninterrupted run's; ``close()`` (and
the end of ``run()``) writes ``trace.json`` and ``run_summary.json``.
The executors are wrapped in ``dispatch`` spans (``obs.wrap``, which
keeps the executor objects' attributes), and a coordinator
(``launch.coordinator``) may replace them with fleet proxies.

A data mesh (``mesh=``, a ``launch.mesh.FedMesh``; by default
``fed.parallel.default_fed_mesh()``, None unless a process group of more
than one rank is initialised): every rank runs the same trainer from the
same seed, draws the same cohorts and draws on its host generators, and
computes its contiguous block of each cohort's clients; the round's sums
are ``all_reduce``s (``fed.rounds``) and the trainer's state is whole on
every rank. The pinned train stack is whole on every rank, the test
stack this rank's block of the clients when the ranks divide N. The
pre-training solves (Alg. 3, eq. 9, the shift probes) run sharded and
their updates are gathered; the measures then run on every rank. The
device is the mesh's.

A mesh with a model axis (``make_fed_mesh(D, M)``, the reference's 2-D
layout) keeps the group and global parameters at rest as this rank's
blocks of ``sharding.specs.group_param_pspec`` (``launch.mesh
.ParamLayout``); the executors gather them over the model group at the
start of a round and keep the rank's blocks of the new ones at its end,
and whatever else reads them (eval, the cold starts' solves, the CLI's
model) gathers them first (``_whole``). A cohort is computed by rank
(``FedMesh.compute_rows``: each data slice's rows split over its M ranks)
and its sums run over the world. Alg. 3 and eq. 9 run on this rank's d_w
block of the updates, the only part of them it receives (``_solve_flat``,
``FedMesh.gather_cols``), their products all-reduced over the model group
(``core.fedgroup``).

The runtime services run on the mesh too. Each decision the reference's
single controller takes by its clock is taken once here, by rank 0, and
followed by every rank through ``FedMesh.agree`` (the host group, never a
CUDA stream): a lease's readiness or expiry and the backoff of a requeued
one (the async runtime), a straggler deadline's prefix (``fed
.population``), a fleet job's outcome (``launch.coordinator``). An async
dispatch computes the rank's rows of its cohort (its all-reduces inside
the dispatch graph over NCCL, eager over gloo) and the fold is
replicated; on a model axis the live carry holds the rank's blocks, a
dispatch gathers them as a round does, and the fold mixes the blocks as
they are (only the mean of the folded groups gathers them). A checkpoint
holds whole leaves in the reference's layout: on a model axis the ranks
gather their blocks over the model group first; rank 0 checks the whole
model tree is the same on every rank, writes the one archive, the ranks
meet at a barrier on the host group and rank 0 alone prunes; every rank
resumes from the same archive and keeps its blocks of it, so an archive
resumes on any mesh shape and without a mesh. Telemetry: rank 0 alone
writes ``telemetry_dir``; the other ranks keep their tracer and registry
in memory.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.data.federated import FederatedData
from repro_torch.draws import TorchDraws
from repro_torch.fed import client as client_lib
from repro_torch.fed import leases as leases_lib
from repro_torch.fed import parallel as parallel_lib
from repro_torch.fed import rounds as rounds_lib
from repro_torch.fed import server as server_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.modules import flatten_stacked, param_count
from repro_torch.models.paper_models import ModelSpec
from repro_torch.obs import telemetry as obs_lib

# seed-derivation tag of the cohort-selection stream (``repro.fed.store``)
SELECT_STREAM = 0x5E1EC7

# the async runtime's lease record (``fed.leases``); its ``metrics`` slot
# holds the readiness event recorded after the dispatch (None on the CPU)
_AsyncLease = leases_lib.Lease


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
    # asynchronous runtime (0 = synchronous): up to `async_depth` cohort
    # dispatches in flight, folded FIFO with staleness weights
    # alpha * (s + 1)^(-beta); a dispatch not ready within
    # `async_lease_timeout` s is requeued with capped exponential backoff,
    # at most `async_max_retries` times
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
    # telemetry (repro_torch.obs): a directory enables span tracing and
    # streams per-round records to <dir>/metrics.jsonl, with trace.json +
    # run_summary.json written at the end of run() and by close()
    telemetry_dir: str | None = None


def _check_mesh(mesh):
    """A mesh must be a ``launch.mesh.FedMesh`` (or None)."""
    if mesh is not None and not isinstance(mesh, mesh_lib.FedMesh):
        raise TypeError(f"a device mesh of type {type(mesh).__name__}: the "
                        "trainers take a launch.mesh.FedMesh")


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
    record ``weighted_acc = nan``; the aggregates below ignore them.

    ``async_stats`` is the async runtime's record (all zero on synchronous
    runs): dispatches / folds / max_in_flight / lease_expiries / requeues
    and ``staleness_hist``, a {max staleness: folds} histogram. Inside a
    trainer it is a view of the registry's ``async.*`` metrics."""

    rounds: list = field(default_factory=list)
    async_stats: dict = field(default_factory=dict)

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
    ``TorchDraws(cfg.seed)``. ``obs`` is the run's telemetry bundle
    (``repro_torch.obs.Telemetry``); ``registry``, the same object as
    ``obs.registry``, holds the reference's metrics (``async.*``,
    ``rounds.*``, a population's ``pop.*``, a coordinator's ``fleet.*``);
    ``counters`` is its nonzero ``rounds.*`` counters.

    ``population=`` (a ``fed.population.Population``) streams the cohorts
    from a host store instead; ``data`` may then be None. The population
    is attached to this trainer and runs on its device; ``close()`` stops
    its prefetcher and state writer.

    ``mesh`` (a ``launch.mesh.FedMesh``; default
    ``fed.parallel.default_fed_mesh(device=device)``) shards the client
    axis over its ranks, and on a model axis the parameters; the device is
    then the mesh's, whose type must be ``device``'s."""

    framework = "fedavg"

    def __init__(self, model: ModelSpec, data: FederatedData | None,
                 cfg: FedConfig, device="cuda", mesh=None, population=None,
                 init_params=None, draws=None):
        if mesh is None:
            mesh = parallel_lib.default_fed_mesh(device=device)
        _check_mesh(mesh)
        self.mesh = mesh
        if mesh is not None:
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"device={device!r} but the mesh's rank "
                                 f"device is {mesh.device}")
            self.device = mesh.device
        else:
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
        params = {k: v.to(self.device, torch.float32)
                  for k, v in init_params.items()}
        self.model_size = param_count(params)
        # at rest: this rank's blocks of the parameters on a model axis
        self._layout = mesh_lib.param_layout(mesh, model)
        self.params = self._block(params)
        # one telemetry bundle per runtime: a population owns one (its
        # degradation counters live there), which the trainer shares
        self.obs = (population.obs if population is not None
                    else obs_lib.from_config(cfg, write=mesh_lib.writes(mesh)))
        self.registry = self.obs.registry
        self._last_staleness = None  # the last async fold's max staleness
        self._last_weights = None    # and group weights (round record)
        self._bind_history(History())
        self.comm_params = 0        # cumulative parameters transferred
        self._resumed = False       # load_checkpoint ran; run() keeps stats
        self._round_exec = None     # lazily-built fused round
        self._block_exec = None     # lazily-built round-block executor
        self._async_exec = None     # lazily-built async dispatch executor
        self.group_version = None   # (m,) per-group staleness clock (async)
        self._grouped_eval = client_lib.grouped_eval_correct(model, mesh)
        self._eval_fn = client_lib.make_eval_fn(model)
        # the rows of the test stack this rank holds (all without a mesh)
        self._test_rows = (0, self.n_clients)
        if population is not None:
            population.attach(cfg, self.mesh if self.mesh is not None
                              else self.device)
            self._train_stack = self._test_stack = None
        else:
            # pin the padded per-client stacks on the device once —
            # selection is a device gather, not an upload every round
            dev = self.device
            self._train_stack = (
                torch.as_tensor(data.x_train, device=dev),
                torch.as_tensor(data.y_train, device=dev).long(),
                torch.as_tensor(data.n_train, device=dev).long())
            test = (data.x_test, np.asarray(data.y_test, np.int64),
                    np.asarray(data.n_test, np.int64))
            if self.mesh is not None:
                # this rank's block of the clients when the ranks divide N
                rows = self.mesh.cohort_rows(self.n_clients)
                self._test_rows = rows or self._test_rows
                self._test_stack = parallel_lib.shard_client_axis(
                    self.mesh, test)
            else:
                self._test_stack = tuple(torch.as_tensor(t, device=dev)
                                         for t in test)
            self._eval_zero_mem = torch.zeros(
                self.n_clients, dtype=torch.long, device=dev)

    def _whole(self, tree: dict) -> dict:
        """A parameter tree kept as model-axis blocks, gathered whole over
        the model group (a collective: every rank calls it); the tree
        itself without a model axis."""
        return tree if self._layout is None else self._layout.whole(tree)

    def model_params(self) -> dict:
        """The consensus (global) parameters, whole on every rank (a gather
        over a model axis: every rank calls it)."""
        return self._whole(self.params)

    def _block(self, tree: dict) -> dict:
        """This rank's model-axis blocks of a whole parameter tree (the
        tree itself without a model axis)."""
        return tree if self._layout is None else self._layout.block(tree)

    def _bind_history(self, h: History):
        """``h.async_stats`` becomes the registry's ``async.*`` view."""
        h.async_stats = self.obs.async_view()
        self.history = h

    # -- telemetry (repro_torch.obs) ----------------------------------------
    def _round_fields(self) -> dict:
        """The round record's state fields, read when the round is added
        (the pinned async loop reads them at fold time and adds the round
        when its metrics arrive): the group clocks, the last fold's
        staleness and weights; subclasses add theirs."""
        rec = {}
        if self.group_version is not None:
            rec["group_version"] = [int(v) for v in self.group_version]
        if self._last_staleness is not None:
            rec["staleness"] = self._last_staleness
            rec["weights"] = self._last_weights
            self._last_staleness = self._last_weights = None
        return rec

    def _round_record(self, m: RoundMetrics, fields: dict) -> dict:
        """One ``metrics.jsonl`` record: deterministic functions of the
        training state (never wall time), so the stream is bit-stable
        across kill-and-resume."""
        return dict(fields, kind="round", t=m.round, acc=m.weighted_acc,
                    loss=m.mean_loss, disc=m.discrepancy,
                    quarantined=m.quarantined)

    def _summary_extra(self) -> dict:
        return {"framework": self.framework,
                "rounds": len(self.history.rounds),
                "max_acc": self.history.max_acc,
                "comm_params": int(self.comm_params)}

    @property
    def counters(self) -> Counter:
        """The registry's nonzero ``rounds.*`` counters (completed rounds,
        evals, cold starts, migrations, shift checks, checkpoints)."""
        reg = self.registry
        return Counter({n: reg.get(n) for n in reg.names("rounds.")
                        if reg.get(n)})

    # -- fused round executor ----------------------------------------------
    def _exec_spec(self) -> dict:
        """Executor grouping: one group for the consensus trainers;
        FedGroup overrides with m + η_G."""
        return {"n_groups": 1, "eta_g": 0.0}

    def _round_executor(self):
        if self._round_exec is None:
            cfg = self.cfg
            fn = rounds_lib.make_round_executor(
                self.model, epochs=cfg.local_epochs,
                batch_size=cfg.batch_size, lr=cfg.lr, mu=cfg.mu,
                max_samples=self._max_samples, quarantine=cfg.quarantine,
                quarantine_mult=cfg.quarantine_mult, mesh=self.mesh,
                **self._exec_spec())
            self._round_exec = self.obs.wrap(
                "dispatch", parallel_lib.make_sharded_executor(fn, self.mesh),
                exec="round")
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
                quarantine_mult=cfg.quarantine_mult, mesh=self.mesh,
                **self._block_kwargs())
            self._block_exec = self.obs.wrap(
                "dispatch", parallel_lib.make_sharded_block_executor(
                    fn, self.mesh), exec="block")
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
        with self.obs.span("stage", t=t0):
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
        return self._block({k: p[None]
                            for k, p in self._whole(self.params).items()})

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
            self._record(t0 + b, acc, float(loss), float(disc), int(n_quar),
                         alive=int(staged[b][2].sum()))

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

    def _local_solve(self, params, idx, solver):
        """This rank's share of one local solve of the ``idx`` clients from
        ``params`` -> (deltas, finals, n of every client, its rows or None):
        its ``compute_rows`` under a mesh (the minibatch rows drawn for all
        of them on every rank), all of them without one or when the ranks
        do not divide the set."""
        solver = self.solver if solver is None else solver
        params = self._whole(params)
        x, y, n = self._client_batch(idx)
        bidx = self._batch_indices(n, solver.max_steps)
        rows = None if self.mesh is None else self.mesh.compute_rows(len(n))
        if rows is None:
            return (*solver(params, x, y, n, bidx), n, None)
        lo, hi = rows
        x, y = self.mesh.take_rows(x, len(n)), self.mesh.take_rows(y, len(n))
        return (*solver(params, x, y, n[lo:hi], bidx[lo:hi]), n, rows)

    @torch.no_grad()
    def _solve(self, params, idx, solver=None):
        """One local solve of the ``idx`` clients from ``params`` ->
        (deltas, finals, n), whole on every rank (a mesh's ranks each solve
        their rows and the updates are gathered)."""
        deltas, finals, n, rows = self._local_solve(params, idx, solver)
        if rows is not None:
            deltas, finals = parallel_lib.gather_client_axis(
                self.mesh, (deltas, finals), len(n))
        return deltas, finals, n

    @torch.no_grad()
    def _solve_flat(self, idx, solver=None) -> torch.Tensor:
        """The flattened updates (c, d_w) of one local solve of the ``idx``
        clients from the global parameters. On a model axis this rank's
        d_w block of every row (``FedMesh.gather_cols``): the d-sharded ΔW
        that Alg. 3 and eq. 9 take, whose whole rows no rank receives."""
        deltas, _, n, _ = self._local_solve(self.params, idx, solver)
        dW = flatten_stacked(deltas)
        return dW if self.mesh is None else self.mesh.gather_cols(dW, len(n))

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
            if len(n):      # a mesh rank's share of a block may be empty
                correct += torch.sum(self._eval_fn(params, x, y, n))
            total += int(pop.store.n_test[block].sum())
        if self.mesh is not None:
            # each data slice scored its rows of every block
            self.mesh.data_sum(correct)
        return int(correct), total

    def _round_eval(self, t: int) -> float:
        if not self._should_eval(t):
            return float("nan")
        with self.obs.span("eval", t=t):
            if self.population is not None:
                return self.evaluate()
            return self._fused_eval_acc(self._stacked_group_params(),
                                        self._eval_zero_mem)

    @torch.no_grad()
    def evaluate(self, params=None, client_idx=None) -> float:
        params = self._whole(self.params if params is None else params)
        if self.population is not None:
            correct, total = self._eval_correct(params, client_idx)
            return correct / max(total, 1)
        xt, yt, nt = self._test_stack
        lo, hi = self._test_rows
        if client_idx is None:
            idx = np.arange(self.n_clients)
        else:
            idx = np.asarray(client_idx)
            if len(idx) == 0:
                return 0.0
            # the ids among this rank's rows (all of them without a mesh)
            mine = idx[(idx >= lo) & (idx < hi)] - lo
            sel = torch.as_tensor(mine.astype(np.int64), device=self.device)
            xt, yt, nt = xt[sel], yt[sel], nt[sel]
        correct = (torch.sum(self._eval_fn(params, xt, yt, nt)) if len(nt)
                   else torch.zeros((), dtype=torch.long, device=self.device))
        if hi - lo != self.n_clients:
            # the test stack is this data slice's block: sum the slices'
            correct = self.mesh.data_sum(correct.long())
        total = self.data.n_test[idx].sum()
        return float(int(correct) / max(total, 1))

    def _add_round(self, t, acc, out) -> RoundMetrics:
        return self._record(t, acc, float(out.mean_loss),
                            float(out.discrepancy), int(out.n_quarantined),
                            alive=int(out.membership.shape[0]))

    def _record(self, t, acc, loss, disc, n_quar, alive=None,
                fields=None) -> RoundMetrics:
        """Add round t to the history: the registry's ``rounds.*``
        counters and, with a telemetry dir, the round's JSONL record
        (``fields``: its state fields when they were read earlier).
        ``alive`` is the cohort's alive count: a round that screened every
        alive update folded the identity (``rounds.empty_folds``)."""
        m = RoundMetrics(t, acc, loss, disc, n_quar)
        self.history.add(m)
        reg = self.registry
        reg.inc("rounds.completed")
        if not math.isnan(acc):
            reg.inc("rounds.evals")
        if m.quarantined:
            reg.inc("rounds.quarantined", m.quarantined)
            if alive is not None and m.quarantined >= alive:
                reg.inc("rounds.empty_folds")
        if self.obs.recording:
            self.obs.round_record(self._round_record(
                m, self._round_fields() if fields is None else fields))
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
        out = ex(self._stacked_group_params(),
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
        ``checkpoint_every`` completed rounds is crossed. With
        ``async_depth >= 1`` the rounds run on the async loop
        (``_run_async``)."""
        if self.population is not None:
            if self._resumed:
                self._resumed = False
            else:
                self.population.reset_stats()
        t = len(self.history.rounds)
        total = t + (n_rounds or self.cfg.n_rounds)
        if self.cfg.async_depth >= 1:
            h = self._run_async(t, total)
            self.obs.finalize(self._summary_extra())
            return h
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
        self.obs.finalize(self._summary_extra())
        return self.history

    # -- asynchronous runtime (FedConfig.async_depth >= 1) -------------------
    def _group_version(self) -> np.ndarray:
        """The (m,) int64 per-group staleness clock: version[g] grows by one
        each time a fold lands clients in group g, and a dispatch's
        staleness is the clock's advance between its dispatch and its fold.
        The population's state table holds it when streaming (shared like
        membership), the trainer when pinned."""
        if self.group_version is None:
            m = self._exec_spec()["n_groups"]
            if self.population is not None:
                self.group_version = \
                    self.population.state.init_group_version(m)
            else:
                self.group_version = np.zeros(m, np.int64)
        return self.group_version

    def _async_executor(self):
        """The pinned dispatch: one ``make_async_dispatch_executor`` step
        against a snapshot carry (the block step, no in-program eval, the
        carry only read), a replayed graph on the card."""
        if self._async_exec is None:
            cfg = self.cfg
            fn = rounds_lib.make_async_dispatch_executor(
                self.model, epochs=cfg.local_epochs,
                batch_size=cfg.batch_size, lr=cfg.lr, mu=cfg.mu,
                max_samples=self._max_samples, quarantine=cfg.quarantine,
                quarantine_mult=cfg.quarantine_mult, mesh=self.mesh,
                **self._block_kwargs())
            self._async_exec = self.obs.wrap(
                "dispatch", parallel_lib.make_async_dispatch_executor(
                    fn, self.mesh, max(1, int(cfg.async_depth))),
                exec="async")
        return self._async_exec

    def _async_host_pre(self):
        """Host work that must precede async staging (FedGroup: the Alg. 3
        group cold start before the first cohort is drawn)."""

    def _async_cold(self, idx) -> np.ndarray:
        """Stage-time host hook; returns the ids whose membership it wrote,
        so the pinned loop writes those rows into the live carry (FedGroup:
        the shift check and eq. 9 for cold newcomers)."""
        return np.empty(0, np.int64)

    def _async_stream_arg(self, idx):
        """The streamed round's assignment argument, built as the
        synchronous ``round()`` builds it."""
        return torch.zeros(len(idx), dtype=torch.long, device=self.device)

    def _async_adopt(self, out, idx, folded_groups, folded_global):
        """Adopt a folded *streamed* dispatch as each trainer's synchronous
        ``round()`` adopts its result, so the weight-1.0 fold (a bitwise
        passthrough) reproduces it."""
        self.params = folded_global

    def _stage_async(self, t: int):
        """Stage one cohort for dispatch: host-pre hook, selection, the
        stage-time hook, the minibatch draws and the communication count,
        in the synchronous paths' order (the draws object is asked once,
        as the per-round path asks it). Returns ``(ids written by the
        hook, staged)``; the staged inputs stay with the lease, so an
        expired one is dispatched again as it was."""
        with self.obs.span("stage", t=t):
            self._async_host_pre()
            idx = self._select()
            cold = np.asarray(self._async_cold(idx))
            if self.population is None:
                idx_p, bidx, alive, _ = self._stage_round(t, idx)
                return cold, (torch.as_tensor(idx_p), bidx,
                              torch.as_tensor(alive))
            x, y, n = self._client_batch(idx)
            bidx = self._batch_indices(n, self._round_executor().max_steps)
            self._stage_comm(len(idx))
            return cold, (np.asarray(idx), x, y, n, bidx,
                          self._async_stream_arg(idx))

    def _ready_event(self):
        """An event recorded on the trainer's current stream after the
        work enqueued so far (None on the CPU, where it is all done)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _lease_ready(self, lease) -> bool:
        """True when a lease's dispatch has finished: its event's
        ``query()`` on the card, always on the CPU (tests patch this to
        script lease expiries)."""
        return lease.metrics is None or lease.metrics.query()

    def _wait_ready(self, lease) -> bool:
        """Poll a lease until ready or past its deadline, the pause backing
        off from 1e-4 s to 5e-3 s; never a synchronize. Readiness is
        checked before the deadline, so a finished dispatch is never
        expired.

        On a mesh each poll's reading is rank 0's (``FedMesh.agree``): a
        lease rank 0 abandons is abandoned by every rank, and one rank 0
        folds is folded by every rank, whose own dispatch then completes
        (its collectives paired with rank 0's)."""
        pause = 1e-4
        while True:
            ready = self._lease_ready(lease)
            expired = not ready and time.monotonic() >= lease.deadline
            if self.mesh is not None:
                state = self.mesh.agree(1 if ready else 2 if expired else 0)
                if state == 1 and not ready and lease.metrics is not None:
                    lease.metrics.synchronize()
                ready, expired = state == 1, state == 2
            if ready:
                return True
            if expired:
                return False
            time.sleep(pause)
            pause = min(pause * 2.0, 0.005)

    def _requeued_index(self, requeued) -> int:
        """The position of the first requeued lease whose backoff has
        elapsed by this process's clock, -1 for none (tests patch this to
        script a backoff)."""
        return requeued.ready_index(time.monotonic())

    def _pop_requeued(self, requeued):
        """The first requeued lease whose backoff has elapsed, by rank 0's
        clock on a mesh, or None."""
        if not requeued:
            return None
        i = self._requeued_index(requeued)
        if self.mesh is not None:
            i = self.mesh.agree(i)
        return None if i < 0 else requeued.pop(i)

    def _async_carry(self) -> dict:
        """The live carry of a pinned async run on the trainer's device.
        The folds write it in place, so the model state gets buffers of its
        own (not the caller's init tensors, not views of each other);
        FeSEM's row buffer is the trainer's already."""
        c = self._carry_in()
        own = lambda d: {k: v.clone() for k, v in d.items()}  # noqa: E731
        return dict(group_params=own(c["group_params"]),
                    global_params=own(c["global_params"]),
                    group_delta=c["group_delta"].clone(),
                    membership=c["membership"].to(self.device),
                    aux=c["aux"])

    def _write_rows(self, membership: torch.Tensor, ids):
        """The host membership of ``ids`` into the live carry's column, in
        stream order (on the card through pinned memory, without a sync)."""
        ids = np.asarray(ids, np.int64)
        ix = torch.as_tensor(ids)
        vals = torch.as_tensor(self.membership[ids]).to(membership.dtype)
        if membership.device.type == "cuda":
            ix, vals = (v.pin_memory().to(membership.device, non_blocking=True)
                        for v in (ix, vals))
        membership.index_put_((ix,), vals)

    @torch.no_grad()
    def _async_eval(self, carry):
        """The fused grouped eval of the folded carry: (correct, total) as a
        (2,) int64 host tensor; on the card a pinned buffer filled without
        a sync (valid once an event recorded after it completes)."""
        xt, yt, nt = self._test_stack
        c, tot = self._grouped_eval(carry["group_params"],
                                    carry["membership"][:-1], xt, yt, nt)
        counts = torch.stack([c, tot]).long()
        if counts.device.type != "cuda":
            return counts
        host = torch.empty(2, dtype=torch.int64, pin_memory=True)
        host.copy_(counts, non_blocking=True)
        return host

    def _run_async(self, t0: int, total: int) -> History:
        """The asynchronous loop: keep up to ``async_depth`` dispatches in
        flight against the live state, fold completed ones FIFO with
        per-group staleness weights, requeue expired leases with capped
        backoff.

        Fold order defines the round index (a requeued cohort folds later
        and becomes a later round), and the eval and checkpoint cadences
        are read at fold time. A checkpoint crossing first drains the
        window, so an archive never holds a lease. Folds are FIFO: on one
        device stream the dispatches run in enqueue order anyway.

        Pinned on the card the loop never waits on the stream: a lease is
        ready when its event is, the fold and the eval are enqueued after
        it, and a folded round's metrics and eval counts come back through
        pinned memory; its ``RoundMetrics`` is added when they have (in
        order, at the latest at a checkpoint and at the end)."""
        cfg = self.cfg
        pop = self.population
        pinned = pop is None
        depth = max(1, int(cfg.async_depth))
        ver = self._group_version()
        st = self.history.async_stats
        shist = st["staleness_hist"]
        self._async_host_pre()
        if pinned:
            exec_ = self._async_executor()
            carry = exec_.bind(self._async_carry())
            fold = parallel_lib.make_async_fold(
                rounds_lib.make_staleness_fold(self._layout), self.mesh)
        else:
            carry, exec_ = None, self._round_executor()
            fold = parallel_lib.make_async_fold(
                rounds_lib.make_param_fold(self._layout), self.mesh)
        policy = leases_lib.RetryPolicy(
            cfg.async_lease_timeout, cfg.async_max_retries,
            cfg.async_backoff, cfg.async_backoff_cap)
        pending = []                 # in-flight leases, FIFO fold order
        requeued = leases_lib.RequeueBuffer()  # expired, backing off
        records = []                 # folded pinned rounds: metrics en route
        t_stage = t0                 # cohorts staged so far
        t_fold = t0                  # rounds folded so far

        def dispatch(staged, attempts):
            if pinned:
                result = exec_(carry, self._train_stack, *staged)
            else:
                result = exec_(self._stacked_group_params(), staged[5],
                               staged[1], staged[2], staged[3], staged[4])
            pending.append(_AsyncLease(
                staged, ver.copy(), result, self._ready_event(),
                time.monotonic() + cfg.async_lease_timeout, attempts))
            st["dispatches"] += 1
            st["max_in_flight"] = max(st["max_in_flight"], len(pending))

        def fill(fresh):
            nonlocal t_stage
            while len(pending) < depth:
                ready = self._pop_requeued(requeued)
                if ready is not None:
                    dispatch(*ready)
                elif fresh and t_stage < total:
                    written, staged = self._stage_async(t_stage)
                    if pinned and len(written):
                        # eq.-9 / shift assignments made on the host: into
                        # the live column, after the dispatches in flight
                        self._write_rows(carry["membership"], written)
                    dispatch(staged, 0)
                    t_stage += 1
                elif requeued and not pending:
                    # nothing in flight, every lease backing off: sleep to
                    # the earliest retry instead of spinning
                    time.sleep(max(0.0, requeued.earliest()
                                   - time.monotonic()))
                else:
                    break

        def fold_one(lease):
            nonlocal t_fold
            t = t_fold
            with self.obs.span("fold", t=t):
                s = (ver - lease.version).astype(np.int64)
                w = rounds_lib.staleness_weight(
                    s, alpha=cfg.async_alpha, beta=cfg.async_beta)
                key = str(int(s.max()) if s.size else 0)
                shist[key] = shist.get(key, 0) + 1
                if self.obs.recording:
                    self._last_staleness = int(s.max()) if s.size else 0
                    self._last_weights = [float(v)
                                          for v in np.asarray(w).ravel()]
                if pinned:
                    d = lease.result
                    mets = d.metrics.numpy().copy()  # ready: lease's event
                    fold(carry, d.result, d.idx, d.alive, w)
                    exec_.release(d)
                    self._carry_refs(carry)
                    alive = lease.staged[2].numpy()
                    mem = mets[3:3 + len(alive)].astype(np.int64)
                    occupied = np.unique(mem[alive > 0])
                    counts = None
                    if self._should_eval(t):
                        with self.obs.span("eval", t=t):
                            counts = self._async_eval(carry)
                    ver[occupied] += 1
                    # the record's state fields as of this fold; the round
                    # is added when its metrics have arrived (flush)
                    fields = (self._round_fields() if self.obs.recording
                              else None)
                    records.append((t, mets[:3], counts, self._ready_event(),
                                    int(alive.sum()), fields))
                else:
                    out = lease.result
                    groups, glob = fold(self._stacked_group_params(),
                                        out.group_params, out.global_params,
                                        w)
                    self._async_adopt(out, lease.staged[0], groups, glob)
                    occupied = np.unique(out.membership.cpu().numpy())
                    acc = self._round_eval(t)
                    ver[occupied] += 1
                    self._add_round(t, acc, out)
                st["folds"] += 1
            t_fold += 1

        def flush(wait):
            """Add the folded pinned rounds whose metrics have arrived."""
            while records:
                t, (loss, disc, n_quar), counts, ev, alive, fields = \
                    records[0]
                if ev is not None and not (wait or ev.query()):
                    return
                if ev is not None:
                    ev.synchronize()
                records.pop(0)
                acc = (float("nan") if counts is None
                       else int(counts[0]) / max(int(counts[1]), 1))
                self._record(t, acc, float(loss), float(disc), int(n_quar),
                             alive=alive, fields=fields)

        def harvest():
            """Fold the FIFO head if it completes within its lease, abandon
            and requeue it with capped backoff otherwise."""
            lease = pending.pop(0)
            if self._wait_ready(lease):
                fold_one(lease)
                return True
            st["lease_expiries"] += 1
            if pop is not None:
                pop._count(lease_expiries=1)
            if pinned:
                exec_.release(lease.result)
            requeued.push(lease, policy, time.monotonic())
            st["requeues"] += 1
            if pop is not None:
                pop._count(requeues=1)
            return False

        while t_fold < total:
            fill(fresh=True)
            prev = t_fold
            if pending and harvest():
                flush(wait=False)
                e = cfg.checkpoint_every
                if e > 0 and cfg.checkpoint_dir and t_fold // e > prev // e:
                    # drain to quiescence first: a checkpoint never holds
                    # an outstanding lease
                    while pending or requeued:
                        fill(fresh=False)
                        if pending:
                            harvest()
                    flush(wait=True)
                    if pinned:
                        self._async_carry_out(carry)
                    self.save_checkpoint()
        flush(wait=True)
        if pinned:
            self._async_carry_out(carry)
        if pop is not None:
            pop.stats["writer_retries"] = pop._writer.retries
        return self.history

    def _async_carry_out(self, carry: dict):
        """``_carry_out`` with the live column fetched (a sync)."""
        self._carry_out(carry, carry["membership"][:-1].cpu().numpy())

    # -- checkpoint / restore ----------------------------------------------
    def _maybe_checkpoint(self, prev_t: int, t: int):
        e = self.cfg.checkpoint_every
        if e > 0 and self.cfg.checkpoint_dir and t // e > prev_t // e:
            self.save_checkpoint()

    def _ckpt_model_tree(self) -> dict:
        """The model state a checkpoint holds, every leaf whole (gathered
        over a model axis: every rank calls it); also the strict load's
        template (a fresh same-config trainer has the same shapes)."""
        return {"params": self._whole(self.params),
                "key": self.draws.get_state()}

    def _ckpt_load_model(self, tree: dict):
        """Adopt a loaded model tree (whole leaves): this rank keeps its
        blocks on a model axis."""
        self.params = self._block(tree["params"])
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

    def _ckpt_state_whole(self, state: dict) -> dict:
        """The ``state`` sub-tree with whatever a rank keeps as its block
        of the model axis gathered whole (a collective on a model axis;
        FedGroup: the cached eq.-9 directions)."""
        return state

    def _ckpt_state_block(self, state: dict) -> dict:
        """``_ckpt_state_whole``'s inverse: this rank's blocks of a loaded
        ``state`` sub-tree."""
        return state

    def save_checkpoint(self, path: str | None = None) -> str:
        """Atomically write the state after ``len(history.rounds)``
        completed rounds to ``path`` (default: ``checkpoint_dir``'s
        ``ckpt_<t>.npz``), in the reference's layout: ``model/*`` (params,
        ``key`` = the draws' state, group state), ``state/*`` (the
        population's scheduler arrays and table rows, framework arrays) and
        the metadata (both numpy streams, history, comm accounting,
        ``extra``, ``group_version``, ``obs`` = the registry's snapshot,
        ``population``). Then prunes to ``checkpoint_keep``.

        On a mesh every rank calls this at the same point: each drains its
        population's writer and, on a model axis, gathers its blocks whole
        over the model group (the parameters and FedGroup's cached
        directions), so the archive holds whole leaves as a single
        controller's does; rank 0 checks that the whole model tree is the
        same on every rank (raising otherwise) and writes the one archive,
        the ranks meet at a barrier on the host group, and rank 0 alone
        prunes."""
        t = len(self.history.rounds)
        if path is None:
            if not self.cfg.checkpoint_dir:
                raise ValueError("pass a path or set FedConfig"
                                 ".checkpoint_dir")
            path = ckpt_io.checkpoint_path(self.cfg.checkpoint_dir, t)
        # counted before the snapshot, so a resumed run's total matches an
        # uninterrupted run's
        self.registry.inc("rounds.checkpoints")
        with self.obs.span("checkpoint", t=t):
            state, pop_meta = {}, None
            if self.population is not None:
                # drains the writer and syncs writer_retries into stats first
                state, pop_meta = self.population.ckpt_state()
            state = self._ckpt_state_whole(
                dict(state, **self._ckpt_state_arrays()))
            meta = {"framework": self.framework, "t": t,
                    "n_clients": int(self.n_clients),
                    "rng": self.rng.bit_generator.state,
                    "select_rng": self.select_rng.bit_generator.state,
                    "comm_params": int(self.comm_params),
                    "history": [[r.round, r.weighted_acc, r.mean_loss,
                                 r.discrepancy, r.quarantined]
                                for r in self.history.rounds],
                    "extra": self._ckpt_meta_extra(),
                    # the async runtime's per-group clocks (a checkpoint never
                    # holds a lease: the async loop drains its window first)
                    "group_version": ([int(v) for v in self.group_version]
                                      if self.group_version is not None
                                      else None),
                    # the registry: async.*, rounds.* and, streamed, pop.*
                    "obs": self.registry.snapshot(),
                    # a coordinator's control-plane snapshot (None alone)
                    "fleet": self._fleet_meta(),
                    "population": pop_meta}
            tree = {"model": self._ckpt_model_tree(), "state": state}
            if self.mesh is not None:
                self.mesh.same_on_every_rank(
                    f"checkpoint at round {t}",
                    ckpt_io._flatten(tree["model"]))
            if mesh_lib.writes(self.mesh):
                ckpt_io.save_pytree(path, tree, meta)
            if self.mesh is not None:
                self.mesh.barrier()       # the archive exists for every rank
        if self.cfg.checkpoint_keep > 0 and self.cfg.checkpoint_dir \
                and mesh_lib.writes(self.mesh):
            # after the atomic write: the newest archive always survives
            ckpt_io.prune_checkpoints(self.cfg.checkpoint_dir,
                                      self.cfg.checkpoint_keep)
        return path

    def _fleet_meta(self):
        """The checkpoint's ``fleet`` metadata: None for a trainer on its
        own; a ``launch.coordinator.Coordinator`` installs its own."""
        return None

    def load_checkpoint(self, path_or_dir: str) -> int:
        """Restore a ``save_checkpoint`` archive (a file, or a directory's
        latest ``ckpt_*.npz``) into this fresh trainer of the same config
        and population construction; returns the completed-round count,
        after which ``run(n)`` continues as the uninterrupted run would.
        Refuses another framework, another client count, a trainer that
        has trained, and a pinned archive in a streamed trainer or the
        reverse. The tensors land on this trainer's device. On a mesh every
        rank reads the same archive of whole leaves and keeps its blocks of
        them on a model axis, so an archive resumes on any mesh shape and
        without a mesh."""
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
        state = self._ckpt_state_block(tree["state"])
        self._ckpt_load_model(tree["model"])
        self._ckpt_apply_extra(meta.get("extra") or {})
        self.rng.bit_generator.state = meta["rng"]
        self.select_rng.bit_generator.state = meta["select_rng"]
        self.comm_params = int(meta["comm_params"])
        self._bind_history(History([RoundMetrics(int(r[0]), float(r[1]),
                                                 float(r[2]), float(r[3]),
                                                 int(r[4]))
                                    for r in meta["history"]]))
        gv = meta.get("group_version")
        if gv is not None:
            self._group_version()[:] = np.asarray(gv, np.int64)
        if self.population is not None:
            self.population.ckpt_restore(state, meta["population"])
        self._ckpt_apply_state(state)
        # the registry's snapshot (pop.* too, the values the population
        # restored); an archive older than the registry carried only its
        # async_stats
        obs = meta.get("obs")
        if obs is None and meta.get("async_stats"):
            obs = {f"async.{k}": v for k, v in meta["async_stats"].items()}
        self.registry.restore(obs or {})
        # drop streamed round records at and after the resume point: the
        # resumed run emits them again, so the JSONL stream stays
        # byte-identical to an uninterrupted run's
        self.obs.resume_at(int(meta["t"]))
        self._resumed = True
        return int(meta["t"])

    def close(self):
        """Stop the population's prefetch thread and state writer (a no-op
        when pinned) and write the telemetry artifacts (``trace.json``,
        ``run_summary.json``; a no-op without ``telemetry_dir``)."""
        if self.population is not None:
            self.population.close()
        self.obs.finalize(self._summary_extra())


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
        self._mig_last = None       # the last membership write's migrations
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
        return self._block({k: v.to(self.device, torch.float32)
                            for k, v in given.items()})

    def _adopt_membership(self, idx, new):
        """Write a cohort's new group assignments, counting migrations
        (previously-assigned clients switching groups)."""
        new = np.asarray(new)
        old = self.membership[idx]
        mig = int(np.sum((old >= 0) & (old != new)))
        self._mig_last = mig
        if mig:
            self.registry.inc("rounds.migrations", mig)
        with self.obs.span("state-write", rows=int(len(new))):
            self.membership[idx] = new

    def _round_fields(self) -> dict:
        rec = super()._round_fields()
        mem = self.membership
        sizes = np.bincount(mem[mem >= 0].astype(np.int64), minlength=self.m)
        rec["group_sizes"] = [int(v) for v in sizes[:self.m]]
        if self._mig_last is not None:
            rec["migrations"] = self._mig_last
            self._mig_last = None
        return rec

    def group_params_whole(self) -> dict:
        """The m-stacked group parameters, whole (gathered over a model
        axis: every rank calls it; the stored state itself otherwise)."""
        return self._whole(self.group_params)

    def group_param(self, j: int) -> dict:
        """The j-th group's parameters, whole (one gather of the stack
        over a model axis: to read several, index ``group_params_whole``)."""
        return server_lib.tree_index(self.group_params_whole(), j)

    def evaluate_groups(self) -> float:
        """Weighted accuracy: each group model on the test data of all
        clients assigned to it (paper §5.1 metric), in one fused pass when
        pinned; streamed, group by group over blocks of the eval ids'
        members."""
        if self.population is not None:
            eval_ids = self.population.eval_ids()
            mem = self.membership[eval_ids]
            groups = self.group_params_whole()
            correct = total = 0
            for j in range(self.m):
                members = eval_ids[mem == j]
                if len(members):
                    c, tot = self._eval_correct(
                        server_lib.tree_index(groups, j), members)
                    correct += c
                    total += tot
            return correct / max(total, 1)
        return self._fused_eval_acc(
            self.group_params,
            torch.as_tensor(self.membership, device=self.device))

    def _round_eval(self, t: int) -> float:
        if not self._should_eval(t):
            return float("nan")
        with self.obs.span("eval", t=t):
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

    def _async_stream_arg(self, idx):
        # the cohort's current group ids (FedGroup's static round, LCFL's
        # hysteresis state); IFCA and FeSEM override
        return torch.as_tensor(self.membership[np.asarray(idx)],
                               device=self.device)

    def _async_adopt(self, out, idx, folded_groups, folded_global):
        # the grouped adoption: group models and the cohort's membership;
        # the consensus params stay as the synchronous round() leaves them
        self.group_params = folded_groups
        self._adopt_membership(idx, out.membership.cpu().numpy())

    # -- checkpoint: m-stacked groups + membership -------------------------
    def _ckpt_model_tree(self) -> dict:
        tree = super()._ckpt_model_tree()
        tree["group_params"] = self.group_params_whole()
        tree["membership"] = np.asarray(self.membership)
        return tree

    def _ckpt_load_model(self, tree: dict):
        super()._ckpt_load_model(tree)
        self.group_params = self._block(tree["group_params"])
        # in place: a population's state table shares this array
        self.membership[:] = tree["membership"]
