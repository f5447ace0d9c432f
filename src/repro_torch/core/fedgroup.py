"""FedGroup / FedGrouProx — the paper's contribution (Algorithms 2 & 3),
``repro.core.fedgroup`` on the pinned synchronous path.

  * group cold start  (Alg. 3): pre-train α·m clients one ClientUpdate from
    w0, flatten updates into ΔW, then either
      - EDC branch:  V = truncatedSVD(ΔWᵀ, m); embed E = K(ΔW, Vᵀ) with the
                     ``edc_cosine`` kernel; K-Means++ on E     (eq. 8)
      - MADC branch: M = K(ΔW, ΔW); MADC proximity with the ``madc``
                     kernel; hierarchical complete linkage     (eq. 7)
  * client cold start (eq. 9): a newcomer takes one pre-training update
    from the auxiliary global model and joins argmin_j of the normalized
    cosine dissimilarity to the group's latest update direction.
  * training round    (Alg. 2): one call of the fused round
    (``fed.rounds``) over all m groups.
  * ablations: RCC (random cluster centres), RAC (randomly assign cold).

Group membership is static once assigned, unless
``FedConfig.shift_threshold`` turns on the shift detector: every
``shift_check_every``-th round, each assigned cohort client with a cached
eq.-9 direction is probed with one pre-training pass from the auxiliary
global model; a client whose fresh direction drifted past the threshold
(``(1 - cos)/2``) has its cached row invalidated, the fresh one cached, and
is re-routed by eq. 9 against the groups' update directions (a migration).

Round blocks (``block_size > 1``) break on host events: the Alg. 3 cold
start before the first round, a cohort with cold newcomers (eq. 9), and
every round while the shift detector is on, which pins the trainer to the
per-round path. The async runtime (``async_depth >= 1``) runs Alg. 3
before its first stage, and the shift check and eq. 9 at stage time on the
state of the last fold; the rows they assign go into the live carry,
while the dispatches in flight keep their snapshot.

A checkpoint adds the groups' update directions (``group_delta``, zeros
before the cold start), the cold-start flags and the shift detector's
clock, and the pinned direction cache as ``state/fg_dir_*``: a resumed
trainer does not run Alg. 3 again.

On a data mesh (``mesh=``, ``fed.engine``) the cold starts' pre-training
solves run sharded over the ranks and, on a 1-D mesh, ΔW (at FEMNIST
MLP-512, n_pre × 415,258 fp32) is gathered onto every rank; EDC
(``edc_cosine``) or MADC (``madc``) then runs on every rank with the same
injected draws, and the labels are checked equal to rank 0's. On a model
axis each rank receives only its d_w block of ΔW (``FedMesh.model_cols``,
``gather_cols``): the randomized SVD's products and E's packed sums
(``edc_cosine``'s partial-sum entry), MADC's Gram, eq. 9's cosines
against ``group_delta`` and the shift detector's drifts are summed over
the model group, MADC's ``madc`` kernel runs on the replicated M, the
groups' mean updates are gathered whole over the model group (m × d_w),
and the cached eq.-9 directions are this rank's blocks; a checkpoint
gathers them whole (the archive holds whole rows, as one device's) and a
resumed rank keeps its columns.

With a streamed population (``population=``) the Alg. 3 founders are
drawn from the scheduler's active clients only, the newcomers its arrival
process activates are routed by eq. 9 in the round they arrive, and every
cold-started client's pre-training direction is cached in the
population's host state table (which the shift detector then reads).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cluster as cluster_lib
from repro_torch.core import measures
from repro_torch.core.svd import OVERSAMPLE, sharded
from repro_torch.fed import client as client_lib
from repro_torch.fed.engine import FedConfig, GroupedTrainer, RoundMetrics
from repro_torch.fed.store import _LazyRows
from repro_torch.models.modules import unflatten_stacked


def shift_drift(fresh: torch.Tensor, cached: torch.Tensor, mesh=None
                ) -> torch.Tensor:
    """(c,) normalised cosine dissimilarity (1 − cos)/2 between each
    client's fresh and cached update direction, 1e-12-guarded. With a
    model-axis ``mesh`` the rows are d-blocks: the dots and squared norms
    are summed over the model group first."""
    if not sharded(mesh):
        dot = torch.sum(fresh * cached, dim=1)
        den = (torch.linalg.norm(fresh, dim=1)
               * torch.linalg.norm(cached, dim=1))
    else:
        dot, a, b = mesh.model_sum(torch.stack([
            torch.sum(fresh * cached, dim=1), torch.sum(fresh * fresh, dim=1),
            torch.sum(cached * cached, dim=1)]))
        den = torch.sqrt(a) * torch.sqrt(b)
    return (1.0 - dot / torch.clamp(den, min=1e-12)) / 2.0


class FedGroupTrainer(GroupedTrainer):
    framework = "fedgroup"

    def __init__(self, model, data, cfg: FedConfig, **kw):
        super().__init__(model, data, cfg, **kw)
        # group state: param dict stacked over the group axis + (m, d_w)
        # latest flattened update direction Δw^(g)
        self.group_params = self._block(
            {k: torch.stack([p] * self.m)
             for k, p in self._whole(self.params).items()})
        self.group_delta = None
        # 1-epoch pre-training solver for newcomer cold start (the paper:
        # pre-training does not occupy a whole round)
        self.pretrain_solver = client_lib.make_batch_solver(
            model, epochs=1, batch_size=cfg.batch_size, lr=cfg.lr, mu=0.0,
            max_samples=self._max_samples)
        self.cold_started = False
        self.last_cold = 0          # newcomers cold-started last round
        # shift detector (FedConfig.shift_threshold): the direction cache
        # (made at its first write), the check-cadence clock, and the last
        # check's (probed, migrated) and migrated ids
        self._pin_dirs = None
        self._shift_tick = 0
        self._shift_last = (0, 0)
        self._last_shifted = np.empty(0, np.int64)

    def _exec_spec(self) -> dict:
        return {"n_groups": self.m, "eta_g": self.cfg.eta_g}

    @property
    def _d_axis(self):
        """The mesh the d-sharded measures sum over: the trainer's on a
        model axis, None otherwise."""
        return None if self._layout is None else self.mesh

    def _cols(self, t: torch.Tensor) -> torch.Tensor:
        """A whole (·, d_w) tensor's block of this rank's d_w columns on a
        model axis (the columns ``_solve_flat`` gives it); ``t``
        otherwise."""
        if self._layout is None:
            return t
        lo, hi = self.mesh.model_cols(t.shape[1])
        return t[:, lo:hi].contiguous()

    # ------------------------------------------------------------------
    # Cached eq.-9 directions: the population's host state table when
    # streaming; pinned, a trainer-owned lazy table on the trainer's
    # device, made only when the detector is on
    # ------------------------------------------------------------------
    def _shift_enabled(self) -> bool:
        return self.cfg.shift_threshold is not None

    def _caches_dirs(self) -> bool:
        return self.population is not None or self._shift_enabled()

    def _set_dirs(self, idx, rows: torch.Tensor):
        if self.population is not None:
            self.population.state.set_pretrain_dir(idx, rows)
            return
        if self._pin_dirs is None:
            self._pin_dirs = _LazyRows(rows.new_zeros(rows.shape[-1]))
        self._pin_dirs.scatter(idx, rows)

    def _has_dirs(self, idx) -> np.ndarray:
        if self.population is not None:
            return self.population.state.has_pretrain_dir(idx)
        if self._pin_dirs is None:
            return np.zeros(len(np.asarray(idx)), bool)
        return self._pin_dirs.has(idx)

    def _get_dirs(self, idx) -> torch.Tensor:
        if self.population is not None:
            return self.population.state.get_pretrain_dir(idx).to(
                self.device)
        return self._pin_dirs.gather(idx)

    def _invalidate_dirs(self, idx):
        if self.population is not None:
            self.population.state.invalidate_pretrain_dir(idx)
        elif self._pin_dirs is not None:
            self._pin_dirs.delete(idx)

    # ------------------------------------------------------------------
    # Group cold start (Algorithm 3)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def group_cold_start(self):
        cfg = self.cfg
        if self.population is not None:
            # founders from the active clients only: the ones yet to arrive
            # are routed by eq. 9, round by round, as they appear
            pool = self.population.scheduler.active_ids()
            n_pool = len(pool)
        else:
            pool = n_pool = self.n_clients
        n_pre = min(cfg.pretrain_scale * self.m, n_pool)
        pre_idx = self.rng.choice(pool, n_pre, replace=False)
        # (n_pre, d_w): this rank's d_w block of it on a model axis
        dW = self._solve_flat(pre_idx)
        self.comm_params += 2 * len(pre_idx) * self.model_size

        if cfg.rcc:                                            # ablation
            labels = self.rng.integers(0, self.m, n_pre)
        elif cfg.measure == "edc":
            omega = self.draws.svd_omega(
                n_pre, min(self.m + OVERSAMPLE, n_pre), self.device)
            E, _ = measures.edc_embed(dW, self.m, omega=omega,
                                      mesh=self._d_axis)
            seeds = self.draws.kmeans_seeds(E, self.m)
            assign, _ = cluster_lib.kmeans_pp(E, self.m, seed_idx=seeds)
            labels = assign.cpu().numpy()
        elif cfg.measure == "madc":
            M = measures.cosine_similarity_matrix(dW, mesh=self._d_axis)
            Mp = measures.madc(M)
            labels = cluster_lib.hierarchical(Mp.cpu().numpy(), self.m)
        else:
            raise ValueError(cfg.measure)
        if self.mesh is not None:
            # every rank clustered ΔW (on a model axis its replicated
            # sums) with the same injected draws; a rank that reached
            # other labels has diverged
            self.mesh.same_on_every_rank("the group cold start's labels",
                                         np.asarray(labels, np.int64))

        self._adopt_membership(pre_idx, labels)
        # segment mean over pre-trained clients: W[j, i] = 1/|G_j| for
        # members, zero rows for empty groups (they stay at w0 with Δ = 0)
        W = np.zeros((self.m, n_pre), np.float32)
        for j in range(self.m):
            members = np.where(labels == j)[0]
            if len(members):
                W[j, members] = 1.0 / len(members)
        Wj = torch.as_tensor(W, device=self.device)
        # the groups' mean updates (m, d_w), whole: on a model axis each
        # rank's columns, gathered over the model group
        mean = Wj @ dW
        if self._layout is not None:
            mean = self.mesh.model_gather(mean, 1, self.model_size)
        self.group_delta = mean
        params = self._whole(self.params)
        mean_delta = unflatten_stacked(mean, params)
        self.group_params = self._block(
            {k: p[None] + mean_delta[k] for k, p in params.items()})
        if self._caches_dirs():
            # the Alg.-3 founders are as shift-detectable as newcomers
            self._set_dirs(pre_idx, dW)
        self.cold_started = True
        return pre_idx, labels

    # ------------------------------------------------------------------
    # Client cold start (eq. 9)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def client_cold_start(self, cold_idx: np.ndarray):
        if len(cold_idx) == 0:
            return
        self.registry.inc("rounds.cold_started", len(cold_idx))
        if self.cfg.rac:                                       # ablation
            self._adopt_membership(
                cold_idx, self.rng.integers(0, self.m, len(cold_idx)))
            return
        # (c, d_w): this rank's d_w block of it on a model axis
        dpre = self._solve_flat(cold_idx, solver=self.pretrain_solver)
        if self._caches_dirs():
            self._set_dirs(cold_idx, dpre)
        sim = measures.cosine_similarity_matrix(
            dpre, self._cols(self.group_delta), mesh=self._d_axis)
        dis = (-sim + 1.0) / 2.0                               # (c, m)
        self._adopt_membership(cold_idx,
                               torch.argmin(dis, dim=1).cpu().numpy())

    # ------------------------------------------------------------------
    # Shift detection + migration (FedConfig.shift_threshold)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _maybe_shift(self, idx) -> np.ndarray:
        """Probe the cohort's assigned, direction-cached clients for
        distribution shift and migrate the drifted ones through eq. 9.

        One pre-training pass from the auxiliary global model per probed
        client (1 model down + 1 update up). A drifted client's stale row
        is invalidated first, then the fresh direction cached, then the
        client re-assigned against the groups' update directions through
        ``_adopt_membership`` (which counts migrations). Only every
        ``shift_check_every``-th tick probes; the others ask ``draws`` for
        nothing. Returns the migrated client ids."""
        cfg = self.cfg
        none = np.empty(0, np.int64)
        self._last_shifted = none
        if not self._shift_enabled() or not self.cold_started \
                or self.group_delta is None:
            return none
        tick = self._shift_tick
        self._shift_tick += 1
        if tick % max(int(cfg.shift_check_every), 1) != 0:
            return none
        idx = np.asarray(idx)
        assigned = idx[self.membership[idx] >= 0]
        checked = assigned[self._has_dirs(assigned)]
        self._shift_last = (len(checked), 0)
        if len(checked) == 0:
            return none
        self.registry.inc("rounds.shift_checks", len(checked))
        self.comm_params += 2 * len(checked) * self.model_size
        # (c, d_w): this rank's d_w block of it on a model axis
        fresh = self._solve_flat(checked, solver=self.pretrain_solver)
        drift = shift_drift(fresh, self._get_dirs(checked), self._d_axis)
        moved = (drift > float(cfg.shift_threshold)).cpu().numpy()
        shifted = checked[moved].astype(np.int64)
        self._shift_last = (len(checked), len(shifted))
        if len(shifted) == 0:
            return none
        fresh_moved = fresh[torch.as_tensor(np.flatnonzero(moved),
                                            device=fresh.device)]
        self._invalidate_dirs(shifted)
        self._set_dirs(shifted, fresh_moved)
        sim = measures.cosine_similarity_matrix(
            fresh_moved, self._cols(self.group_delta), mesh=self._d_axis)
        dis = (-sim + 1.0) / 2.0
        self._adopt_membership(shifted,
                               torch.argmin(dis, dim=1).cpu().numpy())
        self._last_shifted = shifted
        return shifted

    # ------------------------------------------------------------------
    # Round-block staging: blocks break on host events (Alg. 3 cold start,
    # eq.-9 newcomers in a staged cohort); membership is static otherwise
    # ------------------------------------------------------------------
    def _host_round_pre(self) -> bool:
        # shift detection is host work between every round, so an enabled
        # detector pins the trainer to the per-round path (no blocks)
        return not self.cold_started or self._shift_enabled()

    def _needs_host(self, idx) -> bool:
        return bool((self.membership[np.asarray(idx)] < 0).any())

    def _carry_group_delta(self):
        # set by group_cold_start, which _host_round_pre runs first
        return self.group_delta

    def _carry_refs(self, carry: dict):
        super()._carry_refs(carry)
        self.group_delta = carry["group_delta"]

    # ------------------------------------------------------------------
    # Async runtime hooks: Alg. 3 before the first stage, then at stage
    # time the shift check and eq. 9 (round()'s host segment)
    # ------------------------------------------------------------------
    def _async_host_pre(self):
        if not self.cold_started:
            self.group_cold_start()

    def _async_cold(self, idx) -> np.ndarray:
        # eq. 9 routes by the auxiliary model and update directions of the
        # last fold (the trainer's state points at the live carry)
        idx = np.asarray(idx)
        shifted = self._maybe_shift(idx)
        cold = idx[self.membership[idx] < 0]
        self.last_cold = len(cold)
        self.comm_params += 2 * len(cold) * self.model_size
        self.client_cold_start(cold)
        return np.concatenate([shifted, cold]) if len(shifted) else cold

    def _async_adopt(self, out, idx, folded_groups, folded_global):
        super()._async_adopt(out, idx, folded_groups, folded_global)
        self.group_delta = out.group_delta_flat
        self.params = folded_global

    # ------------------------------------------------------------------
    # Checkpoint: + eq.-9 update directions, cold-start flags, the pinned
    # direction cache
    # ------------------------------------------------------------------
    def _ckpt_model_tree(self) -> dict:
        tree = super()._ckpt_model_tree()
        # zeros before the cold start keep the archive's keys fixed;
        # "has_group_delta" in the metadata says which it was
        tree["group_delta"] = self.group_delta \
            if self.group_delta is not None \
            else torch.zeros((self.m, self.model_size), device=self.device)
        return tree

    def _ckpt_load_model(self, tree: dict):
        super()._ckpt_load_model(tree)
        self.group_delta = tree["group_delta"]

    def _ckpt_meta_extra(self) -> dict:
        return {"cold_started": bool(self.cold_started),
                "last_cold": int(self.last_cold),
                "has_group_delta": self.group_delta is not None,
                "shift_tick": int(self._shift_tick)}

    def _ckpt_apply_extra(self, extra: dict):
        self.cold_started = bool(extra["cold_started"])
        self.last_cold = int(extra["last_cold"])
        if not extra["has_group_delta"]:
            self.group_delta = None
        self._shift_tick = int(extra.get("shift_tick", 0))

    def _ckpt_state_arrays(self) -> dict:
        # the population's rows checkpoint through its state table
        out = super()._ckpt_state_arrays()
        if self._pin_dirs is not None:
            for k, v in self._pin_dirs.ckpt_arrays().items():
                out[f"fg_dir_{k}"] = v
        return out

    def _ckpt_apply_state(self, arrays: dict):
        super()._ckpt_apply_state(arrays)
        if "fg_dir_ids" in arrays:
            self._pin_dirs = _LazyRows.from_ckpt(
                {k: arrays[f"fg_dir_{k}"] for k in ("ids", "rows", "default")},
                device=self.device)

    # the direction tables a checkpoint holds: the pinned cache
    # (``fg_dir_*``) and a streamed population's state table's
    # (``pretrain_dir_*``), each {ids, rows, default}
    _DIR_TABLES = ("fg_dir", "pretrain_dir")

    def _ckpt_state_whole(self, state: dict) -> dict:
        # on a model axis a rank caches its d_w block of each direction
        # (the same ids on every rank): the rows and the default gathered
        # whole over the model group, in one collective a table
        state = super()._ckpt_state_whole(state)
        if self._layout is None:
            return state
        out = dict(state)
        for t in self._DIR_TABLES:
            if f"{t}_rows" not in state:
                continue
            rows = torch.as_tensor(np.concatenate(
                [state[f"{t}_default"][None], state[f"{t}_rows"]]),
                device=self.device)
            whole = self.mesh.model_gather(rows, 1,
                                           self.model_size).cpu().numpy()
            out[f"{t}_default"], out[f"{t}_rows"] = whole[0], whole[1:]
        return out

    def _ckpt_state_block(self, state: dict) -> dict:
        state = super()._ckpt_state_block(state)
        if self._layout is None:
            return state
        out = dict(state)
        lo, hi = self.mesh.model_cols(self.model_size)
        for t in self._DIR_TABLES:
            if f"{t}_rows" in state:
                out[f"{t}_rows"] = np.ascontiguousarray(
                    state[f"{t}_rows"][:, lo:hi])
                out[f"{t}_default"] = np.ascontiguousarray(
                    state[f"{t}_default"][lo:hi])
        return out

    def _round_fields(self) -> dict:
        rec = super()._round_fields()
        rec["cold"] = int(self.last_cold)
        rec["eta_g"] = float(self.cfg.eta_g)
        if self._shift_enabled():
            checked, migrated = self._shift_last
            rec["shift_checked"] = int(checked)
            rec["shift_migrations"] = int(migrated)
        return rec

    # ------------------------------------------------------------------
    # Round (Algorithm 2) — one fused call over all groups
    # ------------------------------------------------------------------
    def round(self, t: int, idx=None) -> RoundMetrics:
        if not self.cold_started:
            self.group_cold_start()

        if idx is None:
            idx = self._select()
        idx = np.asarray(idx)
        self._maybe_shift(idx)
        cold = idx[self.membership[idx] < 0]
        self.last_cold = len(cold)
        # cold start: 1 global model down + 1 pretrain update up per newcomer
        self.comm_params += 2 * len(cold) * self.model_size
        self.client_cold_start(cold)
        # per-round: 1 group model down + 1 update up per client
        self.comm_params += 2 * len(idx) * self.model_size

        x, y, n = self._client_batch(idx)
        ex = self._round_executor()
        bidx = self._batch_indices(n, ex.max_steps)
        out = ex(self.group_params,
                 torch.as_tensor(self.membership[idx], device=self.device),
                 x, y, n, bidx)
        self.group_params = out.group_params
        self.group_delta = out.group_delta_flat
        # auxiliary global model: unweighted average of group models
        self.params = out.global_params
        return self._add_round(t, self._round_eval(t), out)


class FedGrouProxTrainer(FedGroupTrainer):
    """FedGroup + FedProx local solver (the paper's FedGrouProx)."""
    framework = "fedgrouprox"

    def __init__(self, model, data, cfg: FedConfig, **kw):
        if cfg.mu <= 0:
            cfg = dataclasses.replace(cfg, mu=0.01)
        super().__init__(model, data, cfg, **kw)
