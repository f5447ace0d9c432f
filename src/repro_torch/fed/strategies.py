"""The assignment-strategy registry behind the fused round's
``assign_fn`` / ``state_update_fn`` stage, ``repro.fed.strategies``.

Besides IFCA's argmin-loss and FeSEM's argmin-ℓ2 it holds two measures
from the follow-up literature, both on the same fused round:

  fedclust  partial-weight cosine similarity (FedClust, arXiv 2403.04144):
            each client joins the group whose flattened centre is most
            cosine-similar on the trailing ``d_head`` coordinates of the
            flattened weights (the classifier head under JAX's sorted leaf
            order, which ``flatten_stacked`` keeps). Rides FeSEM's
            persistent ``local_flat`` state unchanged.
  lcfl      local-loss assignment with hysteresis (LCFL, arXiv
            2407.09360): the per-client loss under all m models, as IFCA,
            but a client keeps its current group unless a rival beats it
            by more than a multiplicative ``margin``. The state is the
            cohort's current membership row (−1 = never assigned).

``serial_fedclust_assign`` and ``serial_lcfl_assign`` are numpy oracles
(copies of the reference's, which has no JAX in them); the
``serial_*_round`` functions pair them with the per-group solver loop.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import measures
from repro_torch.fed import rounds as rounds_lib
from repro_torch.fed.engine import FedConfig, GroupedTrainer, RoundMetrics
from repro_torch.fed.fesem import FeSEMTrainer, fesem_state_update
from repro_torch.fed.ifca import group_losses
from repro_torch.models.modules import flatten_stacked, flatten_updates

LCFL_INIT_OFFSET = 37   # group inits from seed + 37, as the reference


# ---------------------------------------------------------------------------
# FedClust: partial-weight cosine similarity
# ---------------------------------------------------------------------------
def fedclust_head_dim(d_w: int, frac: float) -> int:
    """Head width: the trailing ``frac`` of the ``d_w`` flattened
    coordinates, at least 1 and at most d_w (``FedConfig.fedclust_frac``)."""
    return max(1, min(int(d_w), int(float(frac) * int(d_w))))


def make_fedclust_assign(d_head: int):
    """Assignment stage: argmax cosine similarity between each selected
    client's local model and the group centres on the trailing ``d_head``
    flattened coordinates. Same state as FeSEM:
    {"local_flat": (n_clients, d_w), "idx": (K,) selected client ids}."""
    def assign(group_params, X, Y, n, state):
        centers = flatten_stacked(group_params)             # (m, d_w)
        local = state["local_flat"][state["idx"]]           # (K, d_w)
        sim = measures.cosine_similarity_matrix(
            local[:, -d_head:], centers[:, -d_head:])       # (K, m)
        return torch.argmax(sim, dim=1)

    return assign


def serial_fedclust_assign(centers, local_flat, d_head: int) -> np.ndarray:
    """Numpy oracle of ``make_fedclust_assign``: row-normalised
    (1e-12-guarded, as ``measures.row_normalize``) trailing-head cosine
    argmax."""
    c = np.asarray(centers, np.float32)[:, -d_head:]
    l = np.asarray(local_flat, np.float32)[:, -d_head:]
    cn = c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-12)
    ln = l / np.maximum(np.linalg.norm(l, axis=1, keepdims=True), 1e-12)
    sim = np.clip(ln @ cn.T, -1.0, 1.0)
    return sim.argmax(1)


@torch.no_grad()
def serial_fedclust_round(batch_solver, group_params_list, local_flat,
                          X, Y, n, idx, *, d_head: int):
    """FedClust with the per-group loop: the numpy partial-weight cosine
    E-step, one solver call per non-empty group, rebuild of the per-client
    flattened-model matrix — the oracle of the fused FedClust round.
    local_flat: (K, d_w) tensor. Returns (new group list, membership, new
    local_flat, discrepancy)."""
    centers = torch.stack([flatten_updates(p) for p in group_params_list])
    membership = serial_fedclust_assign(centers.cpu().numpy(),
                                        local_flat.cpu().numpy(), d_head)
    new_list, disc, finals_by_client = rounds_lib._serial_group_update(
        batch_solver, group_params_list, membership, X, Y, n, idx,
        collect_finals=True)
    new_local = local_flat.clone()
    for i, row in finals_by_client.items():
        new_local[i] = row
    return new_list, membership, new_local, disc


class FedClustTrainer(FeSEMTrainer):
    """FedClust = FeSEM's persistent local-model state + partial-weight
    cosine assignment (FeSEM's group inits, offset 29)."""

    framework = "fedclust"

    def _exec_spec(self) -> dict:
        return {"n_groups": self.m, "eta_g": 0.0,
                "assign_fn": make_fedclust_assign(
                    fedclust_head_dim(self.model_size,
                                      self.cfg.fedclust_frac)),
                "state_update_fn": fesem_state_update}


# ---------------------------------------------------------------------------
# LCFL: local-loss assignment with hysteresis
# ---------------------------------------------------------------------------
def make_lcfl_assign(model, margin: float):
    """Assignment stage: per-client loss under all m stacked models (like
    IFCA), but a client with a current group keeps it unless the best
    rival's loss undercuts it by more than the multiplicative ``margin``
    (fp32: ``cur_loss <= best_loss · (1 + margin)``). state: the cohort's
    (K,) current group ids, −1 = never assigned (takes the argmin)."""
    def assign(group_params, X, Y, n, state):
        losses = group_losses(model, group_params, X, Y, n)   # (m, K)
        m = losses.shape[0]
        best = torch.argmin(losses, dim=0)
        best_loss = torch.amin(losses, dim=0)
        cur = state.long()
        valid = (cur >= 0) & (cur < m)
        cur_c = torch.clamp(cur, 0, m - 1)
        cur_loss = torch.gather(losses, 0, cur_c[None, :])[0]
        keep = valid & (cur_loss <= best_loss * (1.0 + margin))
        return torch.where(keep, cur_c, best)

    return assign


def serial_lcfl_assign(losses, cur, margin: float) -> np.ndarray:
    """Numpy oracle of the LCFL hysteresis rule. losses: (m, K)
    per-client losses under each group model; cur: (K,) current ids."""
    losses = np.asarray(losses)
    m = losses.shape[0]
    best = losses.argmin(0)
    best_loss = losses.min(0)
    cur = np.asarray(cur)
    valid = (cur >= 0) & (cur < m)
    cur_c = np.clip(cur, 0, m - 1)
    cur_loss = np.take_along_axis(losses, cur_c[None, :], axis=0)[0]
    keep = valid & (cur_loss <= best_loss * (1.0 + margin))
    return np.where(keep, cur_c, best).astype(np.int64)


@torch.no_grad()
def serial_lcfl_round(batch_solver, loss_fn, group_params_list, cur,
                      X, Y, n, idx, *, margin: float):
    """LCFL with the per-group loop: one loss call per group, the numpy
    hysteresis rule, one solver call per non-empty group — the oracle of
    the fused LCFL round. Returns (new group list, membership,
    discrepancy)."""
    losses = np.stack([loss_fn(p, X, Y, n).cpu().numpy()
                       for p in group_params_list])
    membership = serial_lcfl_assign(losses, cur, margin)
    new_list, disc, _ = rounds_lib._serial_group_update(
        batch_solver, group_params_list, membership, X, Y, n, idx)
    return new_list, membership, disc


class LCFLTrainer(GroupedTrainer):
    """Loss-driven clustering with hysteresis: IFCA's m-model broadcast and
    loss argmin plus a stickiness margin read from the membership column.
    ``init_group_params`` (an m-stacked dict) replaces the random centres;
    the other keywords are ``FedAvgTrainer``'s."""

    framework = "lcfl"

    def __init__(self, model, data, cfg: FedConfig, init_group_params=None,
                 **kw):
        super().__init__(model, data, cfg, **kw)
        self.group_params = self._random_groups(LCFL_INIT_OFFSET,
                                                init_group_params)

    def _exec_spec(self) -> dict:
        return {"n_groups": self.m, "eta_g": 0.0,
                "assign_fn": make_lcfl_assign(self.model,
                                              self.cfg.lcfl_margin)}

    def _stage_comm(self, k: int):
        # like IFCA: the client needs every group model to score it
        self.comm_params += (self.m + 1) * k * self.model_size

    def _block_kwargs(self) -> dict:
        kw = dict(self._exec_spec())
        # a round's state = the carried membership's cohort rows (padded
        # lanes read the trash row, whose -1 means "never assigned"; they
        # aggregate with weight 0 regardless)
        kw["make_state"] = lambda aux, idx, mem: mem[idx]
        return kw

    def round(self, t: int, idx=None) -> RoundMetrics:
        if idx is None:
            idx = self._select()
        # like IFCA: the client needs every group model to score it
        self.comm_params += (self.m + 1) * len(idx) * self.model_size
        x, y, n = self._client_batch(idx)
        ex = self._round_executor()
        cur = torch.as_tensor(self.membership[idx], device=self.device)
        out = ex(self.group_params, cur, x, y, n,
                 self._batch_indices(n, ex.max_steps))
        self.group_params = out.group_params
        self._adopt_membership(idx, out.membership.cpu().numpy())
        return self._add_round(t, self._round_eval(t), out)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
class StrategySpec(NamedTuple):
    """One registered assignment strategy.

    state_kind names the shape of the ``assign_fn``'s state argument:
      "static"      no assign_fn — membership is fixed server state
      "none"        assign_fn ignores its state (IFCA)
      "membership"  (K,) current group ids, −1 = cold (LCFL)
      "local_flat"  {"local_flat": (N, d_w), "idx": (K,)} (FeSEM, FedClust)
    """
    name: str
    trainer: type
    state_kind: str
    make_assign: Callable | None    # (model, d_w, cfg) -> assign_fn
    description: str


_REGISTRY: dict[str, StrategySpec] = {}


def register(spec: StrategySpec) -> StrategySpec:
    if spec.state_kind not in ("static", "none", "membership", "local_flat"):
        raise ValueError(f"unknown state_kind {spec.state_kind!r}")
    if spec.name in _REGISTRY:
        raise ValueError(f"strategy {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_strategy(name: str) -> StrategySpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; available: "
                       f"{available_strategies()}") from None


def available_strategies() -> list:
    return sorted(_REGISTRY)


def make_trainer(name: str, model, data, cfg: FedConfig, **kw):
    """Construct the registered strategy's trainer; ``kw`` goes to it
    (``device=``, ``draws=``, ``init_params=``, and ``init_group_params=``
    for the strategies that start from random centres)."""
    return get_strategy(name).trainer(model, data, cfg, **kw)


def _register_builtin():
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.fed.fesem import make_fesem_assign
    from repro_torch.fed.ifca import IFCATrainer, make_ifca_assign

    register(StrategySpec(
        "static", FedGroupTrainer, "static", None,
        "FedGroup eq.-9 cold-start assignment, static thereafter "
        "(optionally shift-migrated via FedConfig.shift_threshold)"))
    register(StrategySpec(
        "ifca", IFCATrainer, "none",
        lambda model, d_w, cfg: make_ifca_assign(model),
        "per-round argmin mean local loss over all m models"))
    register(StrategySpec(
        "fesem", FeSEMTrainer, "local_flat",
        lambda model, d_w, cfg: make_fesem_assign(),
        "argmin-l2 E-step of local models against flattened centers"))
    register(StrategySpec(
        "fedclust", FedClustTrainer, "local_flat",
        lambda model, d_w, cfg: make_fedclust_assign(
            fedclust_head_dim(d_w, cfg.fedclust_frac)),
        "argmax partial-weight (trailing-head) cosine similarity"))
    register(StrategySpec(
        "lcfl", LCFLTrainer, "membership",
        lambda model, d_w, cfg: make_lcfl_assign(model, cfg.lcfl_margin),
        "argmin local loss with multiplicative hysteresis margin"))


_register_builtin()
