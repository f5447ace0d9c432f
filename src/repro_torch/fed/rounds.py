"""The fused round (Algorithm 2 hot path), ``repro.fed.rounds``.

Group parameters live as a param dict stacked with leading axis ``m``;
each selected client gathers its group's parameters, the local solver runs
batched over the client axis, and per-group aggregation is a segment-sum
(one-hot matmul). Inter-group aggregation (η_G, Alg. 2 lines 17-19), the
auxiliary global model, the flattened per-group update directions and the
eq.-4 discrepancy are computed in the same function, so

  * ``FedAvgTrainer`` / ``FedProxTrainer`` run it with m=1,
  * ``FedGroupTrainer`` / ``FedGrouProxTrainer`` with m=n_groups.

The block, async and staleness executors and the dynamic-assignment stage
(IFCA/FeSEM) are not yet ported (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from repro_torch.fed import client as client_lib
from repro_torch.models.modules import flatten_stacked, leaf_keys


class RoundOutput(NamedTuple):
    group_params: dict        # m-stacked: post-η_G group models
    global_params: dict       # auxiliary global model (mean of groups)
    agg_delta: dict           # m-stacked: intra-group FedAvg Δ
    group_delta_flat: object  # (m, d_w) flattened w_g^{t+1} − w_g^t
    discrepancy: object       # scalar: mean_i ||w_i^final − w̃_{g(i)}||
    membership: object        # (K,) int64 group id used this round
    mean_loss: object = 0.0   # scalar: n_i-weighted mean local train loss
                              # of the clients' final local models
    n_quarantined: object = 0  # scalar: alive clients whose updates were
                               # screened out this round


def _bcast(v, t):
    return v.reshape((-1,) + (1,) * (t.ndim - 1))


def _row_sq(tree: dict, K: int) -> torch.Tensor:
    """Per-row squared norm over all leaves of a K-stacked dict -> (K,)."""
    return sum(torch.sum(torch.square(tree[k].reshape(K, -1)), dim=1)
               for k in leaf_keys(tree))


def _make_round_core(model, *, epochs: int, batch_size: int, lr: float,
                     mu: float, n_groups: int, max_samples: int,
                     eta_g: float = 0.0, quarantine: bool = False,
                     quarantine_mult: float = 10.0):
    """The fused round as a function with an explicit per-client ``alive``
    weight. A client with ``alive == 0`` still runs the batched solver but
    contributes nothing to the aggregation, the mean loss, or the
    discrepancy.

    ``quarantine`` screens a client whose local delta is non-finite or
    whose delta norm exceeds ``quarantine_mult`` × the cohort median into
    the zero-weight path: its delta is zeroed, its final local model is
    replaced by its group's round-start parameters, and its alive weight
    drops to 0 before any reduction (``0 * NaN = NaN``, so zero weight
    alone is not enough)."""
    m = n_groups
    solve = client_lib.make_local_solver(
        model, epochs=epochs, batch_size=batch_size, lr=lr, mu=mu,
        max_samples=max_samples)
    loss_many = vmap(client_lib.client_mean_loss(model))

    def core(group_params, membership, X, Y, n, idx, alive) -> RoundOutput:
        membership = membership.long()
        # each client trains from ITS group's parameters (one gather)
        my_params = {k: g[membership] for k, g in group_params.items()}
        deltas, finals = solve(my_params, X, Y, n, idx)

        K = membership.shape[0]
        ok = None
        n_quarantined = torch.zeros((), dtype=torch.int32, device=X.device)
        if quarantine:
            d_sq = _row_sq(deltas, K)
            finite = torch.isfinite(d_sq)
            norms = torch.sqrt(torch.where(finite, d_sq, 0.0))
            # median over the alive, finite updates. jnp.nanmedian averages
            # the two middle values of an even count; torch.nanmedian
            # returns the lower one, nanquantile(0.5) interpolates like jnp
            med = torch.nanquantile(
                torch.where((alive > 0) & finite, norms,
                            torch.full_like(norms, float("nan"))), 0.5)
            outlier = norms > quarantine_mult * torch.clamp(med, min=1e-12)
            ok = finite & ~outlier
            n_quarantined = torch.sum((alive > 0) & ~ok).to(torch.int32)
            deltas = {k: torch.where(_bcast(ok, d), d, 0.0)
                      for k, d in deltas.items()}
            finals = {k: torch.where(_bcast(ok, f), f, my_params[k])
                      for k, f in finals.items()}
            alive = alive * ok.to(alive.dtype)

        # intra-group FedAvg (Alg. 2): segment-sum with n_i weights
        # normalized within each group
        onehot = torch.nn.functional.one_hot(membership, m).float()  # (K, m)
        w = n.float() * alive
        group_tot = onehot.T @ w                                    # (m,)
        norm_w = w[:, None] * onehot / torch.clamp(group_tot[None],
                                                   min=1e-9)
        agg_delta = {k: (norm_w.T @ d.reshape(K, -1)).reshape(
            (m,) + tuple(d.shape[1:])) for k, d in deltas.items()}
        occupied = (group_tot > 0).float()
        tilde = {k: gp + _bcast(occupied, gp) * agg_delta[k]
                 for k, gp in group_params.items()}

        # mean local training loss of the final local models
        per_client_loss = loss_many(finals, X, Y, n)
        if ok is not None:
            # a quarantined client's batch may itself be poisoned
            per_client_loss = torch.where(ok, per_client_loss, 0.0)
        mean_loss = torch.sum(per_client_loss * w) / torch.clamp(
            torch.sum(w), min=1e-9)

        # eq. 4 discrepancy: each client vs its group's aggregated model
        disc_sq = sum(torch.sum(torch.square(
            (finals[k] - tilde[k][membership]).reshape(K, -1)), dim=1)
            for k in leaf_keys(finals))
        discrepancy = torch.sum(torch.sqrt(disc_sq) * alive) / torch.clamp(
            torch.sum(alive), min=1e-9)

        # inter-group aggregation (Alg. 2 lines 17-19), stacked form
        if eta_g > 0.0 and m > 1:
            norms = torch.clamp(torch.sqrt(_row_sq(tilde, m)), min=1e-12)

            def inter(t):
                nm = t / _bcast(norms, t)
                return t + eta_g * (torch.sum(nm, 0, keepdim=True) - nm)

            new_groups = {k: inter(t) for k, t in tilde.items()}
        else:
            new_groups = tilde

        global_params = {k: torch.mean(g, dim=0)
                         for k, g in new_groups.items()}
        group_delta_flat = flatten_stacked(
            {k: new_groups[k] - group_params[k] for k in new_groups})
        return RoundOutput(new_groups, global_params, agg_delta,
                           group_delta_flat, discrepancy, membership,
                           mean_loss, n_quarantined)

    core.max_steps = solve.max_steps
    return core


def make_round_executor(model, *, epochs: int, batch_size: int, lr: float,
                        mu: float, n_groups: int, max_samples: int,
                        eta_g: float = 0.0, quarantine: bool = False,
                        quarantine_mult: float = 10.0):
    """Returns round_fn(group_params, membership, X, Y, n, idx) ->
    RoundOutput.

    group_params: dict with leading axis m; membership: (K,) group id per
    selected client; X: (K, max_n, ...); Y: (K, max_n); n: (K,); idx:
    (K, max_steps, B) minibatch rows (``round_fn.max_steps``).
    ``quarantine=True`` screens non-finite / norm-outlier client updates
    into the zero-weight path (see ``_make_round_core``)."""
    core = _make_round_core(
        model, epochs=epochs, batch_size=batch_size, lr=lr, mu=mu,
        n_groups=n_groups, max_samples=max_samples, eta_g=eta_g,
        quarantine=quarantine, quarantine_mult=quarantine_mult)

    @torch.no_grad()
    def round_fn(group_params, membership, X, Y, n, idx) -> RoundOutput:
        alive = torch.ones(n.shape[0], dtype=torch.float32, device=X.device)
        return core(group_params, membership, X, Y, n, idx, alive)

    round_fn.max_steps = core.max_steps
    return round_fn
