"""The fused round (Algorithm 2 hot path), ``repro.fed.rounds``.

Group parameters live as a param dict stacked with leading axis ``m``;
each selected client gathers its group's parameters, the local solver runs
batched over the client axis, and per-group aggregation is a segment-sum
(one-hot matmul). Inter-group aggregation (η_G, Alg. 2 lines 17-19), the
auxiliary global model, the flattened per-group update directions and the
eq.-4 discrepancy are computed in the same function, so

  * ``FedAvgTrainer`` / ``FedProxTrainer`` run it with m=1,
  * ``FedGroupTrainer`` / ``FedGrouProxTrainer`` with m=n_groups,
  * the dynamic-assignment trainers (``fed.ifca``, ``fed.fesem``,
    ``fed.strategies``) with m=n_groups plus an *assignment stage*
    (``assign_fn``) that picks each client's group inside the round, and an
    optional ``state_update_fn`` that keeps per-client state (FeSEM's
    ``local_flat``) on the device.

``make_block_executor`` runs B such rounds on a carried state from host-
staged cohorts: cohort ids padded to K with a zero-weight ``alive`` mask,
the alive clients' minibatch rows, and an eval-cadence flag per round;
client batches are gathered from the pinned stacks inside the step. On CPU
tensors its ``block_fn`` runs the step B times eagerly (the plain
version); on the card ``fed.graphs`` captures one step as a CUDA graph and
replays it B times.

The async runtime (``FedConfig.async_depth``) runs one such step per
in-flight dispatch against a snapshot of the state
(``make_async_dispatch_executor``; on the card ``fed.graphs`` replays it
as a captured graph) and folds each result into the live state with
FedAsync staleness weights (``staleness_weight``, ``make_staleness_fold``
when pinned, ``make_param_fold`` when streamed). None of these is a Pallas
kernel in the reference; they are plain torch functions here, on the CPU
and on the card.

On a data mesh (``mesh=``, a ``launch.mesh.FedMesh``) every rank runs the
same round on its contiguous block of the cohort's rows (``_CohortShard``)
and the cohort-global sums become ``all_reduce``s: the per-group weights
and the aggregation numerator, the mean-loss and discrepancy sums and the
quarantine count; the quarantine median is taken over the gathered norms,
and the membership and an assignment state's per-client rows are gathered
before anything replicated is written. The membership and FeSEM's
``local_flat`` stay whole on every rank. A cohort whose size the data
shards do not divide is computed whole on every rank, with no
collective. ``mesh=None`` runs the code of one device as before.

On a 2-D ``(data, model)`` mesh a rank computes its ``compute_rows``: its
data slice's rows split over the slice's M ranks, so no client is solved
twice, and the sums run over the world as above. The group parameters
come in as this rank's blocks of ``group_param_pspec``
(``launch.mesh.ParamLayout``): a round gathers them over the model group
first and hands back its rank's blocks of the new group and global
parameters; everything else of the output is whole.

``serial_reference_round`` / ``serial_ifca_round`` / ``serial_fesem_round``
keep the per-group loop as the oracles the fused round is tested against.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.fed import client as client_lib
from repro_torch.fed import server as server_lib
from repro_torch.launch.mesh import param_layout
from repro_torch.models.modules import (flatten_stacked, flatten_updates,
                                        leaf_keys)


class RoundOutput(NamedTuple):
    group_params: dict        # m-stacked: post-η_G group models
    global_params: dict       # auxiliary global model (mean of groups)
    agg_delta: dict           # m-stacked: intra-group FedAvg Δ
    group_delta_flat: object  # (m, d_w) flattened w_g^{t+1} − w_g^t
    discrepancy: object       # scalar: mean_i ||w_i^final − w̃_{g(i)}||
    membership: object        # (K,) int64 group id used this round
    assign_state: object      # updated assignment-stage state (None if
                              # static)
    mean_loss: object = 0.0   # scalar: n_i-weighted mean local train loss
                              # of the clients' final local models
    n_quarantined: object = 0  # scalar: alive clients whose updates were
                               # screened out this round


def stack_trees(trees: list) -> dict:
    """List of param dicts -> one dict with a new leading axis."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _bcast(v, t):
    return v.reshape((-1,) + (1,) * (t.ndim - 1))


class _CohortShard:
    """This rank's rows ``[lo, hi)`` of a K-row cohort's compute
    (``FedMesh.compute_rows``) and the collectives over them; the identity
    (rows ``[0, K)``, no collective) without a mesh, or when the mesh's
    data shards do not divide K."""

    def __init__(self, mesh, K: int):
        rows = None if mesh is None else mesh.compute_rows(K)
        self.mesh = None if rows is None else mesh
        self.K = K
        self.lo, self.hi = rows if rows is not None else (0, K)

    def rows(self, t):
        return t if self.mesh is None else t[self.lo:self.hi]

    def state(self, state):
        """An assignment state's rows: a tensor state's (LCFL's cohort
        membership), a dict state's ``idx`` (FeSEM's; its ``local_flat``
        stays whole), None as it is."""
        if self.mesh is None or state is None:
            return state
        if isinstance(state, dict):
            return dict(state, idx=self.rows(state["idx"]))
        return self.rows(state)

    def sum(self, t):
        return t if self.mesh is None else self.mesh.all_reduce(t)

    def gather(self, t):
        return t if self.mesh is None else self.mesh.gather_rows(t, self.K)

    def gather_tree(self, tree: dict) -> dict:
        if self.mesh is None:
            return tree
        return {k: self.gather(v) for k, v in tree.items()}


def _flat_rows(t: torch.Tensor) -> torch.Tensor:
    """(K, ...) -> (K, d): also for K = 0 (a mesh rank's empty piece of a
    cohort), which ``reshape(K, -1)`` cannot size."""
    return t.reshape(t.shape[0], math.prod(t.shape[1:]))


def _row_sq(tree: dict, K: int) -> torch.Tensor:
    """Per-row squared norm over all leaves of a K-stacked dict -> (K,)."""
    return sum(torch.sum(torch.square(_flat_rows(tree[k])), dim=1)
               for k in leaf_keys(tree))


def _make_round_core(model, *, epochs: int, batch_size: int, lr: float,
                     mu: float, n_groups: int, max_samples: int,
                     eta_g: float = 0.0, assign_fn=None,
                     state_update_fn=None, quarantine: bool = False,
                     quarantine_mult: float = 10.0, mesh=None):
    """The fused round as a function with an explicit per-client ``alive``
    weight. A client with ``alive == 0`` still runs the batched solver but
    contributes nothing to the aggregation, the mean loss, or the
    discrepancy.

    With ``assign_fn`` the second argument is the assignment state and
    the membership is ``assign_fn(group_params, X, Y, n, state)``;
    ``state_update_fn(state, membership, deltas, finals)`` then runs after
    the quarantine screen, so a screened client hands on its group's
    round-start parameters.

    ``quarantine`` screens a client whose local delta is non-finite or
    whose delta norm exceeds ``quarantine_mult`` × the cohort median into
    the zero-weight path: its delta is zeroed, its final local model is
    replaced by its group's round-start parameters, and its alive weight
    drops to 0 before any reduction (``0 * NaN = NaN``, so zero weight
    alone is not enough).

    With ``mesh`` X and Y hold this rank's rows of the cohort
    (``_CohortShard``) and every other argument the whole cohort; the
    outputs are whole on every rank. ``state_update_fn`` then gets the
    whole state with the gathered membership, deltas and finals. On a
    model axis the group parameters in and the group and global
    parameters out are this rank's blocks.

    The round is three functions, split at its first collective after
    the solves: ``core.prepare`` (the model-axis gather, the rows cut),
    ``core.local`` (the assignment and the local solves of those rows,
    no collective) and ``core.finish`` (the rest). ``core`` calls them
    in that order; a process fleet runs ``local`` in its worker and the
    other two on the rank (``launch.coordinator``)."""
    m = n_groups
    solve = client_lib.make_local_solver(
        model, epochs=epochs, batch_size=batch_size, lr=lr, mu=mu,
        max_samples=max_samples)
    loss_many = vmap(client_lib.client_mean_loss(model))
    layout = param_layout(mesh, model)

    def prepare(group_params, membership, X, Y, n, idx, alive):
        """The round up to its local solves -> (ctx, args of ``local``):
        the group parameters gathered whole over a model axis (the one
        collective before the solves) and this rank's rows cut."""
        sh = _CohortShard(mesh, n.shape[0])
        if layout is not None:
            group_params = layout.whole(group_params)
        if assign_fn is not None:
            state, arg = membership, sh.state(membership)
        else:
            state, arg = None, sh.rows(membership)
        n, idx, alive = sh.rows(n), sh.rows(idx), sh.rows(alive)
        return ((sh, group_params, state, X, Y, n, idx, alive),
                (group_params, arg, X, Y, n, idx))

    def local(group_params, arg, X, Y, n, idx):
        """The local solves of one set of rows, with no collective and no
        mesh: the rows' group ids (``arg`` itself, or the assignment
        stage's on its state rows ``arg``), then each client's update and
        final model from its group's parameters -> (membership, deltas,
        finals). A process worker runs it on its rank's rows."""
        membership = (assign_fn(group_params, X, Y, n, arg)
                      if assign_fn is not None else arg).long()
        # each client trains from ITS group's parameters (one gather)
        my_params = {k: g[membership] for k, g in group_params.items()}
        deltas, finals = solve(my_params, X, Y, n, idx)
        return membership, deltas, finals

    def finish(ctx, part) -> RoundOutput:
        """The round from its local solves on: the quarantine, the sums
        over the ranks, the aggregation and the gathers."""
        sh, group_params, state, X, Y, n, idx, alive = ctx
        membership, deltas, finals = part
        K = membership.shape[0]
        ok = None
        n_quarantined = torch.zeros((), dtype=torch.int32, device=X.device)
        if quarantine:
            my_params = {k: g[membership] for k, g in group_params.items()}
            d_sq = _row_sq(deltas, K)
            finite = torch.isfinite(d_sq)
            norms = torch.sqrt(torch.where(finite, d_sq, 0.0))
            # median over the alive, finite updates. jnp.nanmedian averages
            # the two middle values of an even count; torch.nanmedian
            # returns the lower one, nanquantile(0.5) interpolates like jnp
            med = torch.nanquantile(sh.gather(
                torch.where((alive > 0) & finite, norms,
                            torch.full_like(norms, float("nan")))), 0.5)
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
        group_tot = sh.sum(onehot.T @ w)                            # (m,)
        norm_w = w[:, None] * onehot / torch.clamp(group_tot[None],
                                                   min=1e-9)
        agg_delta = {k: (norm_w.T @ _flat_rows(d)).reshape(
            (m,) + tuple(d.shape[1:])) for k, d in deltas.items()}
        if sh.mesh is not None:
            # every leaf's numerator in one all_reduce
            flat = sh.sum(torch.cat([v.reshape(-1)
                                     for v in agg_delta.values()]))
            parts = torch.split(flat, [v.numel() for v in agg_delta.values()])
            agg_delta = {k: f.view_as(v) for (k, v), f in
                         zip(agg_delta.items(), parts)}
        occupied = (group_tot > 0).float()
        tilde = {k: gp + _bcast(occupied, gp) * agg_delta[k]
                 for k, gp in group_params.items()}

        # mean local training loss of the final local models
        per_client_loss = loss_many(finals, X, Y, n)
        if ok is not None:
            # a quarantined client's batch may itself be poisoned
            per_client_loss = torch.where(ok, per_client_loss, 0.0)

        # eq. 4 discrepancy: each client vs its group's aggregated model
        disc_sq = sum(torch.sum(torch.square(
            _flat_rows(finals[k] - tilde[k][membership])), dim=1)
            for k in leaf_keys(finals))
        sums = [torch.sum(per_client_loss * w), torch.sum(w),
                torch.sum(torch.sqrt(disc_sq) * alive), torch.sum(alive)]
        if sh.mesh is not None:
            # one all_reduce of the cohort's scalar sums (the count exact
            # in float32 far past any cohort size)
            sums = sh.sum(torch.stack(sums + [n_quarantined.float()]))
            n_quarantined = sums[4].to(torch.int32)
        mean_loss = sums[0] / torch.clamp(sums[1], min=1e-9)
        discrepancy = sums[2] / torch.clamp(sums[3], min=1e-9)

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
        membership = sh.gather(membership)
        if assign_fn is not None and state_update_fn is not None:
            state = state_update_fn(state, membership,
                                    sh.gather_tree(deltas),
                                    sh.gather_tree(finals))
        if layout is not None:
            new_groups = layout.block(new_groups)
            global_params = layout.block(global_params)
        return RoundOutput(new_groups, global_params, agg_delta,
                           group_delta_flat, discrepancy, membership, state,
                           mean_loss, n_quarantined)

    def core(group_params, membership, X, Y, n, idx, alive) -> RoundOutput:
        ctx, args = prepare(group_params, membership, X, Y, n, idx, alive)
        return finish(ctx, local(*args))

    core.max_steps = solve.max_steps
    core.prepare, core.local, core.finish = prepare, local, finish
    return core


def make_round_executor(model, *, epochs: int, batch_size: int, lr: float,
                        mu: float, n_groups: int, max_samples: int,
                        eta_g: float = 0.0, assign_fn=None,
                        state_update_fn=None, quarantine: bool = False,
                        quarantine_mult: float = 10.0, mesh=None):
    """Returns round_fn(group_params, membership, X, Y, n, idx) ->
    RoundOutput.

    group_params: dict with leading axis m; membership: (K,) group id per
    selected client; X: (K, max_n, ...); Y: (K, max_n); n: (K,); idx:
    (K, max_steps, B) minibatch rows (``round_fn.max_steps``).

    Dynamic assignment (IFCA, FeSEM, ``fed.strategies``): pass
      assign_fn(group_params, X, Y, n, state) -> (K,) group ids
    and the second argument of round_fn becomes the assignment *state*
    instead of a membership vector. An optional
      state_update_fn(state, membership, deltas, finals) -> new state
    keeps per-client state on the device across rounds; the new state is
    ``RoundOutput.assign_state``.

    ``quarantine=True`` screens non-finite / norm-outlier client updates
    into the zero-weight path (see ``_make_round_core``).

    With ``mesh`` X and Y are this rank's rows of the cohort and the rest
    the whole cohort (``fed.parallel.make_sharded_executor`` slices them);
    ``round_fn.mesh`` is the mesh.

    ``round_fn`` is ``round_fn.finish(ctx, round_fn.local(*args))`` with
    ``ctx, args = round_fn.prepare(...)`` (its arguments): the halves a
    process fleet runs apart (``_make_round_core``)."""
    core = _make_round_core(
        model, epochs=epochs, batch_size=batch_size, lr=lr, mu=mu,
        n_groups=n_groups, max_samples=max_samples, eta_g=eta_g,
        assign_fn=assign_fn, state_update_fn=state_update_fn,
        quarantine=quarantine, quarantine_mult=quarantine_mult, mesh=mesh)

    @torch.no_grad()
    def prepare(group_params, membership, X, Y, n, idx):
        alive = torch.ones(n.shape[0], dtype=torch.float32, device=X.device)
        return core.prepare(group_params, membership, X, Y, n, idx, alive)

    @torch.no_grad()
    def round_fn(group_params, membership, X, Y, n, idx) -> RoundOutput:
        ctx, args = prepare(group_params, membership, X, Y, n, idx)
        return core.finish(ctx, core.local(*args))

    round_fn.max_steps = core.max_steps
    round_fn.mesh = mesh
    round_fn.prepare = prepare
    round_fn.local = torch.no_grad()(core.local)
    round_fn.finish = torch.no_grad()(core.finish)
    return round_fn


def make_block_executor(model, *, epochs: int, batch_size: int, lr: float,
                        mu: float, n_groups: int, max_samples: int,
                        eta_g: float = 0.0, assign_fn=None,
                        state_update_fn=None, make_state=None,
                        state_to_aux=None, quarantine: bool = False,
                        quarantine_mult: float = 10.0, mesh=None):
    """Returns block_fn(carry, train_stack, test_stack, idx, bidx, alive,
    do_eval) -> (carry, metrics): B fused rounds, run eagerly one after
    another (the plain version of ``fed.graphs``' replayed block).

    carry (the round-to-round state):
      ``group_params``  m-stacked param dict
      ``global_params`` auxiliary global model (mean of groups)
      ``group_delta``   (m, d_w) latest flattened update directions (eq. 9)
      ``membership``    (N+1,) int64 — every client's group id (-1 = cold);
                        row N is the scatter trash row of padded lanes
      ``aux``           framework state (FeSEM: the (N+1, d_w) local_flat
                        with the same trash row) or None

    train_stack / test_stack: the pinned ``(x, y, n)`` stacks — a round's
    client batches are gathered from them inside the step. idx: (B, K)
    int64 staged cohorts; bidx: (B, K, max_steps, batch_size) minibatch
    rows; alive: (B, K) float32 zero-weight padding mask (``dropout_rate``
    survivors first, padding after: padded lanes aggregate with weight 0
    and scatter to the trash row); do_eval: (B,) host bools, the eval
    cadence (``FedConfig.eval_every``). metrics: (B, 5) float64 rows of
    (mean_loss, discrepancy, correct, total, n_quarantined); correct and
    total are the fused grouped eval's integer counts (0 where do_eval is
    False), so the host's accuracy division reproduces the per-round path
    bit for bit.

    make_state(aux, idx, membership) builds a round's assignment state from
    the carried ``aux`` and (N+1,) membership, with idx already redirected
    to the trash row for padded lanes (FeSEM: {"local_flat": aux, "idx":
    idx}; LCFL: ``membership[idx]``); state_to_aux takes the updated aux
    out of ``RoundOutput.assign_state``. With ``assign_fn`` but no
    ``make_state`` the state is None (IFCA); without ``assign_fn`` the
    cohort's membership is gathered from the carry (static frameworks).

    ``block_fn.step(carry, train_stack, idx, bidx, alive)`` -> (carry,
    (mean_loss, discrepancy, n_quarantined)) is one round and
    ``block_fn.evaluate(carry, test_stack)`` -> (correct, total) one
    grouped eval: ``fed.graphs`` captures each of them once.

    With ``mesh`` the train stack is whole on every rank and a round
    gathers only this rank's rows of its cohort from it; the test stack
    may hold this rank's block of the clients (``fed.parallel
    .shard_client_axis``), whose counts the eval sums over the ranks. The
    carry is whole on every rank."""
    core = _make_round_core(
        model, epochs=epochs, batch_size=batch_size, lr=lr, mu=mu,
        n_groups=n_groups, max_samples=max_samples, eta_g=eta_g,
        assign_fn=assign_fn, state_update_fn=state_update_fn,
        quarantine=quarantine, quarantine_mult=quarantine_mult, mesh=mesh)
    eval_correct = client_lib.grouped_eval_correct(model, mesh)

    def step(carry, train_stack, ix, bix, al):
        X_all, Y_all, n_all = train_stack
        mine = _CohortShard(mesh, ix.shape[0]).rows(ix)
        x, y, n = X_all[mine], Y_all[mine], n_all[ix]
        mem = carry["membership"]
        trash = mem.shape[0] - 1                    # row N: padded lanes
        ix_eff = torch.where(al > 0, ix, torch.full_like(ix, trash))
        if assign_fn is None:
            arg = mem[ix]
        elif make_state is not None:
            arg = make_state(carry["aux"], ix_eff, mem)
        else:
            arg = None
        out = core(carry["group_params"], arg, x, y, n, bix, al)
        aux = carry["aux"]
        if state_to_aux is not None:
            aux = state_to_aux(out.assign_state)
        new = dict(group_params=out.group_params,
                   global_params=out.global_params,
                   group_delta=out.group_delta_flat,
                   membership=mem.index_put((ix_eff,), out.membership),
                   aux=aux)
        return new, (out.mean_loss, out.discrepancy, out.n_quarantined)

    def evaluate(carry, test_stack):
        return eval_correct(carry["group_params"], carry["membership"][:-1],
                            *test_stack)

    @torch.no_grad()
    def block_fn(carry, train_stack, test_stack, idx, bidx, alive, do_eval):
        rows = []
        for b in range(idx.shape[0]):
            carry, (loss, disc, n_quar) = step(carry, train_stack, idx[b],
                                               bidx[b], alive[b])
            correct = total = loss.new_zeros((), dtype=torch.int64)
            if do_eval[b]:
                correct, total = evaluate(carry, test_stack)
            rows.append(torch.stack([v.double() for v in
                                     (loss, disc, correct, total, n_quar)]))
        return carry, torch.stack(rows)

    block_fn.step = torch.no_grad()(step)
    block_fn.evaluate = torch.no_grad()(evaluate)
    block_fn.max_steps = core.max_steps
    block_fn.mesh = mesh
    return block_fn


def staleness_weight(staleness, *, alpha: float = 1.0, beta: float = 0.0):
    """FedAsync mixing weight w = alpha * (staleness + 1)^(-beta), as (m,)
    float32 host numpy (computed in float64, then cast).

    ``staleness`` counts, per group, how many folds landed between a
    dispatch's snapshot and its own fold (0 = fresh). s = 0 gives exactly
    ``alpha``; the weight is non-increasing in s for beta >= 0; alpha = 1,
    beta = 0 gives exactly 1.0 everywhere, the equivalence mode whose fold
    is a bitwise passthrough of the dispatch result."""
    s = np.asarray(staleness, np.float64)
    if np.any(s < 0):
        raise ValueError(f"negative staleness {s}")
    return np.asarray(alpha * (s + 1.0) ** (-float(beta)), np.float32)


def _device_weights(weights, device) -> tuple:
    """(host numpy float32 weights, the same as a tensor on ``device``);
    the copy to the card goes through pinned memory, without a sync."""
    host = (weights.detach().cpu().numpy() if isinstance(weights, torch.Tensor)
            else np.asarray(weights)).astype(np.float32)
    w = torch.from_numpy(host)
    if torch.device(device).type == "cuda":
        w = w.pin_memory().to(device, non_blocking=True)
    return host, w


def _mix_weighted(w):
    """Per-leaf convex mix new = (1-w)*cur + w*res over the leading group
    axis, with w == 1.0 an exact bitwise passthrough of ``res`` (0*cur +
    1*res is NOT bit-exact when cur is -0.0 or non-finite, so the
    passthrough is a ``where`` select, not arithmetic)."""
    def mix(cur, res):
        wl = w.reshape((-1,) + (1,) * (res.ndim - 1)).to(res.dtype)
        return torch.where(wl == 1.0, res, (1.0 - wl) * cur + wl * res)
    return mix


def make_async_dispatch_executor(model, *, epochs: int, batch_size: int,
                                 lr: float, mu: float, n_groups: int,
                                 max_samples: int, eta_g: float = 0.0,
                                 assign_fn=None, state_update_fn=None,
                                 make_state=None, state_to_aux=None,
                                 quarantine: bool = False,
                                 quarantine_mult: float = 10.0, mesh=None):
    """Returns dispatch_fn(carry, train_stack, idx, bidx, alive) ->
    (result, metrics): ONE staged round computed against a *snapshot*
    carry, for the async runtime's in-flight window
    (``FedConfig.async_depth``).

    It is ``make_block_executor``'s step (same core, same in-program gather
    from the pinned stacks, padded lanes redirected to the trash row)
    without the in-program eval (the loop evaluates at fold time) and
    without writing the carry: at depth D > 1 the snapshot is shared with
    the live state and every other dispatch in flight. So the result holds
    only what the cohort touched:

      ``group_params`` / ``global_params`` / ``group_delta``  the round's
      ``membership``  (K,) the cohort's post-assignment group ids
      ``aux``         (K, ·) the cohort's updated rows (FeSEM's
                      ``local_flat``), or None

    and ``make_staleness_fold`` scatters the two row sets at the cohort's
    ids. With an ``aux``, ``make_state`` receives the cohort's gathered
    rows and their local ids 0..K-1 (the streamed trainers' form), so a
    state update that writes its rows in place (``fesem_state_update``)
    writes the gathered copy; without one it receives ``(None, ids,
    membership)``, the ids redirected to the trash row.

    metrics: (3 + K,) float64: mean_loss, discrepancy, n_quarantined, then
    the K post-assignment group ids (the fold's version clocks read them
    on the host).

    With ``mesh`` a dispatch gathers only this rank's rows of the cohort
    from the (whole) train stack, as the block step does, and its result
    is whole on every rank: the fold is replicated."""
    core = _make_round_core(
        model, epochs=epochs, batch_size=batch_size, lr=lr, mu=mu,
        n_groups=n_groups, max_samples=max_samples, eta_g=eta_g,
        assign_fn=assign_fn, state_update_fn=state_update_fn,
        quarantine=quarantine, quarantine_mult=quarantine_mult, mesh=mesh)

    @torch.no_grad()
    def dispatch_fn(carry, train_stack, idx, bidx, alive):
        X_all, Y_all, n_all = train_stack
        mine = _CohortShard(mesh, idx.shape[0]).rows(idx)
        x, y, n = X_all[mine], Y_all[mine], n_all[idx]
        mem = carry["membership"]
        trash = mem.shape[0] - 1                    # row N: padded lanes
        ix_eff = torch.where(alive > 0, idx, torch.full_like(idx, trash))
        aux = carry["aux"]
        rows = None if aux is None else aux[ix_eff]
        if assign_fn is None:
            arg = mem[idx]
        elif make_state is not None:
            arg = (make_state(None, ix_eff, mem) if rows is None else
                   make_state(rows, torch.arange(idx.shape[0],
                                                 device=idx.device), mem))
        else:
            arg = None
        out = core(carry["group_params"], arg, x, y, n, bidx, alive)
        if state_to_aux is not None:
            rows = state_to_aux(out.assign_state)
        result = dict(group_params=out.group_params,
                      global_params=out.global_params,
                      group_delta=out.group_delta_flat,
                      membership=out.membership, aux=rows)
        metrics = torch.cat([torch.stack([out.mean_loss.double(),
                                          out.discrepancy.double(),
                                          out.n_quarantined.double()]),
                             out.membership.double()])
        return result, metrics

    dispatch_fn.max_steps = core.max_steps
    dispatch_fn.mesh = mesh
    return dispatch_fn


def _group_mean(groups: dict, layout=None) -> dict:
    """The auxiliary global model of m-stacked groups, the mean over the
    group axis. On a model axis (``layout``) the groups and the result are
    this rank's blocks, whose dims differ (``group_param_pspec``): the
    mean is taken of the groups gathered whole, then blocked."""
    if layout is None:
        return {k: torch.mean(g, dim=0) for k, g in groups.items()}
    return layout.block({k: torch.mean(g, dim=0)
                         for k, g in layout.whole(groups).items()})


def make_staleness_fold(layout=None):
    """Returns fold_fn(current, result, idx, alive, weights) -> current:
    fold a completed async dispatch (``make_async_dispatch_executor``'s
    result) into the live carry with per-group staleness weights
    (``staleness_weight``), IN PLACE: the carry keeps its buffers, so a
    captured dispatch graph that reads them stays valid, and a dispatch
    enqueued before the fold (on the card: earlier in stream order; on the
    CPU: already computed) keeps the snapshot it read.

      * group_params: per-group convex mix (1-w)·current + w·result, w ==
        1.0 a bitwise ``where`` passthrough of the result;
      * global_params: the result's own when every weight is 1.0 (bitwise:
        the D = 1 equivalence mode), the mean of the folded groups
        otherwise;
      * group_delta: the result's flattened update directions (eq. 9
        routes by the direction, not the magnitude);
      * membership / aux: only the cohort's rows are written, dead lanes
        redirected to the trash row, so at D > 1 concurrent dispatches
        merge row-wise (the last fold wins on a shared row).

    idx / alive: the staged cohort (K,) (any device); weights: (m,) host
    numpy or tensor. On a model axis (``layout``, a ``launch.mesh
    .ParamLayout``) the carry's parameters and the result's are this
    rank's blocks: the mix is elementwise, and only the mean of the
    folded groups gathers them (``_group_mean``)."""
    @torch.no_grad()
    def fold_fn(current, result, idx, alive, weights):
        mem = current["membership"]
        dev = mem.device
        trash = mem.shape[0] - 1
        idx, alive = idx.to(dev), alive.to(dev)
        ix_eff = torch.where(alive > 0, idx, torch.full_like(idx, trash))
        mem.index_put_((ix_eff,), result["membership"].to(mem.dtype))
        if current["aux"] is not None:
            current["aux"].index_put_((ix_eff,), result["aux"])
        host, w = _device_weights(weights, dev)
        mix = _mix_weighted(w)
        groups = current["group_params"]
        for k, g in groups.items():
            g.copy_(mix(g, result["group_params"][k]))
        glob = (result["global_params"] if bool(np.all(host == 1.0))
                else _group_mean(groups, layout))
        for k, p in current["global_params"].items():
            p.copy_(glob[k])
        current["group_delta"].copy_(result["group_delta"])
        return current

    return fold_fn


def make_param_fold(layout=None):
    """Returns fold_fn(current_groups, result_groups, result_global,
    weights) -> (folded_groups, folded_global): the carry-less staleness
    fold of the *streamed* async path, where membership and FeSEM's rows
    stay on the host and only the m-stacked group parameters live on the
    device. The same mixing as ``make_staleness_fold`` (w == 1.0 a bitwise
    passthrough, so the equivalence mode adopts the dispatch result as the
    synchronous round does); the current groups are not written. On a
    model axis (``layout``) the parameters are this rank's blocks, as in
    ``make_staleness_fold``."""
    @torch.no_grad()
    def fold_fn(current_groups, result_groups, result_global, weights):
        dev = next(iter(current_groups.values())).device
        host, w = _device_weights(weights, dev)
        mix = _mix_weighted(w)
        groups = {k: mix(g, result_groups[k])
                  for k, g in current_groups.items()}
        if bool(np.all(host == 1.0)):
            return groups, result_global
        return groups, _group_mean(groups, layout)

    return fold_fn


def serial_reference_round(batch_solver, group_params_list, membership,
                           X, Y, n, idx, *, eta_g: float = 0.0):
    """The per-group round loop: one solver call per non-empty group plus
    host-side aggregation — the oracle of the fused round.

    batch_solver: ``client.make_batch_solver`` product; group_params_list:
    list of m param dicts; membership: (K,) numpy int array; idx: the
    (K, max_steps, B) minibatch rows, shared with the fused round so both
    train on the same batches. Returns (new group list, global params,
    (m, d_w) group deltas, discrepancy)."""
    m = len(group_params_list)
    tilde, disc, _ = _serial_group_update(
        batch_solver, group_params_list, membership, X, Y, n, idx)
    new_list = server_lib.inter_group_aggregate(tilde, eta_g)
    group_delta = torch.stack([
        flatten_updates(server_lib.tree_sub(new_list[j],
                                            group_params_list[j]))
        for j in range(m)])
    return new_list, server_lib.tree_mean(new_list), group_delta, disc


@torch.no_grad()
def _serial_group_update(batch_solver, group_params_list, membership,
                         X, Y, n, idx, collect_finals: bool = False):
    """Shared tail of the per-group rounds: one solver call per non-empty
    group, weighted intra-group aggregation, host discrepancy.
    ``collect_finals`` also flattens each member's final local model
    (FeSEM's host-side ``local_flat`` rebuild) into {client row: (d_w,)}."""
    m = len(group_params_list)
    new_list = list(group_params_list)
    disc_sum, disc_n = 0.0, 0
    finals_by_client = {}
    membership = np.asarray(membership)
    for j in range(m):
        members = np.where(membership == j)[0]
        if len(members) == 0:
            continue
        sel = torch.as_tensor(members, device=X.device)
        deltas, finals = batch_solver(group_params_list[j], X[sel], Y[sel],
                                      n[sel], idx[sel])
        new_list[j] = server_lib.apply_delta(
            group_params_list[j], server_lib.weighted_delta(deltas, n[sel]))
        diffs = vmap(lambda f: server_lib.tree_norm(
            server_lib.tree_sub(f, new_list[j])))(finals)
        disc_sum += float(torch.sum(diffs))
        disc_n += len(members)
        if collect_finals:
            flats = flatten_stacked(finals)
            for r, i in enumerate(members):
                finals_by_client[int(i)] = flats[r]
    return new_list, disc_sum / max(disc_n, 1), finals_by_client


@torch.no_grad()
def serial_ifca_round(batch_solver, loss_fn, group_params_list,
                      X, Y, n, idx):
    """IFCA estimate-then-loop: one loss call per group on the host side,
    argmin, then ``_serial_group_update`` — the oracle of the fused IFCA
    round. loss_fn: ``client.make_loss_eval_fn`` product. Returns (new
    group list, membership (K,) numpy, discrepancy)."""
    losses = torch.stack([loss_fn(p, X, Y, n) for p in group_params_list])
    membership = torch.argmin(losses, dim=0).cpu().numpy()
    new_list, disc, _ = _serial_group_update(
        batch_solver, group_params_list, membership, X, Y, n, idx)
    return new_list, membership, disc


@torch.no_grad()
def serial_fesem_round(batch_solver, group_params_list, local_flat,
                       X, Y, n, idx):
    """FeSEM with the per-group loop: ℓ2 E-step over flattened centres,
    per-group M-step (centre = weighted average of the members' final local models),
    rebuild of the per-client flattened-model matrix — the oracle of the
    fused FeSEM round.

    local_flat: (K, d_w) flattened local models of the selected clients.
    Returns (new group list, membership, new local_flat, discrepancy)."""
    centers = torch.stack([flatten_updates(p) for p in group_params_list])
    d2 = torch.sum(torch.square(local_flat[:, None, :] - centers[None]), -1)
    membership = torch.argmin(d2, dim=1).cpu().numpy()
    new_list, disc, finals_by_client = _serial_group_update(
        batch_solver, group_params_list, membership, X, Y, n, idx,
        collect_finals=True)
    new_local = local_flat.clone()
    for i, row in finals_by_client.items():
        new_local[i] = row
    return new_list, membership, new_local, disc
