"""Client-side local optimization (Algorithm 1 ClientUpdate + FedProx
variant), ``repro.fed.client`` with the client axis written out as a batch
dimension (``torch.func.vmap`` over ``grad``).

Every client's data is padded to a fixed max size; batches are drawn
uniformly from the valid prefix. The number of SGD steps is
``E * ceil(n_i / B)`` (E local epochs of mini-batch SGD), masked inside a
fixed trip count ``E * ceil(max_samples / B)`` so one loop serves all
client sizes.

The reference draws each step's minibatch inside its loop (a key split,
then ``randint``). Here the solver takes the whole ``(K, max_steps, B)``
index tensor up front — drawn from a generator when none is given — so a
parity test can replay the reference's draws.
"""
from __future__ import annotations

import torch
from torch.func import grad, vmap

from repro_torch.launch.mesh import param_layout
from repro_torch.models.modules import leaf_keys
from repro_torch.models.paper_models import ModelSpec


def max_local_steps(epochs: int, batch_size: int, max_samples: int) -> int:
    return epochs * ((max_samples + batch_size - 1) // batch_size)


def draw_batch_indices(n: torch.Tensor, max_steps: int, batch_size: int,
                       generator=None) -> torch.Tensor:
    """(K, max_steps, B) int64 rows uniform in [0, max(n_k, 1)), drawn on
    the generator's device (the CPU by default) and moved to n's."""
    gdev = generator.device if generator is not None else "cpu"
    nv = torch.clamp(n.to(gdev, torch.int64), min=1)
    u = torch.rand((n.shape[0], max_steps, batch_size), generator=generator,
                   device=gdev, dtype=torch.float64)
    idx = torch.floor(u * nv[:, None, None]).to(torch.int64)
    return torch.minimum(idx, nv[:, None, None] - 1).to(n.device)


def _bcast(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(K,) -> (K, 1, ..., 1) broadcastable against t."""
    return v.reshape((-1,) + (1,) * (t.ndim - 1))


def make_local_solver(model: ModelSpec, *, epochs: int, batch_size: int,
                      lr: float, mu: float = 0.0, max_samples: int):
    """Returns solve(params0, X, Y, n_valid, idx=None, generator=None) ->
    (deltas, finals), all batched over the K clients: params0 leaves are
    (K, ...), X (K, max_n, ...), Y (K, max_n), n_valid (K,), idx
    (K, max_steps, B)."""
    max_steps = max_local_steps(epochs, batch_size, max_samples)

    def loss_with_prox(params, params0, xb, yb):
        loss = model.loss(params, {"x": xb, "y": yb})
        if mu > 0.0:
            sq = sum(torch.sum(torch.square(params[k] - params0[k]))
                     for k in leaf_keys(params))
            loss = loss + 0.5 * mu * sq
        return loss

    grad_fn = vmap(grad(loss_with_prox))

    def solve(params0, x, y, n_valid, idx=None, generator=None):
        K = x.shape[0]
        n_valid = torch.clamp(n_valid, min=1)
        steps = epochs * ((n_valid + batch_size - 1) // batch_size)
        if idx is None:
            idx = draw_batch_indices(n_valid, max_steps, batch_size,
                                     generator)
        if tuple(idx.shape) != (K, max_steps, batch_size):
            raise ValueError(f"batch indices {tuple(idx.shape)} != "
                             f"{(K, max_steps, batch_size)}")
        y = y.long()
        rows = torch.arange(K, device=x.device)[:, None]
        params = dict(params0)
        for i in range(max_steps):
            sel = idx[:, i]
            g = grad_fn(params, params0, x[rows, sel], y[rows, sel])
            step = lr * (i < steps).to(x.dtype)                # lr * live
            params = {k: p - _bcast(step, p) * g[k]
                      for k, p in params.items()}
        delta = {k: params[k] - params0[k] for k in params}
        return delta, params

    solve.max_steps = max_steps
    return solve


def make_batch_solver(model: ModelSpec, *, epochs: int, batch_size: int,
                      lr: float, mu: float = 0.0, max_samples: int):
    """The solver from one shared params0 (unbatched leaves):
    solve_many(params0, X, Y, n, idx=None, generator=None)
      -> (deltas stacked over clients, final params stacked)."""
    solve = make_local_solver(model, epochs=epochs, batch_size=batch_size,
                              lr=lr, mu=mu, max_samples=max_samples)

    def solve_many(params0, x, y, n, idx=None, generator=None):
        K = x.shape[0]
        p0 = {k: p.expand((K,) + tuple(p.shape)) for k, p in params0.items()}
        return solve(p0, x, y, n, idx, generator)

    solve_many.max_steps = solve.max_steps
    return solve_many


def _correct_one(model: ModelSpec):
    """Per-client correct-prediction count (params, x, y, n_valid)."""
    def one(params, x, y, n_valid):
        pred = torch.argmax(model.apply(params, x), -1)
        rows = torch.arange(y.shape[0], device=y.device)
        return torch.sum((pred == y) & (rows < n_valid))
    return one


def make_eval_fn(model: ModelSpec):
    """correct_counts(params, X (K,max_n,...), Y, n) -> correct (K,)."""
    return vmap(_correct_one(model), in_dims=(None, 0, 0, 0))


def grouped_eval_correct(model: ModelSpec, mesh=None):
    """Fused grouped eval: ONE pass for all m groups.

    fn(group_params, membership, Xt, Yt, nt) -> (correct, total) int
    scalars. group_params is the m-stacked param dict; membership (N,)
    routes each client's test shard to its group's model (-1 = never
    assigned, excluded from both counts) — the paper's §5.1 weighted
    accuracy. Each client gathers its own group's parameters and is scored
    once: N forward passes.

    With ``mesh`` the test stack may hold only this data slice's block of
    the N clients (``mesh.cohort_rows(N)``, fewer rows than
    ``membership``): each slice scores its block and the two counts are
    summed over the data group as int64, exactly. On a model axis the
    group parameters come as this rank's blocks and are gathered whole
    over the model group first.
    """
    one = vmap(_correct_one(model))
    layout = param_layout(mesh, model)

    def score(group_params, membership, Xt, Yt, nt):
        membership = membership.long()
        valid = membership >= 0
        m = next(iter(group_params.values())).shape[0]
        mem = torch.clamp(membership, 0, m - 1)
        my_params = {k: g[mem] for k, g in group_params.items()}
        per_client = one(my_params, Xt, Yt.long(), nt)        # (N,)
        correct = torch.sum(torch.where(valid, per_client, 0))
        total = torch.sum(torch.where(valid, nt.long(), 0))
        return correct, total

    def fn(group_params, membership, Xt, Yt, nt):
        if layout is not None:
            group_params = layout.whole(group_params)
        if mesh is None or Xt.shape[0] == membership.shape[0]:
            return score(group_params, membership, Xt, Yt, nt)
        lo, hi = mesh.cohort_rows(membership.shape[0])
        counts = torch.stack(score(group_params, membership[lo:hi], Xt, Yt,
                                   nt)).long()
        mesh.data_sum(counts)
        return counts[0], counts[1]

    return fn


def client_mean_loss(model: ModelSpec):
    """Per-client mean CE loss (params, x, y, n_valid) -> scalar, for one
    client (vmap it over the client axis): the round's mean loss and the
    IFCA / LCFL assignment stages' score."""
    def one(params, x, y, n_valid):
        logits = model.apply(params, x)
        logp = torch.log_softmax(logits.float(), -1)
        ce = -torch.gather(logp, -1, y.long()[:, None])[:, 0]
        rows = torch.arange(y.shape[0], device=y.device)
        mask = (rows < n_valid).to(ce.dtype)
        return torch.sum(ce * mask) / torch.clamp(n_valid, min=1)
    return one


def make_loss_eval_fn(model: ModelSpec):
    """loss(params, X (K, max_n, ...), Y, n) -> (K,) mean train loss per
    client under one shared params (IFCA's cluster-identity score, the
    serial oracles')."""
    return vmap(client_mean_loss(model), in_dims=(None, 0, 0, 0))
