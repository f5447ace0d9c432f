"""Gate-weighted group-model combination, ``repro.core.gating`` (the
paper's stated future work, §5.2: a gate network to combine group models).

A similarity gate: a client's pre-training update direction is scored
against every group's latest update direction (eq. 9's cosine); the
softmax weights mix the logits of the m group models at evaluation time.
Temperature τ runs from hard assignment (τ → 0, vanilla FedGroup) to a
uniform ensemble (τ → ∞).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core import measures
from repro_torch.fed import server as server_lib
from repro_torch.models.modules import flatten_stacked


def gate_weights(dpre, group_deltas, temperature: float = 0.1):
    """dpre: (c, d_w) client pre-training updates; group_deltas: (m, d_w).
    Returns (c, m) softmax similarity gates."""
    sim = measures.cosine_similarity_matrix(dpre, group_deltas)    # (c, m)
    return torch.softmax(sim / max(float(temperature), 1e-6), dim=-1)


def mixture_correct_counts(model, group_params: list, weights, x, y,
                           n_valid):
    """Gate-mixed evaluation: logits = Σ_j w_j · logits_j per client.

    weights: (c, m); x: (c, max_n, ...); y: (c, max_n); n_valid: (c,).
    Returns per-client correct counts (c,)."""
    def per_client(w, xc, yc, nv):
        logit_sum = 0.0
        for j, gp in enumerate(group_params):
            logit_sum = logit_sum + w[j] * model.apply(gp, xc)
        pred = torch.argmax(logit_sum, -1)
        rows = torch.arange(yc.shape[0], device=yc.device)
        return torch.sum((pred == yc) & (rows < nv))

    return vmap(per_client)(weights, x, y, n_valid)


@torch.no_grad()
def evaluate_gated(trainer, temperature: float = 0.1,
                   client_idx=None) -> float:
    """Gate-mixed weighted accuracy over (a subset of) assigned clients.

    Recomputes each client's 1-epoch pre-training update from the
    auxiliary global model (the client cold start's probe, its minibatch
    rows asked of the trainer's ``draws``), gates the m group models with
    it, and scores the mixture on the client test set."""
    if client_idx is None:
        client_idx = np.where(trainer.membership >= 0)[0]
    client_idx = np.asarray(client_idx)
    if len(client_idx) == 0:
        return 0.0
    deltas, _, _ = trainer._solve(trainer.params, client_idx,
                                  solver=trainer.pretrain_solver)
    G = trainer.group_delta                          # (m, d_w) directions
    w = gate_weights(flatten_stacked(deltas), G, temperature)
    groups = trainer.group_params_whole()
    group_list = [server_lib.tree_index(groups, j) for j in range(G.shape[0])]
    xt, yt, nt = trainer._test_stack
    sel = torch.as_tensor(client_idx.astype(np.int64), device=trainer.device)
    correct = mixture_correct_counts(trainer.model, group_list, w, xt[sel],
                                     yt[sel], nt[sel])
    total = trainer.data.n_test[client_idx].sum()
    return float(int(torch.sum(correct)) / max(total, 1))
