"""Server-side aggregation helpers (``repro.fed.server``) on param dicts.

The fused round does its aggregation in stacked form; these per-tree
helpers serve the serial oracles (``fed.rounds.serial_*``) and
``core.gating``. Leaves are visited in JAX's leaf order (sorted keys), so
a sum over leaves adds in the reference's order.
"""
from __future__ import annotations

import torch

from repro_torch.models.modules import leaf_keys


def weighted_delta(deltas_stacked: dict, weights) -> dict:
    """FedAvg aggregation: Σ_i (n_i / n) Δw_i over a stacked client axis.

    deltas_stacked: dict with leading client axis K; weights: (K,) raw
    (e.g. sample counts), normalised here."""
    w = weights.float()
    w = w / torch.clamp(torch.sum(w), min=1e-12)
    return {k: torch.sum(d * w.reshape((-1,) + (1,) * (d.ndim - 1)), dim=0)
            for k, d in deltas_stacked.items()}


def apply_delta(params: dict, delta: dict, scale: float = 1.0) -> dict:
    return {k: p + scale * delta[k] for k, p in params.items()}


def tree_mean(trees: list) -> dict:
    """Plain average of a list of param dicts (the auxiliary global model)."""
    n = len(trees)
    return {k: sum(t[k] for t in trees) / n for k in trees[0]}


def tree_index(group_params, j: int) -> dict:
    """j-th group's parameters from a list of dicts or an m-stacked dict
    (views)."""
    if isinstance(group_params, (list, tuple)):
        return group_params[j]
    return {k: g[j] for k, g in group_params.items()}


def tree_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(tree[k]))
                          for k in leaf_keys(tree)))


def tree_sub(a: dict, b: dict) -> dict:
    return {k: a[k] - b[k] for k in a}


def tree_add(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def tree_scale(a: dict, s) -> dict:
    return {k: v * s for k, v in a.items()}


def inter_group_aggregate(group_params: list, eta_g: float) -> list:
    """Alg. 2 lines 17-19: w_g <- w̃_g + η_G Σ_{l≠g} w̃_l / ||w̃_l||."""
    if eta_g <= 0.0 or len(group_params) == 1:
        return group_params
    normed = [tree_scale(p, 1.0 / torch.clamp(tree_norm(p), min=1e-12))
              for p in group_params]
    total = {k: sum(nm[k] for nm in normed) for k in normed[0]}
    return [tree_add(p, tree_scale(tree_sub(total, nm), eta_g))
            for p, nm in zip(group_params, normed)]
