"""Parameter-dict helpers (``repro.models.modules`` lines 148-174).

Leaf order follows ``jax.tree_util.tree_leaves``, which sorts dict keys:
the MLP's leaves go ``b1, b2, w1, w2``. That order fixes the columns of
every ``(·, d_w)`` matrix on the main path (ΔW, ``group_delta_flat``, the
eq.-9 directions), so every flattening here iterates ``sorted(params)``.
"""
from __future__ import annotations

import torch


def leaf_keys(params: dict) -> list:
    """The param dict's keys in JAX's leaf order (sorted)."""
    return sorted(params)


def param_count(params: dict) -> int:
    return int(sum(p.numel() for p in params.values()))


def flatten_updates(params: dict) -> torch.Tensor:
    """Flatten a param dict into one 1-D vector (the paper's Δw)."""
    leaves = [params[k].reshape(-1) for k in leaf_keys(params)
              if params[k].is_floating_point()]
    if not leaves:
        return torch.zeros(0)
    return torch.cat(leaves)


def flatten_stacked(params: dict) -> torch.Tensor:
    """``vmap(flatten_updates)`` over a leading axis: (L, ...) leaves ->
    (L, d_w)."""
    keys = [k for k in leaf_keys(params) if params[k].is_floating_point()]
    lead = params[keys[0]].shape[0]
    return torch.cat([params[k].reshape(lead, -1) for k in keys], dim=1)


def unflatten_like(vec: torch.Tensor, params: dict) -> dict:
    """Inverse of ``flatten_updates`` given a template param dict."""
    out, off = {}, 0
    for k in leaf_keys(params):
        p = params[k]
        if p.is_floating_point():
            out[k] = vec[off:off + p.numel()].reshape(p.shape).to(p.dtype)
            off += p.numel()
        else:
            out[k] = p
    return out
