"""Weights carried across between the two packages.

``jax.random`` and ``torch.Generator`` give different numbers from one
seed, so a parity test builds the JAX package's params (as numpy arrays)
and loads them here. Nested dicts are kept nested, lists (xLSTM's
``blocks_list``, its cache's ``"xlstm"``) stay lists in their order. A
training state (``zoo.init_train_state``'s: params, ``mu``, ``nu``,
``step``) carries across the same way. On a mesh a rank keeps its blocks
of the whole tree (``params_from_numpy`` with ``cfg`` and ``mesh``:
``zoo.shard_params``; ``train_state_from_numpy`` likewise:
``zoo.shard_state``).
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu", *, cfg=None, mesh=None):
    """Tree (dicts, lists) of numpy arrays (or array-likes) -> the same
    tree of tensors on device; with ``mesh`` (and the zoo's ``cfg``) the
    rank's blocks of it by ``sharding.specs.param_specs``, each leaf cut
    before it is copied to the device."""
    if mesh is not None:
        from repro_torch.models import zoo
        return params_from_numpy(
            zoo.shard_params(params_from_numpy(tree), cfg, mesh), device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.as_tensor(np.array(tree)).to(device)


def params_to_numpy(params):
    """Inverse of ``params_from_numpy``: tree of tensors -> numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to_numpy(v) for v in params]
    return params.detach().cpu().numpy()


TRAIN_STATE_KEYS = ("mu", "nu", "params", "step")


def train_state_from_numpy(state, device="cpu", *, cfg=None, mesh=None,
                           zero: bool = False, fsdp: bool = False,
                           moe_2d: bool = False):
    """A JAX ``zoo.init_train_state`` tree (params, fp32 ``mu`` and ``nu``
    of the params' shapes, an int32 ``step``), as numpy arrays or
    array-likes -> the port's, tensors on device; with ``mesh`` (and the
    zoo's ``cfg``) the rank's blocks of it by
    ``sharding.specs.state_specs(zero=, fsdp=, moe_2d=)``
    (``zoo.shard_state``), each leaf cut before it is copied to the
    device."""
    if tuple(sorted(state)) != TRAIN_STATE_KEYS:
        raise ValueError(f"a train state has the keys {TRAIN_STATE_KEYS}, "
                         f"not {tuple(sorted(state))}")
    if mesh is not None:
        from repro_torch.models import zoo
        return params_from_numpy(zoo.shard_state(
            params_from_numpy(dict(state)), cfg, mesh, zero=zero, fsdp=fsdp,
            moe_2d=moe_2d), device)
    return params_from_numpy(dict(state), device)


def train_state_to_numpy(state):
    """Inverse of ``train_state_from_numpy``."""
    if tuple(sorted(state)) != TRAIN_STATE_KEYS:
        raise ValueError(f"a train state has the keys {TRAIN_STATE_KEYS}, "
                         f"not {tuple(sorted(state))}")
    return params_to_numpy(dict(state))
