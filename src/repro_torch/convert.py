"""Weights carried across between the two packages.

``jax.random`` and ``torch.Generator`` give different numbers from one
seed, so a parity test builds the JAX package's params (as numpy arrays)
and loads them here. Nested dicts are kept nested.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu") -> dict:
    """dict of numpy arrays (or array-likes) -> dict of tensors on device."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree)).to(device)


def params_to_numpy(params) -> dict:
    """Inverse of ``params_from_numpy``: dict of tensors -> numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()
