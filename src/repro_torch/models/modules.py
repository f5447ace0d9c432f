"""Functional building blocks on param dicts (``repro.models.modules``).

Every layer is a pair of functions, as in the JAX package:
  init_*(gen, ..., device=) -> params (nested dict of tensors)
  *_apply(params, x, ...) -> y
Weights keep the JAX orientation ``(in, out)``, so a JAX param tree
carries across unchanged (``repro_torch.convert.params_from_numpy``).
Parameters are stored in ``param_dtype``; compute runs in the activation
dtype of ``x``, each weight cast at its use (``.astype(x.dtype)`` there).

Init draws from an explicit ``torch.Generator`` on the target device. On
the ``meta`` device nothing is drawn (``gen`` may be None): that builds a
param tree of shapes only, for counting.

Leaf order follows ``jax.tree_util.tree_leaves``, which sorts dict keys:
the MLP's leaves go ``b1, b2, w1, w2``. That order fixes the columns of
every ``(·, d_w)`` matrix on the FedGroup path (ΔW, ``group_delta_flat``,
the eq.-9 directions), so every flattening here iterates ``sorted(params)``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def randn(gen, shape, device) -> torch.Tensor:
    """Standard-normal fp32 draw of ``shape`` (an empty tensor on meta)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=gen, device=device)


def dense_init(gen, in_dim: int, out_dim: int, dtype=torch.float32,
               device="cpu", scale: float | None = None):
    """Lecun-normal style init for a (in_dim, out_dim) kernel."""
    if scale is None:
        scale = 1.0 / math.sqrt(in_dim)
    return (randn(gen, (in_dim, out_dim), device) * scale).to(dtype)


def embed_init(gen, vocab: int, dim: int, dtype=torch.float32, device="cpu"):
    return (randn(gen, (vocab, dim), device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32, cast back to x's dtype. The default eps is 1e-6,
    as in the JAX package: Mamba2's inner norm relies on it."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(dim: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm with a bias, in fp32, cast back to x's dtype (xLSTM's
    norms; eps 1e-5, not rmsnorm's 1e-6)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def act_fn(name: str):
    """``jax.nn.gelu`` defaults to the tanh approximation, so both gelu
    names take ``approximate="tanh"``."""
    if name == "silu":
        return F.silu
    if name in ("gelu", "geglu_gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":  # squared ReLU (Nemotron-4)
        return lambda x: torch.square(F.relu(x))
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# Gated / plain MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, gated: bool, dtype=torch.float32,
             device="cpu"):
    p = {
        "w_up": dense_init(gen, d_model, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device),
    }
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, device)
    return p


def mlp_apply(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) if 'w_gate' present, else plain act(xW)W."""
    a = act_fn(act)
    up = x @ params["w_up"].to(x.dtype)
    if "w_gate" in params:
        h = a(x @ params["w_gate"].to(x.dtype)) * up
    else:
        h = a(up)
    return h @ params["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-half layout, not interleaved)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device="cpu") -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * inv_freq        # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]                   # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Param-tree helpers
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict (or list) of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_stack(trees: Sequence):
    """Stack a list of identically-structured param dicts along new dim 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(list(trees), dim=0)


def tree_index(tree, i: int):
    """Slice ``i`` of a stacked param dict (``tree_map(lambda a: a[i])``)."""
    return tree_map(lambda a: a[i], tree)


def leaf_keys(params: dict) -> list:
    """The param dict's keys in JAX's leaf order (sorted)."""
    return sorted(params)


def param_count(params) -> int:
    return int(sum(p.numel() for p in tree_leaves(params)))


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
    return torch.cat([params[k].reshape(lead, math.prod(params[k].shape[1:]))
                      for k in keys], dim=1)


def unflatten_stacked(flat: torch.Tensor, params: dict) -> dict:
    """Inverse of ``flatten_stacked`` given a template param dict of
    unstacked leaves: (L, d_w) -> (L, ...) leaves."""
    out, off = {}, 0
    lead = flat.shape[0]
    for k in leaf_keys(params):
        p = params[k]
        if p.is_floating_point():
            out[k] = flat[:, off:off + p.numel()].reshape(
                (lead,) + tuple(p.shape)).to(p.dtype)
            off += p.numel()
    return out


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
