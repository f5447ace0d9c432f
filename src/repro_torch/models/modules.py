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

Under a mesh with a model axis (the zoo's tensor parallelism) a layer's
``*_apply`` takes ``tp``, a ``ModelAxis``: the rank's place on the axis,
the specs of the layer's leaves (``sharding.specs.param_specs``) and the
model group's collectives. A leaf the specs shard is the rank's block;
``tp=None``, or an axis of one rank, is the path of one device.

Training differentiates through the collectives: with grad enabled on a
tensor that requires it, ``ModelAxis.sum`` / ``gather`` / ``enter`` and
the data group's ``data_sum`` / ``data_stack`` / ``fsdp_gather`` are
autograd Functions, out of place (without grad they are the serving
path's collectives, unchanged). A sum feeds what every rank of the group
computes alike, so its backward is the identity; a gather's is this
rank's block of the gradient; ``enter`` marks where a tensor the group
holds alike enters a rank's own computation (its columns, heads,
experts or vocab block) and sums the gradient over the group there. So
after the backward a leaf split over "model" holds its block's gradient
and a replicated leaf the whole gradient, the same on every rank of the
group: no leaf needs a model-group reduction. The data group's sum of a
loss term every slice holds alike (the MoE aux losses, the cross-entropy
shares summed whole) has the identity backward too, so the gradient's sum
over the data group afterwards counts each slice's share once. A leaf
split over "data" (ZeRO-3) is gathered where it is used
(``ModelAxis.whole``); its gradient is summed over the data group and
cut back to the block in the gather's backward (a sum then a cut: gloo
on CUDA tensors takes only ``all_reduce`` and ``broadcast``).

Under remat (``torch.utils.checkpoint``) a layer's forward collectives
run again inside the backward. Every rank recomputes the same layers in
the same order, so the ranks' sequences of collectives stay matched.

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
# The model axis (tensor parallelism over a FedMesh)
# ---------------------------------------------------------------------------

def _grad_on(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _ModelSum(torch.autograd.Function):
    """The model group's sum of partial sums (fp32 on the wire, out of
    place); the backward is the identity."""

    @staticmethod
    def forward(ctx, t, mesh):
        return mesh.model_sum(t.to(torch.float32, copy=True)).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelGather(torch.autograd.Function):
    """The model group's equal blocks concatenated along ``dim``; the
    backward is this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.dim, ctx.n = dim, t.shape[dim]
        ctx.lo = mesh.model_index * ctx.n
        return mesh.model_gather(t.float().contiguous(), dim).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n), None, None


class _ModelEnter(torch.autograd.Function):
    """The identity; the backward sums the gradient over the model group
    (fp32 on the wire)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_sum(g.to(torch.float32, copy=True)).to(
            g.dtype), None


class _DataSum(torch.autograd.Function):
    """The data group's sum of a term every slice's loss holds alike; the
    backward is the identity."""

    @staticmethod
    def forward(ctx, t, mesh):
        return mesh.data_sum(t.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _DataStack(torch.autograd.Function):
    """(D, *t.shape) over the data group; the backward is this slice's
    row of the gradient."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.i = mesh.data_index
        return mesh.data_stack(t)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.i], None


class _FsdpGather(torch.autograd.Function):
    """A leaf split over "data" gathered along ``dim`` over the mesh's
    ``fsdp_group`` (fp32 on the wire); the backward sums the gradient over
    the data group when the batch is split over it (a sum, then the cut
    of this rank's block)."""

    @staticmethod
    def forward(ctx, t, mesh, dim, summed):
        ctx.mesh, ctx.dim, ctx.summed, ctx.n = mesh, dim, summed, t.shape[dim]
        ctx.lo = mesh.fsdp_index * ctx.n
        return mesh.fsdp_gather(t.float().contiguous(), dim).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = ctx.mesh.data_sum(g.to(torch.float32, copy=True)).to(g.dtype)
        return g.narrow(ctx.dim, ctx.lo, ctx.n).contiguous(), None, None, \
            None


class ModelAxis:
    """A rank's view of the model axis of a ``launch.mesh.FedMesh`` as the
    zoo's layers read it: ``size`` ranks, this one at ``index``; ``specs``,
    the spec dict of the leaves of the module at hand (``sub`` descends
    into a child module); ``data_split``, whether the batch this rank
    holds is its data slice's block (the MoE layer's routing then counts
    the slices before it, and the loss's terms are summed over them).

    The collectives are the port's own (``FedMesh.model_sum`` /
    ``model_gather`` over the model group), not a partitioner's: a
    row-parallel product's partial sums are summed in fp32 and cast back
    (exact for a sum with one nonzero term), a gather concatenates the
    ranks' blocks in model-index order. With grad they are the autograd
    Functions of the module's docstring."""

    def __init__(self, mesh, specs=None, data_split: bool = False):
        self.mesh = mesh
        self.size = mesh.model_shards
        self.index = mesh.model_index
        self.specs = specs or {}
        self.data_split = bool(data_split) and mesh.data_shards > 1

    def sub(self, key: str) -> "ModelAxis":
        """The same axis, with the specs of child module ``key``."""
        return self.with_specs(self.specs.get(key, {}))

    def with_specs(self, specs: dict) -> "ModelAxis":
        """The same axis, with ``specs`` for the module at hand."""
        child = ModelAxis.__new__(ModelAxis)
        child.__dict__.update(self.__dict__)
        child.specs = specs
        return child

    def split(self, name: str, dim: int | None = None) -> bool:
        """Whether leaf ``name`` (its ``dim``, any dim by default) is
        sharded over the model axis: never on an axis of one rank."""
        if self.size == 1 or name not in self.specs:
            return False
        spec = self.specs[name]
        dims = range(len(spec)) if dim is None else (dim,)
        return any(_has_model(spec[d]) for d in dims)

    def span(self, n: int) -> tuple:
        """This rank's ``(lo, hi)`` of ``n`` rows split evenly over the
        axis (a sharded dim's block)."""
        b = n // self.size
        return self.index * b, (self.index + 1) * b

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The model group's sum of the partial sums ``t`` (fp32 on the
        wire, cast back to ``t``'s dtype); without grad an fp32 ``t`` is
        summed in place."""
        if self.size == 1:
            return t
        if _grad_on(t):
            return _ModelSum.apply(t, self.mesh)
        return self.mesh.model_sum(t.float()).to(t.dtype)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's equal blocks of ``t`` concatenated along
        ``dim`` (a non-fp32 float moves as fp32: exact)."""
        if self.size == 1:
            return t
        if _grad_on(t):
            return _ModelGather.apply(t, self.mesh, dim)
        wire = t.float() if t.is_floating_point() else t
        return self.mesh.model_gather(wire.contiguous(), dim).to(t.dtype)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, which every rank of the model group holds alike, where it
        enters this rank's own computation: the backward sums its gradient
        over the group (nothing without grad, or on an axis of one)."""
        if self.size == 1 or not _grad_on(t):
            return t
        return _ModelEnter.apply(t, self.mesh)

    def stack(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t`` in model-index order."""
        return self.gather(t[None], 0)

    def data_stack(self, t: torch.Tensor) -> torch.Tensor:
        """(D, *t.shape): the data slices' ``t`` in slice order."""
        if _grad_on(t):
            return _DataStack.apply(t, self.mesh)
        return self.mesh.data_stack(t)

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The data slices' sum of ``t`` (one rank a slice); without grad,
        in place."""
        if _grad_on(t):
            return _DataSum.apply(t, self.mesh)
        return self.mesh.data_sum(t)

    def fsdp_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """A leaf split over "data" along ``dim``, gathered whole over the
        data axis (a non-fp32 float moves as fp32: exact)."""
        if self.mesh.fsdp_shards == 1:
            return t
        if _grad_on(t):
            return _FsdpGather.apply(t, self.mesh, dim, self.data_split)
        wire = t.float() if t.is_floating_point() else t
        return self.mesh.fsdp_gather(wire.contiguous(), dim).to(t.dtype)

    def whole(self, tree, specs=None):
        """``tree`` (the module at hand's, or ``specs``' leaves) with every
        leaf its specs split over "data" alone (ZeRO-3) gathered over the
        data axis: the model blocks the layers read."""
        specs = self.specs if specs is None else specs
        if isinstance(tree, dict):
            return {k: self.whole(v, specs.get(k, ())) for k, v in
                    tree.items()}
        if isinstance(tree, list):
            return [self.whole(v, s) for v, s in zip(tree, specs)]
        dim = data_dim(specs)
        return tree if dim is None else self.fsdp_gather(tree, dim)


def data_dim(spec):
    """The dim a leaf's spec splits over "data" alone (ZeRO-3), or None."""
    if isinstance(spec, tuple):
        for d, e in enumerate(spec):
            if e == "data":
                return d
    return None


def _has_model(entry) -> bool:
    return entry == "model" or (isinstance(entry, tuple) and
                                "model" in entry)


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


def rmsnorm_split(params, x: torch.Tensor, tp, full: int,
                  eps: float = 1e-6) -> torch.Tensor:
    """``rmsnorm`` over a dim of ``full`` channels of which ``x`` holds the
    rank's block (``tp.span(full)``): the squares summed over the model
    group, the replicated ``scale`` cut to the block (both entering the
    rank's own computation: ``ModelAxis.enter``)."""
    x32 = x.float()
    ss = tp.enter(tp.sum(torch.sum(torch.square(x32), dim=-1,
                                   keepdim=True)))
    y = x32 * torch.rsqrt(ss / full + eps)
    lo, hi = tp.span(full)
    return (y * tp.enter(params["scale"])[lo:hi].float()).to(x.dtype)


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


def mlp_apply(params, x: torch.Tensor, act: str, tp=None) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) if 'w_gate' present, else plain act(xW)W.
    With ``tp`` splitting d_ff: ``w_gate`` / ``w_up`` are the rank's
    columns, ``w_down`` its rows, and the partial products are summed
    over the model group."""
    if tp is not None and tp.split("w_down"):
        return tp.sum(_mlp(params, tp.enter(x), act))
    return _mlp(params, x, act)


def _mlp(params, x: torch.Tensor, act: str) -> torch.Tensor:
    a = act_fn(act)
    up = x @ params["w_up"].to(x.dtype)
    if "w_gate" in params:
        h = a(x @ params["w_gate"].to(x.dtype)) * up
    else:
        h = a(up)
    return h @ params["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Vocab-parallel embedding and head
# ---------------------------------------------------------------------------

def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, dtype,
                 tp=None) -> torch.Tensor:
    """``embed.to(dtype)[tokens]``. With ``tp`` splitting the vocab rows
    (``embed`` is the rank's rows): the tokens outside them read zeros and
    the model group sums, one nonzero term a token, so the rows are
    exactly the whole table's."""
    if tp is None or not tp.split("embed"):
        return embed.to(dtype)[tokens]
    lo = tp.index * embed.shape[0]
    local = tokens - lo
    mine = (local >= 0) & (local < embed.shape[0])
    rows = embed.to(dtype)[torch.where(mine, local, 0)]
    return tp.sum(torch.where(mine[..., None], rows, 0))


def vocab_logits(h: torch.Tensor, w: torch.Tensor, name: str,
                 tp=None) -> torch.Tensor:
    """``h @ w`` for ``lm_head`` (d, V), or ``h @ w.T`` for a tied
    ``embed`` (V, d). With ``tp`` splitting the vocab: the rank's columns,
    gathered over the model group into the whole (…, V)."""
    out = h @ (w.to(h.dtype).T if name == "embed" else w.to(h.dtype))
    if tp is not None and tp.split(name):
        out = tp.gather(out, out.ndim - 1)
    return out


def vocab_ce_sum(h: torch.Tensor, w: torch.Tensor, name: str,
                 labels: torch.Tensor, tp) -> tuple:
    """The vocab-parallel cross-entropy: (Σ over the labels >= 0 of
    −log softmax(h @ W)[label] in fp32, their count), W the whole vocab's
    head of which ``w`` is the rank's columns (``lm_head``) or rows (a
    tied ``embed``); the logits are never gathered. The log-sum-exp takes
    the group's largest row maximum (one gather of the rows' maxima) and
    the group's sum of exp(logit − max); the label's logit comes from the
    rank that owns its column, the others adding zero. Its backward, by
    the Functions of ``ModelAxis``, is softmax − one-hot on the rank's
    columns. ``h`` must have entered the rank's computation
    (``tp.enter``)."""
    logits = (h @ (w.to(h.dtype).T if name == "embed" else w.to(h.dtype))
              ).float()
    mask = labels >= 0
    m = tp.stack(logits.detach().amax(-1)).amax(0)
    se = tp.sum(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    local = labels - tp.index * logits.shape[-1]
    mine = mask & (local >= 0) & (local < logits.shape[-1])
    picked = torch.take_along_dim(logits, torch.where(mine, local, 0).long()
                                  [..., None], dim=-1)[..., 0]
    label_logit = tp.sum(torch.where(mine, picked, 0.0))
    ce = m + torch.log(se) - label_logit
    return torch.sum(ce * mask), torch.sum(mask)


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
