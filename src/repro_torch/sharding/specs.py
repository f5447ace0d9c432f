"""Placement specs (``repro.sharding.specs``): the federated round
executor's client axis and group parameters (``specs.py:192-253``), and the
architecture half, the zoo's tensor parallelism (``specs.py:57-190,
255-333``): ``param_specs``, ``state_specs``, ``data_specs`` and
``cache_specs``.

A spec is a plain tuple with one entry per tensor dim: the mesh axis name
the dim shards over (a tuple of names for several), or None
(replicated), the entries a ``jax.sharding.PartitionSpec`` holds, so
``port == tuple(reference)``. ``fed.parallel`` places the client axis by them
over a ``launch.mesh.FedMesh``; the zoo (``models.zoo.shard_params``,
``init_cache(mesh=)``) keeps a rank's block of each leaf by them
(``local_block``, ``shard_shape``).

The rules read only shapes and the config, and a mesh only through its
``shape`` (axis name to size) and ``axis_names``: a ``FedMesh``, or any
stand-in with those two, serves. The trees are the zoo's nested dicts: the
stacked layer leaves under ``"blocks"`` (a leading layer dim, replicated),
xLSTM's per-layer dicts in the list ``"blocks_list"`` (read as the
reference reads them: as if stacked), a cache's per-layer xLSTM states in
the list ``"xlstm"``.

Tensor-parallel scheme over the "model" axis (``_rule``):
  embedding / lm_head        shard the (padded) vocab dim
  attention wq/wo            shard heads      (only if n_heads  % MP == 0)
  attention wk/wv            shard kv heads   (only if n_kv     % MP == 0)
  MLP w_gate/w_up/w_down     shard d_ff
  MoE expert stacks          shard the EXPERT axis (expert parallelism)
  MLA w_uq/w_uk/w_uv/wo      shard heads;  w_dq shards q_rank
  Mamba2 wz/wx/out_proj      shard d_inner;  B/C/dt stay replicated
  xLSTM                      replicated on "model"
  1-D params (norms, biases) replicated
"""
from __future__ import annotations

import torch

MP_AXIS = "model"


def data_axis_names(mesh) -> tuple:
    """The mesh axes the client (cohort) axis shards over: the data-ish
    axes ("pod", "data") when present, every axis of a mesh that has
    neither."""
    named = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return named or tuple(mesh.axis_names)


def _axes(data_axes):
    """One spec entry for a dim over ``data_axes``: the name alone when
    there is one (as ``PartitionSpec`` normalises it), else the tuple."""
    axes = tuple(data_axes)
    return axes[0] if len(axes) == 1 else axes


def cohort_pspec(ndim: int, data_axes=("data",)) -> tuple:
    """Spec of one K-leading cohort leaf (X / Y / n / minibatch rows /
    assignment state): the client axis over the data axes, the rest
    replicated."""
    return (_axes(data_axes),) + (None,) * (ndim - 1)


def block_staged_pspec(ndim: int, data_axes=("data",)) -> tuple:
    """Spec of one staged round-block leaf of shape ``(B, K, ...)``: the
    round axis replicated (every rank steps through all B rounds), the
    client axis (axis 1) over the data axes."""
    return (None, _axes(data_axes)) + (None,) * (ndim - 2)


def group_param_pspec(shape: tuple, model_size: int,
                      model_axis: str = MP_AXIS) -> tuple:
    """Spec of one m-stacked group-parameter leaf: the group axis
    replicated, and the largest trailing dim that ``model_size`` divides
    over the model axis. No divisible dim, or ``model_size == 1`` (the
    1-D data mesh), replicates it whole."""
    nd = len(shape)
    parts = [None] * nd
    if model_size > 1 and nd >= 2:
        best, best_dim = -1, -1
        for i in range(1, nd):
            if shape[i] % model_size == 0 and shape[i] > best:
                best, best_dim = shape[i], i
        if best_dim >= 0:
            parts[best_dim] = model_axis
    return tuple(parts)


def model_dim(shape: tuple, model_size: int):
    """The dim of a leaf of ``shape`` that ``group_param_pspec`` shards
    over the model axis, or None (whole on every rank)."""
    spec = group_param_pspec(tuple(shape), model_size)
    return spec.index(MP_AXIS) if MP_AXIS in spec else None


def group_param_specs(group_params: dict, mesh) -> dict:
    """``group_param_pspec`` of each leaf of an m-stacked param dict under
    ``mesh`` (model-axis size read off the mesh; 1 when absent)."""
    model_size = dict(mesh.shape).get(MP_AXIS, 1)
    return {k: group_param_pspec(tuple(v.shape), model_size)
            for k, v in group_params.items()}


# ---------------------------------------------------------------------------
# The architecture half: the zoo's tensor parallelism
# ---------------------------------------------------------------------------

def spec_items(tree, names=()):
    """[(path names, leaf)] of a nested dict / list tree in its own order:
    a dict's key or a list's index (as a string), as the reference's
    ``_path_names`` reads a ``DictKey`` / ``SequenceKey`` path. A tuple is
    a leaf (a spec)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in spec_items(v, names + (str(k),))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in spec_items(v, names + (str(i),))]
    return [(list(names), tree)]


def _map_with_names(fn, tree, names=()):
    """``jax.tree_util.tree_map_with_path`` over a nested dict / list:
    ``fn(path names, leaf)`` in the tree's structure."""
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_names(fn, v, names + (str(i),))
                          for i, v in enumerate(tree))
    return fn(list(names), tree)


def _rule(names: list, shape: tuple, cfg, mp: int, moe_2d: bool = False
          ) -> tuple:
    """Spec of one parameter leaf without its stacked-layer dim (the
    caller prepends None for leaves under 'blocks')."""
    name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    nd = len(shape)
    rep = (None,) * nd
    if nd <= 1:
        return rep

    heads_ok = cfg.n_heads % mp == 0
    kv_ok = cfg.n_kv_heads % mp == 0
    ff = cfg.moe_d_ff if (cfg.family == "moe" and parent != "shared") \
        else cfg.d_ff
    ff_ok = ff % mp == 0 and ff > 0
    vocab_ok = cfg.padded_vocab % mp == 0
    di_ok = (cfg.ssm_expand * cfg.d_model) % mp == 0

    if name == "embed":
        return (MP_AXIS, None) if vocab_ok else rep
    if name == "lm_head":
        return (None, MP_AXIS) if vocab_ok else rep
    if name in ("frontend_proj",):
        return rep
    if parent == "projector":
        return rep

    if parent in ("attn", "shared_attn"):
        if name == "wq":
            return (None, MP_AXIS) if heads_ok else rep
        if name in ("wk", "wv"):
            return (None, MP_AXIS) if kv_ok else rep
        if name == "wo":
            return (MP_AXIS, None) if heads_ok else rep
        # MLA projections
        if name == "w_dq":
            return (None, MP_AXIS) if cfg.q_rank % mp == 0 else rep
        if name == "w_uq":
            return ((MP_AXIS, None) if cfg.q_rank % mp == 0
                    else ((None, MP_AXIS) if heads_ok else rep))
        if name in ("w_uk", "w_uv"):
            return (None, MP_AXIS) if heads_ok else rep
        if name == "w_dkv":
            return rep
    if parent in ("mlp", "shared"):
        if name in ("w_gate", "w_up"):
            return (None, MP_AXIS) if ff_ok else rep
        if name == "w_down":
            return (MP_AXIS, None) if ff_ok else rep
    if parent == "moe":
        if name == "router":
            return rep
        if name in ("w_gate", "w_up", "w_down") and nd == 3:
            if moe_2d and cfg.n_experts % (mp * mp) == 0:
                # experts over both axes: weights never gathered
                return (("data", MP_AXIS), None, None)
            return ((MP_AXIS, None, None) if cfg.n_experts % mp == 0
                    else rep)
    if parent == "mixer":
        if name in ("wz", "wx"):
            return (None, MP_AXIS) if di_ok else rep
        if name == "out_proj":
            return (MP_AXIS, None) if di_ok else rep
        if name == "conv_x":
            return (None, MP_AXIS) if di_ok else rep
        return rep
    # xLSTM and the rest: replicated
    return rep


def _add_fsdp(parts, shape, axis, axis_size: int = 16):
    """Shard the largest unsharded dim that ``axis_size`` divides over
    ``axis`` (ZeRO-3 / FSDP), unless the leaf's spec uses ``axis``."""
    used = set()
    for p in parts:
        for a in (p if isinstance(p, tuple) else (p,)):
            used.add(a)
    if axis in used:
        return parts
    best, best_dim = -1, -1
    for i, (p, d) in enumerate(zip(parts, shape)):
        if p is None and d % axis_size == 0 and d > best:
            best, best_dim = d, i
    if best_dim >= 0:
        parts = list(parts)
        parts[best_dim] = axis
    return parts


def param_specs(params, cfg, mp: int = 16, fsdp_axis=None,
                moe_2d: bool = False):
    """The spec tree of ``params`` (a zoo tree, or its shapes on
    ``meta``). ``fsdp_axis`` (e.g. "data") also shards each leaf's largest
    unsharded dim that 16 divides over that axis (ZeRO-3); ``moe_2d``
    shards the expert stacks over both axes."""
    def spec_for(names, leaf):
        stacked = "blocks" in names or (names and names[0] == "blocks_list")
        shape = tuple(leaf.shape)
        base = _rule(names, shape[1:] if stacked and leaf.ndim >= 1
                     else shape, cfg, mp, moe_2d=moe_2d)
        parts = ([None] + list(base)) if stacked else list(base)
        if fsdp_axis is not None and leaf.ndim >= 2:
            parts = _add_fsdp(parts, shape, fsdp_axis)
        return tuple(parts)
    return _map_with_names(spec_for, params)


def state_specs(state_template, cfg, mp: int = 16, zero: bool = False,
                fsdp: bool = False, moe_2d: bool = False) -> dict:
    """Specs of a train state {params, mu, nu, step}: the moments also
    over "data" with ``zero`` (ZeRO-1), the params too with ``fsdp``."""
    p_specs = param_specs(state_template["params"], cfg, mp,
                          fsdp_axis="data" if fsdp else None, moe_2d=moe_2d)
    m_specs = param_specs(state_template["mu"], cfg, mp,
                          fsdp_axis="data" if (zero or fsdp) else None,
                          moe_2d=moe_2d)
    return {"params": p_specs, "mu": m_specs, "nu": m_specs, "step": ()}


def batch_axes(mesh) -> tuple:
    """The mesh's data-ish axes ("pod", "data") that it has."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= int(mesh.shape[a])
    return n


def data_specs(batch_tree, mesh, include_model: bool = False):
    """The leading batch dim over ("pod", "data") when their product
    divides it, else replicated; ``include_model`` adds the model axis
    (an architecture with no tensor-parallel parameter)."""
    axes = batch_axes(mesh)
    if include_model:
        axes = axes + (MP_AXIS,)
    total = _size(mesh, axes)

    def spec(_, leaf):
        if leaf.ndim == 0:
            return ()
        if leaf.shape[0] % total == 0 and leaf.shape[0] > 0:
            return (_axes(axes),) + (None,) * (leaf.ndim - 1)
        return (None,) * leaf.ndim
    return _map_with_names(spec, batch_tree)


def cache_specs(cache_tree, cfg, mesh, mp: int = 16,
                seq_shard: bool = False):
    """Specs of a decode cache: the batch dim over the data axes, head-
    and expert-like dims over "model" where the axis divides them. Leaves
    (a leading L of stacked layers): attention k / v (L, B, S, KV, hd),
    MLA c_kv (L, B, S, r) and k_pe (L, B, S, rope), Mamba2 conv_* (L, B,
    W-1, C) and ssm (L, B, H, P, N), xLSTM's per-layer states (B, ...).

    ``seq_shard``: where the kv heads do not divide the model axis, the
    slot dim shards over it instead (MLA's latent too, before its rank
    dim): a decode then exchanges only softmax statistics."""
    axes = batch_axes(mesh)
    total = _size(mesh, axes)

    def spec_for(names, leaf):
        nd = leaf.ndim
        parts = [None] * nd
        stacked = nd >= 1 and any(n in ("k", "v", "c_kv", "k_pe", "conv_x",
                                        "conv_B", "conv_C", "ssm")
                                  for n in names)
        bdim = 1 if (stacked and names[0] != "xlstm") else 0
        if nd > bdim and leaf.shape[bdim] % total == 0:
            parts[bdim] = _axes(axes)
        last = names[-1]
        if last in ("k", "v") and nd == 5:
            if cfg.n_kv_heads % mp == 0:
                parts[3] = MP_AXIS
            elif seq_shard and leaf.shape[2] % mp == 0:
                parts[2] = MP_AXIS
        if last == "c_kv" and nd == 4:
            if seq_shard and leaf.shape[2] % mp == 0:
                parts[2] = MP_AXIS
            elif cfg.kv_rank % mp == 0:
                parts[3] = MP_AXIS
        if last == "k_pe" and nd == 4 and seq_shard and \
                leaf.shape[2] % mp == 0:
            parts[2] = MP_AXIS
        if last == "ssm" and nd == 5 and leaf.shape[2] % mp == 0:
            parts[2] = MP_AXIS
        if last == "conv_x" and nd == 4 and leaf.shape[3] % mp == 0:
            parts[3] = MP_AXIS
        return tuple(parts)
    return _map_with_names(spec_for, cache_tree)


# ---------------------------------------------------------------------------
# A rank's blocks
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec, mesh) -> tuple:
    """The shape of a rank's block of a ``shape`` leaf placed by ``spec``
    on ``mesh``: each dim divided by the sizes of its axes. A dim they do
    not divide raises (the rules shard only dims they divide)."""
    out = []
    for d, entry in zip(tuple(shape), tuple(spec)):
        n = _size(mesh, _entry_axes(entry))
        if d % n:
            raise ValueError(f"spec {spec} does not divide shape "
                             f"{tuple(shape)} on mesh {dict(mesh.shape)}")
        out.append(d // n)
    return tuple(out)


def mesh_coords(mesh, rank=None) -> dict:
    """{axis: index} of ``rank`` (``mesh.rank`` by default) on ``mesh``:
    row-major over ``axis_names``, the model axis fastest, as
    ``launch.mesh`` numbers its ranks."""
    r = int(mesh.rank if rank is None else rank)
    out = {}
    for a in reversed(tuple(mesh.axis_names)):
        n = int(mesh.shape[a])
        out[a] = r % n
        r //= n
    return out


def local_block(t, spec, mesh, rank=None):
    """A rank's block of the whole tensor ``t`` placed by ``spec`` (an
    entry of several axes counts them row-major, as ("pod", "data") the
    data slices): a contiguous copy (a view would keep the whole leaf's
    storage alive), or ``t`` itself where ``spec`` replicates every
    dim."""
    coords = mesh_coords(mesh, rank)
    sl = []
    for b, entry in zip(shard_shape(tuple(t.shape), spec, mesh), spec):
        i = 0
        for a in _entry_axes(entry):
            i = i * int(mesh.shape[a]) + coords[a]
        sl.append(slice(i * b, (i + 1) * b))
    if all(s.start == 0 and s.stop == d for s, d in zip(sl, t.shape)):
        return t
    return t[tuple(sl)].clone(memory_format=torch.contiguous_format)


def tree_blocks(tree, specs, mesh, rank=None):
    """``local_block`` of every leaf of ``tree`` by the same-structured
    ``specs``."""
    if isinstance(tree, dict):
        return {k: tree_blocks(v, specs[k], mesh, rank)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_blocks(v, s, mesh, rank) for v, s in zip(tree, specs)]
    return local_block(tree, specs, mesh, rank)
