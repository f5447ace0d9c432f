"""Placement specs of the federated round executor, the federated half of
``repro.sharding.specs`` (``specs.py:192-253``).

A spec is a plain tuple with one entry per tensor dim: the mesh axis name
the dim shards over (a tuple of names for several), or None
(replicated), the entries a ``jax.sharding.PartitionSpec`` holds, so
``port == tuple(reference)``. ``fed.parallel`` places the client axis by them over
a ``launch.mesh.FedMesh``.

Not ported (``ROADMAP.md`` queue 1, 16d): the architecture half,
``param_specs`` … ``cache_specs`` (``specs.py:57-190, 255-333``).
"""
from __future__ import annotations

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
