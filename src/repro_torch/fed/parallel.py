"""Mesh-parallel FedGroup (``repro.fed.parallel``): the client axis of the
synchronous trainers over a data mesh or a 2-D ``(data, model)`` mesh of
``torch.distributed`` ranks (``parallel.py:58-330``), and the functions of
tensors that the federated dry run (``launch/fed_dryrun.py``) drives at
production size (``parallel.py:336-447``), on one device or on a
d_w-sharded ΔW.

The mesh helpers. The reference places arrays on a single controller's
mesh and XLA inserts the reductions; here every rank is a process of its
own (``launch.mesh.FedMesh``) and the reductions are explicit in the
fused round (``fed.rounds``, ``fed.client``):

  default_data_mesh     a 1-D ("data",) mesh over the process group's
                        ranks, or None without one or on a world of one
                        (the reference's ``jax.device_count() <= 1``).
  default_fed_mesh      the same, or with ``REPRO_MODEL_AXIS`` = M > 1 a
                        (world / M, M) mesh.
  mesh_data_shards, shard_client_axis, put_sharded_cohort
                        this rank's contiguous block of a K-leading leaf
                        on its device when the shards divide K, the whole
                        leaf (replicated) otherwise.
  make_sharded_executor, make_sharded_block_executor
                        the trainers' round and block executors over the
                        mesh: the first hands a round its rank's rows of
                        X and Y (``FedMesh.take_rows``), the second is
                        ``fed.graphs``' ``GraphBlockExecutor`` with the
                        mesh (captured graphs over NCCL, the eager block
                        over gloo). On a model axis the group parameters
                        go in and come out as this rank's blocks of
                        ``group_param_pspec`` (``fed.rounds`` gathers them
                        over the model group).
  make_async_dispatch_executor, make_async_fold
                        the async runtime's executors: a dispatch computes
                        its rank's rows of the cohort (captured graphs
                        over NCCL, eager over gloo) and the fold is
                        replicated on every rank (on a model axis, over
                        the rank's blocks).

The dry run's functions:

  make_parallel_round   one FedGroup round: K clients, each E epochs of
                        local SGD from its group's parameters, then
                        per-group weighted aggregation.
  cholesky_qr2, rsvd_sharded, edc_embedding_distributed, kmeans_step
                        Algorithm 3 on a production-size update matrix ΔW
                        (n_pre × d_w, d_w up to hundreds of millions):
                        the randomized SVD's heavy work is (d_w × small)
                        products; ``qr_impl="cholesky"`` replaces the
                        tall-skinny Householder QR by CholeskyQR2. The
                        range finder and ``cholesky_qr2`` are
                        ``core.svd``'s, the ones ``edc_embed`` runs.

On the reference's mesh ΔW is sharded over "model" along d_w
(``P(None, "model")``) and XLA turns the small products into all-reduces.
Here a ``mesh`` with a model axis makes the same explicit: a rank passes
its d-block of ΔW; ``A @ Ω`` and ``A @ W`` are local, ``Aᵀ Q`` and ``Qᵀ A``
and CholeskyQR2's two (k, k) Grams are summed over the model group, a
Householder QR of a d-sharded Y runs as TSQR (``core.svd.tsqr``), and E
comes from ``edc_cosine``'s partial-sum entry, its packed sums summed
over the model group (``core.measures.edc_cosine_sharded``). With
``qr_impl="cholesky"`` that is 16 all-reduces. As everywhere in the port,
the randomized SVD's test matrix Ω is an input (``repro_torch.draws``),
not drawn from a key.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.measures import edc_cosine_sharded
from repro_torch.core.svd import (cholesky_qr2,  # noqa: F401 (API)
                                  randomized_truncated_svd)
from repro_torch.fed import graphs as graphs_lib
from repro_torch.fed.rounds import make_round_executor
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding.specs import data_axis_names


# ---------------------------------------------------------------------------
# Client-axis sharding for the synchronous trainers
# ---------------------------------------------------------------------------

def default_data_mesh(device=None):
    """A 1-D ("data",) mesh over the default process group's ranks, or None
    when no group is initialised or its world is one rank: the trainers'
    detected sharding (None selects the path of one device). ``device``
    is this rank's (``make_fed_mesh``'s default otherwise)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    n = dist.get_world_size()
    if n <= 1:
        return None
    return mesh_lib.make_fed_mesh(n, 1, device=device)


def default_fed_mesh(model_axis: int | None = None, device=None):
    """The trainers' detected mesh. ``model_axis`` (default:
    ``REPRO_MODEL_AXIS``, 1) > 1 asks for the (data, model) layout: the
    process group's ranks as a (world / model_axis, model_axis) mesh, None
    without a process group; 1 is ``default_data_mesh()``."""
    if model_axis is None:
        model_axis = int(os.environ.get("REPRO_MODEL_AXIS", "1"))
    if model_axis <= 1:
        return default_data_mesh(device)
    if not (dist.is_available() and dist.is_initialized()):
        return None
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"model_axis={model_axis} does not divide the "
                         f"{n} ranks")
    return mesh_lib.make_fed_mesh(n // model_axis, model_axis, device=device)


def mesh_data_shards(mesh) -> int:
    """Number of data-axis slices of ``mesh`` (1 for mesh=None): the shard
    count of the client axis and of ``ShardedClientStore`` cohorts."""
    if mesh is None:
        return 1
    total = 1
    for a in data_axis_names(mesh):
        total *= int(mesh.shape[a])
    return total


def _tree_map(fn, *trees):
    """``fn`` over the leaves of same-structure dicts / lists / tuples
    (None stays None)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    if t is None:
        return None
    return fn(*trees)


def shard_client_axis(mesh, tree):
    """Every leaf of ``tree`` as a tensor; with a mesh, on the mesh's device
    and, where the data shards divide its leading (client) axis, only this
    rank's contiguous block of it (sliced before the copy, so the copy
    moves K/S rows), the whole leaf otherwise. ``mesh=None`` leaves each
    tensor where it is."""
    if mesh is None:
        return _tree_map(torch.as_tensor, tree)

    def put(leaf):
        t = torch.as_tensor(leaf)
        rows = mesh.cohort_rows(t.shape[0]) if t.ndim >= 1 and t.shape[0] \
            else None
        if rows is not None:
            t = t[rows[0]:rows[1]]
        return t.to(mesh.device)

    return _tree_map(put, tree)


def put_sharded_cohort(mesh, parts):
    """This rank's part of a cohort gathered per data shard.

    ``parts`` is a list of same-structure trees, one per data shard
    (``ShardedClientStore.gather_train_shards``): shard ``s`` holds the
    rows rank s owns. This rank's part goes to its device, one copy of
    its rows; nothing is concatenated. Falls back to ``shard_client_axis``
    over the concatenation when the parts are not one per shard of equal
    size (a non-divisible cohort, which is then replicated) or without a
    mesh."""
    n_shards = mesh_data_shards(mesh)
    cat = lambda *ls: np.concatenate([np.asarray(x) for x in ls])  # noqa: E731
    if mesh is None or n_shards != len(parts):
        return shard_client_axis(mesh, _tree_map(cat, *parts))

    def one(*leaf_parts):
        rows = {len(x) for x in leaf_parts}
        if len(rows) != 1 or not rows.pop():
            return shard_client_axis(mesh, cat(*leaf_parts))
        return torch.as_tensor(leaf_parts[mesh.data_index]).to(mesh.device)

    return _tree_map(one, *parts)


def gather_client_axis(mesh, tree, k: int):
    """The whole k-row cohort of a tree whose leaves hold this rank's rows
    (``FedMesh.gather_rows``), on every rank."""
    return _tree_map(lambda t: mesh.gather_rows(t, k), tree)


def _same_mesh(fn, mesh, what: str):
    if getattr(fn, "mesh", None) is not mesh:
        raise ValueError(f"{what} was built for another mesh: pass mesh= "
                         "to fed.rounds' executor factory too")


def make_sharded_executor(round_fn, mesh=None):
    """``round_fn`` (``fed.rounds.make_round_executor(..., mesh=mesh)``)
    with the cohort's X and Y cut to this rank's rows.

    mesh=None is ``round_fn`` itself. With a mesh the call takes the
    round's arguments as the trainers pass them (X and Y the whole cohort,
    or already this data slice's rows, as a sharded population stages
    them; membership or assignment state, n and the minibatch rows the
    whole cohort) and returns the whole round's output on every rank. The
    group parameters go in and come out per ``group_param_pspec``: whole
    on a model axis of 1, this rank's blocks on a larger one."""
    _same_mesh(round_fn, mesh, "round_fn")
    if mesh is None:
        return round_fn

    def call(group_params, assign, X, Y, n, idx):
        k = n.shape[0]
        return round_fn(group_params, assign, mesh.take_rows(X, k),
                        mesh.take_rows(Y, k), n, idx)

    def prepare(group_params, assign, X, Y, n, idx):
        k = n.shape[0]
        return round_fn.prepare(group_params, assign, mesh.take_rows(X, k),
                                mesh.take_rows(Y, k), n, idx)

    call.max_steps = round_fn.max_steps
    call.mesh = mesh
    call.prepare, call.local, call.finish = (prepare, round_fn.local,
                                             round_fn.finish)
    return call


def make_sharded_block_executor(block_fn, mesh=None):
    """The block executor of ``block_fn`` (``fed.rounds
    .make_block_executor(..., mesh=mesh)``): ``fed.graphs
    .GraphBlockExecutor``, which replays captured graphs of a round on the
    card (over NCCL with the round's collectives inside the graphs) and
    runs the block eagerly on the CPU and over gloo, whose collectives a
    graph cannot hold. Each round gathers its rank's rows of the cohort
    from the (whole) pinned train stack; the carry is whole on every
    rank, but for the group and global parameters on a model axis (this
    rank's blocks)."""
    _same_mesh(block_fn, mesh, "block_fn")
    return graphs_lib.GraphBlockExecutor(block_fn, mesh)


def make_async_dispatch_executor(dispatch_fn, mesh=None, depth: int = 1):
    """The async runtime's dispatch executor of ``dispatch_fn`` (``fed
    .rounds.make_async_dispatch_executor(..., mesh=mesh)``): ``fed.graphs
    .GraphDispatchExecutor`` with ``depth`` dispatches in flight. Under a
    mesh each dispatch gathers its rank's rows of the cohort and returns
    the whole result on every rank; on the card its all-reduces are
    captured in the dispatch graph over NCCL, and it runs eagerly over
    gloo."""
    _same_mesh(dispatch_fn, mesh, "dispatch_fn")
    return graphs_lib.GraphDispatchExecutor(dispatch_fn, depth, mesh)


def make_async_fold(fold_fn, mesh=None):
    """The async runtime's staleness fold as it is (it writes the live
    carry in place: nothing to donate). Under a mesh every rank runs it on
    its own replica of the carry and of the dispatch result; on a model
    axis their parameters are this rank's blocks, which the fold built
    with the trainer's ``ParamLayout`` mixes as they are."""
    return fold_fn


# ---------------------------------------------------------------------------
# One round, client-parallel; Algorithm 3 at scale (the dry run)
# ---------------------------------------------------------------------------

def make_parallel_round(model, *, epochs: int, batch_size: int, lr: float,
                        mu: float, n_groups: int, max_samples: int,
                        mesh=None):
    """Returns round_fn(group_params_stacked, membership, X, Y, n, idx)
      -> (new group params stacked, auxiliary global params, group deltas).

    group_params_stacked: param dict with leading axis m; membership: (K,)
    group id per client; X: (K, max_n, ...), Y: (K, max_n), n: (K,); idx:
    (K, round_fn.max_steps, batch_size) minibatch rows, where the reference
    takes a key per client.

    A thin adapter over ``fed.rounds.make_round_executor`` at η_G = 0, the
    fused round the trainers run. The executor's other outputs (the
    discrepancy, the mean loss, the flattened group deltas) are computed
    and dropped: eager PyTorch has no jit to eliminate them. The
    reference's ``quarantine`` pass-through is left to the executor's
    callers: no round here screens its clients. With a ``mesh`` it is a
    rank's round (``make_sharded_executor``)."""
    core = make_sharded_executor(make_round_executor(
        model, epochs=epochs, batch_size=batch_size, lr=lr, mu=mu,
        n_groups=n_groups, max_samples=max_samples, eta_g=0.0, mesh=mesh),
        mesh)

    def round_fn(group_params, membership, X, Y, n, idx):
        out = core(group_params, membership, X, Y, n, idx)
        return out.group_params, out.global_params, out.agg_delta

    round_fn.max_steps = core.max_steps
    return round_fn


def rsvd_sharded(dW: torch.Tensor, m: int, *, omega: torch.Tensor,
                 n_iter: int = 4, oversample: int = 8,
                 qr_impl: str = "householder", mesh=None) -> torch.Tensor:
    """Top-m left singular directions of ΔWᵀ -> V (d_w, m):
    ``core.svd.randomized_truncated_svd`` of ``dW.T`` (n, d_w).

    omega: the (n, min(m + oversample, n)) Gaussian test matrix. qr_impl:
    ``"householder"`` (TSQR on a model axis) or ``"cholesky"``
    (``cholesky_qr2``). With a model-axis ``mesh`` dW is this rank's
    d-block and V comes back as its rows."""
    return randomized_truncated_svd(dW.T, m, omega, n_iter=n_iter,
                                    oversample=oversample, qr_impl=qr_impl,
                                    mesh=mesh)


def edc_embedding_distributed(dW: torch.Tensor, m: int, *,
                              omega: torch.Tensor,
                              qr_impl: str = "householder", mesh=None):
    """ΔW -> (E (n, m) cosine embedding, V (d_w, m)): the group cold
    start's hot path. E comes from ``edc_cosine``: the Hopper kernel on
    CUDA tensors, its plain version on the CPU and on ``meta``; with a
    model-axis ``mesh`` (dW and V this rank's d-blocks) from its partial-sum
    entry, summed over the model group. The reference's ``use_kernel``
    switch has no counterpart, so the cold start on the card always goes
    through the kernel."""
    V = rsvd_sharded(dW, m, omega=omega, qr_impl=qr_impl, mesh=mesh)
    return edc_cosine_sharded(dW, V, mesh), V


def kmeans_step(E: torch.Tensor, centers: torch.Tensor):
    """One Lloyd iteration on the embedding -> (assign (n,), new centers);
    an empty cluster keeps its center."""
    d2 = torch.sum(torch.square(E[:, None, :] - centers[None]), -1)
    assign = torch.argmin(d2, -1)
    onehot = (assign[:, None] == torch.arange(
        centers.shape[0], device=E.device)).float()
    counts = torch.sum(onehot, 0)
    sums = onehot.T @ E
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp(counts[:, None], min=1), centers)
    return assign, new
