"""Device meshes over ``torch.distributed`` ranks (``repro.launch.mesh``).

The reference is single-controller: one process holds a ``jax`` mesh of
devices and XLA inserts the reductions. The port is SPMD, PyTorch's
idiom: one process per rank under ``torch.distributed``, every rank
building the same trainer from the same seed and drawing the same
cohorts on its host generators. A ``FedMesh`` is what a rank needs to
know of that world: its process group, rank and world size, the
``(data, model)`` shape with its axis names, the collective backend and
the device this rank computes on.

The client (cohort) axis shards over "data": rank r holds the contiguous
block ``shard_cohort_slices(K, S)[r]`` of a cohort of K rows when S
divides K, and the whole cohort (replicated, no collective) otherwise,
as ``fed.parallel.shard_client_axis`` places it. Sums over the cohort
become ``all_reduce``s and gathers of the cohort's rows an ``all_reduce``
of a zero-filled buffer into which each rank writes its own rows. These
are the only collectives the port uses, with ``broadcast``: the two that
gloo takes for CUDA tensors, so one code path runs over gloo on the CPU,
over gloo on one card shared by several ranks, and over NCCL with a card
a rank.

The backend is chosen up front (``choose_backend``), never by catching a
failure: NCCL when every rank of a host has a card of its own, gloo when
ranks share a card or run on the CPU.

Beside the compute group every rank holds a *host group*: a gloo group
over CPU tensors, made once per process group (``host_group``), in the
same order on every rank and before any graph capture. The runtime
services decide things by the clock (a straggler deadline, a lease's
expiry, a backoff, a fleet worker's death); the reference decides each
once, on its single controller, where the port's ranks would each decide
by their own clock and tear apart. ``FedMesh.agree`` gives every rank
rank 0's decision over the host group: it never touches a CUDA stream,
so it never waits behind the dispatch whose lateness it decides, and a
thread may call it while another runs the compute group's collectives.

Not ported (``ROADMAP.md`` queue 1, 16c): a model axis > 1, and with it
``make_production_mesh``'s 2-D and multi-pod layouts. The reference's TPU
roofline constants have no counterpart here.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.fed.store import shard_cohort_slices

DATA_AXIS, MP_AXIS = "data", "model"

# the device ``init_process_group`` chose for this rank (None before)
_RANK_DEVICE = None
# the host group of the current default process group (``host_group``)
_HOST_GROUP = None


def not_ported_16(item: str, what: str):
    """The ``NotImplementedError`` of a mesh feature left to ROADMAP.md
    queue 1, item 16b′ (the fleet's process workers under a mesh), 16c (a
    model axis) or 16d (the zoo's tensor parallelism)."""
    return NotImplementedError(
        f"{what} is not yet ported to repro_torch: ROADMAP.md queue 1, item "
        f"{item}")


@dataclass(eq=False)
class FedMesh:
    """One rank's view of a 1-D data mesh (``make_fed_mesh``).

    ``shape`` maps axis name to size (``{"data": S, "model": 1}``, as
    ``dict(jax_mesh.shape)`` reads); ``data_index`` is this rank's slice
    of the data axis."""
    group: object
    rank: int
    world: int
    shape: dict
    backend: str
    device: torch.device
    axis_names: tuple = (DATA_AXIS, MP_AXIS)
    host: object = None        # the host group (``host_group``)

    @property
    def data_shards(self) -> int:
        return int(self.shape[DATA_AXIS])

    @property
    def data_index(self) -> int:
        return self.rank // int(self.shape[MP_AXIS])

    def cohort_rows(self, k: int):
        """This rank's ``(lo, hi)`` rows of a k-row cohort, or None when the
        data shards do not divide k (the cohort is then replicated)."""
        slices = shard_cohort_slices(int(k), self.data_shards)
        return None if slices is None else slices[self.data_index]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns it."""
        dist.broadcast(t, src=src, group=self.group)
        return t

    def gather_rows(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """The k-row cohort tensor whose rows ``cohort_rows(k)`` this rank
        holds as ``t``: a zero-filled buffer with this rank's rows written,
        summed over the ranks. ``x + 0`` is exact, so every row equals its
        owner's (a -0.0 reads +0.0)."""
        lo, hi = self.cohort_rows(k)
        buf = t.new_zeros((int(k),) + tuple(t.shape[1:]))
        buf[lo:hi] = t
        return self.all_reduce(buf)

    def agree(self, value, src: int = 0):
        """Rank ``src``'s small integer or boolean ``value`` on every rank,
        over the host group (a CPU tensor: no CUDA stream is touched). The
        ranks call it at the same points, so each decision is taken once,
        by ``src``, and followed by all."""
        t = torch.tensor([int(value)], dtype=torch.int64)
        if self.world > 1:
            dist.broadcast(t, src=src, group=self.host)
        v = int(t[0])
        return bool(v) if isinstance(value, bool) else v

    def barrier(self):
        """Every rank meets here, over the host group."""
        if self.world > 1:
            dist.barrier(group=self.host)

    def same_on_every_rank(self, what: str, value):
        """Raise unless ``value`` (a tensor, or {name: numpy array or
        tensor}) equals rank 0's byte for byte (NaN and -0.0 included): a
        replicated result every rank computed on its own. Each rank's
        SHA-256 digest of the bytes, read on the host, is held against rank
        0's over the host group."""
        if self.world <= 1:
            return
        items = value.items() if isinstance(value, dict) else [("", value)]
        h = hashlib.sha256()
        for k, a in items:
            a = (a.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                 .numpy() if isinstance(a, torch.Tensor) else
                 np.ascontiguousarray(a).reshape(-1).view(np.uint8))
            h.update(f"{k}:{a.size};".encode())
            h.update(a.tobytes())
        mine = torch.tensor(list(h.digest()), dtype=torch.uint8)
        ref = mine.clone()
        dist.broadcast(ref, src=0, group=self.host)
        if not torch.equal(ref, mine):
            raise RuntimeError(f"{what} differs between rank 0 and rank "
                               f"{self.rank}: the ranks have diverged")


def writes(mesh) -> bool:
    """True in the process that writes a run's files (checkpoints, the
    telemetry directory): the only one without a mesh, rank 0 on one."""
    return mesh is None or mesh.rank == 0


def choose_backend(device_type: str, local_world: int,
                   cards: int | None = None) -> str:
    """``"nccl"`` when each of a host's ``local_world`` ranks has a card of
    its own, ``"gloo"`` when they share cards or run on the CPU."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"no collective backend for device {device_type!r}")
    cards = torch.cuda.device_count() if cards is None else int(cards)
    return "nccl" if cards >= int(local_world) else "gloo"


def rank_device(device_type: str, local_rank: int, cards: int | None = None
                ) -> torch.device:
    """This rank's device: the CPU, or card ``local_rank`` modulo the
    host's cards (ranks beyond the cards share them, over gloo)."""
    if device_type == "cpu":
        return torch.device("cpu")
    cards = torch.cuda.device_count() if cards is None else int(cards)
    if cards < 1:
        raise RuntimeError("device='cuda' asked for but this host has no "
                           "CUDA device; pass device='cpu'")
    return torch.device("cuda", int(local_rank) % cards)


def init_process_group(device="cuda", *, init_method: str = "env://",
                       rank: int | None = None,
                       world_size: int | None = None,
                       local_rank: int | None = None,
                       local_world: int | None = None) -> torch.device:
    """Initialise the default process group for ``device`` ("cuda" or
    "cpu") with the backend ``choose_backend`` picks, and return this
    rank's device. Unset ranks and sizes come from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``); a
    FileStore or TCP ``init_method`` with explicit ``rank`` and
    ``world_size`` needs no environment."""
    global _RANK_DEVICE
    dtype = torch.device(device).type
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    local_rank = (int(env.get("LOCAL_RANK", rank)) if local_rank is None
                  else int(local_rank))
    local_world = (int(env.get("LOCAL_WORLD_SIZE", world_size))
                   if local_world is None else int(local_world))
    backend = choose_backend(dtype, local_world)
    dev = rank_device(dtype, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    _RANK_DEVICE = dev
    host_group()
    return dev


def host_group():
    """The default process group's host group: a gloo group of every rank
    over CPU tensors, made at the first call (a collective call: every rank
    makes it, in the same order, before any graph capture) and kept until
    ``destroy_process_group``. Always a group of its own, also on a gloo
    world, so that ``FedMesh.agree`` on one thread never interleaves with
    the compute group's collectives on another."""
    global _HOST_GROUP
    if _HOST_GROUP is None:
        _HOST_GROUP = dist.new_group(backend="gloo")
    return _HOST_GROUP


def destroy_process_group():
    """Tear the default process group down (a no-op without one)."""
    global _RANK_DEVICE, _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE = None
    _HOST_GROUP = None


def make_fed_mesh(data: int, model: int = 1, *, device=None) -> FedMesh:
    """The federated-round mesh over the default process group: the round
    executor's client axis shards over ``data`` ranks. ``data * model``
    must equal the world size. ``device`` defaults to the one
    ``init_process_group`` chose for this rank (else card ``LOCAL_RANK``);
    NCCL needs a card."""
    if int(model) > 1:
        raise not_ported_16("16c", f"a model axis of {model} (the 2-D "
                            "(data, model) layout)")
    if not dist.is_initialized():
        raise RuntimeError("make_fed_mesh needs an initialised process group "
                           "(repro_torch.launch.mesh.init_process_group)")
    world = dist.get_world_size()
    if int(data) * int(model) != world:
        raise ValueError(f"mesh ({data}, {model}) does not cover the world "
                         f"of {world} ranks")
    backend = str(dist.get_backend())
    if device is None:
        dev = _RANK_DEVICE if _RANK_DEVICE is not None else rank_device(
            "cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank())))
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, not {dev}")
    return FedMesh(group=dist.group.WORLD, rank=dist.get_rank(), world=world,
                   shape={DATA_AXIS: int(data), MP_AXIS: int(model)},
                   backend=backend, device=dev, host=host_group())


def make_local_mesh(*, device=None) -> FedMesh:
    """The world this process is in as a ``(world, 1)`` mesh."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialised process "
                           "group")
    return make_fed_mesh(dist.get_world_size(), 1, device=device)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16 × 16 (× 2 pods) layout: a model axis, not
    ported."""
    raise not_ported_16("16c", "the production (data, model) mesh"
                        + (" over two pods" if multi_pod else ""))
