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
become ``all_reduce``s. A gather is an ``all_gather_into_tensor`` on
NCCL (and on the dry run's ``fake`` group); gloo takes only
``all_reduce`` and ``broadcast`` for CUDA tensors, so there a gather is an
``all_reduce`` of a zero-filled buffer into which each rank writes its own
part (``x + 0`` is exact: every value equals its owner's, a -0.0 reads
+0.0). So one code path runs over gloo on the CPU, over gloo on one card
shared by several ranks, and over NCCL with a card a rank.

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

A model axis (``make_fed_mesh(D, M)``, the reference's 2-D ``(data,
model)`` layout; ``make_production_mesh``'s 16 × 16 and 2 × 16 × 16 with a
leading "pod" axis): rank r sits at data slice ``r // M`` and model index
``r % M``. Each rank holds a data group (the ranks of its model index, one
a data slice), a model group (the M ranks of its data slice) and the
world, all made once by ``make_fed_mesh``. A cohort is placed by data
slice (``cohort_rows``: the slice's rows, replicated over its M ranks) and
computed by rank (``compute_rows``: the slice's rows split into M
contiguous pieces), so no client is solved twice and the round's sums run
over the world as on a 1-D mesh. The m-stacked group parameters are kept
at rest as blocks of ``sharding.specs.group_param_pspec`` (``ParamLayout``)
and gathered over the model group where they are used whole. The updates
of a pre-training solve come to a rank as its d_w block of every row
(``gather_cols``), never whole. A zoo leaf split over "data" alone
(ZeRO-3, ``sharding.specs.param_specs(fsdp_axis="data")``) is gathered
over ``fsdp_group``: the data group, or on the multi-pod mesh the "data"
axis within the rank's pod. The reference's TPU roofline constants
have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.fed.store import shard_cohort_slices
from repro_torch.sharding.specs import model_dim

POD_AXIS, DATA_AXIS, MP_AXIS = "pod", "data", "model"

# torch renamed all_gather_into_tensor all_gather_single in 2.13
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
# the device ``init_process_group`` chose for this rank (None before)
_RANK_DEVICE = None
# the host group of the current default process group (``host_group``)
_HOST_GROUP = None


@dataclass(eq=False)
class FedMesh:
    """One rank's view of a data mesh or a 2-D ``(data, model)`` mesh
    (``make_fed_mesh``, ``make_production_mesh``).

    ``shape`` maps axis name to size (``{"data": D, "model": M}``, with a
    leading ``"pod"`` on the multi-pod mesh, as ``dict(jax_mesh.shape)``
    reads); ``data_index`` is this rank's slice of the data axes and
    ``model_index`` its place on the model axis. ``group`` is the world;
    ``data_group`` and ``model_group`` the ranks of this rank's model index
    and of its data slice (the world when the model axis is 1)."""
    group: object
    rank: int
    world: int
    shape: dict
    backend: str
    device: torch.device
    axis_names: tuple = (DATA_AXIS, MP_AXIS)
    host: object = None        # the host group (``host_group``)
    data_group: object = None
    model_group: object = None
    # when a list: (kind, group, bytes) of each compute collective (the
    # federated dry run's inventory)
    comm_log: list | None = None
    # the ranks of this rank's pod and model index (the "data" axis alone:
    # what a leaf split over "data" is gathered over); the data group when
    # the mesh has no "pod" axis
    fsdp_group: object = None
    # (index, size) on the "data" axis when this view's shape does not
    # give them (``flat``)
    fsdp_coord: tuple | None = None

    @property
    def data_shards(self) -> int:
        return int(self.shape.get(POD_AXIS, 1)) * int(self.shape[DATA_AXIS])

    @property
    def model_shards(self) -> int:
        return int(self.shape.get(MP_AXIS, 1))

    @property
    def data_index(self) -> int:
        return self.rank // self.model_shards

    @property
    def model_index(self) -> int:
        return self.rank % self.model_shards

    def __post_init__(self):
        if self.fsdp_group is None:
            self.fsdp_group = self.data_group

    @property
    def fsdp_index(self) -> int:
        """This rank's place on the "data" axis (its pod's slices)."""
        if self.fsdp_coord is not None:
            return self.fsdp_coord[0]
        return (self.rank // self.model_shards) % int(self.shape[DATA_AXIS])

    @property
    def fsdp_shards(self) -> int:
        """The "data" axis' size (a pod's data slices)."""
        if self.fsdp_coord is not None:
            return self.fsdp_coord[1]
        return int(self.shape[DATA_AXIS])

    @property
    def first_pod(self) -> bool:
        """Whether this rank is in pod 0 (every rank of a mesh of one
        pod)."""
        return self.rank < self.fsdp_shards * self.model_shards \
            if self.fsdp_coord is None else True

    def flat(self) -> "FedMesh":
        """This world as a ``(world, 1)`` mesh: a batch split over every
        rank (``data_specs(include_model=True)`` with no leaf split over
        "model"), reduced over the world; a leaf split over "data" is still
        gathered over this rank's ``fsdp_group``."""
        return dataclasses.replace(
            self, shape={DATA_AXIS: self.world, MP_AXIS: 1},
            axis_names=(DATA_AXIS, MP_AXIS), data_group=self.group,
            model_group=self.group,
            fsdp_coord=(self.fsdp_index, self.fsdp_shards))

    def _rows_of(self, k: int, r: int):
        """Rank r's ``compute_rows(k)``."""
        slices = shard_cohort_slices(int(k), self.data_shards)
        if slices is None:
            return None
        M, i = self.model_shards, r % self.model_shards
        lo, hi = slices[r // M]
        return lo + i * (hi - lo) // M, lo + (i + 1) * (hi - lo) // M

    def cohort_rows(self, k: int):
        """This rank's data slice's ``(lo, hi)`` rows of a k-row cohort
        (where the cohort is placed: the same on the slice's M ranks), or
        None when the data shards do not divide k (the cohort is then
        replicated)."""
        slices = shard_cohort_slices(int(k), self.data_shards)
        return None if slices is None else slices[self.data_index]

    def compute_rows(self, k: int):
        """This rank's ``(lo, hi)`` rows of a k-row cohort's compute: its
        data slice's rows split into ``model_shards`` contiguous pieces as
        even as can be (a piece may be empty); ``cohort_rows`` on a 1-D
        mesh, None when the cohort is replicated."""
        return self._rows_of(k, self.rank)

    def take_rows(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """This rank's ``compute_rows(k)`` of ``t``, which holds either the
        whole k-row cohort or its data slice's rows (as a sharded
        population stages them); ``t`` itself for a replicated cohort."""
        rows = self.compute_rows(k)
        if rows is None:
            return t
        lo, hi = rows
        if t.shape[0] != int(k):
            off = self.cohort_rows(k)[0]
            lo, hi = lo - off, hi - off
        return t[lo:hi]

    def _log(self, kind: str, name: str, t: torch.Tensor):
        if self.comm_log is not None:
            self.comm_log.append((kind, name, t.numel() * t.element_size()))

    def _gathers(self) -> bool:
        """Whether the backend takes gathers and reduces (NCCL, the dry
        run's ``fake`` group); over gloo a gather sums a zero-filled
        buffer."""
        return self.backend in ("nccl", "fake")

    def _stack(self, t: torch.Tensor, group, n: int, name: str
               ) -> torch.Tensor:
        """(n, *t.shape): the n ranks of ``group``'s equal ``t`` stacked in
        group-rank order (``all_gather_into_tensor``)."""
        out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
        self._log("all_gather", name, out)
        _all_gather(out, t.contiguous(), group=group)
        return out.view((n,) + tuple(t.shape))

    def _sum(self, t: torch.Tensor, group, name: str) -> torch.Tensor:
        self._log("all_reduce", name, t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        return self._sum(t, self.group, "world")

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data group (one rank a data slice), in place:
        a count each slice's M ranks computed alike."""
        return self._sum(t, self.data_group, "data")

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the model group (the M ranks of this data slice),
        in place: the partial sums of a d-sharded product."""
        if self.model_shards > 1:
            self._sum(t, self.model_group, "model")
        return t

    def model_gather(self, t: torch.Tensor, dim: int, full: int | None = None
                     ) -> torch.Tensor:
        """The model group's blocks of a tensor concatenated along ``dim``
        in model-index order. The blocks split ``full`` as ``model_cols``
        does (equal blocks of ``t.shape[dim]`` without it)."""
        M = self.model_shards
        if M == 1:
            return t
        full = t.shape[dim] * M if full is None else int(full)
        cuts = [j * full // M for j in range(M + 1)]
        if not self._gathers():
            shape = list(t.shape)
            shape[dim] = full
            buf = t.new_zeros(shape)
            lo, hi = cuts[self.model_index], cuts[self.model_index + 1]
            buf.narrow(dim, lo, hi - lo).copy_(t)
            return self.model_sum(buf)
        p = max(b - a for a, b in zip(cuts, cuts[1:]))
        if t.shape[dim] < p:
            pad = list(t.shape)
            pad[dim] = p - t.shape[dim]
            t = torch.cat([t, t.new_zeros(pad)], dim)
        out = self._stack(t, self.model_group, M, "model")
        return torch.cat([out[j].narrow(dim, 0, cuts[j + 1] - cuts[j])
                          for j in range(M)], dim)

    def data_stack(self, t: torch.Tensor) -> torch.Tensor:
        """(D, *t.shape): the data group's ``t`` (one rank a data slice,
        equal shapes) in slice order; over gloo, a zero-filled buffer with
        this slice's row written, summed over the data group."""
        D = self.data_shards
        if D == 1:
            return t[None]
        if self._gathers():
            return self._stack(t[None], self.data_group, D, "data").reshape(
                (D,) + tuple(t.shape))
        buf = t.new_zeros((D,) + tuple(t.shape))
        buf[self.data_index] = t
        return self.data_sum(buf)

    def fsdp_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The "data" axis' equal blocks of ``t`` concatenated along ``dim``
        in slice order (a leaf split over "data": ZeRO-3); over gloo, a
        zero-filled buffer with this rank's block written, summed over the
        ``fsdp_group``."""
        n = self.fsdp_shards
        if n == 1:
            return t
        if self._gathers():
            out = self._stack(t.movedim(dim, 0).contiguous(),
                              self.fsdp_group, n, "fsdp")
            return out.reshape((n * t.shape[dim],) + tuple(
                out.shape[2:])).movedim(0, dim)
        shape = list(t.shape)
        b = shape[dim]
        shape[dim] = b * n
        buf = t.new_zeros(shape)
        buf.narrow(dim, self.fsdp_index * b, b).copy_(t)
        return self._sum(buf, self.fsdp_group, "fsdp")

    def model_cols(self, d: int) -> tuple:
        """This rank's ``(lo, hi)`` block of d columns sharded over the
        model axis (a d-sharded ΔW, ``P(None, "model")``): contiguous and
        as even as can be."""
        M, i = self.model_shards, self.model_index
        return i * int(d) // M, (i + 1) * int(d) // M

    def warm_up(self, device):
        """One collective on each compute group (NCCL makes a group's
        communicator at its first collective, which must not happen inside
        a graph capture)."""
        z = torch.zeros(1, device=device)
        self.all_reduce(z)
        if self.model_shards > 1:
            self.data_sum(z)
            self.model_sum(z)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns it."""
        dist.broadcast(t, src=src, group=self.group)
        return t

    def gather_rows(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """The k-row cohort tensor whose rows ``compute_rows(k)`` this rank
        holds as ``t``, on every rank: each rank's rows, padded to the
        longest piece, gathered over the world; over gloo, a zero-filled
        buffer with this rank's rows written, summed over the world."""
        if not self._gathers():
            lo, hi = self.compute_rows(k)
            buf = t.new_zeros((int(k),) + tuple(t.shape[1:]))
            buf[lo:hi] = t
            return self.all_reduce(buf)
        spans = [self._rows_of(k, r) for r in range(self.world)]
        p = max(b - a for a, b in spans)
        if t.shape[0] < p:
            t = torch.cat([t, t.new_zeros((p - t.shape[0],)
                                          + tuple(t.shape[1:]))])
        out = self._stack(t, self.group, self.world, "world")
        return torch.cat([out[r, :b - a] for r, (a, b) in enumerate(spans)])

    def gather_cols(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """This rank's ``model_cols(d)`` block of every row of the (k, d)
        cohort matrix whose rows ``compute_rows(k)`` it holds as ``t``:
        the d-sharded ΔW of Alg. 3 and eq. 9, of which no rank receives a
        whole row. Each column block of the data slice's rows is reduced
        onto its model index (over gloo, summed over the model group and
        kept there), then the slices' blocks are gathered over the data
        group. A replicated cohort (solved whole here) needs no
        collective."""
        d = t.shape[1]
        c0, c1 = self.model_cols(d)
        rows = self.compute_rows(k)
        if rows is None:
            return t[:, c0:c1].contiguous()
        M = self.model_shards
        if M == 1:
            return self.gather_rows(t, k)
        (s0, s1), (lo, hi) = self.cohort_rows(k), rows
        mine = None
        for j in range(M):
            a, b = j * d // M, (j + 1) * d // M
            buf = t.new_zeros((s1 - s0, b - a))
            buf[lo - s0:hi - s0] = t[:, a:b]
            if self._gathers():
                self._log("reduce", "model", buf)
                dist.reduce(buf, dst=self.data_index * M + j,
                            group=self.model_group)
            else:
                self.model_sum(buf)
            if j == self.model_index:
                mine = buf
        D = self.data_shards
        if D == 1:
            return mine
        if self._gathers():
            return self._stack(mine, self.data_group, D, "data").reshape(
                int(k), c1 - c0)
        out = mine.new_zeros((int(k), c1 - c0))
        out[s0:s1] = mine
        return self.data_sum(out)

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

    def most(self, value: int) -> int:
        """The largest of the ranks' small integers ``value``, on every
        rank, over the host group: a decision that waits for the rank
        furthest behind (a process fleet's lease, whose outcome each rank
        reads off its own worker)."""
        t = torch.tensor([int(value)], dtype=torch.int64)
        if self.world > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host)
        return int(t[0])

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
        # a fake world (the dry run's) has no peers to reach over gloo
        fake = str(dist.get_backend()) == "fake"
        _HOST_GROUP = dist.new_group(backend=None if fake else "gloo")
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
    executor's client axis shards over ``data`` slices and the group
    parameters over ``model`` ranks (replicated when 1). ``data * model``
    must equal the world size. ``device`` defaults to the one
    ``init_process_group`` chose for this rank (else card ``LOCAL_RANK``);
    NCCL needs a card."""
    return _make_mesh({DATA_AXIS: int(data), MP_AXIS: int(model)}, device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> FedMesh:
    """The reference's production layout over the default process group:
    ``(16, 16)`` as ``("data", "model")``, or ``(2, 16, 16)`` as ``("pod",
    "data", "model")`` with ``multi_pod``; the world must be 256 or 512
    ranks (the federated dry run makes a ``fake`` one)."""
    shape = {DATA_AXIS: 16, MP_AXIS: 16}
    if multi_pod:
        shape = {POD_AXIS: 2, **shape}
    return _make_mesh(shape, device)


def _make_mesh(shape: dict, device) -> FedMesh:
    if not dist.is_initialized():
        raise RuntimeError("make_fed_mesh needs an initialised process group "
                           "(repro_torch.launch.mesh.init_process_group)")
    world = dist.get_world_size()
    if math.prod(shape.values()) != world or min(shape.values()) < 1:
        raise ValueError(f"mesh {tuple(shape.values())} does not cover the "
                         f"world of {world} ranks")
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
    rank, M = dist.get_rank(), int(shape[MP_AXIS])
    world_group = dist.group.WORLD
    data_group = model_group = world_group
    if M > 1:
        # every rank makes every group, in the same order
        for i in range(M):
            g = dist.new_group(list(range(i, world, M)))
            if rank % M == i:
                data_group = g
        for j in range(world // M):
            g = dist.new_group(list(range(j * M, (j + 1) * M)))
            if rank // M == j:
                model_group = g
    fsdp_group = data_group
    if POD_AXIS in shape and int(shape[POD_AXIS]) > 1:
        # the "data" axis within a pod: a leaf split over "data" alone
        per_pod = world // int(shape[POD_AXIS])
        for p in range(int(shape[POD_AXIS])):
            for i in range(M):
                g = dist.new_group(list(range(p * per_pod + i,
                                              (p + 1) * per_pod, M)))
                if rank // per_pod == p and rank % M == i:
                    fsdp_group = g
    return FedMesh(group=world_group, rank=rank, world=world,
                   shape=dict(shape), backend=backend, device=dev,
                   axis_names=tuple(shape), host=host_group(),
                   data_group=data_group, model_group=model_group,
                   fsdp_group=fsdp_group)


def make_local_mesh(*, device=None) -> FedMesh:
    """The world this process is in as a ``(world, 1)`` mesh."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialised process "
                           "group")
    return make_fed_mesh(dist.get_world_size(), 1, device=device)


class ParamLayout:
    """Where each leaf of a model's parameters lies at rest on a mesh with
    a model axis: ``group_param_pspec``'s block of its largest trailing dim
    that the model axis divides, for an m-stacked group leaf and for a
    global leaf alike (a global leaf's dim 0 stands where the group axis
    would, as the reference places both by the one spec). ``shapes`` are
    the unstacked leaves' shapes; a leaf with one more dim is m-stacked.

    ``block`` keeps this rank's block of each whole leaf, ``whole`` gathers
    the blocks over the model group (a collective). Each takes its leaves
    in the one form it converts from, and raises on any other; a leaf the
    spec leaves whole is the same in both."""

    def __init__(self, mesh: FedMesh, shapes: dict):
        self.mesh = mesh
        self.shapes = {k: tuple(int(x) for x in v) for k, v in shapes.items()}

    def _where(self, k: str, t: torch.Tensor, to: str) -> tuple:
        """(the whole leaf's shape, the model dim or None) of ``t``, which
        must be in the form ``block`` (whole) or ``whole`` (a block)
        takes."""
        base = self.shapes[k]
        full = (tuple(t.shape[:1]) + base if t.ndim == len(base) + 1
                else base)
        dim = model_dim(full, self.mesh.model_shards)
        want = list(full)
        if dim is not None and to == "whole":
            want[dim] //= self.mesh.model_shards
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"ParamLayout.{to}: leaf {k!r} is "
                             f"{tuple(t.shape)}, not the {tuple(want)} it "
                             f"takes")
        return full, dim

    def block(self, tree: dict) -> dict:
        out = {}
        for k, t in tree.items():
            full, dim = self._where(k, t, "block")
            if dim is not None:
                size = full[dim] // self.mesh.model_shards
                # a copy: a view would keep the whole leaf's storage alive
                t = t.narrow(dim, self.mesh.model_index * size, size).clone(
                    memory_format=torch.contiguous_format)
            out[k] = t
        return out

    def whole(self, tree: dict) -> dict:
        out = {}
        for k, t in tree.items():
            _, dim = self._where(k, t, "whole")
            if dim is not None:
                t = self.mesh.model_gather(t.contiguous(), dim)
            out[k] = t
        return out


def param_layout(mesh, model):
    """The ``ParamLayout`` of ``model``'s parameters (their shapes read
    from an init on ``meta``) on a mesh with a model axis; None otherwise
    (the parameters are whole on every rank)."""
    if mesh is None or mesh.model_shards == 1:
        return None
    return ParamLayout(mesh, {k: v.shape for k, v in
                              model.init(None, "meta").items()})
