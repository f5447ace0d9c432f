"""Host-resident client population store and persistent per-client state
table (``repro.fed.store``).

The pinned trainers place the whole padded (N, max_n, ...) train/test
stacks on the device at init. The stores here keep the population on the
*host*, as materialised numpy arrays (``ArrayClientStore``, the small-N
case and the streamed-vs-pinned oracle's backing) or as a *virtual*
population (``VirtualClientStore``) whose clients are generated lazily
from a per-client seed and optionally persisted as memory-mapped ``.npy``
shard files. They expose the one operation the streamed engine needs:
``gather_train`` / ``gather_test`` over a cohort of client ids, returning
padded numpy arrays ready for one host-to-device copy
(``fed.population`` stages them through pinned buffers).

``ClientStateTable`` is the per-client state the dynamic frameworks keep
once the population no longer fits on the device: group membership and
cold flags (FedGroup eq. 9), FeSEM's flattened local models and the cached
pre-training directions. The row tables are ``_LazyRows`` over a CPU
default row, so memory scales with the clients ever touched, not N.

The table checkpoints its row tables (``ckpt_arrays`` / ``ckpt_restore``)
in the reference's key names.

``ShardedClientStore`` and ``shard_cohort_slices`` are the per-shard
gather over a data mesh: shard s's cohort rows are the s-th contiguous
block, the rows rank s of a ``launch.mesh.FedMesh`` holds, and each rank
gathers only its own (``fed.population``).
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.data.federated import FederatedData

# Seed-derivation tag of the cohort-selection rng stream: the pinned
# trainers' ``select_rng`` and the population ``Scheduler`` both draw from
# ``default_rng([seed, SELECT_STREAM])``, so a same-seed streamed run
# selects the pinned run's cohorts.
SELECT_STREAM = 0x5E1EC7


class ClientStore:
    """Interface: a host-resident population of ``n_clients`` padded
    clients.

    Concrete stores implement ``_gather(split, idx)`` returning padded host
    arrays ``(x (K, max_n, *feat), y (K, max_n), n (K,))`` for a cohort.
    ``n_train`` / ``n_test`` are full (N,) host size vectors.
    """

    name: str
    n_clients: int
    n_classes: int
    max_train: int
    max_test: int
    feat: tuple
    n_train: np.ndarray
    n_test: np.ndarray

    def gather_train(self, idx):
        return self._gather("train", np.asarray(idx, np.int64))

    def gather_test(self, idx):
        return self._gather("test", np.asarray(idx, np.int64))

    def _gather(self, split, idx):
        raise NotImplementedError

    def materialize(self, name: str | None = None) -> FederatedData:
        """The whole population as pinned-path ``FederatedData`` (small N
        only: exactly the materialisation the streamed path avoids)."""
        ids = np.arange(self.n_clients)
        xt, yt, nt = self.gather_train(ids)
        xe, ye, ne = self.gather_test(ids)
        return FederatedData(name or self.name, xt, yt, nt, xe, ye, ne,
                             self.n_classes, {"store": self.name})


class ArrayClientStore(ClientStore):
    """A materialised ``FederatedData`` behind the store API: the small-N
    backing and the streamed-vs-pinned equivalence oracle."""

    def __init__(self, data: FederatedData):
        self.data = data
        self.name = data.name
        self.n_clients = data.n_clients
        self.n_classes = data.n_classes
        self.max_train = data.x_train.shape[1]
        self.max_test = data.x_test.shape[1]
        self.feat = tuple(data.x_train.shape[2:])
        self.n_train = np.asarray(data.n_train)
        self.n_test = np.asarray(data.n_test)

    def _gather(self, split, idx):
        d = self.data
        if split == "train":
            return d.x_train[idx], d.y_train[idx], d.n_train[idx]
        return d.x_test[idx], d.y_test[idx], d.n_test[idx]


class VirtualClientStore(ClientStore):
    """Lazily generated population: client ``i``'s data is a pure function
    of ``i`` (``client_fn(i) -> {x, y, x_test, y_test}`` unpadded), so a
    10^5-10^6 client population costs only its (N,) size vectors until
    sampled. Two caching backends:

      * ``memmap_dir=None``: an LRU of the last ``cache_clients``
        generated clients.
      * ``memmap_dir=...``: clients are materialised in shard files of
        ``shard_clients`` clients (``np.lib.format.open_memmap``) the first
        time any member is touched; a shard counts as complete only once
        its ``done_*`` marker exists.
    """

    def __init__(self, name: str, n_clients: int, client_fn, *,
                 max_train: int, max_test: int, feat: tuple, n_classes: int,
                 n_train: np.ndarray, n_test: np.ndarray,
                 memmap_dir: str | None = None, shard_clients: int = 64,
                 cache_clients: int = 4096, x_dtype=np.float32):
        self.name = name
        self.n_clients = int(n_clients)
        self.client_fn = client_fn
        self.max_train, self.max_test = int(max_train), int(max_test)
        self.feat = tuple(feat)
        self.n_classes = int(n_classes)
        self.n_train = np.asarray(n_train, np.int32)
        self.n_test = np.asarray(n_test, np.int32)
        if self.n_train.shape != (self.n_clients,):
            raise ValueError(f"n_train has shape {self.n_train.shape}, "
                             f"expected ({self.n_clients},)")
        if int(self.n_train.max(initial=0)) > self.max_train or \
                int(self.n_test.max(initial=0)) > self.max_test:
            raise ValueError("a client's size exceeds max_train / max_test")
        self.x_dtype = x_dtype
        self.memmap_dir = memmap_dir
        self.shard_clients = int(shard_clients)
        self._shards = {}                      # shard id -> memmap arrays
        self._shard_locks = {}                 # shard id -> build lock
        self._cache = OrderedDict()            # client id -> padded tuple
        self.cache_clients = int(cache_clients)
        self._generated_ids = set()
        # the prefetch thread gathers train cohorts while the main thread's
        # streamed eval gathers test blocks: serialise the mutable backends
        # (LRU dict, shard check-then-create)
        self._lock = threading.Lock()

    @property
    def generated_clients(self) -> int:
        """Distinct clients ever generated (the lazy population's cost)."""
        return len(self._generated_ids)

    # -- per-client generation --------------------------------------------
    def _padded_client(self, i: int):
        c = self.client_fn(int(i))
        nt, ne = len(c["y"]), len(c["y_test"])
        if nt != self.n_train[i] or ne != self.n_test[i]:
            raise ValueError(
                f"client_fn({i}) produced {nt}/{ne} train/test samples, "
                f"size table says {self.n_train[i]}/{self.n_test[i]}")
        xt = np.zeros((self.max_train,) + self.feat, self.x_dtype)
        yt = np.zeros((self.max_train,), np.int32)
        xe = np.zeros((self.max_test,) + self.feat, self.x_dtype)
        ye = np.zeros((self.max_test,), np.int32)
        xt[:nt], yt[:nt] = c["x"], c["y"]
        if ne:
            xe[:ne], ye[:ne] = c["x_test"], c["y_test"]
        with self._lock:
            self._generated_ids.add(int(i))
        return xt, yt, xe, ye

    def _client(self, i: int):
        with self._lock:
            hit = self._cache.get(i)
            if hit is not None:
                self._cache.move_to_end(i)
                return hit
        out = self._padded_client(i)
        with self._lock:
            self._cache[i] = out
            while len(self._cache) > self.cache_clients:
                self._cache.popitem(last=False)
        return out

    # -- memmap shard backend ---------------------------------------------
    def _shard(self, s: int):
        """Open (or build) shard ``s``. Generation holds a per-shard lock
        only, so gathers of other shards are not serialised behind it."""
        with self._lock:
            arrs = self._shards.get(s)
            if arrs is not None:
                return arrs
            slock = self._shard_locks.setdefault(s, threading.Lock())
        with slock:
            with self._lock:
                arrs = self._shards.get(s)
                if arrs is not None:
                    return arrs
            arrs = self._open_or_build_shard(s)     # global lock not held
            with self._lock:
                self._shards[s] = arrs
        return arrs

    def _open_or_build_shard(self, s: int):
        lo = s * self.shard_clients
        hi = min(lo + self.shard_clients, self.n_clients)
        rows = hi - lo
        os.makedirs(self.memmap_dir, exist_ok=True)
        paths = {k: os.path.join(self.memmap_dir, f"{k}_{s:06d}.npy")
                 for k in ("xt", "yt", "xe", "ye")}
        done = os.path.join(self.memmap_dir, f"done_{s:06d}")
        shapes = {"xt": (rows, self.max_train) + self.feat,
                  "yt": (rows, self.max_train),
                  "xe": (rows, self.max_test) + self.feat,
                  "ye": (rows, self.max_test)}
        dtypes = {"xt": self.x_dtype, "yt": np.int32,
                  "xe": self.x_dtype, "ye": np.int32}
        # open_memmap('w+') creates the full-size file up front, so only the
        # marker (written after the flush) says a shard is complete
        fresh = not os.path.exists(done)
        mode = "w+" if fresh else "r"
        arrs = {k: np.lib.format.open_memmap(
            paths[k], mode=mode, dtype=dtypes[k], shape=shapes[k] if fresh
            else None) for k in paths}
        if fresh:
            for r, i in enumerate(range(lo, hi)):
                xt, yt, xe, ye = self._padded_client(i)
                arrs["xt"][r], arrs["yt"][r] = xt, yt
                arrs["xe"][r], arrs["ye"][r] = xe, ye
            for a in arrs.values():
                a.flush()
            with open(done, "w") as f:
                f.write("ok\n")
        return arrs

    def _gather(self, split, idx):
        K = len(idx)
        xk, yk = ("xt", "yt") if split == "train" else ("xe", "ye")
        max_n = self.max_train if split == "train" else self.max_test
        x = np.empty((K, max_n) + self.feat, self.x_dtype)
        y = np.empty((K, max_n), np.int32)
        if self.memmap_dir is not None:
            for r, i in enumerate(idx):
                arrs = self._shard(int(i) // self.shard_clients)
                row = int(i) % self.shard_clients
                x[r], y[r] = arrs[xk][row], arrs[yk][row]
        else:
            pick = {"xt": 0, "yt": 1, "xe": 2, "ye": 3}
            for r, i in enumerate(idx):
                c = self._client(int(i))
                x[r], y[r] = c[pick[xk]], c[pick[yk]]
        n = (self.n_train if split == "train" else self.n_test)[idx]
        return x, y, n


def shard_cohort_slices(K: int, n_shards: int):
    """Contiguous equal (lo, hi) cohort slices, one per data shard: the
    row blocks each rank of a data mesh holds. None when ``n_shards`` does
    not divide ``K`` (the cohort is then replicated, as
    ``fed.parallel.shard_client_axis`` places a non-divisible leaf)."""
    if n_shards <= 0 or K % n_shards:
        return None
    block = K // n_shards
    return [(s * block, (s + 1) * block) for s in range(n_shards)]


class ShardedClientStore(ClientStore):
    """Host-sharded population view: ``n_shards`` hosts, each gathering
    only its cohort slice.

    Wraps any inner ``ClientStore`` and keeps its metadata and size
    vectors; gathers decompose per shard. ``gather_train_shards`` /
    ``gather_test_shards`` return the per-shard padded host arrays (shard
    ``s`` covers cohort rows ``[s*K/S, (s+1)*K/S)``), and the plain
    ``ClientStore`` API is the concatenation of the shard gathers, so a
    ``ShardedClientStore`` is drop-in wherever a store is accepted, with
    bit-identical cohorts. Under a mesh each rank's population gathers
    only its own shard (``inner._gather`` of its slice)."""

    def __init__(self, inner: ClientStore, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.inner = inner
        self.n_shards = int(n_shards)
        self.name = f"{inner.name}@sharded{n_shards}"
        self.n_clients = inner.n_clients
        self.n_classes = inner.n_classes
        self.max_train = inner.max_train
        self.max_test = inner.max_test
        self.feat = inner.feat
        self.n_train = inner.n_train
        self.n_test = inner.n_test

    def _gather_shards(self, split: str, idx, n_shards: int | None = None):
        """-> list of per-shard (x, y, n) host tuples, or None when the
        shard count does not divide the cohort size."""
        idx = np.asarray(idx, np.int64)
        slices = shard_cohort_slices(len(idx), n_shards or self.n_shards)
        if slices is None:
            return None
        return [self.inner._gather(split, idx[lo:hi]) for lo, hi in slices]

    def gather_train_shards(self, idx, n_shards: int | None = None):
        return self._gather_shards("train", idx, n_shards)

    def gather_test_shards(self, idx, n_shards: int | None = None):
        return self._gather_shards("test", idx, n_shards)

    def _gather(self, split, idx):
        parts = self._gather_shards(split, idx)
        if parts is None:                     # non-divisible cohort
            return self.inner._gather(split, idx)
        return tuple(np.concatenate([p[i] for p in parts])
                     for i in range(3))


class _LazyRows:
    """(N, d) row table materialised per touched row: a shared default row
    plus an id -> row dict (memory ∝ clients touched). Rows live on the
    default row's device; ids are bookkept on the host."""

    def __init__(self, default_row: torch.Tensor):
        self.default_row = default_row.detach().float()
        self.rows = {}

    def gather(self, idx) -> torch.Tensor:
        """(len(idx), d) rows, the default where none was scattered."""
        idx = np.asarray(idx).ravel()
        if len(idx) == 0:
            return self.default_row.new_zeros((0,) + self.default_row.shape)
        return torch.stack([self.rows.get(int(i), self.default_row)
                            for i in idx])

    def scatter(self, idx, rows):
        rows = torch.as_tensor(rows, dtype=torch.float32,
                               device=self.default_row.device)
        for r, i in enumerate(np.asarray(idx).ravel()):
            self.rows[int(i)] = rows[r].clone()

    def delete(self, idx):
        """Drop materialised rows (untouched ids are a no-op) — the shift
        detector's cache invalidation: a deleted row reads back as the
        default until the next scatter."""
        for i in np.asarray(idx).ravel():
            self.rows.pop(int(i), None)

    def has(self, idx) -> np.ndarray:
        """(len(idx),) bool: which ids have a materialised row."""
        return np.array([int(i) in self.rows for i in np.asarray(idx)],
                        bool)

    def __len__(self):
        return len(self.rows)

    # -- checkpointing ------------------------------------------------------
    def ckpt_arrays(self) -> dict:
        """Dense numpy snapshot {ids (sorted), rows, default}."""
        ids = np.sort(np.fromiter(self.rows.keys(), np.int64, len(self.rows)))
        rows = (torch.stack([self.rows[int(i)] for i in ids]).cpu().numpy()
                if len(ids) else
                np.zeros((0,) + tuple(self.default_row.shape), np.float32))
        return {"ids": ids, "rows": rows,
                "default": self.default_row.cpu().numpy()}

    @classmethod
    def from_ckpt(cls, arrays: dict, device="cpu") -> "_LazyRows":
        """The table of a ``ckpt_arrays`` snapshot, its rows on
        ``device``."""
        table = cls(torch.as_tensor(np.asarray(arrays["default"],
                                               np.float32), device=device))
        table.scatter(arrays["ids"], np.asarray(arrays["rows"], np.float32))
        return table


def _host_rows(rows) -> torch.Tensor:
    """fp32 rows on the CPU (a device tensor is copied back)."""
    return torch.as_tensor(rows, dtype=torch.float32).detach().cpu()


class ClientStateTable:
    """Persistent per-client state, gathered and scattered per cohort.

    membership   (N,) int64 group id, -1 = cold (never assigned); the
                 grouped trainers share it by reference, so their in-place
                 writes persist across cohorts.
    local_flat   lazy (N, d_w) CPU rows: FeSEM's / FedClust's flattened
                 local models (the host replacement of the pinned device
                 matrix).
    pretrain_dir lazy (N, d_w) CPU rows: the eq.-9 pre-training direction
                 cached at client cold start (the shift detector reads it).
    """

    def __init__(self, n_clients: int):
        self.n_clients = int(n_clients)
        self.membership = np.full(self.n_clients, -1, np.int64)
        self._local_flat = None
        self._pretrain_dir = None
        self.group_version = None      # (m,) int64 per-group staleness clock

    def init_group_version(self, m: int) -> np.ndarray:
        """The (m,) per-group version counters of the async runtime
        (``FedAvgTrainer._group_version``), made once and shared by
        reference like ``membership``."""
        if self.group_version is None:
            self.group_version = np.zeros(int(m), np.int64)
        return self.group_version

    # -- cold flags --------------------------------------------------------
    def cold_mask(self) -> np.ndarray:
        return self.membership < 0

    def cold_ids(self, idx) -> np.ndarray:
        idx = np.asarray(idx)
        return idx[self.membership[idx] < 0]

    # -- FeSEM local models ------------------------------------------------
    def init_local_flat(self, default_row):
        if self._local_flat is None:
            self._local_flat = _LazyRows(_host_rows(default_row))

    def gather_local_flat(self, idx) -> torch.Tensor:
        if self._local_flat is None:
            raise RuntimeError("init_local_flat first")
        return self._local_flat.gather(idx)

    def scatter_local_flat(self, idx, rows):
        self._local_flat.scatter(idx, _host_rows(rows))

    # -- cached pre-training directions -------------------------------------
    def set_pretrain_dir(self, idx, rows):
        rows = _host_rows(rows)
        if self._pretrain_dir is None:
            self._pretrain_dir = _LazyRows(torch.zeros(rows.shape[-1]))
        self._pretrain_dir.scatter(idx, rows)

    def get_pretrain_dir(self, idx) -> torch.Tensor | None:
        if self._pretrain_dir is None:
            return None
        return self._pretrain_dir.gather(idx)

    def has_pretrain_dir(self, idx) -> np.ndarray:
        """(len(idx),) bool: which clients have a cached eq.-9 direction."""
        if self._pretrain_dir is None:
            return np.zeros(len(np.asarray(idx)), bool)
        return self._pretrain_dir.has(idx)

    def invalidate_pretrain_dir(self, idx):
        """Drop cached directions (shift migration): a migrated client's
        next read is the default until a fresh direction is scattered."""
        if self._pretrain_dir is not None:
            self._pretrain_dir.delete(idx)

    def touched_rows(self) -> int:
        return sum(len(t) for t in (self._local_flat, self._pretrain_dir)
                   if t is not None)

    # -- checkpointing ------------------------------------------------------
    _CKPT_TABLES = (("local_flat", "_local_flat"),
                    ("pretrain_dir", "_pretrain_dir"))

    def ckpt_arrays(self) -> dict:
        """The row tables as numpy, prefixed per table
        (``local_flat_ids`` ...). Membership is left out: the trainer,
        which shares the array, checkpoints it."""
        out = {}
        for name, attr in self._CKPT_TABLES:
            table = getattr(self, attr)
            if table is not None:
                for k, v in table.ckpt_arrays().items():
                    out[f"{name}_{k}"] = v
        return out

    def ckpt_restore(self, arrays: dict):
        """Rebuild the row tables of a ``ckpt_arrays`` snapshot (a table
        absent from it was never made and is left as it is)."""
        for name, attr in self._CKPT_TABLES:
            if f"{name}_ids" in arrays:
                setattr(self, attr, _LazyRows.from_ckpt(
                    {k: arrays[f"{name}_{k}"]
                     for k in ("ids", "rows", "default")}))
