"""Streamed populations: round cohorts over a host-resident client store
(``repro.fed.population``).

The pinned trainers place the whole padded population on the device at
init; this module is the large-N replacement. A ``Population`` bundles

  * a ``ClientStore`` (``fed.store``) holding the population on the host,
  * a ``Scheduler``: uniform (the pinned trainers' selection under the
    same seed), size-weighted or scripted cohorts, diurnal availability,
    and a Poisson *arrival process* that activates unseen clients every
    round, so FedGroup's eq.-9 client cold start runs every round,
  * a ``ClientStateTable`` (membership, cold flags, FeSEM's ``local_flat``
    rows, cached pre-training directions) gathered and scattered per
    cohort; ``local_flat`` writes land on a FIFO writer thread that every
    read drains first,
  * a *prefetcher*: a producer thread selects round t+1's cohort, gathers
    it from the store into one of ``prefetch + 1`` page-locked host slots
    and enqueues its host-to-device copy on a CUDA stream of its own,
    while round t runs. It records an event after the copy;
    ``next_cohort()`` makes the consumer's stream wait on that event
    before anything reads the cohort, and a slot is refilled only after
    its last copy's event completed. Eval blocks (``eval_batches``) and
    ad-hoc gathers (``device_batch``) go through the same staging. On the
    CPU a fresh host block takes the slot's place and the cohort's tensors
    view it: there is no copy.

Either way x is float32 and y and n are int64, the dtypes of the pinned
stacks, so the fused round sees the same inputs on both paths: a streamed
run equals its pinned run bit for bit on the CPU.

The population is also a distribution-shift stage: a ``ShiftConfig``
scripts label swaps and gradual drift (``ShiftSpec``), pure functions of
(round, client id, seed) applied to the host labels on every gather path
before the copy:

>>> import numpy as np
>>> from repro_torch.fed.population import ShiftConfig, ShiftSpec, \\
...     apply_shift
>>> sh = ShiftConfig([ShiftSpec(at=2, classes=(0, 2))])
>>> y = np.array([[0, 1, 2]])
>>> apply_shift(sh, 4, 3, 1, np.array([0]), y).tolist()   # before t=2
[[0, 1, 2]]
>>> apply_shift(sh, 4, 3, 2, np.array([0]), y).tolist()   # 0<->2 swapped
[[2, 1, 0]]

It is also the runtime's failure domain. A ``FaultConfig`` scripts
per-round faults (``FaultSpec``: clients killed mid-round, a straggling
gather, poisoned payloads, a killed state writer) against the production
paths; ``PopulationConfig.deadline`` bounds how long ``next_cohort()``
waits for the cohort before it degrades to the staged prefix (the gather
runs in ``stage_chunks`` pieces into the rows of the round's slot, so that
a prefix exists; a degraded cohort copies only its staged rows); a state write that fails is retried with
backoff. ``Population.stats`` counts what happened. ``ckpt_state()`` /
``ckpt_restore()`` capture the scheduler stream as of the last consumed
round and the state table, for the trainers' bit-identical resume.

The population owns the run's telemetry bundle (``obs``,
``repro_torch.obs``), which a trainer built on it shares: ``stats`` is a
view of the ``pop.*`` counters of its registry, and its tracer records the
cohorts' ``stage`` and ``h2d`` spans (on the producer thread when
prefetching) and the writer thread's ``state-write`` spans.

On a data mesh (``attach(cfg, mesh)`` with a ``launch.mesh.FedMesh``)
every rank's population draws the same cohorts and gathers only its
shard's rows of each: rows ``mesh.cohort_rows(K)`` of the cohort, from
the inner store of a ``ShardedClientStore`` (the rank's partition), into
its pinned slot and onto its own device, so a rank's H2D bytes are ∝ K /
S; n comes whole (the minibatch draws read it). A cohort the ranks do
not divide is gathered whole on every rank. Eval blocks split over the
ranks, whose counts the trainer sums. The per-client state writes take
the cohort's gathered rows, so every rank's host table stays a whole
replica.

Scripted faults and the deadline run on the mesh as on one device. Kills
and the corrupted lanes are drawn over the whole cohort from ``(seed,
t)``, as one device draws them; each rank poisons the lanes among its own
rows and counts them all, so ``stats`` agrees across ranks. A deadline
fires by rank 0's clock alone: every rank stages the whole cohort in
chunks on its host (the prefix the ranks agree on must exist on each),
rank 0 decides the prefix, every rank takes it through ``FedMesh.agree``
(inline, a decision before each chunk; prefetching, the prefix length,
which each rank's consumer then claims from its producer's staging) and
copies its rows of that prefix. A corrupted lane counts when it lies in
the prefix.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.fed.store import (SELECT_STREAM, ClientStateTable,
                                   ClientStore, ShardedClientStore,
                                   _host_rows)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import telemetry as obs_lib
from repro_torch.obs import trace as obs_trace

# the reference's population degradation counters (``Population.stats``):
# fault injection, the deadline and the state writer feed the first six,
# the async runtime's lease window the last two
_STATS_ZERO = {"deadline_rounds": 0, "deadline_dropped_clients": 0,
               "killed_clients": 0, "corrupted_clients": 0,
               "writer_crashes": 0, "writer_retries": 0,
               "lease_expiries": 0, "requeues": 0}


def pop_metric_specs():
    """The ``pop.*`` registry schema derived from ``_STATS_ZERO``."""
    return [obs_metrics.MetricSpec(f"pop.{k}", obs_metrics.COUNTER,
                                   "population degradation counter")
            for k in _STATS_ZERO]

# fault-injection sentinel: the writer thread returns without finishing
# its pending write, the observable state of a thread killed mid-write
_CRASH = object()

# spans of a writer made outside a Population (unit tests) go nowhere: a
# permanently disabled tracer, whose span() is the no-op path
_NULL_TRACER = obs_trace.Tracer(enabled=False)


class _AsyncStateWriter:
    """One background thread applying host state-table writes in FIFO
    order. ``drain()`` blocks until every submitted write has landed, and
    readers call it before any gather, so the asynchrony never reorders a
    read past a write.

    A write that raises is retried up to ``max_retries`` times, sleeping
    ``backoff * 2**attempt`` seconds (at most ``backoff_cap``) between
    attempts; ``retries`` counts the failed attempts that later succeeded
    (``Population.stats["writer_retries"]``). A write that still fails is
    recorded and raised by the next ``drain()``. Waits are bounded: a
    drain that outlives ``timeout``, or finds the worker dead with writes
    pending, raises instead of hanging. Each write runs in a
    ``state-write`` span of ``tracer``."""

    def __init__(self, timeout: float = 60.0, max_retries: int = 3,
                 backoff: float = 0.02, backoff_cap: float = 1.0,
                 tracer=None):
        self.timeout = timeout
        self._tracer = tracer if tracer is not None else _NULL_TRACER
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.retries = 0
        self._q = queue.Queue()
        self._thread = None
        self._err = None
        self._cond = threading.Condition()
        self._pending = 0
        self._label = None              # description of the write in flight

    def _attempt(self, fn, args):
        for attempt in range(self.max_retries + 1):
            try:
                fn(*args)
            except Exception as e:      # noqa: BLE001 — raised by drain()
                if attempt == self.max_retries:
                    self._err = e
                    return
                time.sleep(min(self.backoff * 2.0 ** attempt,
                               self.backoff_cap))
            else:
                self.retries += attempt
                return

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, label = item
            with self._cond:
                self._label = label
            if fn is _CRASH:
                return                  # injected: die, the write pending
            with self._tracer.span("state-write", label=label):
                self._attempt(fn, args)
            with self._cond:
                self._pending -= 1
                self._label = None
                self._cond.notify_all()

    def _enqueue(self, fn, args, label: str):
        with self._cond:
            self._pending += 1
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="state-table-writer", daemon=True)
            self._thread.start()
        # a dead thread is not restarted: its pending count stays up and
        # the next drain() reports the crash
        self._q.put((fn, args, label))

    def submit(self, fn, *args, label: str | None = None):
        self._enqueue(fn, args, label or getattr(fn, "__name__", "write"))

    def drain(self, timeout: float | None = None):
        """Block until every submitted write has landed, at most
        ``timeout`` seconds (default: the writer's); raise the first
        failed write's error."""
        limit = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + limit
        with self._cond:
            while self._pending > 0:
                if self._thread is not None and not self._thread.is_alive():
                    raise RuntimeError(
                        f"state-table writer thread died with "
                        f"{self._pending} write(s) pending (in flight: "
                        f"{self._label or 'queued, never started'})")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RuntimeError(
                        f"state-table write did not complete within "
                        f"{limit:.1f}s: {self._pending} pending (in "
                        f"flight: {self._label!r})")
                self._cond.wait(min(remaining, 0.1))
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async state-table write failed") from err

    def close(self, timeout: float | None = None):
        """Land the pending writes (bounded), then stop the worker."""
        self.drain(timeout)
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=5.0)
            self._thread = None

    def inject_thread_crash(self):
        """Fault injection: the worker exits without finishing a pending
        write, as a writer thread killed mid-write; the next ``drain()`` or
        ``close()`` raises instead of hanging."""
        self._enqueue(_CRASH, (), "<injected writer-thread crash>")


class _HostSlot:
    """Host buffers for up to ``rows`` clients of ``max_n`` samples (x
    float32, y and n int64), page-locked on the card's path, and the event
    recorded after the last copy out of them (None on the CPU)."""

    def __init__(self, rows: int, max_n: int, feat: tuple, pin: bool = True):
        self.rows = rows
        self.x = torch.empty((rows, max_n) + feat, dtype=torch.float32,
                             pin_memory=pin)
        self.y = torch.empty((rows, max_n), dtype=torch.int64,
                             pin_memory=pin)
        self.n = torch.empty((rows,), dtype=torch.int64, pin_memory=pin)
        self.event = None


class _SlotRing:
    """Slots taken round robin. ``take`` waits for the slot's last copy to
    finish before handing it out again (refilling it earlier would corrupt
    a transfer in flight) and replaces a slot too small for the request."""

    def __init__(self, count: int, rows: int, max_n: int, feat: tuple):
        self.rows, self.max_n, self.feat = rows, max_n, feat
        self.slots = [None] * count
        self.pos = 0

    def fill(self):
        """Allocate every slot now (so a failure to pin raises here)."""
        self.slots = [_HostSlot(self.rows, self.max_n, self.feat)
                      for _ in self.slots]

    def take(self, rows: int) -> _PinnedSlot:
        i = self.pos
        self.pos = (i + 1) % len(self.slots)
        slot = self.slots[i]
        if slot is not None and slot.event is not None:
            slot.event.synchronize()
        if slot is None or slot.rows < rows:
            slot = self.slots[i] = _HostSlot(max(rows, self.rows),
                                               self.max_n, self.feat)
        return slot


@dataclass
class FaultSpec:
    """What goes wrong in one round (all effects compose).

    kill            clients that die mid-round after selection: the tail of
                    the cohort drops (forced newcomers stage first and
                    survive), floored at 1 survivor; the round proceeds
                    with the rest, re-weighted by the segment sum.
    straggle        extra staging wall-clock (seconds) for this round's
                    cohort, spread over the gather chunks: what
                    ``PopulationConfig.deadline`` degrades against.
    corrupt         clients whose payload arrives poisoned: ``corrupt``
                    seeded cohort lanes have their train features
                    overwritten per ``corrupt_mode`` on the host, before
                    the copy, so the quarantine screen has NaN / Inf /
                    blown-up updates to catch.
    corrupt_mode    "nan" | "inf" | "scale" (features times
                    ``corrupt_scale``: finite, norm-outlier updates).
    writer_crash    kill the state writer thread mid-write this round (the
                    next drain raises, ``_AsyncStateWriter
                    .inject_thread_crash``).

    The ``worker_kill`` / ``heartbeat_delay`` / ``msg_*`` fields are the
    fleet faults: a ``Population`` ignores them, and the coordinator
    (``launch.coordinator``) reads them from ``FleetConfig.faults`` on its
    dispatch clock."""
    kill: int = 0
    straggle: float = 0.0
    corrupt: int = 0
    corrupt_mode: str = "nan"
    corrupt_scale: float = 64.0
    writer_crash: bool = False
    worker_kill: bool = False
    heartbeat_delay: float = 0.0
    msg_drop: bool = False
    msg_dup: bool = False
    msg_reorder: bool = False


@dataclass
class FaultConfig:
    """Scripted per-round faults (``PopulationConfig.faults``): ``rounds``
    maps round t to the ``FaultSpec`` injected that round; ``seed`` drives
    the choice of corrupted lanes, so a scenario replays identically."""
    rounds: dict
    seed: int = 0

    def spec(self, t: int) -> FaultSpec | None:
        return self.rounds.get(int(t))


@dataclass
class ShiftSpec:
    """One scripted distribution shift over the client population.

    at          first round the shift is live (train cohorts gathered for
                round ``at`` and eval blocks from round ``at`` on see it).
    kind        "label_swap" — every affected client's labels are remapped
                through one cycle of ``classes`` at once (the classic
                abrupt concept shift); "drift" — the remap phases in
                sample-by-sample over ``duration`` rounds (gradual concept
                drift): each sample flips at a fixed deterministic point of
                the ramp, so the set of remapped samples grows
                monotonically and any given round is reproducible.
    frac        fraction of clients affected (chosen by a seeded hash of
                the client id — the same clients every round / replay).
    classes     label cycle, e.g. ``(0, 2)`` swaps 0<->2 and ``(1, 2, 3)``
                rotates 1->2->3->1; None cycles *all* classes.
    duration    drift ramp length in rounds (ignored for label_swap).
    """
    at: int
    kind: str = "label_swap"
    frac: float = 1.0
    classes: tuple | None = None
    duration: int = 0


@dataclass
class ShiftConfig:
    """Scripted distribution-shift scenarios (``PopulationConfig.shift``):
    every ``ShiftSpec`` in ``specs`` composes, in order, onto the host
    label arrays of each gather; ``seed`` drives the affected-client and
    per-sample drift choices so a scenario replays identically across
    prefetch depths, restarts and checkpoint resumes (the transform is a
    pure function of (round, client id, seed) — nothing is persisted)."""
    specs: list
    seed: int = 0


def shift_client_mask(n_clients: int, seed: int, spec_index: int,
                      frac: float) -> np.ndarray:
    """(N,) bool mask of the clients a spec affects — a fixed seeded draw,
    identical every round, so a shifted client stays shifted."""
    if frac >= 1.0:
        return np.ones(n_clients, bool)
    rng = np.random.default_rng([int(seed), 0x5F1F7, int(spec_index)])
    return rng.random(n_clients) < frac


def shift_label_map(n_classes: int, classes) -> np.ndarray:
    """Label permutation for one spec: cycle ``classes`` by one position
    (identity elsewhere); ``classes=None`` cycles all labels."""
    mapping = np.arange(int(n_classes), dtype=np.int64)
    cyc = np.asarray(classes if classes is not None
                     else np.arange(int(n_classes)), np.int64)
    if len(cyc) >= 2:
        mapping[cyc] = np.roll(cyc, -1)
    return mapping


def apply_shift(cfg: "ShiftConfig | None", n_clients: int, n_classes: int,
                t, idx, y):
    """Apply every live spec of ``cfg`` to the (K, max_n) label block ``y``
    of clients ``idx`` as seen at round ``t``. Pure and deterministic:
    a copy is returned only when something actually changes. Padding rows
    beyond each client's ``n`` are remapped too, harmlessly — every
    consumer masks by the sample counts."""
    if cfg is None or t is None or int(t) < 0 or not cfg.specs:
        return y
    t = int(t)
    idx = np.asarray(idx, np.int64)
    out = None
    for si, spec in enumerate(cfg.specs):
        if t < spec.at:
            continue
        mask = shift_client_mask(n_clients, cfg.seed, si, spec.frac)
        rows = np.where(mask[idx])[0]
        if len(rows) == 0:
            continue
        if out is None:
            out = np.array(y, copy=True)
        mapping = shift_label_map(n_classes, spec.classes)
        if spec.kind == "label_swap":
            out[rows] = mapping[out[rows]]
        elif spec.kind == "drift":
            p = 1.0 if spec.duration <= 0 else \
                min(max((t - spec.at + 1) / spec.duration, 0.0), 1.0)
            for r in rows:
                u = np.random.default_rng(
                    [int(cfg.seed), 0xD51F7, si, int(idx[r])]
                ).random(out.shape[1])
                sel = u < p
                out[r, sel] = mapping[out[r, sel]]
        else:
            raise ValueError(f"unknown shift kind {spec.kind!r}")
    return y if out is None else out


@dataclass
class PopulationConfig:
    """Knobs of the streamed population (sampling, availability, arrivals,
    prefetch, eval). ``seed=None`` inherits the trainer's ``cfg.seed``, so a
    same-seed uniform, always-available population selects the pinned
    trainers' cohorts exactly.

    ``prefetch > 0`` stages the next cohorts on a producer thread. On eager
    rounds it has shown no measured gain over ``prefetch=0``: the round is
    host-bound and the producer's gather runs under the GIL in the
    launching thread's gaps (PERF.md §6). The default follows the
    reference's."""
    sampler: str = "uniform"        # uniform | size | scripted
    script: list | None = None      # scripted: per-round index arrays
    availability: str = "always"    # always | diurnal
    period: int = 24                # diurnal: rounds per simulated day
    duty: float = 0.5               # diurnal: awake fraction of the day
    initial_active: int | None = None   # None = whole population active
    arrival_rate: float = 0.0       # Poisson mean newcomers per round
    newcomers_join: bool = True     # arrivals are forced into their round's cohort
    prefetch: int = 2               # cohorts in flight (0 = synchronous)
    # eval on a fixed subsample; None = the whole population (the pinned
    # path's semantics, O(N) per evaluate())
    eval_clients: int | None = None
    eval_batch: int = 512           # clients per streamed eval block
    seed: int | None = None
    # straggler deadline (seconds): how long next_cohort() waits for the
    # whole cohort before it proceeds with the clients staged so far
    # (>= 1), re-weighting the segment sum instead of waiting. None = wait
    # for all. With a deadline the cohort stages in ``stage_chunks`` pieces
    # so that a prefix exists to degrade to.
    deadline: float | None = None
    stage_chunks: int = 8
    faults: FaultConfig | None = None   # scripted per-round faults
    shift: ShiftConfig | None = None    # scripted distribution shifts


@dataclass
class Cohort:
    """One scheduled round batch: ids and padded (x, y, n) tensors on the
    population's device. ``stage_ms`` is the host time of its select,
    gather and copy enqueue; ``_event`` the copy's event (None on the
    CPU), which ``next_cohort()`` makes the consumer wait on.
    ``sched_state`` is the scheduler's snapshot right after this cohort's
    select, kept when the trainer checkpoints: what a checkpoint at round t
    stores, since the live scheduler may be rounds ahead."""
    t: int
    idx: np.ndarray                 # (K,) client ids
    x: torch.Tensor                 # (K, max_n, ...) float32
    y: torch.Tensor                 # (K, max_n) int64
    n: torch.Tensor                 # (K,) int64
    n_new: int = 0                  # newcomers activated this round
    stage_ms: float = 0.0
    sched_state: dict | None = None
    total: int | None = None        # clients drawn (> K after a deadline)
    _event: object = field(default=None, repr=False)
    _pos: dict = field(default_factory=dict, repr=False)

    def positions(self, ids) -> np.ndarray | None:
        """Cohort-local positions of ``ids`` (None if any id is absent)."""
        if not self._pos:
            self._pos = {int(i): p for p, i in enumerate(self.idx)}
        try:
            return np.asarray([self._pos[int(i)] for i in ids], np.int64)
        except KeyError:
            return None


class Scheduler:
    """Availability-aware cohort selection + the newcomer arrival process.

    The active set starts as ``initial_active`` uniformly random clients
    (or everyone); each round ``select(t, k)`` first activates
    ``Poisson(arrival_rate)`` arrivals (in a fixed random arrival order),
    then samples the cohort from the *available* actives: everyone under
    ``availability='always'``, or the clients whose diurnal phase puts them
    awake at round t (each client keeps a fixed phase; a fraction ``duty``
    of the period is awake — the classic cross-device availability trace).
    Newcomers join their arrival round's cohort (they "report in", which
    is what feeds the eq.-9 cold-start path every round); the rest of the
    cohort fills uniformly or size-weighted without replacement.
    """

    def __init__(self, store: ClientStore, cfg: PopulationConfig, seed: int):
        self.store, self.cfg = store, cfg
        # same derived stream as the pinned trainers' select_rng
        self.rng = np.random.default_rng(
            [cfg.seed if cfg.seed is not None else seed, SELECT_STREAM])
        N = store.n_clients
        if cfg.sampler not in ("uniform", "size", "scripted"):
            raise ValueError(f"unknown sampler {cfg.sampler!r}")
        if cfg.sampler == "scripted" and not cfg.script:
            raise ValueError("scripted sampler needs cfg.script")
        self.active = np.ones(N, bool)
        self._arrival_queue = np.empty(0, np.int64)
        if cfg.initial_active is not None and cfg.initial_active < N:
            perm = self.rng.permutation(N)
            self.active[:] = False
            self.active[perm[:cfg.initial_active]] = True
            self._arrival_queue = perm[cfg.initial_active:]
        self.phase = (self.rng.integers(0, cfg.period, N)
                      if cfg.availability == "diurnal" else None)
        self.last_arrivals = np.empty(0, np.int64)
        self.rounds_scheduled = 0

    # -- availability ------------------------------------------------------
    def available_mask(self, t: int) -> np.ndarray:
        avail = self.active.copy()
        if self.phase is not None:
            awake = ((t + self.phase) % self.cfg.period) < \
                self.cfg.duty * self.cfg.period
            avail &= awake
        return avail

    def active_ids(self) -> np.ndarray:
        return np.where(self.active)[0]

    # -- arrivals ----------------------------------------------------------
    def _arrive(self) -> np.ndarray:
        cfg = self.cfg
        if cfg.arrival_rate <= 0 or len(self._arrival_queue) == 0:
            self.last_arrivals = np.empty(0, np.int64)
            return self.last_arrivals
        k = min(int(self.rng.poisson(cfg.arrival_rate)),
                len(self._arrival_queue))
        new, self._arrival_queue = (self._arrival_queue[:k],
                                    self._arrival_queue[k:])
        self.active[new] = True
        self.last_arrivals = new
        return new

    # -- selection ---------------------------------------------------------
    def select(self, t: int, k: int, dropout_rate: float = 0.0):
        """-> (cohort ids (K,), n_new). Sequential in t (the prefetcher is
        the only caller); all randomness comes from the scheduler rng."""
        cfg = self.cfg
        if cfg.sampler == "scripted":
            idx = np.asarray(cfg.script[t % len(cfg.script)], np.int64)
            self.rounds_scheduled += 1
            return idx, 0
        new = self._arrive()
        avail = self.available_mask(t)
        pool = np.where(avail)[0]
        if cfg.sampler == "uniform" and len(new) == 0 and \
                len(pool) == self.store.n_clients:
            # bit-compatible with the pinned trainers' selection: same
            # rng.choice(n, k) call when the whole population is available
            idx = self.rng.choice(self.store.n_clients,
                                  min(k, self.store.n_clients),
                                  replace=False)
        else:
            forced = new[:k] if cfg.newcomers_join else np.empty(0, np.int64)
            rest = pool[~np.isin(pool, forced)]
            want = min(k, len(rest) + len(forced)) - len(forced)
            if want > 0 and len(rest) > 0:
                if cfg.sampler == "size":
                    w = self.store.n_train[rest].astype(np.float64)
                    p = w / max(w.sum(), 1e-12)
                    fill = self.rng.choice(rest, want, replace=False, p=p)
                else:
                    fill = self.rng.choice(rest, want, replace=False)
            else:
                fill = np.empty(0, np.int64)
            idx = np.concatenate([forced, fill])
        if len(idx) == 0:
            # every active client is asleep this round — the round executor
            # needs >=1 client (the pinned dropout path keeps the same
            # floor), so wake one active client uniformly
            actives = np.where(self.active)[0]
            if len(actives) == 0:
                raise RuntimeError(
                    "population has no active clients to schedule "
                    "(initial_active=0 and no arrivals yet)")
            idx = self.rng.choice(actives, 1)
        if dropout_rate > 0.0 and len(idx):
            alive = self.rng.random(len(idx)) >= dropout_rate
            if not alive.any():
                alive[self.rng.integers(len(idx))] = True
            idx = idx[alive]
        self.rounds_scheduled += 1
        return idx, len(new)

    # -- checkpointing ------------------------------------------------------
    def snapshot(self) -> dict:
        """Everything ``select`` depends on besides t: rng stream, active
        set, pending arrival order. ``phase`` is deliberately absent — it
        is drawn once at construction, so a same-config fresh scheduler
        regenerates it before ``restore`` rewinds the rng."""
        return {"rng_state": self.rng.bit_generator.state,
                "active": self.active.copy(),
                "arrival_queue": self._arrival_queue.copy(),
                "last_arrivals": self.last_arrivals.copy(),
                "rounds_scheduled": int(self.rounds_scheduled)}

    def restore(self, snap: dict):
        self.rng.bit_generator.state = snap["rng_state"]
        self.active[:] = np.asarray(snap["active"], bool)
        self._arrival_queue = np.asarray(snap["arrival_queue"],
                                         np.int64).copy()
        self.last_arrivals = np.asarray(snap["last_arrivals"],
                                        np.int64).copy()
        self.rounds_scheduled = int(snap["rounds_scheduled"])


class _Staging:
    """Progress of one cohort's chunked gather into the rows of its
    ``slot`` (rows ``[0, n_staged)`` are staged), shared by the producer
    and a consumer whose deadline fired. The consumer claims the staged
    prefix (``claimed``), after which the producer abandons the round.
    ``done`` flips once every chunk is staged; it and ``claimed`` are set
    under ``cond``, so exactly one side owns the cohort."""

    def __init__(self, t: int, idx: np.ndarray, n_new: int,
                 sched_state: dict | None, slot, t0: float, spec=None):
        self.t = t
        self.idx = idx
        self.spec = spec
        self.n_new = n_new
        self.sched_state = sched_state
        self.slot = slot
        self.t0 = t0
        self.n_staged = 0
        self.cohort = None              # the producer's copy of all of it
        self.done = False
        self.claimed = False
        self.cond = threading.Condition()


class Population:
    """Store + scheduler + state table + prefetcher, bound to one trainer.

    Construct with a store and a ``PopulationConfig`` and pass it as a
    trainer's ``population=``; the trainer calls ``attach`` with its
    ``FedConfig`` and device. The prefetch thread starts at the first
    ``next_cohort()``, after FedGroup's group cold start has read
    ``scheduler.active_ids()`` (the producer runs the scheduler's rng up to
    ``prefetch`` rounds ahead).

    On a CUDA device the cohorts are staged through page-locked slots and a
    copy stream of the population's own; failing to pin memory or to
    create the stream raises: nothing gathers on the CPU instead.
    """

    # streamed rounds stay on the per-round path: the arrival process and
    # the prefetcher are observed by the host between rounds
    block_stageable = False

    def __init__(self, store: ClientStore, cfg: PopulationConfig | None = None):
        self.store = store
        self.cfg = cfg or PopulationConfig()
        self.state = ClientStateTable(store.n_clients)
        self.scheduler = None
        self.device = None
        self.mesh = None               # a data mesh: this rank's shard
        self._cuda_index = None
        self._copy_stream = None
        self._rings = {}
        self._k = None
        self._dropout = 0.0
        self._queue = None
        self._thread = None
        self._stop = threading.Event()
        self._producer_error = None
        # the run's telemetry bundle: its registry is this population's
        # own (counters never bleed between populations), its tracer the
        # process default's when a harness installed one
        self.obs = obs_lib.from_config(None)
        self._writer = _AsyncStateWriter(tracer=self.obs.tracer)
        self._warned_eval_scale = False
        self._cohort = None            # live (most recently consumed) cohort
        self._eval_ids = None
        self.rounds_streamed = 0
        self._staging = None           # the producer's chunked gather
        self._track_sched = False      # keep per-cohort scheduler snapshots
        self._consumed_sched = None    # the last consumed round's snapshot
        # fault, deadline, writer and lease counters: zeroed by each fresh
        # run() (reset_stats), carried through checkpoints. A view of the
        # pop.* metrics of this population's registry, which its trainer
        # shares; the producer and the consumer both count, under
        # _stats_lock
        self.registry = self.obs.registry
        self.registry.declare(pop_metric_specs())
        self.stats = self.registry.view({k: f"pop.{k}" for k in _STATS_ZERO})
        self._stats_lock = threading.Lock()

    def _count(self, **incs):
        with self._stats_lock:
            for k, n in incs.items():
                self.stats[k] += n

    def _set_stats(self, values: dict):
        with self._stats_lock:
            self.stats.update(_STATS_ZERO)
            self.stats.update(values)
        self._writer.retries = int(self.stats["writer_retries"])

    def reset_stats(self):
        """Zero the counters (the engine calls it at the start of a fresh
        run; a resumed run keeps the restored totals)."""
        self._set_stats({})

    # -- trainer binding ---------------------------------------------------
    def attach(self, fed_cfg, device_or_mesh="cuda"):
        """Bind to a trainer: its cohort size, dropout and seed, and its
        device (``cuda`` unless the caller asks for the CPU) or data mesh
        (a ``launch.mesh.FedMesh``: this rank's shard on the mesh's
        device). A trainer that checkpoints makes every cohort keep its
        scheduler snapshot."""
        if self.scheduler is not None:
            raise RuntimeError("Population is already attached to a trainer")
        if isinstance(device_or_mesh, mesh_lib.FedMesh):
            self.mesh = device_or_mesh
            device_or_mesh = self.mesh.device
        self.device = resolve_device(device_or_mesh)
        self.scheduler = Scheduler(self.store, self.cfg, seed=fed_cfg.seed)
        self._k = fed_cfg.clients_per_round
        self._dropout = fed_cfg.dropout_rate
        self._track_sched = bool(fed_cfg.checkpoint_every
                                 or fed_cfg.checkpoint_dir)
        if fed_cfg.telemetry_dir:
            # on a mesh rank 0 alone writes the directory
            self.obs.configure(fed_cfg.telemetry_dir
                               if mesh_lib.writes(self.mesh) else None)
        if self.device.type == "cuda":
            self._cuda_index = (self.device.index
                                if self.device.index is not None
                                else torch.cuda.current_device())
            self._copy_stream = torch.cuda.Stream(device=self._cuda_index)
            k = min(self._k, self.store.n_clients)
            # on a mesh with a deadline a rank may copy again a prefix of
            # a finished staging waiting on the queue: one slot more, so
            # that its rows are not refilled first
            extra = 2 if (self.mesh is not None
                          and self.cfg.deadline is not None) else 1
            train = _SlotRing(max(self.cfg.prefetch, 0) + extra, k,
                              self.store.max_train, self.store.feat)
            train.fill()
            self._rings["train"] = train
        if self.cfg.eval_clients is not None and \
                self.cfg.eval_clients < self.store.n_clients:
            eval_rng = np.random.default_rng(
                (self.cfg.seed if self.cfg.seed is not None
                 else fed_cfg.seed) + 0x5EED)
            self._eval_ids = np.sort(eval_rng.choice(
                self.store.n_clients, self.cfg.eval_clients, replace=False))
        else:
            self._eval_ids = np.arange(self.store.n_clients)

    # -- host -> device staging ----------------------------------------------
    def _ring(self, name: str) -> _SlotRing:
        """The slot ring of one staging path: "train" (the cohorts,
        ``prefetch + 1`` slots), "eval" (two slots, so one block's gather
        overlaps the previous block's eval) and "batch" (ad-hoc gathers)."""
        ring = self._rings.get(name)
        if ring is None:
            store = self.store
            if name == "eval":
                rows = min(max(int(self.cfg.eval_batch), 1),
                           len(self.eval_ids()))
                ring = _SlotRing(2, rows, store.max_test, store.feat)
            else:
                ring = _SlotRing(1, min(self._k, store.n_clients),
                                 store.max_train, store.feat)
            self._rings[name] = ring
        return ring

    def _ready(self, arrays, event):
        """Make the calling thread's current stream wait for the copy, and
        mark the tensors (allocated on the copy stream) as used by it, so
        the caching allocator does not hand their memory out while that
        stream may still read it."""
        if event is None:
            return arrays
        cur = torch.cuda.current_stream(self._cuda_index)
        cur.wait_event(event)
        for t in arrays:
            t.record_stream(cur)
        return arrays

    def _shift_host(self, t, idx, arrays):
        """The scripted distribution shift (if any) on one gathered host
        block, before fault corruption and the copy."""
        if self.cfg.shift is None:
            return arrays
        x, y, n = arrays
        return (x, apply_shift(self.cfg.shift, self.store.n_clients,
                               self.store.n_classes, t, idx, y), n)

    def _host(self, split: str, idx, t):
        """Store gather and shift of ``idx``: host (x, y, n)."""
        idx = np.asarray(idx, np.int64)
        return self._shift_host(t, idx, self.store._gather(split, idx))

    def _slot(self, ring: str, k: int) -> _HostSlot:
        """Staging rows for ``k`` clients: a pinned slot of ``ring`` on the
        card; on the CPU a fresh host block, which the cohort's tensors
        then view."""
        r = self._ring(ring)
        if self._copy_stream is None:
            return _HostSlot(k, r.max_n, r.feat, pin=False)
        return r.take(k)

    @staticmethod
    def _fill(slot, lo: int, arrays):
        """Host arrays into the slot's rows from ``lo`` on (x and y may hold
        fewer rows than n: a mesh rank's share of a cohort)."""
        x, y, n = arrays
        slot.x[lo:lo + len(x)].numpy()[...] = x
        slot.y[lo:lo + len(y)].numpy()[...] = y
        slot.n[lo:lo + len(n)].numpy()[...] = n

    def _copy(self, slot, k: int, kx: int | None = None, lo: int = 0):
        """The slot's rows ``[lo, lo + kx)`` of x and y and ``[0, k)`` of n
        (kx = k, lo = 0 but for a mesh rank's share) on the device ->
        ((x, y, n) tensors, event). On the CPU the tensors view the slot
        (event None). On the card the copy and then its event are enqueued
        on the copy stream: the tensors must not be read before ``_ready``
        made the reader's stream wait."""
        kx = k if kx is None else kx
        with self.obs.span("h2d", rows=int(kx)):
            if self._copy_stream is None:
                return (slot.x[lo:lo + kx], slot.y[lo:lo + kx],
                        slot.n[:k]), None
            with torch.cuda.stream(self._copy_stream):
                out = tuple(h[a:b].to(self.device, non_blocking=True)
                            for h, a, b in ((slot.x, lo, lo + kx),
                                            (slot.y, lo, lo + kx),
                                            (slot.n, 0, k)))
                slot.event = torch.cuda.Event()
                slot.event.record(self._copy_stream)
            return out, slot.event

    def _put(self, ring: str, arrays):
        """Host (x, y, n) -> (tensors, event), through a slot of ``ring``."""
        slot = self._slot(ring, len(arrays[2]))
        self._fill(slot, 0, arrays)
        return self._copy(slot, len(arrays[2]), len(arrays[0]))

    def _gather_put(self, ring: str, split: str, idx, t=None, spec=None,
                    pos=None, total=None):
        """Store gather, shift, the scripted corruption of ``spec`` and copy
        enqueue of ``idx``; ``t`` is the shift clock of the round this
        gather feeds (None = no shift). ``idx`` is a cohort of ``total``
        clients (default: all of it, whose poisoned lanes are counted) or
        the clients at its positions ``pos`` (a re-gather: nothing is
        counted). Under a mesh a train gather the ranks divide takes this
        rank's rows of x and y (from a ``ShardedClientStore``'s inner
        store, this rank's partition) and the whole n."""
        idx = np.asarray(idx, np.int64)
        if pos is None:
            self._count_corrupt(t, spec, len(idx), len(idx))
        pos = np.arange(len(idx)) if pos is None else np.asarray(pos)
        total = len(idx) if total is None else total
        rows = (self.mesh.cohort_rows(len(idx))
                if self.mesh is not None and split == "train" else None)
        if rows is None:
            return self._put(ring, self._corrupt(
                t, spec, self._host(split, idx, t), pos, total))
        store = self.store
        inner = store.inner if isinstance(store, ShardedClientStore) else store
        lo, hi = rows
        mine = idx[lo:hi]
        x, y, n = self._shift_host(t, mine, inner._gather(split, mine))
        # the lanes among this rank's rows poisoned
        x, y, n = self._corrupt(t, spec, (x, y, n), pos[lo:hi], total)
        return self._put(ring, (x, y, store.n_train[idx]))

    def device_batch(self, idx):
        """(x, y, n) on the device for any id set. Ids inside the live
        cohort are sliced from its tensors (the cold-start subset case);
        anything else is a fresh gather at the live cohort's shift clock.
        A mesh rank holds only its share of the cohort: a subset of it is
        gathered afresh, poisoned as the cohort's lanes were (drawn over
        all the clients of its round, ``total``, also when a deadline cut
        the cohort)."""
        idx = np.asarray(idx)
        c = self._cohort
        pos = spec = total = None
        if c is not None:
            pos = c.positions(idx)
            whole = pos is not None and len(pos) == len(c.idx) and \
                np.array_equal(pos, np.arange(len(pos)))
            if pos is not None and c.x.shape[0] != len(c.idx) and not whole:
                # a mesh rank's share of the cohort: the subset afresh
                spec = self._fault_spec(c.t)
                total = len(c.idx) if c.total is None else c.total
            elif whole:
                return c.x, c.y, c.n
            elif pos is not None:
                sel = torch.as_tensor(pos, device=c.x.device)
                return c.x[sel], c.y[sel], c.n[sel]
        return self._ready(*self._gather_put(
            "batch", "train", idx, t=self.rounds_streamed - 1, spec=spec,
            pos=pos if spec is not None else None, total=total))

    # -- persistent state --------------------------------------------------
    def gather_local_flat(self, idx) -> torch.Tensor:
        """(len(idx), d_w) CPU rows of FeSEM's ``local_flat``. Drains the
        writer first, so a gather observes every earlier scatter."""
        self._writer.drain()
        return self.state.gather_local_flat(idx)

    def scatter_local_flat(self, idx, rows):
        """Write the cohort's updated rows back into the host table: the
        device-to-host copy here, the per-row table update on the writer
        thread (it overlaps the eval and the next cohort's staging)."""
        rows = _host_rows(rows)
        self._writer.submit(self.state.scatter_local_flat,
                            np.asarray(idx).copy(), rows,
                            label=f"scatter_local_flat[{len(rows)} rows]")

    # -- fault injection ---------------------------------------------------
    def _fault_spec(self, t: int) -> FaultSpec | None:
        return self.cfg.faults.spec(t) if self.cfg.faults is not None \
            else None

    def _apply_kill(self, spec: FaultSpec | None, idx: np.ndarray):
        """Mid-round client death: the cohort's tail drops (forced
        newcomers come first and survive), floored at one survivor."""
        if spec is None or spec.kill <= 0 or len(idx) <= 1:
            return idx
        keep = max(len(idx) - int(spec.kill), 1)
        self._count(killed_clients=len(idx) - keep)
        return idx[:keep]

    def _corrupt_lanes(self, t: int, spec: FaultSpec | None,
                       total: int) -> np.ndarray:
        """Round t's seeded poisoned lanes of a ``total``-client cohort (the
        reference's numpy draw)."""
        if spec is None or spec.corrupt <= 0:
            return np.empty(0, np.int64)
        rng = np.random.default_rng([self.cfg.faults.seed, 0xFA017, t])
        return rng.choice(total, min(int(spec.corrupt), total),
                          replace=False)

    def _count_corrupt(self, t: int, spec, k: int, total: int):
        """Count the poisoned lanes of a ``total``-client cohort that lie in
        its first ``k`` (the cohort's count, the same on every rank of a
        mesh, whichever rows each holds)."""
        hit = int(np.sum(self._corrupt_lanes(t, spec, total) < k))
        if hit:
            self._count(corrupted_clients=hit)

    def _corrupt(self, t: int, spec: FaultSpec | None, arrays, pos,
                 total: int):
        """Poison the train features of this round's seeded cohort lanes
        among the rows of ``arrays``, on the host before the copy: the
        device sees exactly a poisoned upload. Row i is the cohort's lane
        ``pos[i]``; the lanes are the reference's (the same numpy draw).
        The caller counts them (``_count_corrupt``)."""
        if spec is None or spec.corrupt <= 0:
            return arrays
        lanes = self._corrupt_lanes(t, spec, total)
        x, y, n = arrays
        hit = np.flatnonzero(np.isin(pos, lanes))
        if len(hit) == 0:
            return arrays
        x = np.array(x, copy=True)
        if spec.corrupt_mode == "nan":
            x[hit] = np.nan
        elif spec.corrupt_mode == "inf":
            x[hit] = np.inf
        elif spec.corrupt_mode == "scale":
            x[hit] *= spec.corrupt_scale
        else:
            raise ValueError(f"unknown corrupt_mode {spec.corrupt_mode!r}")
        return (x, y, n)

    def _pre_round_faults(self, t: int):
        """Select, then the faults that act before the gather ->
        (idx, n_new, spec, scheduler snapshot)."""
        idx, n_new = self.scheduler.select(t, self._k, self._dropout)
        snap = self.scheduler.snapshot() if self._track_sched else None
        spec = self._fault_spec(t)
        idx = self._apply_kill(spec, np.asarray(idx, np.int64))
        if spec is not None and spec.writer_crash:
            self._count(writer_crashes=1)
            self._writer.inject_thread_crash()
        return idx, min(n_new, len(idx)), spec, snap

    def _chunking(self, spec: FaultSpec | None, n: int):
        """(chunk step, straggle sleep a chunk) of an n-client staged
        gather."""
        step = max(-(-n // max(int(self.cfg.stage_chunks), 1)), 1)
        straggle = spec.straggle if spec is not None else 0.0
        return step, (straggle / -(-n // step) if straggle > 0 else 0.0)

    def _chunk(self, t: int, spec, idx: np.ndarray, lo: int, step: int):
        """Gathered, shifted and corrupted host chunk ``idx[lo:lo+step]``
        (its poisoned lanes count when the cohort is taken)."""
        part = idx[lo:lo + step]
        return self._corrupt(t, spec, self._host("train", part, t),
                             np.arange(lo, lo + len(part)), len(idx))

    # -- streamed cohorts --------------------------------------------------
    def _sync_cohort(self, t: int) -> Cohort:
        """Select, gather and enqueue the copy of round t's whole cohort,
        with the scripted faults (a straggle sleeps before the gather):
        inline when ``prefetch=0``, on the producer thread otherwise. With
        a deadline, ``_stage_chunked`` stages instead."""
        t0 = time.perf_counter()
        with self.obs.span("stage", t=t):
            idx, n_new, spec, snap = self._pre_round_faults(t)
            if spec is not None and spec.straggle > 0:
                time.sleep(spec.straggle)
            # on a mesh this rank's shard of the cohort
            arrays, event = self._gather_put("train", "train", idx, t, spec)
        return Cohort(t, idx, *arrays, n_new,
                      stage_ms=(time.perf_counter() - t0) * 1e3,
                      sched_state=snap, total=len(idx), _event=event)

    def _stage_chunked(self, t: int, inline: bool):
        """Round t's cohort with a deadline: staged chunk by chunk into the
        rows of its slot. ``inline`` (``prefetch=0``): the cohort stops at
        the first chunk past the deadline. On the producer: the record is
        published as ``_staging``, so a consumer whose deadline fired can
        claim the staged prefix; the producer then abandons the round (its
        prefix is being trained on) and returns None, else it queues the
        finished record (``_take_staged``)."""
        with self.obs.span("stage", t=t):
            return self._chunked_cohort(t, inline)

    def _chunked_cohort(self, t: int, inline: bool):
        """Inline: round t's cohort, cut at the first chunk past the
        deadline. On the producer: the finished ``_Staging``, the copy of
        the whole cohort enqueued (overlapping the round in flight), or
        None when a consumer claimed a prefix first."""
        t0 = time.perf_counter()
        idx, n_new, spec, snap = self._pre_round_faults(t)
        st = _Staging(t, idx, n_new, snap, self._slot("train", len(idx)), t0,
                      spec)
        step, delay = self._chunking(spec, len(idx))
        end = time.monotonic() + self.cfg.deadline if inline else None
        if not inline:
            self._staging = st
        for lo in range(0, len(idx), step):
            if inline and lo > 0:
                late = time.monotonic() >= end
                if self.mesh is not None:
                    late = self.mesh.agree(late)     # rank 0's clock
                if late:
                    return self._take(st, lo)
            if delay:
                time.sleep(delay)
            if self._stop.is_set():
                return None
            # rows >= n_staged: a claimed prefix never reads them
            self._fill(st.slot, lo, self._chunk(t, spec, idx, lo, step))
            with st.cond:
                if st.claimed:
                    return None
                st.n_staged = min(lo + step, len(idx))
                # done with the last chunk, in one step: a claim always
                # takes a strict prefix
                st.done = st.n_staged == len(idx)
                st.cond.notify_all()
        if inline:
            return self._take(st, len(idx))
        st.cohort = self._staged_cohort(st, len(idx))
        return st

    def _staged_cohort(self, st: _Staging, k: int) -> Cohort:
        """Round ``st.t``'s cohort of its first ``k`` clients from its
        slot's rows (on a mesh this rank's rows of them), the copy
        enqueued."""
        rows = None if self.mesh is None else self.mesh.cohort_rows(k)
        if rows is None:
            arrays, event = self._copy(st.slot, k)
        else:
            arrays, event = self._copy(st.slot, k, rows[1] - rows[0], rows[0])
        return Cohort(st.t, st.idx[:k], *arrays, min(st.n_new, k),
                      stage_ms=(time.perf_counter() - st.t0) * 1e3,
                      sched_state=st.sched_state, total=len(st.idx),
                      _event=event)

    def _take(self, st: _Staging, k: int) -> Cohort:
        """Round ``st.t``'s cohort of its first ``k`` clients, counted: a
        degraded round's dropped clients, the poisoned lanes among the k.
        The producer's copy when it holds all of them, else a copy of the
        prefix's rows."""
        if k < len(st.idx):
            self._count(deadline_rounds=1,
                        deadline_dropped_clients=len(st.idx) - k)
        self._count_corrupt(st.t, st.spec, k, len(st.idx))
        if st.cohort is not None and k == len(st.idx):
            return st.cohort
        return self._staged_cohort(st, k)

    def _produce(self):
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)   # per thread
            t = self.rounds_streamed
            while not self._stop.is_set():
                item = (self._sync_cohort(t) if self.cfg.deadline is None
                        else self._stage_chunked(t, inline=False))
                t += 1
                while item is not None and not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except Exception as e:          # noqa: BLE001 — raised by next_cohort
            self._producer_error = e
            while not self._stop.is_set():
                try:                    # wake a blocked consumer
                    self._queue.put(None, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def _deadline_cohort(self, t: int) -> Cohort:
        """Round t's cohort with a deadline, prefetching. Rank 0 (one
        device: the only rank) waits for its whole cohort until the
        deadline, else claims the staged prefix of the gather in flight,
        and tells the ranks its length; every other rank takes exactly
        that many clients of its own producer's staging."""
        mesh = self.mesh
        if mesh is None or mesh.rank == 0:
            cohort = self._take_staged(
                t, end=time.monotonic() + self.cfg.deadline)
            if mesh is not None:
                mesh.agree(len(cohort.idx))
            return cohort
        return self._take_staged(t, k=mesh.agree(0))

    def _take_staged(self, t: int, end: float | None = None,
                     k: int | None = None) -> Cohort:
        """Round t's cohort from its ``_Staging``: ``k`` clients of it (all
        with k None), from the queue once the producer finished it (before
        ``end`` when given), else claimed from the gather in flight once
        ``k`` clients (past ``end``: at least one chunk) are staged. A
        claimed prefix's copy is enqueued before the claim's lock is
        released, so the producer cannot refill the slot before the
        copy's event."""
        while True:
            if end is not None and time.monotonic() < end:
                try:
                    st = self._queue.get(
                        timeout=min(end - time.monotonic(), 0.05))
                except queue.Empty:
                    continue
                break
            live = self._staging
            if live is None or live.t != t:
                # not visible yet, or already finished and on the queue
                try:
                    st = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                break
            with live.cond:
                while not live.done and live.n_staged < (k or 1):
                    if self._producer_error is not None:
                        raise RuntimeError("population prefetch thread "
                                           "failed") from self._producer_error
                    live.cond.wait(0.05)
                if not live.done:
                    live.claimed = True     # the producer abandons it
                    return self._take(live,
                                      live.n_staged if k is None else k)
            st = self._queue.get()
            break
        if st is None:                      # the producer died
            raise RuntimeError("population prefetch thread failed"
                               ) from self._producer_error
        return self._take(st, len(st.idx) if k is None else k)

    def next_cohort(self) -> Cohort:
        """The next scheduled round batch, its tensors safe to read on the
        calling thread's current stream. With ``prefetch=0`` selection and
        gather run inline. With ``cfg.deadline`` the wait for the whole
        cohort is bounded: past it the round proceeds with the staged
        prefix (>= 1 client), and ``stats`` counts the degraded rounds."""
        if self.scheduler is None:
            raise RuntimeError("attach() a trainer first")
        if self._stop.is_set():
            raise RuntimeError("population was close()d — the cohort "
                               "stream cannot be resumed")
        if self.cfg.prefetch <= 0:
            cohort = (self._sync_cohort(self.rounds_streamed)
                      if self.cfg.deadline is None else
                      self._stage_chunked(self.rounds_streamed, inline=True))
        else:
            if self._thread is None:
                self._queue = queue.Queue(maxsize=self.cfg.prefetch)
                self._thread = threading.Thread(
                    target=self._produce, name="population-prefetch",
                    daemon=True)
                self._thread.start()
            cohort = (self._queue.get() if self.cfg.deadline is None
                      else self._deadline_cohort(self.rounds_streamed))
            if cohort is None:          # producer died: raise its error
                raise RuntimeError(
                    "population prefetch thread failed"
                ) from self._producer_error
        cohort.x, cohort.y, cohort.n = self._ready(
            (cohort.x, cohort.y, cohort.n), cohort._event)
        self.rounds_streamed += 1
        self._cohort = cohort
        self._consumed_sched = cohort.sched_state
        return cohort

    def close(self):
        """Stop the prefetch thread (joined) and the state writer (pending
        writes land first; a writer killed by a fault raises here)."""
        self._stop.set()
        if self._thread is not None:
            # empty the queue so a producer blocked on put() sees the flag
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                raise RuntimeError("population prefetch thread did not stop")
            self._thread = None
        self._writer.close()

    # -- checkpointing ------------------------------------------------------
    def ckpt_state(self):
        """(arrays, meta) of the streamed runtime as of the last consumed
        round: the scheduler stream (rng, active set, pending arrivals),
        the state table's rows, the round count and ``stats``. Drains the
        writer first, so every scatter is in. Membership is left out: the
        trainer checkpoints it (the array is shared)."""
        if self.scheduler is None:
            raise RuntimeError("attach() a trainer first")
        self._writer.drain()
        self.stats["writer_retries"] = self._writer.retries
        snap = self._consumed_sched
        if snap is None:
            if self.rounds_streamed and self.cfg.prefetch > 0 \
                    and not self._track_sched:
                raise RuntimeError(
                    "cannot checkpoint a prefetching population whose "
                    "trainer was attached without checkpointing enabled "
                    "(FedConfig.checkpoint_every / checkpoint_dir): the "
                    "live scheduler stream is already ahead of the "
                    "consumed round")
            # nothing consumed yet, or inline: the live scheduler state is
            # the state after the consumed round
            snap = self.scheduler.snapshot()
        arrays = {"sched_active": snap["active"],
                  "sched_arrival_queue": np.asarray(snap["arrival_queue"],
                                                    np.int64),
                  "sched_last_arrivals": np.asarray(snap["last_arrivals"],
                                                    np.int64)}
        arrays.update(self.state.ckpt_arrays())
        meta = {"sched_rng": snap["rng_state"],
                "sched_rounds_scheduled": int(snap["rounds_scheduled"]),
                "rounds_streamed": int(self.rounds_streamed),
                "stats": {k: int(v) for k, v in self.stats.items()}}
        return arrays, meta

    def ckpt_restore(self, arrays: dict, meta: dict):
        """Rewind a fresh (attached, never streamed) population to a
        ``ckpt_state`` snapshot: the next select draws the checkpointed
        run's next cohort bit for bit."""
        if self.scheduler is None:
            raise RuntimeError("attach() a trainer first, then restore")
        if self._thread is not None or self.rounds_streamed:
            raise RuntimeError(
                "checkpoint restore needs a fresh population — this one "
                "has already streamed cohorts")
        self.scheduler.restore({
            "rng_state": meta["sched_rng"],
            "active": np.asarray(arrays["sched_active"], bool),
            "arrival_queue": np.asarray(arrays["sched_arrival_queue"],
                                        np.int64),
            "last_arrivals": np.asarray(arrays["sched_last_arrivals"],
                                        np.int64),
            "rounds_scheduled": meta["sched_rounds_scheduled"]})
        self.state.ckpt_restore(arrays)
        self.rounds_streamed = int(meta["rounds_streamed"])
        self._set_stats(meta.get("stats", {}))
        self._consumed_sched = self.scheduler.snapshot() \
            if self._track_sched else None

    # -- streamed evaluation ----------------------------------------------
    def eval_ids(self) -> np.ndarray:
        return self._eval_ids if self._eval_ids is not None \
            else np.arange(self.store.n_clients)

    def eval_batches(self, idx=None):
        """Yield (ids, x_test, y_test, n_test) blocks of at most
        ``eval_batch`` clients on the device: the whole population's eval
        without a whole-population device allocation."""
        idx = self.eval_ids() if idx is None else np.asarray(idx)
        if len(idx) > 20_000 and not self._warned_eval_scale:
            self._warned_eval_scale = True
            warnings.warn(
                f"streaming evaluation over {len(idx)} clients every "
                f"round is O(N) host gather — set "
                f"PopulationConfig.eval_clients to subsample (grouped "
                f"trainers' eval only touches assigned members)",
                stacklevel=2)
        B = max(int(self.cfg.eval_batch), 1)
        for lo in range(0, len(idx), B):
            block = idx[lo:lo + B]
            mine = block
            if self.mesh is not None:
                # this data slice's contiguous share (possibly empty):
                # the trainer sums the slices' integer counts
                mine = np.array_split(block, self.mesh.data_shards)[
                    self.mesh.data_index]
            x, y, n = self._ready(*self._gather_put(
                "eval", "test", mine, t=self.rounds_streamed - 1))
            yield block, x, y, n
