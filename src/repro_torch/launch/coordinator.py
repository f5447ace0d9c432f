"""The elastic coordinator: process-level fault domains for the federated
runtime (``repro.launch.coordinator``; the port's own copy, held to it by
``tests/test_torch_fleet.py``, ``tests/test_torch_fleet_resume.py`` and
``tests/test_torch_fleet_proc.py``).

``Coordinator`` wraps an ordinarily-constructed trainer and routes its
train dispatches (the executors behind ``_round_executor`` /
``_block_executor`` / ``_async_executor``) through a worker fleet, while
keeping everything stateful exactly where the paper's reliable server owns
it — the m-stacked group params, the ``ClientStateTable``, membership,
both rng streams, the eq.-9 cold start, evaluation, staleness folds and
checkpointing all stay on the coordinator. Workers are stateless executors
(``launch.worker``); a per-round job is a pure function of its message, so
any worker — or the same worker after a restart — produces the
bit-identical result.

Every dispatch holds a **lease** (``fed.leases`` — the same
timeout/requeue/backoff machinery the async runtime uses): the job is
sent to a worker, and if the result is not back before the deadline — or
the holder is declared dead by the heartbeat miss-threshold detector, or
chaos dropped the message — the lease is requeued with capped exponential
backoff and re-dispatched to the next live worker. After ``max_retries``
requeues the job is unrecoverable and the run raises.

Failure detection is heartbeat-driven: workers beat every
``heartbeat_interval`` seconds; a worker silent for ``heartbeat_interval *
heartbeat_miss`` seconds is declared dead (``fleet.worker_deaths``), its
leases requeue, and the fleet degrades gracefully down to a single worker.
A late heartbeat resurrects (``fleet.joins``). Elastic membership is
scripted or programmatic: ``FleetConfig.joins``/``leaves`` adopt newcomer
workers or retire live ones at a given dispatch clock, and
:meth:`Coordinator.spawn`/:meth:`Coordinator.retire` do the same on
demand. A process-mode newcomer cold-starts itself by building its trainer
replica from the ``WorkerSpec`` before joining.

Chaos injection reads ``FaultSpec``'s fleet fields (``worker_kill``,
``heartbeat_delay``, ``msg_drop``, ``msg_dup``, ``msg_reorder``) per
dispatch-clock tick from ``FleetConfig.faults`` and applies them to that
dispatch's lease — a kill mid-dispatch, a muted heartbeat window, or
delivery-order faults on the transport. Because per-round jobs are pure,
every recovery path re-converges on the bit-identical run.

Fleet-size-1 in-process mode is the equivalence anchor: arguments pass by
reference to a thread running the trainer's own executors, so
``Coordinator(trainer).run()`` is bit-identical to ``trainer.run()`` for
every trainer, pinned and streamed.

On the card. An in-process job runs on the stream the coordinator's
thread dispatched from (the proxy sends it along; the current stream is
per thread in PyTorch), so the trainer's readiness events and the
population's ``record_stream`` order against the work. The block and
async executors capture their CUDA graph on their first call, which
behind the fleet happens on a worker thread: while a job runs the
coordinator's thread only waits on the lease (queue operations, no CUDA
call), and the population's producer thread never runs beside a graph
executor (streamed runs dispatch the eager per-round executor), so the
capture's global error mode sees no other thread's CUDA call. Each
executor still captures once: a fleet-routed block is replays of one
captured graph. Some jobs write state in place and so are not pure: on
the card the block executor's static carry and the async executor's
result slots (a slot is given back by the coordinator's fold, or here
when its result is superseded), and FeSEM's pinned rows on every device.
Message chaos is for the other per-round jobs. A process worker is its
own CUDA context: its payloads are numpy trees, and its results land on
the coordinator trainer's device.

On a mesh (the trainer's ``launch.mesh.FedMesh``, a data mesh or a
``(data, model)`` one) each rank's coordinator wraps that rank's trainer.
Its thread workers run the rank's executors inside the rank's process
group, so a job's collectives (over the data group, the model group and
the world) pair with the same job's on the other ranks. Every rank
dispatches the same jobs in the same order on the same dispatch clock, so
scripted kills, heartbeat delays and message faults hit the same job on
every rank. Each decision that reads a clock or a local delivery is taken
by rank 0 and followed by every rank (``FedMesh.agree``): a job's worker
(picked from rank 0's live set) and a lease's outcome (a result, or a
requeue on expiry, a lost message or the holder's death). A requeue waits
until this rank's abandoned attempt is over (it never ran, or its result
came back), so that no two jobs' collectives ever run at once on a rank.
The heartbeat counters are each rank's own.

A process worker is not a member of any process group, so it runs no
collective: a per-round job is split at the round's first collective
after the solves (``fed.rounds``' ``prepare`` / ``local`` / ``finish``).
The rank's coordinator runs ``prepare`` (on a model axis the gather of
the group parameters), its worker ``local`` on the rank's rows (the
assignment and the local solves, most of a round's time, with numpy
payloads both ways), and the coordinator ``finish`` (the sums over the
ranks, the aggregation, the gathers), so a process fleet's round is the
in-process round's computation in the same order, bit for bit. Without a
mesh the split is the same, on all the rows. Under a mesh each rank picks
from its own workers (their deaths are its own), and a lease's outcome is
the ranks' joint reading (``FedMesh.most``): the job is done when every
rank has its result, and requeued on every rank when any rank's lease
expired, lost its message or lost its holder. A SIGKILLed worker thus
never holds a rank in a collective: the ranks meet only in the
coordinators' own ``prepare`` and ``finish``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.fed import leases as leases_lib
from repro_torch.launch import worker as worker_lib
from repro_torch.launch.transport import (ChaosRouter, HeartbeatMonitor,
                                          InProcTransport, Message,
                                          ProcTransport)
from repro_torch.obs import metrics as metrics_lib

_MISSING = object()


@dataclass
class FleetConfig:
    """Control-plane knobs.

    transport           "inproc" (thread workers, bit-identity mode) or
                        "proc" (spawned processes, real fault domains —
                        requires ``worker_spec``; per-round pinned path
                        only; a worker runs a round's local solves).
    heartbeat_interval  worker beat period (seconds).
    heartbeat_miss      beats missed before a worker is declared dead.
    lease_timeout /     the fleet job lease's ``fed.leases.RetryPolicy``:
    max_retries /       a job not answered by the deadline requeues with
    backoff /           capped exponential backoff, at most ``max_retries``
    backoff_cap         times.
    join_timeout        how long to wait for a live worker before the run
                        fails (covers a process worker's replica build).
    faults              scripted chaos: ``FaultConfig`` whose ``rounds``
                        map *dispatch-clock* ticks to ``FaultSpec``s; only
                        the fleet fields are read here.
    joins / leaves      elastic membership scripts: {dispatch-clock:
                        [worker names]} adopted / retired at that tick.
    worker_spec         process-mode trainer replica recipe
                        (``launch.worker.WorkerSpec``).
    """
    n_workers: int = 1
    transport: str = "inproc"
    heartbeat_interval: float = 0.05
    heartbeat_miss: int = 3
    lease_timeout: float = 60.0
    max_retries: int = 3
    backoff: float = 0.01
    backoff_cap: float = 0.25
    join_timeout: float = 180.0
    faults: object | None = None
    joins: dict | None = None
    leaves: dict | None = None
    worker_spec: worker_lib.WorkerSpec | None = None


class _ExecutorProxy:
    """The executor seam: called like the real executor, it runs the job
    through lease + transport + fleet. Every other attribute (``max_steps``,
    ``bind``, ``release``, ``replays``, ...) is the real executor's, read
    and called on the coordinator."""

    def __init__(self, coord, fn_name: str, real, remote: bool):
        self._coord = coord
        self._fn_name = fn_name
        self._remote = remote
        self.__wrapped__ = real

    def __call__(self, *args):
        return self._coord._dispatch(self._fn_name, args, self._remote)

    def __getattr__(self, name):
        # only reached for names the proxy itself does not have
        return getattr(self.__dict__["__wrapped__"], name)


class Coordinator:
    """Owns the trainer (and with it all training state); routes its train
    dispatches through the worker fleet. See the module docstring."""

    def __init__(self, trainer, fleet: FleetConfig | None = None):
        self.trainer = trainer
        self.fleet = fleet or FleetConfig()
        self.mesh = getattr(trainer, "mesh", None)
        # under a mesh: thread workers follow rank 0's pick and outcome; a
        # process fleet's ranks pick their own and read the outcome jointly
        self._joint = (self.mesh is not None
                       and self.fleet.transport == "proc")
        self.obs = trainer.obs
        self.obs.registry.declare(metrics_lib.FLEET_SCHEMA)
        self._policy = leases_lib.RetryPolicy(
            self.fleet.lease_timeout, self.fleet.max_retries,
            self.fleet.backoff, self.fleet.backoff_cap)
        self._monitor = HeartbeatMonitor(self.fleet.heartbeat_interval,
                                         self.fleet.heartbeat_miss)
        self._chaos = ChaosRouter(self.obs.registry)
        self._clock = 0              # train dispatches submitted (the
        self._job_id = 0             # chaos/elasticity script clock)
        self._rr = 0                 # round-robin cursor
        self._live: list = []        # adopted worker names, join order
        self._workers: dict = {}     # name -> InProcWorker (inproc mode)
        self._results: dict = {}     # job_id -> payload (delivered)
        self._done: set = set()      # completed/abandoned job ids (so a
        #                              late or duplicated result is ignored)
        self._async_jobs: set = set()  # job ids of async dispatches
        self._killed: set = set()    # workers hard-killed (run no more jobs)
        self._names: list = []       # every worker spawned, in spawn order
        self._closed = False
        if self.fleet.transport == "inproc":
            self._transport = InProcTransport()
            self._table = worker_lib.worker_fn_table(trainer)
            self._real = dict(self._table)
        elif self.fleet.transport == "proc":
            self._validate_proc(trainer)
            self._transport = ProcTransport()
            self._table = None
            # the coordinator's own executor: its attributes (max_steps)
            # for the engine, and the halves of a job the coordinator runs
            # (prepare, finish); never called whole
            self._real = {"round": trainer._round_executor()}
        else:
            raise ValueError(
                f"unknown fleet transport {self.fleet.transport!r} "
                f"(expected 'inproc' or 'proc')")
        self._patch(trainer)
        for i in range(self.fleet.n_workers):
            self.spawn(f"w{i}")

    # -- setup ----------------------------------------------------------
    def _validate_proc(self, trainer):
        cfg = trainer.cfg
        if self.fleet.worker_spec is None:
            raise ValueError("proc transport needs FleetConfig.worker_spec "
                             "(the worker-side trainer replica recipe)")
        if trainer.population is not None:
            raise ValueError("proc transport supports pinned trainers only "
                             "(the streamed population's prefetched device "
                             "cohorts cannot cross a process boundary)")
        if cfg.block_size > 1 or cfg.async_depth >= 1:
            raise ValueError("proc transport supports the per-round path "
                             "only (set block_size=1, async_depth=0)")

    def _patch(self, trainer):
        """Route the trainer's executor seams through the fleet.
        Everything else — staging, rng, cold start, eval, folds,
        checkpoints — keeps running on the coordinator, unchanged."""
        remote = self.fleet.transport == "proc"
        for fn_name, real in self._real.items():
            setattr(trainer, f"_{fn_name}_exec",
                    _ExecutorProxy(self, fn_name, real, remote))
        trainer._fleet_meta = self._fleet_meta

    def _fleet_meta(self) -> dict:
        """The control-plane checkpoint snapshot (the archive's ``fleet``
        metadata): enough to resume the chaos/elasticity script clock and
        audit the fleet shape at save time."""
        return {"transport": self.fleet.transport,
                "n_workers": int(self.fleet.n_workers),
                "live": sorted(self._live),
                "dispatch_clock": int(self._clock),
                "next_job_id": int(self._job_id)}

    # -- fleet membership -----------------------------------------------
    def spawn(self, name: str):
        """Start (and eventually adopt) a worker. In-process workers share
        the coordinator's executor table; process workers build their own
        trainer replica from the ``WorkerSpec`` (their cold start) and
        join once it is up. Adoption happens when the ``join`` message is
        pumped — dispatches only ever go to adopted workers."""
        self._names.append(name)
        if self.fleet.transport == "inproc":
            ep = self._transport.add_worker(name)
            w = worker_lib.InProcWorker(name, ep, self._table,
                                        self.fleet.heartbeat_interval,
                                        device=self.trainer.device)
            self._workers[name] = w
            w.start()
        else:
            self._transport.add_worker(
                name, worker_lib.worker_entry, self.fleet.worker_spec,
                self.fleet.heartbeat_interval)

    def retire(self, name: str):
        """Graceful leave: stop dispatching to the worker and ask it to
        drain and exit; the ``leave`` message finalizes the departure."""
        if name in self._live:
            self._live.remove(name)
            self.obs.registry.set("fleet.workers", len(self._live))
        self._transport.send(name, Message("stop"))

    def kill_worker(self, name: str):
        """Hard-kill a worker (the chaos primitive): SIGKILL in process
        mode, a no-reply hard-stop in-process. Detection is the heartbeat
        monitor's job (or the closed pipe's), not ours."""
        self._killed.add(name)
        if self.fleet.transport == "inproc":
            w = self._workers.get(name)
            if w is not None:
                w.kill()
        else:
            self._transport.kill(name)

    def _adopt(self, name: str, now: float):
        if name in self._live:
            return
        self._live.append(name)
        self._monitor.add(name, now)
        self.obs.registry.inc("fleet.joins")
        self.obs.registry.set("fleet.workers", len(self._live))

    def _declare_dead(self, name: str):
        if name in self._live:
            self._live.remove(name)
        self.obs.registry.inc("fleet.worker_deaths")
        self.obs.registry.set("fleet.workers", len(self._live))

    def _on_leave(self, name: str):
        if name in self._live:
            self._live.remove(name)
        self._monitor.remove(name)
        self._workers.pop(name, None)
        self._transport.remove_worker(name)
        self.obs.registry.inc("fleet.leaves")
        self.obs.registry.set("fleet.workers", len(self._live))

    # -- the message pump -----------------------------------------------
    def _route(self, msg: Message, now: float):
        reg = self.obs.registry
        if msg.kind == "heartbeat":
            reg.inc("fleet.heartbeats")
            if self._monitor.beat(msg.src, now) \
                    and msg.src not in self._live:
                # back from the dead (a muted/delayed heartbeat window):
                # re-adopt — the resurrection path. ``beat`` only returns
                # True for a previously-adopted worker.
                self._live.append(msg.src)
                reg.inc("fleet.joins")
                reg.set("fleet.workers", len(self._live))
        elif msg.kind == "join":
            self._adopt(msg.src, now)
        elif msg.kind == "leave":
            self._on_leave(msg.src)
        elif msg.kind == "result":
            if msg.job_id in self._done or msg.job_id in self._results:
                # a superseded lease's late answer, or a chaos-duplicated
                # delivery: the first result won, this copy is ignored
                reg.inc("fleet.stale_results")
                if msg.job_id in self._async_jobs and msg.job_id in self._done:
                    # a superseded async dispatch: its result slot is free
                    self._async_jobs.discard(msg.job_id)
                    self._real["async"].release(msg.payload)
            else:
                self._results[msg.job_id] = msg.payload
        elif msg.kind == "error":
            raise RuntimeError(
                f"fleet worker {msg.src!r} failed job {msg.job_id}:\n"
                f"{msg.payload}")
        elif msg.kind == "eof":
            # closed pipe: the fast path of process-death detection. The
            # pipe must come out of the transport either way, or the
            # closed fd keeps signalling ready forever.
            self._transport.remove_worker(msg.src)
            if msg.src in self._live:
                with self.obs.span("heartbeat", worker=msg.src,
                                   event="eof"):
                    self._monitor.remove(msg.src)
                    self._declare_dead(msg.src)

    def _pump(self, timeout: float):
        """Drain every available message (blocking up to ``timeout`` for
        the first), then sweep the heartbeat monitor — drain-first keeps
        queued beats from reading as misses."""
        now = time.monotonic()
        msg = self._transport.recv(timeout)
        while msg is not None:
            for m in self._chaos.filter(msg, now):
                self._route(m, now)
            msg = self._transport.recv(0.0)
            now = time.monotonic()
        for name in self._monitor.sweep(time.monotonic()):
            self.obs.registry.inc("fleet.heartbeat_misses")
            with self.obs.span("heartbeat", worker=name, event="miss"):
                self._declare_dead(name)

    # -- dispatch -------------------------------------------------------
    def _elastic(self):
        """Apply the membership script for this dispatch-clock tick."""
        for name in (self.fleet.joins or {}).get(self._clock, ()):
            self.spawn(name)
        for name in (self.fleet.leaves or {}).get(self._clock, ()):
            self.retire(name)

    def _pick_worker(self) -> str:
        """The next live worker, round robin. With thread workers on a
        mesh rank 0 picks and every rank takes its pick (by spawn order,
        the same on every rank): a rank's own live set follows its own
        heartbeat clock. A process fleet's rank picks from its own."""
        agreed = self.mesh is not None and not self._joint
        if agreed and self.mesh.rank != 0:
            return self._names[self.mesh.agree(0)]
        deadline = time.monotonic() + self.fleet.join_timeout
        while not self._live:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "fleet has no live workers (all dead or departed, and "
                    "none joined within join_timeout="
                    f"{self.fleet.join_timeout}s)")
            self._pump(0.01)
        w = self._live[self._rr % len(self._live)]
        self._rr += 1
        if agreed:
            self.mesh.agree(self._names.index(w))
        return w

    def _lease_state(self, job_id: int, holder: str, deadline: float,
                     sent: bool) -> int:
        """This rank's reading of a lease: 1 its result is here, 2 it must
        requeue (not sent, timeout, dropped message, or the holder died),
        0 wait."""
        if job_id in self._results:
            return 1
        if not sent or job_id in self._chaos.dropped:
            # no inbox, or the transport lost the result: informationally
            # a timeout, resolved now instead of stalling out the lease
            return 2
        if holder not in self._live:
            return 2                     # holder died: requeue immediately
        return 2 if time.monotonic() >= deadline else 0

    def _await_result(self, job_id: int, holder: str, deadline: float,
                      sent: bool):
        """The lease wait: the result, or ``_MISSING`` when the lease must
        requeue. With thread workers on a mesh rank 0's reading decides
        for every rank; a process fleet's ranks decide jointly: done when
        every rank has its result, requeued when any rank must requeue."""
        while True:
            self._pump(0.005)
            state = self._lease_state(job_id, holder, deadline, sent)
            if self._joint:
                # as severities (result here 0, wait 1, requeue 2): the
                # largest is the ranks' joint state
                state = (1, 0, 2)[self.mesh.most((1, 0, 2)[state])]
                if state == 2:
                    self._drop_stale(job_id)
            elif self.mesh is not None:
                state = self.mesh.agree(state)
                if state:
                    # on 1 rank 0 has its result: this rank's attempt ran
                    # too (its collectives paired), so its result comes
                    self._settle(job_id, holder, sent, state == 1)
            if state == 1:
                return self._results.pop(job_id)
            if state == 2:
                self._chaos.dropped.discard(job_id)
                return _MISSING

    def _settle(self, job_id: int, holder: str, sent: bool, arrived: bool):
        """On a mesh, after rank 0's decision: with ``arrived`` wait for
        this rank's result; else wait until this rank's abandoned attempt
        is over (it was never sent, its holder was killed before the job,
        or its result came back or was dropped), so that a requeued
        attempt never runs beside it, and drop a result that came back as
        stale, as ``_route`` drops a late one."""
        def over():
            return job_id in self._results or (not arrived and (
                not sent or holder in self._killed
                or job_id in self._chaos.dropped))
        limit = time.monotonic() + self.fleet.lease_timeout
        while not over():
            if time.monotonic() >= limit:
                raise RuntimeError(
                    f"rank {self.mesh.rank}: fleet job {job_id} did not "
                    f"settle within lease_timeout={self.fleet.lease_timeout}"
                    "s of rank 0's decision: the ranks have diverged")
            self._pump(0.005)
        if not arrived:
            self._drop_stale(job_id)

    def _drop_stale(self, job_id: int):
        """Drop this rank's result of an attempt the ranks gave up (a
        stale result, as ``_route`` drops a late one)."""
        if job_id in self._results:
            payload = self._results.pop(job_id)
            self.obs.registry.inc("fleet.stale_results")
            if job_id in self._async_jobs:
                self._async_jobs.discard(job_id)
                self._real["async"].release(payload)

    def _dispatch(self, fn_name: str, args: tuple, remote: bool):
        """One train dispatch through the fleet (an ``_ExecutorProxy``
        call): the chaos and membership scripts of this clock tick, then
        the lease. An in-process job carries the calling thread's CUDA
        stream. A remote job is the round's ``local`` half: the
        coordinator runs ``prepare`` first and ``finish`` on the result,
        which comes back as numpy and lands on the trainer's device."""
        spec = (self.fleet.faults.spec(self._clock)
                if self.fleet.faults is not None else None)
        self._elastic()
        self._clock += 1
        if remote:
            real = self._real[fn_name]
            ctx, local_args = real.prepare(*args)
            payload = (fn_name, worker_lib._to_numpy(local_args))
        else:
            dev = self.trainer.device
            stream = (torch.cuda.current_stream(dev)
                      if dev.type == "cuda" else None)
            payload = (fn_name, args, stream)
        lease = leases_lib.Lease(staged=payload)
        result = self._dispatch_lease(lease, spec, fn_name == "async")
        if remote:
            result = real.finish(ctx, worker_lib._to_device(
                result, self.trainer.device))
        return result

    def _dispatch_lease(self, lease, spec, is_async: bool = False):
        reg = self.obs.registry
        buf = leases_lib.RequeueBuffer()
        attempts = 0
        while True:
            holder = self._pick_worker()
            if spec is not None and getattr(spec, "worker_kill", False):
                # killed mid-dispatch: the holder dies with the job in
                # flight; heartbeat misses (or the closed pipe) detect it
                self.kill_worker(holder)
            if spec is not None and getattr(spec, "heartbeat_delay", 0.0):
                self._chaos.mute_heartbeats(
                    holder, time.monotonic() + float(spec.heartbeat_delay))
            job_id = self._job_id
            self._job_id += 1
            self._chaos.arm(spec, job_id)
            spec = None                  # chaos fires once per scripted tick
            if is_async:
                self._async_jobs.add(job_id)
            reg.inc("fleet.jobs")
            lease.holder, lease.job_id = holder, job_id
            lease.deadline = self._policy.deadline(time.monotonic())
            with self.obs.span("lease", job=job_id, worker=holder,
                               attempt=attempts):
                sent = self._transport.send(
                    holder, Message("job", job_id=job_id,
                                    payload=lease.staged))
                result = self._await_result(job_id, holder, lease.deadline,
                                            sent)
            self._done.add(job_id)
            if result is not _MISSING:
                self._async_jobs.discard(job_id)
                reg.inc("fleet.results")
                return result
            # expired / lost / holder died: requeue with capped backoff
            # (raises "unrecoverable" after max_retries, like the async
            # runtime's cohort leases)
            reg.inc("fleet.lease_expiries")
            lease.attempts = attempts
            buf.push(lease, self._policy, time.monotonic(),
                     what="fleet job", timeout_key="lease_timeout",
                     retries_key="max_retries")
            reg.inc("fleet.requeues")
            ready = None
            while ready is None:
                wait = buf.earliest() - time.monotonic()
                if wait > 0:
                    self._pump(min(wait, 0.02))
                ready = buf.pop_ready(time.monotonic())
            _, attempts = ready

    # -- the run surface -------------------------------------------------
    def run(self, n_rounds=None):
        """Train through the fleet: the trainer's own loop, every train
        dispatch routed through a worker lease."""
        return self.trainer.run(n_rounds)

    def save_checkpoint(self, path: str | None = None) -> str:
        """Coordinator-owned checkpointing: the trainer's atomic snapshot,
        with this fleet's control-plane metadata riding along."""
        return self.trainer.save_checkpoint(path)

    def load_checkpoint(self, path_or_dir: str) -> int:
        """Coordinator restart: restore the trainer bit-identically and
        resume the control-plane script clock from the fleet metadata."""
        path = path_or_dir
        if os.path.isdir(path):
            path = ckpt_io.latest_checkpoint(path)
            if path is None:
                raise FileNotFoundError(
                    f"no ckpt_*.npz checkpoints in {path_or_dir}")
        t = self.trainer.load_checkpoint(path)
        fm = ckpt_io.load_metadata(path).get("fleet")
        if fm is not None:
            self._clock = int(fm["dispatch_clock"])
            self._job_id = int(fm["next_job_id"])
        return t

    def close(self):
        """Retire the fleet, close the transport (process workers are
        terminated), stop the worker threads, finalize the trainer."""
        if self._closed:
            return
        self._closed = True
        for name in list(self._live):
            self.retire(name)
        # give graceful leavers a moment to ack (hard-killed workers never
        # will — don't wait on them), then tear down
        deadline = time.monotonic() + 0.5
        while time.monotonic() < deadline:
            if all(w._dead.is_set() for w in self._workers.values()):
                break
            try:
                self._pump(0.02)
            except RuntimeError:
                break
        workers = list(self._workers.values())
        for w in workers:
            w.kill()
        for w in workers:
            w.join()
        self._transport.close()
        self.trainer.close()
