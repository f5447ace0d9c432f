"""Coordinator <-> worker message transport: in-process (thread workers,
payloads by reference) and process-level (spawned workers, pipes), plus the
failure-detection and chaos primitives the control plane builds on
(``repro.launch.transport``, which imports no JAX; this is the port's own
copy, held to it by ``tests/test_torch_fleet.py``).

Two transports, one wire protocol (:class:`Message`):

* :class:`InProcTransport` — every worker is a thread in the coordinator's
  process; each has its own inbox queue and all share the coordinator's
  inbox. Payloads pass **by reference**, so a routed dispatch runs the
  exact same executor on the exact same tensors as a single-process run —
  this is what makes the fleet-size-1 mode *bit-identical* to
  ``engine.run()`` while every message still flows through the transport
  (so leases, heartbeats and chaos injection are exercised in-process).
* :class:`ProcTransport` — every worker is a spawned OS process (its own
  failure domain, and on the card its own CUDA context) connected by a
  duplex pipe; payloads are pickled numpy trees. A SIGKILLed worker
  surfaces as an ``"eof"`` message (closed pipe) or as missed heartbeats,
  whichever the coordinator sees first. Workers are started in the
  ``spawn`` context only: a forked child of a process with a CUDA context
  cannot use the card.

:class:`HeartbeatMonitor` turns per-worker beat timestamps into a
miss-threshold failure detector (dead after ``interval * miss`` seconds of
silence; a late beat resurrects). :class:`ChaosRouter` injects scripted
delivery-order faults — dropped / duplicated / reordered messages and
suppressed heartbeats — on the coordinator's receive path, deterministically
armed per job by the coordinator from ``FaultSpec``'s fleet fields.
"""
from __future__ import annotations

import os
import queue
import signal
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Message:
    """One wire message. ``kind`` is the protocol:

    job        coordinator -> worker: ``payload = (fn_name, args)``; an
               in-process job adds the coordinator thread's CUDA stream
               (None on the CPU): ``(fn_name, args, stream)``
    result     worker -> coordinator: ``payload`` = the executor's return
    error      worker -> coordinator: ``payload`` = formatted traceback
    heartbeat  worker -> coordinator: liveness beat (no payload)
    join       worker -> coordinator: ready to take jobs (sent once the
               worker — for a process worker, its trainer replica — is up)
    leave      worker -> coordinator: graceful departure
    stop       coordinator -> worker: drain and exit
    eof        synthesized by ``ProcTransport.recv`` when a worker's pipe
               closes (the fast path of SIGKILL detection)
    """
    kind: str
    src: str = ""
    job_id: int = -1
    payload: object = None


# ---------------------------------------------------------------------------
# in-process transport (thread workers)
# ---------------------------------------------------------------------------
class InProcEndpoint:
    """A thread worker's view of the transport: ``recv`` its own inbox,
    ``send`` into the coordinator's."""

    def __init__(self, name: str, inbox: queue.Queue, coord: queue.Queue):
        self.name = name
        self._inbox = inbox
        self._coord = coord

    def recv(self, timeout: float):
        try:
            return self._inbox.get(timeout=timeout)
        except queue.Empty:
            return None

    def send(self, msg: Message):
        self._coord.put(msg)


class InProcTransport:
    """Queue-based transport: one inbox per worker, one shared coordinator
    inbox. Everything passes by reference — zero serialization."""

    def __init__(self):
        self._coord: queue.Queue = queue.Queue()
        self._inboxes: dict[str, queue.Queue] = {}

    def add_worker(self, name: str) -> InProcEndpoint:
        if name in self._inboxes:
            raise ValueError(f"worker {name!r} already registered")
        self._inboxes[name] = queue.Queue()
        return InProcEndpoint(name, self._inboxes[name], self._coord)

    def remove_worker(self, name: str):
        self._inboxes.pop(name, None)

    def send(self, name: str, msg: Message) -> bool:
        inbox = self._inboxes.get(name)
        if inbox is None:
            return False
        inbox.put(msg)
        return True

    def recv(self, timeout: float):
        try:
            return self._coord.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self):
        self._inboxes.clear()


# ---------------------------------------------------------------------------
# process transport (spawned workers, duplex pipes)
# ---------------------------------------------------------------------------
class PipeEndpoint:
    """A process worker's view of its pipe. ``send`` is lock-serialized —
    the job loop and the heartbeat thread share one connection, and
    interleaved writes would tear the pickle stream."""

    def __init__(self, name: str, conn):
        self.name = name
        self._conn = conn
        self._lock = threading.Lock()

    def recv(self, timeout: float):
        if not self._conn.poll(timeout):
            return None
        return self._conn.recv()

    def send(self, msg: Message):
        with self._lock:
            self._conn.send(msg)

    def close(self):
        self._conn.close()


class ProcTransport:
    """Spawned-process transport. The coordinator holds one pipe end per
    worker and multiplexes ``recv`` over all of them with
    ``multiprocessing.connection.wait``; a closed pipe (killed worker)
    surfaces as a synthesized ``eof`` message."""

    def __init__(self):
        import multiprocessing as mp
        self._ctx = mp.get_context("spawn")
        self._procs: dict[str, object] = {}
        self._conns: dict[str, object] = {}

    def add_worker(self, name: str, entry, *args):
        """Spawn ``entry(worker_conn, name, *args)`` as a new process."""
        if name in self._procs:
            raise ValueError(f"worker {name!r} already registered")
        coord_conn, worker_conn = self._ctx.Pipe()
        proc = self._ctx.Process(target=entry, args=(worker_conn, name)
                                 + tuple(args), daemon=True)
        proc.start()
        worker_conn.close()          # the child owns its end now
        self._procs[name] = proc
        self._conns[name] = coord_conn
        return proc

    def remove_worker(self, name: str):
        conn = self._conns.pop(name, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        proc = self._procs.pop(name, None)
        if proc is not None and proc.is_alive():
            proc.terminate()
            proc.join(timeout=5.0)

    def kill(self, name: str):
        """SIGKILL a worker process — the chaos injection primitive (and
        the hard-stop path of a misbehaving worker)."""
        proc = self._procs.get(name)
        if proc is not None and proc.pid and proc.is_alive():
            os.kill(proc.pid, signal.SIGKILL)

    def send(self, name: str, msg: Message) -> bool:
        conn = self._conns.get(name)
        if conn is None:
            return False
        try:
            conn.send(msg)
            return True
        except (BrokenPipeError, OSError):
            return False

    def recv(self, timeout: float):
        from multiprocessing.connection import wait
        conns = list(self._conns.values())
        if not conns:
            time.sleep(min(timeout, 0.01))
            return None
        ready = wait(conns, timeout=timeout)
        if not ready:
            return None
        conn = ready[0]
        name = next((n for n, c in self._conns.items() if c is conn), "")
        try:
            return conn.recv()
        except (EOFError, OSError):
            return Message("eof", src=name)

    def close(self):
        for name in list(self._procs):
            self.remove_worker(name)


# ---------------------------------------------------------------------------
# heartbeat failure detection
# ---------------------------------------------------------------------------
class HeartbeatMonitor:
    """Miss-threshold failure detector over per-worker beat timestamps:
    a worker silent for longer than ``interval * miss`` seconds is
    declared dead by :meth:`sweep`; a later beat (:meth:`beat` returns
    True) resurrects it — the caller decides whether to re-adopt.

    >>> m = HeartbeatMonitor(interval=1.0, miss=3)
    >>> m.add("w0", now=0.0); m.sweep(now=2.9)
    []
    >>> m.sweep(now=3.1)
    ['w0']
    >>> m.beat("w0", now=3.2)        # late beat: back from the dead
    True
    >>> m.sweep(now=3.3)
    []
    """

    def __init__(self, interval: float, miss: int):
        self.window = float(interval) * int(miss)
        self._last: dict[str, float] = {}
        self._dead: set = set()

    def add(self, name: str, now: float):
        self._last[name] = now
        self._dead.discard(name)

    def remove(self, name: str):
        self._last.pop(name, None)
        self._dead.discard(name)

    def beat(self, name: str, now: float) -> bool:
        """Record a beat; True when it resurrects a declared-dead worker."""
        if name not in self._last and name not in self._dead:
            return False                 # never adopted / already removed
        resurrected = name in self._dead
        self._dead.discard(name)
        self._last[name] = now
        return resurrected

    def is_dead(self, name: str) -> bool:
        return name in self._dead

    def sweep(self, now: float) -> list:
        """Names newly declared dead this sweep (beat older than the
        miss window)."""
        newly = [n for n, t in self._last.items()
                 if n not in self._dead and now - t > self.window]
        for n in newly:
            self._dead.add(n)
        return newly


# ---------------------------------------------------------------------------
# scripted delivery chaos
# ---------------------------------------------------------------------------
@dataclass
class _Armed:
    drop: set = field(default_factory=set)
    dup: set = field(default_factory=set)
    reorder: set = field(default_factory=set)
    hb_mute: dict = field(default_factory=dict)      # worker -> mute-until


class ChaosRouter:
    """Deterministic delivery-order faults on the coordinator's receive
    path, armed per job id from ``FaultSpec``'s fleet fields:

    * ``drop``    — the job's result message is consumed and discarded;
      the job id lands in :attr:`dropped` so the awaiting lease can expire
      immediately (the information-equivalent of a timeout, without
      stalling the test clock) and requeue.
    * ``dup``     — the result is delivered twice; the coordinator must
      ignore the second copy by job id.
    * ``reorder`` — the result is held back until the next message (a
      heartbeat, typically) passes it.
    * ``mute_heartbeats`` — beats from a worker are suppressed until a
      monotonic deadline, driving the miss-threshold detector without
      touching the (healthy) worker.

    ``filter`` maps one received message to the 0..2 messages actually
    delivered. Counters land in the coordinator's metric registry.
    """

    def __init__(self, counters=None):
        self._armed = _Armed()
        self._held: list = []
        self.dropped: set = set()
        self._counters = counters    # MetricsRegistry or None

    def _inc(self, name):
        if self._counters is not None:
            self._counters.inc(name)

    # -- arming (coordinator, at dispatch time) -------------------------
    def arm(self, spec, job_id: int):
        """Arm one job's message faults from a ``FaultSpec`` (no-op when
        the spec is None or carries no fleet message faults)."""
        if spec is None:
            return
        if getattr(spec, "msg_drop", False):
            self._armed.drop.add(job_id)
        if getattr(spec, "msg_dup", False):
            self._armed.dup.add(job_id)
        if getattr(spec, "msg_reorder", False):
            self._armed.reorder.add(job_id)

    def mute_heartbeats(self, worker: str, until: float):
        self._armed.hb_mute[worker] = until

    # -- the receive path ----------------------------------------------
    def filter(self, msg: Message, now: float) -> list:
        """0..2 messages to deliver in place of ``msg``."""
        out = []
        if msg.kind == "heartbeat":
            until = self._armed.hb_mute.get(msg.src)
            if until is not None:
                if now < until:
                    return self._flush(out)       # suppressed
                del self._armed.hb_mute[msg.src]
        if msg.kind == "result":
            if msg.job_id in self._armed.drop:
                self._armed.drop.discard(msg.job_id)
                self.dropped.add(msg.job_id)
                self._inc("fleet.msgs_dropped")
                return self._flush(out)
            if msg.job_id in self._armed.reorder:
                self._armed.reorder.discard(msg.job_id)
                self._held.append(msg)
                self._inc("fleet.msgs_reordered")
                return out                        # held until another passes
            if msg.job_id in self._armed.dup:
                self._armed.dup.discard(msg.job_id)
                self._inc("fleet.msgs_duplicated")
                out.extend([msg, Message(msg.kind, msg.src, msg.job_id,
                                         msg.payload)])
                return self._flush(out)
        out.append(msg)
        return self._flush(out)

    def _flush(self, out: list) -> list:
        """A delivered (or consumed) message lets any held one pass."""
        if self._held:
            out.extend(self._held)
            self._held.clear()
        return out
