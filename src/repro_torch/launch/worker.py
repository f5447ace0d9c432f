"""Stateless fleet workers: the compute side of the coordinator/worker
control plane (``repro.launch.worker``; the port's own copy, held to it by
``tests/test_torch_fleet.py`` and ``tests/test_torch_fleet_proc.py``).

A worker owns **no training state** — the coordinator holds the m-stacked
group params, the ``ClientStateTable``, membership, both rng streams and
the checkpoints. A worker holds only *executors* (the fused round, block
and async dispatch of ``fed.rounds`` / ``fed.graphs``) and runs whatever
job message arrives: ``payload = (fn_name, args)``, looked up in its
function table, executed, result sent back. A per-round job is a pure
function of its arguments, so a re-dispatched lease (after a SIGKILL, a
dropped message, an expired lease) produces the bit-identical result on
any other worker.

Two flavors:

* :class:`InProcWorker` — a thread sharing the coordinator's process and
  its executors (the coordinator passes its own executor table); arguments
  arrive by reference. On the card the thread first selects the trainer's
  device (the current device is per thread in PyTorch), then runs each job
  inside ``torch.cuda.stream(s)``, ``s`` being the stream the
  coordinator's thread was on when it dispatched: the trainer's events,
  the population's ``record_stream`` and the next dispatch all order
  against that stream. ``kill()`` hard-stops it mid-queue without a reply
  — the observable signature of a process death, used by the chaos path.
* :func:`worker_entry` — the spawned-process body (``ProcTransport``):
  builds its own trainer replica from a :class:`WorkerSpec` (its own CUDA
  context on the card; outside any process group, so mesh-free), then
  serves jobs whose arguments and results cross the pipe as numpy trees
  (``_to_numpy``) and go to the replica's device for each job. A job is
  the ``local`` half of a round (``local_fn_table``): the local solves of
  the rows the coordinator sends, which need no collective, so a worker
  serves a rank of a mesh as it serves a trainer alone.

Both beat a heartbeat every ``heartbeat_interval`` seconds from a side
thread, and announce themselves with a ``join`` message once ready.
"""
from __future__ import annotations

import importlib
import queue
import threading
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.launch.transport import Message


# ---------------------------------------------------------------------------
# building a worker-side trainer (process mode)
# ---------------------------------------------------------------------------
@dataclass
class WorkerSpec:
    """How a process worker builds its trainer replica: ``builder`` is a
    ``"module:function"`` import string; the function receives ``kwargs``
    and returns a constructed (untrained) trainer. The builder must be
    importable from the spawned interpreter — a module on ``sys.path``
    (spawn propagates it), never a test-file local."""
    builder: str
    kwargs: dict = field(default_factory=dict)


def resolve_builder(spec: WorkerSpec):
    mod_name, _, fn_name = spec.builder.partition(":")
    if not fn_name:
        raise ValueError(
            f"WorkerSpec.builder must be 'module:function', got "
            f"{spec.builder!r}")
    return getattr(importlib.import_module(mod_name), fn_name)


def synthetic_builder(framework: str = "fedavg", n_clients: int = 40,
                      dim: int = 16, seed: int = 0, device="cuda", **cfg_kw):
    """Reference builder for tests: an mnist-like pinned trainer of any of
    the four frameworks on ``device`` (the card unless the caller asks for
    the CPU). Deterministic in its arguments, so every worker process
    builds the identical replica."""
    from repro_torch.core.fedgroup import FedGroupTrainer
    from repro_torch.data.generators import mnist_like
    from repro_torch.fed.engine import FedAvgTrainer, FedConfig
    from repro_torch.fed.fesem import FeSEMTrainer
    from repro_torch.fed.ifca import IFCATrainer
    from repro_torch.models.paper_models import mclr

    classes = {"fedavg": FedAvgTrainer, "fedgroup": FedGroupTrainer,
               "ifca": IFCATrainer, "fesem": FeSEMTrainer}
    data = mnist_like(seed=seed, n_clients=n_clients, classes_per_client=2,
                      total_train=50 * n_clients, dim=dim)
    base = dict(n_rounds=4, clients_per_round=8, local_epochs=2,
                batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4,
                seed=seed)
    base.update(cfg_kw)
    return classes[framework](mclr(dim, 10), data, FedConfig(**base),
                              device=device)


def worker_fn_table(trainer) -> dict:
    """The jobs a worker serves: the trainer's train dispatches.
    Evaluation stays on the coordinator (server-side metrics)."""
    return {"round": trainer._round_executor(),
            "block": trainer._block_executor(),
            "async": trainer._async_executor()}


def local_fn_table(trainer) -> dict:
    """The jobs a process worker serves: the ``local`` half of the
    trainer's per-round dispatch (``fed.rounds``), the assignment and the
    local solves of the rows it is sent, with no collective; the
    coordinator runs the rest of the round."""
    return {"round": trainer._round_executor().local}


def _to_numpy(tree):
    """Host copy of a nest of dicts, lists and (named) tuples whose tensors
    become numpy arrays, for pickling across the process boundary; other
    leaves pass as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_device(tree, device):
    """``_to_numpy``'s inverse: numpy arrays become tensors on ``device``."""
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# in-process (thread) worker
# ---------------------------------------------------------------------------
class InProcWorker:
    """A thread worker over an :class:`InProcEndpoint`. The function table
    is shared with the coordinator's trainer, so a routed dispatch runs
    the *same* executor on the *same* tensors as a single-process run —
    the fleet-size-1 bit-identity guarantee. ``device`` is the trainer's:
    on the card the job thread selects it before its first job."""

    def __init__(self, name: str, endpoint, table: dict,
                 heartbeat_interval: float = 0.05, device=None):
        self.name = name
        self._ep = endpoint
        self._table = table
        self._interval = heartbeat_interval
        self._device = None if device is None else torch.device(device)
        self._dead = threading.Event()     # hard-stop (chaos kill)
        self._thread = None
        self._beat_thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name=f"fleet-worker-{self.name}", daemon=True)
        self._beat_thread = threading.Thread(
            target=self._beat, name=f"fleet-beat-{self.name}", daemon=True)
        self._thread.start()
        self._beat_thread.start()
        self._ep.send(Message("join", self.name))

    def kill(self):
        """Hard-stop: no more job replies, no more heartbeats — the
        in-process equivalent of SIGKILL (chaos ``worker_kill``). A job
        already in the inbox is lost, exactly like a process death
        mid-dispatch."""
        self._dead.set()

    def stop(self):
        """Graceful leave: the worker drains its inbox up to the stop
        marker and announces departure."""
        self._ep.send(Message("leave", self.name))
        self._dead.set()

    def join(self, timeout: float = 5.0):
        """Wait for both threads to end (after ``kill``/``stop``)."""
        for t in (self._thread, self._beat_thread):
            if t is not None:
                t.join(timeout)

    def _beat(self):
        while not self._dead.is_set():
            self._ep.send(Message("heartbeat", self.name))
            self._dead.wait(self._interval)

    def _call(self, fn_name: str, args, stream):
        fn = self._table[fn_name]
        if stream is None:
            return fn(*args)
        with torch.cuda.stream(stream):
            return fn(*args)

    def _run(self):
        if self._device is not None and self._device.type == "cuda":
            # the current device is per thread: the trainer's, as the
            # population's producer thread selects it
            torch.cuda.set_device(self._device.index
                                  if self._device.index is not None
                                  else torch.cuda.current_device())
        while not self._dead.is_set():
            msg = self._ep.recv(timeout=0.02)
            if msg is None or self._dead.is_set():
                continue
            if msg.kind == "stop":
                self._ep.send(Message("leave", self.name))
                self._dead.set()         # stops the beat thread too
                break
            if msg.kind != "job":
                continue
            fn_name, args, *rest = msg.payload
            try:
                out = self._call(fn_name, args, rest[0] if rest else None)
            except Exception:
                self._ep.send(Message("error", self.name, msg.job_id,
                                      traceback.format_exc()))
                continue
            if self._dead.is_set():
                continue                 # killed mid-dispatch: result lost
            self._ep.send(Message("result", self.name, msg.job_id, out))


# ---------------------------------------------------------------------------
# spawned-process worker body
# ---------------------------------------------------------------------------
def worker_entry(conn, name: str, spec: WorkerSpec,
                 heartbeat_interval: float = 0.05):
    """Process-worker main: build the trainer replica from ``spec`` (the
    newcomer cold start), join the fleet, then serve ``local_fn_table``'s
    jobs until ``stop`` or pipe close. Payloads are numpy trees both ways;
    a job's arguments go to the replica's device. A reader thread takes
    every message off the pipe as it comes, so neither end ever blocks
    writing to the other."""
    from repro_torch.launch.transport import PipeEndpoint

    ep = PipeEndpoint(name, conn)
    try:
        trainer = resolve_builder(spec)(**spec.kwargs)
        table = local_fn_table(trainer)
    except Exception:
        try:
            ep.send(Message("error", name, -1, traceback.format_exc()))
        finally:
            ep.close()
        return
    stop = threading.Event()

    def beat():
        while not stop.is_set():
            try:
                ep.send(Message("heartbeat", name))
            except (BrokenPipeError, OSError):
                return
            stop.wait(heartbeat_interval)

    inbox = queue.Queue()

    def read():
        # drain the pipe as messages come: a coordinator sending a job
        # while this worker still runs one (a superseded attempt) must not
        # wait for it, for the job's result send would then wait for the
        # coordinator to read, each blocked in a write to the other
        try:
            while not stop.is_set():
                msg = ep.recv(timeout=0.05)
                if msg is not None:
                    inbox.put(msg)
        except (EOFError, OSError):
            pass                         # coordinator went away
        inbox.put(None)

    threading.Thread(target=beat, daemon=True).start()
    threading.Thread(target=read, daemon=True).start()
    ep.send(Message("join", name))
    try:
        while True:
            msg = inbox.get()
            if msg is None:
                break
            if msg.kind == "stop":
                ep.send(Message("leave", name))
                break
            if msg.kind != "job":
                continue
            fn_name, args = msg.payload[:2]
            try:
                out = _to_numpy(table[fn_name](
                    *_to_device(args, trainer.device)))
            except Exception:
                ep.send(Message("error", name, msg.job_id,
                                traceback.format_exc()))
                continue
            ep.send(Message("result", name, msg.job_id, out))
    finally:
        stop.set()
        ep.close()
