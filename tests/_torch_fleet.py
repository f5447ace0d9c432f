"""Shared fixtures of the port's fleet tests (``tests/test_torch_fleet*.py``):
``tests/test_fleet.py``'s small configuration (``mnist_like(n_clients=40,
dim=16)``, ``mclr(16, 10)``, K = 8, E = 2), trainers by name, pinned or
streamed, and the bit-identity surface of two runs.

The reference's fleet tests race on the wall clock (a 0.6 s heartbeat
window, a job sleeping past a 0.4 s lease). Here every test that asserts
``fleet.jobs == fleet.results``, or an exact count of deaths or requeues,
runs with a heartbeat window of 5 s (``CALM``), and a job that must
outlive a lease or a window waits on the fleet's own counters
(``wait_for``), never on a sleep.
"""
import threading
import time

import numpy as np

from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.fed import strategies
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.fed.population import Population, PopulationConfig
from repro_torch.fed.store import ArrayClientStore
from repro_torch.models.paper_models import mclr

N_CLIENTS = 40
DATA_KW = dict(seed=0, n_clients=N_CLIENTS, classes_per_client=2,
               total_train=2000, dim=16)
STREAM_KW = dict(initial_active=30, arrival_rate=2.0, prefetch=2)

#: a 5 s heartbeat window (0.05 s beats, 100 missed) and short backoffs:
#: no healthy worker reads as dead under any load a test run sees
CALM = dict(heartbeat_interval=0.05, heartbeat_miss=100, backoff=0.005,
            backoff_cap=0.02)

#: the trainers of the port: six pinned, four of them also streamed
TRAINERS = ([(n, s) for n in ("fedavg", "fedgroup", "ifca", "fesem")
             for s in (False, True)]
            + [("fedclust", False), ("lcfl", False)])
TRAINER_IDS = [f"{n}-{'streamed' if s else 'pinned'}" for n, s in TRAINERS]

#: the longest any test waits on a fleet counter before failing
WAIT_S = 120.0


def cfg(**kw):
    base = dict(n_rounds=4, clients_per_round=8, local_epochs=2,
                batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4, seed=0)
    base.update(kw)
    return FedConfig(**base)


def make(name, data, cfg_, population=None):
    kw = dict(device="cpu", population=population)
    model = mclr(16, 10)
    if name == "fedavg":
        return FedAvgTrainer(model, data, cfg_, **kw)
    if name == "fedgroup":
        return FedGroupTrainer(model, data, cfg_, **kw)
    return strategies.make_trainer(name, model, data, cfg_, **kw)


def fresh(name, data, streamed=False, **cfg_kw):
    c = cfg(**cfg_kw)
    if streamed:
        pop = Population(ArrayClientStore(data),
                         PopulationConfig(**STREAM_KW))
        return make(name, None, c, pop)
    return make(name, data, c)


def fleet_snap(tr) -> dict:
    reg = tr.registry
    return {k: reg.get(k) for k in reg.names("fleet.")}


def _local_flat(tr):
    if tr.population is not None:
        if tr.population.state._local_flat is None:
            return None
        return tr.population.gather_local_flat(np.arange(N_CLIENTS))
    return getattr(tr, "local_flat", None)


def state_of(tr) -> dict:
    """Everything a run leaves behind, as numpy (read before ``close``)."""
    out = {f"params/{k}": v.cpu().numpy() for k, v in tr.params.items()}
    for k, v in getattr(tr, "group_params", {}).items():
        out[f"group_params/{k}"] = v.cpu().numpy()
    if hasattr(tr, "membership"):
        out["membership"] = np.array(tr.membership)
    lf = _local_flat(tr)
    if lf is not None:
        out["local_flat"] = lf.cpu().numpy()
    out["draws"] = tr.draws.get_state()
    out["comm_params"] = np.asarray(tr.comm_params)
    out["select_rng"] = np.asarray(
        tr.select_rng.bit_generator.state["state"]["state"])
    return out


def assert_same_run(a_tr, b_tr, a_state=None, b_state=None):
    """History and every piece of state bit for bit."""
    assert a_tr.history.rounds == b_tr.history.rounds
    a = state_of(a_tr) if a_state is None else a_state
    b = state_of(b_tr) if b_state is None else b_state
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def wait_for(pred, what: str, pump=None):
    """Block until ``pred()`` holds (pumping the coordinator if given),
    failing after ``WAIT_S`` seconds: a bound, not a timing."""
    end = time.monotonic() + WAIT_S
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"waited {WAIT_S}s for {what}")
        if pump is not None:
            pump(0.01)
        else:
            time.sleep(0.005)


class Gate:
    """An executor stand-in that holds the calls picked by ``hold`` (by
    call number) until ``until()`` holds or ``release()`` is called, then
    runs the real executor."""

    def __init__(self, real, hold, until=lambda: False):
        self.real = real
        self.hold = hold
        self.until = until
        self.event = threading.Event()
        self.calls = 0
        self.held = 0

    def __call__(self, *args):
        self.calls += 1
        if self.hold(self.calls):
            self.held += 1
            end = time.monotonic() + WAIT_S
            while not (self.event.is_set() or self.until()):
                if time.monotonic() > end:
                    raise AssertionError("gate never released")
                self.event.wait(0.005)
        return self.real(*args)

    def release(self):
        self.event.set()
