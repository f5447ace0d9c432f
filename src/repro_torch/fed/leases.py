"""Cohort leases: bounded waits with timeout, requeue and capped
exponential backoff (``repro.fed.leases``, which imports no JAX; this is
the port's own copy, held to it by ``tests/test_torch_async.py``).

A *lease* is the unit of at-least-once work handoff: whoever dispatches a
unit of work (the async runtime's in-flight cohort dispatch) holds a lease
with a monotonic-clock deadline. A lease whose result is not ready by the
deadline is *abandoned and requeued* with capped exponential backoff, and
re-dispatched against the then-current state. After ``max_retries``
requeues the work is declared unrecoverable (not merely slow) and the run
raises with a clear error instead of retrying forever.

``fed.engine._run_async`` uses this module, and so does the fleet's
coordinator (``launch.coordinator``) for its job leases.

>>> from repro_torch.fed.leases import RetryPolicy, backoff_delay
>>> backoff_delay(0, 0.05, 1.0)
0.05
>>> backoff_delay(10, 0.05, 1.0)          # capped
1.0
>>> RetryPolicy(timeout=30.0, max_retries=3).deadline(100.0)
130.0
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple


@dataclass
class Lease:
    """One in-flight dispatch: the staged inputs (kept so an expired lease
    can be re-dispatched against the then-current state), the per-group
    version clock snapshot taken at dispatch (staleness at fold = clock
    now − snapshot), the result/metric references the loop polls for
    readiness, the monotonic expiry deadline, how many leases for this
    work unit already expired (drives the requeue backoff), and — on the
    fleet path — which worker holds it and under which job id."""
    staged: tuple
    version: object = None
    result: object = None
    metrics: object = None
    deadline: float = 0.0
    attempts: int = 0
    holder: object = None
    job_id: int = -1


class RetryPolicy(NamedTuple):
    """Timeout/requeue/backoff knobs of one lease domain (the engine's
    ``async_lease_timeout``/``async_max_retries``/``async_backoff``/
    ``async_backoff_cap``; the fleet's ``FleetConfig`` equivalents)."""
    timeout: float = 30.0
    max_retries: int = 3
    backoff: float = 0.05
    backoff_cap: float = 1.0

    def deadline(self, now: float) -> float:
        return now + self.timeout


def backoff_delay(attempts: int, backoff: float, cap: float) -> float:
    """Capped exponential backoff: ``min(backoff * 2^attempts, cap)``."""
    return min(backoff * (2.0 ** attempts), cap)


class RequeueBuffer:
    """Expired leases waiting out their backoff before re-dispatch.

    Entries are ``(ready_at, staged, attempts)``; ``pop_ready`` returns
    the first entry whose backoff has elapsed (FIFO among ready ones, so
    re-dispatch order is deterministic), ``earliest`` the soonest
    ready-at time (for sleep-instead-of-spin waits when nothing else is
    in flight)."""

    def __init__(self):
        self._items = []

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def push(self, lease: Lease, policy: RetryPolicy, now: float,
             what: str = "async cohort",
             timeout_key: str = "async_lease_timeout",
             retries_key: str = "async_max_retries") -> float:
        """Requeue an expired lease; returns the backoff delay applied.
        Raises ``RuntimeError`` when the retry budget is exhausted — the
        work unit is unrecoverable, not merely slow. ``timeout_key`` /
        ``retries_key`` name the caller's config knobs in that error
        (the engine's ``async_*`` names by default; the fleet passes its
        ``FleetConfig`` field names)."""
        attempts = lease.attempts + 1
        if attempts > policy.max_retries:
            raise RuntimeError(
                f"{what} lease expired {attempts} times "
                f"({timeout_key}={policy.timeout}s, "
                f"{retries_key}={policy.max_retries}) — the "
                f"{what.split()[-1]} is unrecoverable, not merely slow")
        delay = backoff_delay(lease.attempts, policy.backoff,
                              policy.backoff_cap)
        self._items.append((now + delay, lease.staged, attempts))
        return delay

    def pop_ready(self, now: float):
        """``(staged, attempts)`` of the first backoff-elapsed entry, or
        None when every entry is still backing off (or the buffer is
        empty)."""
        i = self.ready_index(now)
        return None if i < 0 else self.pop(i)

    def ready_index(self, now: float) -> int:
        """The position of the first backoff-elapsed entry, -1 for none:
        on a data mesh rank 0's reading, which every rank then pops."""
        for i, (ready_at, _, _) in enumerate(self._items):
            if ready_at <= now:
                return i
        return -1

    def pop(self, i: int):
        """``(staged, attempts)`` of entry ``i``, removed."""
        _, staged, attempts = self._items.pop(i)
        return staged, attempts

    def earliest(self):
        """Soonest ready-at time, or None when empty."""
        return min((r for r, _, _ in self._items), default=None)
