"""Typed metrics registry: counters / gauges / histograms with a declared
schema, plus dict-like *views* that keep the runtime's historical surfaces
(``Population.stats``, ``History.async_stats``) working unchanged
(``repro.obs.metrics``, which imports no JAX; this is the port's own
copy, held to it by ``tests/test_torch_async.py`` and
``tests/test_torch_fleet.py``). ``FLEET_SCHEMA`` is declared by the
coordinator (``launch.coordinator``) when it attaches to a trainer.

Namespacing matters: ``lease_expiries`` / ``requeues`` exist both as async
window counters (``async.*`` — incremented by the engine's fill loop) and
as population degradation counters (``pop.*`` — incremented by the
streamed staging path); a view maps the short legacy key to its
namespaced metric, so the two never collide in one registry.

Snapshots are plain JSON-able dicts and round-trip through checkpoint
meta: :meth:`MetricsRegistry.snapshot` → ``__meta__`` →
:meth:`MetricsRegistry.restore`.

>>> reg = MetricsRegistry()
>>> reg.declare([MetricSpec("pop.killed_clients", COUNTER)])
>>> reg.inc("pop.killed_clients", 3)
>>> view = reg.view({"killed_clients": "pop.killed_clients"})
>>> view["killed_clients"]
3
>>> reg.restore(reg.snapshot()); view["killed_clients"]
3
>>> reg.hist("async.staleness_hist")["0"] = 4
>>> reg.snapshot()["async.staleness_hist"]
{'0': 4}
"""
from __future__ import annotations

from collections.abc import MutableMapping
from typing import NamedTuple

COUNTER = "counter"
GAUGE = "gauge"
HIST = "hist"
_KINDS = (COUNTER, GAUGE, HIST)


class MetricSpec(NamedTuple):
    name: str
    kind: str
    help: str = ""


#: async dispatch-window counters (engine._run_async); the legacy
#: ``History.async_stats`` keys are these names minus the "async." prefix.
ASYNC_SCHEMA = (
    MetricSpec("async.dispatches", COUNTER, "cohorts dispatched"),
    MetricSpec("async.folds", COUNTER, "in-flight results folded"),
    MetricSpec("async.max_in_flight", GAUGE, "peak dispatch-window depth"),
    MetricSpec("async.lease_expiries", COUNTER, "cohort leases expired"),
    MetricSpec("async.requeues", COUNTER, "expired cohorts re-dispatched"),
    MetricSpec("async.staleness_hist", HIST, "folds by staleness s"),
)

#: per-round series counters (engine._emit_round)
ROUND_SCHEMA = (
    MetricSpec("rounds.completed", COUNTER, "rounds folded into history"),
    MetricSpec("rounds.evals", COUNTER, "rounds with a measured accuracy"),
    MetricSpec("rounds.quarantined", COUNTER, "client updates quarantined"),
    MetricSpec("rounds.migrations", COUNTER, "cohort group-membership flips"),
    MetricSpec("rounds.cold_started", COUNTER, "eq.-9 newcomers cold-started"),
    MetricSpec("rounds.checkpoints", COUNTER, "checkpoints written"),
    MetricSpec("rounds.shift_checks", COUNTER,
               "clients probed by the shift detector"),
    MetricSpec("rounds.empty_folds", COUNTER,
               "rounds whose cohort was entirely screened (identity fold)"),
)

#: coordinator/worker control-plane counters (launch.coordinator) —
#: declared when a Coordinator attaches, not in the default registry, so
#: single-process runs keep their exact metric set.
FLEET_SCHEMA = (
    MetricSpec("fleet.jobs", COUNTER, "jobs dispatched to workers"),
    MetricSpec("fleet.results", COUNTER, "job results folded in"),
    MetricSpec("fleet.heartbeats", COUNTER, "worker heartbeats received"),
    MetricSpec("fleet.heartbeat_misses", COUNTER,
               "heartbeat-window expiries observed while awaiting results"),
    MetricSpec("fleet.worker_deaths", COUNTER,
               "workers declared dead (missed heartbeats / closed pipe)"),
    MetricSpec("fleet.lease_expiries", COUNTER, "fleet job leases expired"),
    MetricSpec("fleet.requeues", COUNTER, "expired jobs re-dispatched"),
    MetricSpec("fleet.joins", COUNTER,
               "workers adopted mid-run (elastic joins + resurrections)"),
    MetricSpec("fleet.leaves", COUNTER, "workers departed gracefully"),
    MetricSpec("fleet.stale_results", COUNTER,
               "results for superseded job ids ignored"),
    MetricSpec("fleet.msgs_dropped", COUNTER, "chaos: messages dropped"),
    MetricSpec("fleet.msgs_duplicated", COUNTER,
               "chaos: messages delivered twice"),
    MetricSpec("fleet.msgs_reordered", COUNTER,
               "chaos: messages held past a later one"),
    MetricSpec("fleet.workers", GAUGE, "live workers"),
)

#: ``History.async_stats``' keys -> their metrics (the reference
#: telemetry bundle's ``async_view``)
ASYNC_VIEW = {k: f"async.{k}" for k in (
    "dispatches", "folds", "max_in_flight", "lease_expiries", "requeues",
    "staleness_hist")}


def _zero(kind):
    return {} if kind == HIST else 0


class MetricsRegistry:
    """Declared metrics + current values; thread-safe enough for the
    runtime's single-writer-per-metric counters (dict ops are atomic
    under the GIL; no read-modify-write races across threads exist
    because each metric has one incrementing site)."""

    def __init__(self, specs=ASYNC_SCHEMA + ROUND_SCHEMA):
        self._specs: dict[str, MetricSpec] = {}
        self._values: dict[str, object] = {}
        self.declare(specs)

    # -- schema ---------------------------------------------------------
    def declare(self, specs) -> None:
        """Idempotently declare metrics; a kind conflict is an error."""
        for spec in specs:
            spec = MetricSpec(*spec)
            if spec.kind not in _KINDS:
                raise ValueError(f"unknown metric kind {spec.kind!r}")
            old = self._specs.get(spec.name)
            if old is not None:
                if old.kind != spec.kind:
                    raise ValueError(
                        f"metric {spec.name!r} redeclared as {spec.kind}, "
                        f"was {old.kind}")
                continue
            self._specs[spec.name] = spec
            self._values[spec.name] = _zero(spec.kind)

    @property
    def schema(self) -> dict:
        """{name: MetricSpec} of everything declared."""
        return dict(self._specs)

    def names(self, prefix: str = "") -> list:
        return sorted(n for n in self._specs if n.startswith(prefix))

    def _check(self, name):
        if name not in self._specs:
            raise KeyError(f"metric {name!r} not declared")

    # -- updates --------------------------------------------------------
    def inc(self, name: str, n=1):
        self._check(name)
        if self._specs[name].kind == HIST:
            raise TypeError(f"cannot inc histogram {name!r}")
        self._values[name] += n

    def set(self, name: str, value):
        self._check(name)
        if self._specs[name].kind == HIST:
            if not isinstance(value, dict):
                raise TypeError(f"histogram {name!r} takes a dict")
            self._values[name] = dict(value)
        else:
            self._values[name] = value

    def observe(self, name: str, key, n=1):
        """Bump bucket ``key`` of histogram ``name``."""
        h = self.hist(name)
        key = str(key)
        h[key] = h.get(key, 0) + n

    def get(self, name: str):
        self._check(name)
        return self._values[name]

    def hist(self, name: str) -> dict:
        """The *live* bucket dict — callers may mutate it in place (the
        engine's staleness histogram does)."""
        self._check(name)
        if self._specs[name].kind != HIST:
            raise TypeError(f"metric {name!r} is not a histogram")
        return self._values[name]

    # -- lifecycle ------------------------------------------------------
    def reset(self, names=None):
        """Zero the given metrics (all when ``names`` is None). Histograms
        are cleared in place so live views/aliases stay attached."""
        for name in (self._specs if names is None else names):
            self._check(name)
            if self._specs[name].kind == HIST:
                self._values[name].clear()
            else:
                self._values[name] = 0

    def snapshot(self) -> dict:
        """JSON-able copy of every value (histograms copied)."""
        return {n: (dict(v) if isinstance(v, dict) else v)
                for n, v in self._values.items()}

    def restore(self, snap: dict):
        """Load a snapshot; unknown names are declared on the fly (a newer
        checkpoint read by older code keeps its counters)."""
        for name, value in (snap or {}).items():
            if name not in self._specs:
                kind = HIST if isinstance(value, dict) else COUNTER
                self.declare([MetricSpec(name, kind)])
            if self._specs[name].kind == HIST:
                live = self._values[name]
                live.clear()
                live.update(value)
            else:
                self._values[name] = value

    def view(self, mapping: dict) -> "MetricsView":
        """Dict-like alias view: {legacy_key: metric_name}."""
        return MetricsView(self, dict(mapping))


class MetricsView(MutableMapping):
    """MutableMapping over a fixed alias→metric mapping. Reads return the
    live value (histograms by reference, so in-place mutation patterns
    like ``hist[k] = hist.get(k, 0) + 1`` keep working); writes go
    through :meth:`MetricsRegistry.set`. Keys cannot be added/removed —
    the schema owns the key set."""

    def __init__(self, registry: MetricsRegistry, mapping: dict):
        self._registry = registry
        self._mapping = mapping

    def __getitem__(self, key):
        return self._registry.get(self._mapping[key])

    def __setitem__(self, key, value):
        self._registry.set(self._mapping[key], value)

    def __delitem__(self, key):
        raise TypeError("metric views have a fixed key set")

    def __iter__(self):
        return iter(self._mapping)

    def __len__(self):
        return len(self._mapping)

    def __contains__(self, key):
        return key in self._mapping

    def __repr__(self):
        return f"MetricsView({dict(self)!r})"

    def __eq__(self, other):
        if isinstance(other, (dict, MutableMapping)):
            return dict(self) == dict(other)
        return NotImplemented

    def snapshot(self) -> dict:
        """Plain-dict copy under the legacy key names."""
        return {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in self.items()}
