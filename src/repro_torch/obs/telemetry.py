"""Telemetry bundle: one object owning the span tracer, the metrics
registry, and the on-disk stream for a run (``repro.obs.telemetry``,
which imports no JAX; this is the port's own copy, held to it by
``tests/test_torch_obs.py`` and ``tests/test_torch_obs_run.py``).

Layout of a telemetry dir (``FedConfig.telemetry_dir``):

  metrics.jsonl       one JSON object per round record (deterministic:
                      sorted keys, fixed separators, NO wall-clock
                      fields — bit-stable across kill-and-resume)
  metrics-NNNNN.jsonl rotated segments (atomic ``os.replace`` rotation)
  trace.json          Chrome trace-event export of the span ring buffer
  run_summary.json    final counters + per-stage totals + slowest rounds

On a data mesh rank 0 alone writes the directory; the other ranks' bundles
trace and count in memory. The round records are functions of the
replicated training state, so rank 0's equal a run's without a mesh; the
spans of staging (``stage``, ``h2d`` with its ``rows``) are rank 0's own.

The engine truncates ``metrics.jsonl`` on checkpoint resume
(:meth:`Telemetry.resume_at`) so records for rounds >= the restore point
are dropped before the resumed run re-emits them — no duplicates, and
the resumed stream is byte-identical to an uninterrupted one.

A process-wide *default* telemetry (:func:`set_default`) lets harnesses
thread span collection through trainers they did not construct:
``from_config`` always returns a fresh bundle (its own registry —
counters never bleed between populations), sharing only the default's
tracer when one is installed.
"""
from __future__ import annotations

import json
import os

from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import trace as trace_lib

SUMMARY_FORMAT = 1


class JsonlSink:
    """Append-only JSONL stream with atomic size-based rotation."""

    def __init__(self, directory: str, name: str = "metrics",
                 max_bytes: int = 64 * 1024 * 1024):
        self.directory = directory
        self.name = name
        self.max_bytes = int(max_bytes)
        self.path = os.path.join(directory, f"{name}.jsonl")
        self._rotated = 0
        self._fh = None
        self._size = 0
        os.makedirs(directory, exist_ok=True)
        for f in sorted(os.listdir(directory)):
            if f.startswith(f"{name}-") and f.endswith(".jsonl"):
                self._rotated += 1

    @staticmethod
    def encode(record: dict) -> str:
        # deterministic encoding — the bit-stability contract
        return json.dumps(record, sort_keys=True, separators=(",", ":"))

    def _open(self):
        # persistent append handle, flushed per record: every line is
        # visible to the OS, which is what kill-and-resume needs (process
        # death, not power loss)
        self._fh = open(self.path, "a")
        self._size = self._fh.tell()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def emit(self, record: dict):
        line = self.encode(record) + "\n"
        if self._fh is None:
            self._open()
        if self._size and self._size + len(line) > self.max_bytes:
            self.close()
            dst = os.path.join(self.directory,
                               f"{self.name}-{self._rotated:05d}.jsonl")
            os.replace(self.path, dst)
            self._rotated += 1
            self._open()
        self._fh.write(line)
        self._fh.flush()
        self._size += len(line)

    def segment_paths(self) -> list:
        segs = sorted(
            os.path.join(self.directory, f) for f in os.listdir(self.directory)
            if f.startswith(f"{self.name}-") and f.endswith(".jsonl"))
        if os.path.exists(self.path):
            segs.append(self.path)
        return segs

    def records(self) -> list:
        out = []
        for path in self.segment_paths():
            with open(path) as f:
                for line in f:
                    if line.strip():
                        out.append(json.loads(line))
        return out

    def truncate_from(self, t: int):
        """Drop round records with ``rec['t'] >= t`` (resume point) and
        compact the stream back into the main file, atomically."""
        self.close()
        keep = [r for r in self.records()
                if not (r.get("kind") == "round" and r.get("t", -1) >= t)]
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for r in keep:
                f.write(self.encode(r) + "\n")
        for path in self.segment_paths():
            if path != self.path:
                os.remove(path)
        os.replace(tmp, self.path)
        self._rotated = 0


class Telemetry:
    """Tracer + registry + (optional) on-disk stream for one run."""

    def __init__(self, enabled: bool = False, directory: str | None = None,
                 capacity: int = 65536, annotate: bool = False,
                 tracer: trace_lib.Tracer | None = None):
        # the registry is ALWAYS fresh (counters must not bleed between
        # populations/trainers of one process); only the tracer may be
        # shared, through ``from_config`` and the process default
        self.registry = metrics_lib.MetricsRegistry()
        self.tracer = tracer if tracer is not None else trace_lib.Tracer(
            enabled=enabled, capacity=capacity, annotate=annotate)
        self.directory = None
        self._sink = None
        if directory:
            self.configure(directory)

    # -- wiring ---------------------------------------------------------
    def configure(self, directory: str | None = None, enabled: bool = True,
                  annotate: bool | None = None):
        """Enable tracing and (when ``directory`` is set) open the JSONL
        stream. Called by ``Population.attach`` / trainer init from
        ``FedConfig.telemetry_dir``."""
        self.tracer.enabled = bool(enabled)
        if annotate is not None:
            self.tracer.annotate = bool(annotate)
        if directory:
            self.directory = directory
            self._sink = JsonlSink(directory)
        return self

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled

    @property
    def recording(self) -> bool:
        """True when round records should be built (a sink is open)."""
        return self._sink is not None

    # -- tracing delegates ---------------------------------------------
    def span(self, kind: str, **attrs):
        return self.tracer.span(kind, **attrs)

    def wrap(self, kind: str, fn, **attrs):
        return self.tracer.wrap(kind, fn, **attrs)

    # -- legacy views ---------------------------------------------------
    def async_view(self) -> metrics_lib.MetricsView:
        """``History.async_stats``-shaped view over the async.* metrics."""
        return self.registry.view(metrics_lib.ASYNC_VIEW)

    # -- stream ---------------------------------------------------------
    def round_record(self, record: dict):
        if self._sink is not None:
            self._sink.emit(record)

    def resume_at(self, t: int):
        """Checkpoint resume at round ``t``: drop already-streamed records
        for t' >= t and restart the span clock (cumulative counters come
        back via ``registry.restore`` from checkpoint meta)."""
        if self._sink is not None:
            self._sink.truncate_from(t)
        self.tracer.clear()

    def stream_records(self) -> list:
        return self._sink.records() if self._sink is not None else []

    # -- finalization ---------------------------------------------------
    def summary(self, extra: dict | None = None) -> dict:
        stages = self.tracer.stage_totals()
        rounds = self.tracer.round_totals()
        top = sorted(rounds.items(), key=lambda kv: -kv[1])[:10]
        doc = {
            "format": SUMMARY_FORMAT,
            "counters": self.registry.snapshot(),
            "stages": stages,
            "span_kinds": sorted(stages),
            "top_rounds": [{"t": t, "s": s} for t, s in top],
        }
        if extra:
            doc.update(extra)
        return doc

    def finalize(self, extra: dict | None = None) -> dict | None:
        """Write ``trace.json`` + ``run_summary.json`` (idempotent; no-op
        without a directory)."""
        if not self.directory:
            return None
        if self._sink is not None:
            self._sink.close()      # emit() reopens lazily if run resumes
        trace_lib.export_chrome_trace(
            os.path.join(self.directory, "trace.json"), self.tracer)
        doc = self.summary(extra)
        tmp = os.path.join(self.directory, "run_summary.json.tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(self.directory, "run_summary.json"))
        return doc

    def profile(self, subdir: str = "profile"):
        """Programmatic ``torch.profiler`` capture scoped to a with-block;
        the Chrome trace lands in ``<directory>/<subdir>/``. The context
        manager's ``prof`` is the finished ``torch.profiler.profile``
        (spans appear in it as ``record_function`` ranges while the
        tracer's ``annotate`` is on)."""
        tel = self

        class _Profile:
            prof = None
            log_dir = os.path.join(tel.directory or ".", subdir)

            def __enter__(self):
                trace_lib.start_profiler(self.log_dir)
                return self

            def __exit__(self, *exc):
                self.prof = trace_lib.stop_profiler()
                return False

        return _Profile()


# -- process-wide default (benchmark harness hook) -----------------------
_DEFAULT: Telemetry | None = None


def set_default(tel: Telemetry | None):
    global _DEFAULT
    _DEFAULT = tel


def get_default() -> Telemetry | None:
    return _DEFAULT


def from_config(cfg, write: bool = True) -> Telemetry:
    """Telemetry for a trainer: always a FRESH bundle (own registry), but
    sharing the process default's *tracer* when one is installed — span
    collection crosses object boundaries, metric counts never do.
    ``cfg.telemetry_dir`` additionally opens the JSONL stream; with
    ``write=False`` (a data mesh's ranks > 0) it only turns the tracer on,
    and the bundle writes nothing."""
    shared = _DEFAULT.tracer if _DEFAULT is not None else None
    tdir = getattr(cfg, "telemetry_dir", None)
    if tdir:
        return Telemetry(enabled=True, directory=tdir if write else None,
                         tracer=shared)
    return Telemetry(enabled=False, tracer=shared)
