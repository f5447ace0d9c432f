"""Low-overhead span tracer with Chrome-trace export (``repro.obs.trace``,
which imports no JAX; this is the port's own copy, held to it by
``tests/test_torch_obs.py``).

Spans are context managers around the runtime's hot seams (cohort staging,
H2D, dispatch, fold, state-table write, eval, checkpoint, and the fleet's
lease and heartbeat). Design goals:

  * zero-cost when disabled — ``Tracer.span`` returns a shared no-op
    context manager singleton (``NULL_SPAN``) without allocating,
  * thread-safe — spans are opened from the main loop, the population's
    prefetch producer, the state-writer thread and fleet workers;
    completed records land in a bounded ``deque`` ring buffer,
  * monotonic clocks — ``time.perf_counter_ns`` throughout; wall time
    never enters a record, so traces are comparable across restarts.

A span reads the host clock only: it never synchronizes the card and
records no CUDA event, so a dispatch span is the host time of enqueueing
the work (the reference's spans are host time under JAX's asynchronous
dispatch too).

Per-thread nesting depth is tracked with a ``threading.local`` stack so
exports can reconstruct parent/child structure (the producer nests h2d
inside stage).

Export targets the Chrome trace-event JSON format (complete events,
``ph: "X"``) loadable in ``chrome://tracing`` / Perfetto, validated by
:func:`validate_chrome_trace`. When ``annotate=True`` each span also
enters a ``torch.profiler.record_function`` of its kind, so inside a
programmatic profiler capture (:func:`start_profiler` /
:func:`stop_profiler`) a span shows up with the kernels it launched.

>>> tr = Tracer(enabled=True)
>>> with tr.span("stage", t=0):
...     with tr.span("h2d"):
...         pass
>>> [ (r.kind, r.depth) for r in tr.records() ]
[('h2d', 1), ('stage', 0)]
>>> Tracer(enabled=False).span("stage") is NULL_SPAN
True
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time


class _NullSpan:
    """Shared no-op context manager: the disabled-tracer fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()

#: canonical span kinds instrumented across the runtime
SPAN_KINDS = ("stage", "h2d", "dispatch", "fold", "state-write", "eval",
              "checkpoint", "lease", "heartbeat")


class SpanRecord:
    """One completed span: monotonic start/duration in ns + context."""
    __slots__ = ("kind", "start_ns", "dur_ns", "tid", "depth", "attrs")

    def __init__(self, kind, start_ns, dur_ns, tid, depth, attrs):
        self.kind = kind
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.tid = tid
        self.depth = depth
        self.attrs = attrs

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"SpanRecord({self.kind!r}, dur={self.dur_ns / 1e6:.3f}ms, "
                f"depth={self.depth}, attrs={self.attrs})")


class _Span:
    __slots__ = ("_tracer", "kind", "attrs", "_start", "_annot")

    def __init__(self, tracer, kind, attrs):
        self._tracer = tracer
        self.kind = kind
        self.attrs = attrs
        self._start = 0
        self._annot = None

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        stack.append(self)
        if tr.annotate:
            import torch
            self._annot = torch.profiler.record_function(self.kind)
            self._annot.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        tr = self._tracer
        if self._annot is not None:
            self._annot.__exit__(*exc)
        stack = tr._stack()
        # tolerate a foreign pop (mis-nesting) rather than corrupting depth
        if stack and stack[-1] is self:
            stack.pop()
        depth = len(stack)
        tr._records.append(SpanRecord(
            self.kind, self._start - tr.epoch_ns, end - self._start,
            threading.get_ident(), depth, self.attrs))
        return False


class Wrapped:
    """``Tracer.wrap``'s callable: every call runs inside a span of
    ``kind`` while the tracer is enabled (checked per call). Any other
    attribute is the wrapped object's, so an executor object keeps its
    surface (``max_steps``, ``bind``, ``release``, ``replays``, ...)."""

    def __init__(self, tracer, kind: str, fn, attrs: dict):
        self._tracer = tracer
        self._kind = kind
        self._attrs = attrs
        self.__wrapped__ = fn

    def __call__(self, *args, **kwargs):
        if not self._tracer.enabled:
            return self.__wrapped__(*args, **kwargs)
        with _Span(self._tracer, self._kind, self._attrs):
            return self.__wrapped__(*args, **kwargs)

    def __getattr__(self, name):
        # only reached for names the wrapper itself does not have
        return getattr(self.__dict__["__wrapped__"], name)


class Tracer:
    """Thread-safe span tracer over a bounded ring buffer.

    ``capacity`` bounds memory: the oldest records are dropped once the
    ring is full (``deque(maxlen=...)`` — appends are atomic under the
    GIL, so producer/writer threads need no extra lock).
    """

    def __init__(self, enabled: bool = False, capacity: int = 65536,
                 annotate: bool = False):
        self.enabled = bool(enabled)
        self.annotate = bool(annotate)
        self.capacity = int(capacity)
        self.epoch_ns = time.perf_counter_ns()
        self._records = collections.deque(maxlen=self.capacity)
        self._local = threading.local()

    # -- recording ------------------------------------------------------
    def span(self, kind: str, **attrs):
        """Open a span; returns ``NULL_SPAN`` (no allocation) when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, kind, attrs)

    def wrap(self, kind: str, fn, **attrs) -> Wrapped:
        """Wrap ``fn`` so every call runs inside a ``kind`` span.

        The enabled check happens per call, so a tracer enabled after
        executors were built still records their dispatches."""
        return Wrapped(self, kind, fn, attrs)

    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def open_depth(self) -> int:
        """Open (unclosed) spans on the *calling* thread — 0 when balanced."""
        return len(self._stack())

    # -- inspection -----------------------------------------------------
    def records(self):
        """Snapshot of completed spans (oldest first)."""
        return list(self._records)

    def clear(self):
        self._records.clear()
        self.epoch_ns = time.perf_counter_ns()

    def stage_totals(self) -> dict:
        """Aggregate per-kind timing: {kind: {count, total_s, max_s}}."""
        out = {}
        for r in self._records:
            agg = out.setdefault(r.kind, {"count": 0, "total_s": 0.0,
                                          "max_s": 0.0})
            s = r.dur_ns / 1e9
            agg["count"] += 1
            agg["total_s"] += s
            if s > agg["max_s"]:
                agg["max_s"] = s
        return out

    def round_totals(self) -> dict:
        """Per-round attributed time: {t: seconds} over spans with a ``t``
        attr (stage/fold/eval carry the round index)."""
        out = {}
        for r in self._records:
            t = r.attrs.get("t")
            if t is None or r.depth > 0:   # count top-level spans only
                continue
            out[int(t)] = out.get(int(t), 0.0) + r.dur_ns / 1e9
        return out

    # -- export ---------------------------------------------------------
    def chrome_events(self) -> list:
        """Records as Chrome trace-event complete events (``ph: "X"``)."""
        pid = os.getpid()
        events = []
        for r in self._records:
            ev = {"name": r.kind, "cat": "repro", "ph": "X",
                  "ts": r.start_ns / 1e3, "dur": r.dur_ns / 1e3,
                  "pid": pid, "tid": r.tid}
            if r.attrs:
                ev["args"] = {k: v for k, v in r.attrs.items()}
            events.append(ev)
        return events


def chrome_trace_doc(events: list) -> dict:
    """Wrap events in the JSON object format Perfetto expects."""
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str, tracer: Tracer) -> dict:
    """Atomically write the tracer's records as a Chrome trace JSON file."""
    doc = chrome_trace_doc(tracer.chrome_events())
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return doc


def validate_chrome_trace(doc) -> list:
    """Validate a trace document against the trace-event schema subset we
    emit. Returns a list of error strings (empty = valid)."""
    errors = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["trace document must be an object with a 'traceEvents' key"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                errors.append(f"event {i}: missing required key {key!r}")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "i", "C", "M"):
            errors.append(f"event {i}: unknown phase {ph!r}")
        if ph == "X" and "dur" not in ev:
            errors.append(f"event {i}: complete event missing 'dur'")
        for key in ("ts", "dur"):
            if key in ev and (not isinstance(ev[key], (int, float))
                              or ev[key] < 0):
                errors.append(f"event {i}: {key!r} must be a number >= 0")
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"event {i}: 'args' must be an object")
    return errors


# -- programmatic torch.profiler hooks -----------------------------------
_PROFILER = None        # (torch.profiler.profile, log_dir) while capturing

#: file :func:`stop_profiler` exports the capture to, inside ``log_dir``
PROFILE_TRACE = "profile_trace.json"


def start_profiler(log_dir: str):
    """Start a programmatic ``torch.profiler`` capture (CPU activity, and
    CUDA when a card is present) whose Chrome trace :func:`stop_profiler`
    writes into ``log_dir``."""
    global _PROFILER
    import torch
    if _PROFILER is not None:
        raise RuntimeError("a profiler capture is already running")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _PROFILER = (prof, log_dir)


def stop_profiler():
    """Stop the capture started by :func:`start_profiler` and export its
    Chrome trace to ``log_dir/profile_trace.json``; returns the
    ``torch.profiler.profile`` (``key_averages()`` and friends), or None
    when nothing was capturing (idempotent)."""
    global _PROFILER
    if _PROFILER is None:
        return None
    prof, log_dir = _PROFILER
    _PROFILER = None
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(log_dir, PROFILE_TRACE))
    return prof
