"""Run inspector: render a telemetry dir (``FedConfig.telemetry_dir``)
(``repro.launch.inspect``, which imports no JAX; this is the port's own
copy, held to it by ``tests/test_torch_obs_run.py``).

    PYTHONPATH=src python -m repro_torch.launch.inspect RUN_DIR [--top K] \
        [--spark]
    PYTHONPATH=src python -m repro_torch.launch.inspect --check RUN_DIR

Works on finished *and* live runs: ``run_summary.json`` is used when
present, otherwise the per-stage breakdown is derived from ``trace.json``
and the accuracy series from the (still-growing) ``metrics.jsonl``.

``--check`` validates the dir against the telemetry schemas — Chrome
trace-event format, JSONL round-record keys + monotone round index, and
the summary's required keys — and exits non-zero on any violation.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

from repro_torch.obs.trace import validate_chrome_trace

#: keys every JSONL round record must carry (trainer subclasses add more)
ROUND_RECORD_KEYS = ("kind", "t", "acc", "loss", "disc", "quarantined")

#: keys a run_summary.json must carry (obs.telemetry.Telemetry.summary)
SUMMARY_KEYS = ("format", "counters", "stages", "span_kinds", "top_rounds")

_SPARK = "▁▂▃▄▅▆▇█"


def load_dir(run_dir: str) -> dict:
    """Best-effort load of everything a telemetry dir may contain."""
    out = {"summary": None, "records": [], "trace": None}
    p = os.path.join(run_dir, "run_summary.json")
    if os.path.exists(p):
        with open(p) as f:
            out["summary"] = json.load(f)
    p = os.path.join(run_dir, "trace.json")
    if os.path.exists(p):
        with open(p) as f:
            out["trace"] = json.load(f)
    for name in sorted(os.listdir(run_dir)):
        if name.startswith("metrics") and name.endswith(".jsonl"):
            with open(os.path.join(run_dir, name)) as f:
                for line in f:
                    if line.strip():
                        out["records"].append(json.loads(line))
    out["records"].sort(key=lambda r: r.get("t", -1))
    return out


def _stages_from_trace(trace: dict) -> dict:
    stages = {}
    for ev in trace.get("traceEvents", []):
        agg = stages.setdefault(ev["name"], {"count": 0, "total_s": 0.0,
                                             "max_s": 0.0})
        s = ev.get("dur", 0.0) / 1e6
        agg["count"] += 1
        agg["total_s"] += s
        agg["max_s"] = max(agg["max_s"], s)
    return stages


def _top_rounds_from_trace(trace: dict, k: int) -> list:
    per_round = {}
    for ev in trace.get("traceEvents", []):
        t = (ev.get("args") or {}).get("t")
        if t is None:
            continue
        per_round[int(t)] = per_round.get(int(t), 0.0) + \
            ev.get("dur", 0.0) / 1e6
    top = sorted(per_round.items(), key=lambda kv: -kv[1])[:k]
    return [{"t": t, "s": s} for t, s in top]


def sparkline(values, width: int = 60) -> str:
    vals = [v for v in values if v is not None and not math.isnan(v)]
    if not vals:
        return "(no data)"
    if len(vals) > width:          # downsample to the display width
        step = len(vals) / width
        vals = [vals[int(i * step)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))]
                   for v in vals)


def render(run_dir: str, data: dict, top_k: int = 5,
           spark: bool = False) -> str:
    summary, records, trace = data["summary"], data["records"], data["trace"]
    live = summary is None
    lines = [f"telemetry dir: {run_dir}" + ("   [live — no summary yet]"
                                            if live else "")]
    stages = (summary or {}).get("stages") or (
        _stages_from_trace(trace) if trace else {})
    if stages:
        total = sum(a["total_s"] for a in stages.values()) or 1.0
        lines += ["", "per-stage time breakdown:",
                  f"  {'stage':<12} {'count':>7} {'total':>10} "
                  f"{'mean':>10} {'max':>10} {'share':>7}"]
        for kind, a in sorted(stages.items(), key=lambda kv: -kv[1]["total_s"]):
            mean = a["total_s"] / max(a["count"], 1)
            lines.append(
                f"  {kind:<12} {a['count']:>7} {a['total_s']:>9.3f}s "
                f"{mean * 1e3:>8.2f}ms {a['max_s'] * 1e3:>8.2f}ms "
                f"{a['total_s'] / total:>6.1%}")
    counters = (summary or {}).get("counters") or {}
    # pop.* are all degradation counters by construction (_STATS_ZERO);
    # of async.* only expiries/requeues and quarantines signal trouble;
    # of fleet.* everything except normal throughput/liveness traffic
    # (jobs, results, heartbeats, joins, workers gauge) is a fault signal
    _FLEET_OK = ("fleet.jobs", "fleet.results", "fleet.heartbeats",
                 "fleet.joins", "fleet.workers")
    degraded = {k: v for k, v in counters.items()
                if (k.startswith("pop.")
                    or (k.startswith("fleet.") and k not in _FLEET_OK)
                    or k in ("async.lease_expiries", "async.requeues",
                             "rounds.quarantined", "rounds.empty_folds"))
                and not isinstance(v, dict) and v}
    lines += ["", "degradation counters:"]
    if degraded:
        lines += [f"  {k:<28} {v}" for k, v in sorted(degraded.items())]
    else:
        lines.append("  (all zero)")
    shist = counters.get("async.staleness_hist") or {}
    if shist:
        lines.append("  staleness histogram: " + ", ".join(
            f"s={k}: {v}" for k, v in sorted(shist.items(),
                                             key=lambda kv: int(kv[0]))))
    top = (summary or {}).get("top_rounds") or (
        _top_rounds_from_trace(trace, top_k) if trace else [])
    if top:
        lines += ["", f"top-{min(top_k, len(top))} slowest rounds:"]
        lines += [f"  t={r['t']:<6} {r['s'] * 1e3:>9.2f}ms"
                  for r in top[:top_k]]
    if records:
        accs = [r.get("acc") for r in records if r.get("kind") == "round"]
        lines += ["", f"rounds streamed: "
                      f"{sum(1 for r in records if r.get('kind') == 'round')}"]
        if spark:
            lines.append("accuracy: " + sparkline(accs))
            losses = [r.get("loss") for r in records
                      if r.get("kind") == "round"]
            lines.append("loss:     " + sparkline(losses))
    return "\n".join(lines)


def check_dir(run_dir: str) -> list:
    """Schema-validate a telemetry dir; returns error strings (empty = ok)."""
    errors = []
    if not os.path.isdir(run_dir):
        return [f"{run_dir}: not a directory"]
    trace_path = os.path.join(run_dir, "trace.json")
    if os.path.exists(trace_path):
        try:
            with open(trace_path) as f:
                doc = json.load(f)
        except ValueError as e:
            errors.append(f"trace.json: invalid JSON ({e})")
        else:
            errors += [f"trace.json: {e}" for e in validate_chrome_trace(doc)]
    last_t = None
    for name in sorted(os.listdir(run_dir)):
        if not (name.startswith("metrics") and name.endswith(".jsonl")):
            continue
        with open(os.path.join(run_dir, name)) as f:
            for i, line in enumerate(f):
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError as e:
                    errors.append(f"{name}:{i + 1}: invalid JSON ({e})")
                    continue
                if rec.get("kind") != "round":
                    continue
                missing = [k for k in ROUND_RECORD_KEYS if k not in rec]
                if missing:
                    errors.append(f"{name}:{i + 1}: missing {missing}")
                    continue
                if last_t is not None and rec["t"] <= last_t:
                    errors.append(
                        f"{name}:{i + 1}: round index t={rec['t']} not "
                        f"increasing (previous {last_t}) — duplicate or "
                        f"out-of-order record")
                last_t = rec["t"]
    summary_path = os.path.join(run_dir, "run_summary.json")
    if os.path.exists(summary_path):
        try:
            with open(summary_path) as f:
                summary = json.load(f)
        except ValueError as e:
            errors.append(f"run_summary.json: invalid JSON ({e})")
        else:
            for k in SUMMARY_KEYS:
                if k not in summary:
                    errors.append(f"run_summary.json: missing key {k!r}")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="inspect a repro_torch.obs telemetry dir")
    ap.add_argument("run_dir", help="telemetry dir (FedConfig.telemetry_dir)")
    ap.add_argument("--top", type=int, default=5,
                    help="slowest rounds to show")
    ap.add_argument("--spark", action="store_true",
                    help="ASCII sparklines of accuracy/loss")
    ap.add_argument("--check", action="store_true",
                    help="schema-validate only; exit 1 on violations")
    args = ap.parse_args(argv)
    if args.check:
        errors = check_dir(args.run_dir)
        for e in errors:
            print(f"SCHEMA VIOLATION: {e}", file=sys.stderr)
        print(f"{args.run_dir}: "
              + ("OK" if not errors else f"{len(errors)} violation(s)"))
        return 1 if errors else 0
    if not os.path.isdir(args.run_dir):
        print(f"{args.run_dir}: not a directory", file=sys.stderr)
        return 2
    print(render(args.run_dir, load_dir(args.run_dir),
                 top_k=args.top, spark=args.spark))
    return 0


if __name__ == "__main__":
    sys.exit(main())
