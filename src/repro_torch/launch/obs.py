"""Telemetry CLI: tail / report over the obs JSONL stream.

The serving launchers (``serve.py --obs``, ``optimize.py --obs``) stream
interleaved metrics snapshots and span records to a JSONL file (see
:mod:`repro_torch.obs.export`; the reference package writes the same
format). This CLI is the offline / live reader over that one artifact:

* ``tail`` — follow the stream and pretty-print records as they land
  (spans as one-liners, metrics snapshots as deltas of a few headline
  keys);
* ``report`` — reconstruct the whole session: span trees reassembled
  across processes, a per-phase latency waterfall (count / mean / p95 /
  errors per span name), the slowest-trace table with full tree
  rendering, and the final drift/alarm gauges.

    PYTHONPATH=src python -m repro_torch.launch.obs report \
        obs_telemetry.jsonl
    PYTHONPATH=src python -m repro_torch.launch.obs tail obs_telemetry.jsonl
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Iterable, List, Tuple

from repro_torch.obs.trace import TraceTree, assemble, completeness


def read_records(path: str) -> Tuple[List[Dict[str, Any]],
                                     List[Dict[str, Any]]]:
    """Split one telemetry stream into (span records, metric snapshots).
    Tolerates junk lines — a telemetry reader must never crash on a
    torn write."""
    spans: List[Dict[str, Any]] = []
    metrics: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            try:
                rec = json.loads(ln)
            except ValueError:
                continue
            if rec.get("kind") == "span":
                spans.append(rec)
            elif rec.get("kind") == "metrics":
                metrics.append(rec)
    return spans, metrics


# ------------------------------------------------------------------ report
def _pct(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    return s[min(int(q * len(s)), len(s) - 1)]


def waterfall(spans: Iterable[Dict[str, Any]]) -> List[Tuple]:
    """Per-phase latency table: (name, count, mean_ms, p95_ms, errs),
    heaviest total time first — the one-look answer to 'where does a
    request's wall actually go'."""
    by_name: Dict[str, List[float]] = {}
    errs: Dict[str, int] = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(float(s["dur_s"]))
        if s.get("status") not in (None, "ok"):
            errs[s["name"]] = errs.get(s["name"], 0) + 1
    rows = []
    for name, ds in by_name.items():
        rows.append((name, len(ds), 1e3 * sum(ds) / len(ds),
                     1e3 * _pct(ds, 0.95), errs.get(name, 0)))
    rows.sort(key=lambda r: -(r[1] * r[2]))
    return rows


def render_tree(tree: TraceTree, indent: str = "  ") -> List[str]:
    lines = []
    for depth, s in tree.walk():
        tags = " ".join(f"{k}={v}" for k, v in sorted(s["tags"].items()))
        mark = "" if s["status"] == "ok" else f" [{s['status']}]"
        lines.append(f"{indent * depth}{s['name']} "
                     f"{1e3 * s['dur_s']:.2f}ms ({s['proc']}){mark}"
                     f"{('  ' + tags) if tags else ''}")
    for s in tree.orphans:
        lines.append(f"  ?orphan {s['name']} (parent {s['parent'][:8]} "
                     f"missing)")
    return lines


def cmd_report(args) -> int:
    spans, metrics = read_records(args.path)
    trees = assemble(spans)
    print(f"{args.path}: {len(spans)} spans, {len(trees)} traces, "
          f"{len(metrics)} metric snapshots")
    if trees:
        procs = sorted({p for t in trees.values() for p in t.procs})
        print(f"traces reconstruct at {completeness(trees):.1%} "
              f"completeness across procs {procs}")
        print("\nlatency waterfall (per span name):")
        print(f"  {'phase':<24}{'count':>7}{'mean_ms':>10}"
              f"{'p95_ms':>10}{'errs':>6}")
        for name, n, mean, p95, ne in waterfall(spans):
            print(f"  {name:<24}{n:>7}{mean:>10.3f}{p95:>10.3f}{ne:>6}")
        slow = sorted((t for t in trees.values() if t.roots),
                      key=lambda t: -t.dur_s)[:args.slowest]
        print(f"\nslowest {len(slow)} trace(s):")
        for t in slow:
            state = "complete" if t.complete else \
                f"INCOMPLETE ({len(t.roots)} roots, " \
                f"{len(t.orphans)} orphans)"
            print(f"- trace {t.trace_id[:12]} {1e3 * t.dur_s:.2f}ms "
                  f"[{state}]")
            for ln in render_tree(t):
                print("    " + ln)
    if metrics:
        last = metrics[-1].get("metrics", {})
        drift = {k: v for k, v in sorted(last.items())
                 if k.startswith("drift.")}
        if drift:
            print("\nfinal drift gauges:")
            for k, v in drift.items():
                print(f"  {k} = {v:.4f}" if isinstance(v, float)
                      else f"  {k} = {v}")
        alarms = {k: v for k, v in last.items()
                  if k.endswith("_alarm") and v}
        if alarms:
            print(f"ALARMS ARMED: {sorted(alarms)}")
    return 0


# -------------------------------------------------------------------- tail
def _fmt_line(rec: Dict[str, Any]) -> str:
    if rec.get("kind") == "span":
        tags = " ".join(f"{k}={v}" for k, v in sorted(rec["tags"].items()))
        return (f"span  {rec['trace'][:10]} {rec['name']:<22} "
                f"{1e3 * rec['dur_s']:9.3f}ms {rec['proc']:<10} "
                f"{rec['status']}{('  ' + tags) if tags else ''}")
    if rec.get("kind") == "metrics":
        m = rec.get("metrics", {})
        keys = ("server.requests", "router.shed_count", "drift.scored",
                "drift.oov_alarm", "trace.buffered_spans")
        picks = " ".join(f"{k.split('.', 1)[1]}={m[k]}"
                         for k in keys if k in m)
        return f"metrics seq={rec.get('seq')} {picks}"
    return json.dumps(rec)[:120]


def cmd_tail(args) -> int:
    with open(args.path, encoding="utf-8") as f:
        while True:
            ln = f.readline()
            if ln:
                try:
                    rec = json.loads(ln)
                except ValueError:
                    continue
                if args.kind in (None, rec.get("kind")):
                    print(_fmt_line(rec), flush=True)
            elif args.follow:
                time.sleep(0.2)
            else:
                return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Inspect the unified-telemetry JSONL stream "
                    "written by --obs runs and the obs bench.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("tail", help="print records (optionally follow)")
    t.add_argument("path")
    t.add_argument("--follow", "-f", action="store_true",
                   help="keep waiting for new lines (live session)")
    t.add_argument("--kind", choices=("span", "metrics"), default=None,
                   help="only this record kind")
    t.set_defaults(fn=cmd_tail)
    r = sub.add_parser("report", help="session report: trees, "
                       "waterfall, slowest traces, drift gauges")
    r.add_argument("path")
    r.add_argument("--slowest", type=int, default=3,
                   help="how many slowest traces to render fully")
    r.set_defaults(fn=cmd_report)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
