"""Text reporting over traces, spans, and session metrics (port of
``repro.obs.report``).

* ``format_result``   — one-line engine-run summary from a ``ColoringResult``
* ``format_trace``    — per-super-step table from a ``RunTrace``
* ``format_spans``    — phase table with the compile-vs-execute split
* ``format_metrics``  — aligned key/value block (``session.metrics()``)

and a CLI that re-reports from files instead of rerunning anything::

    python -m repro_torch.obs.report trace.json          # Chrome-trace export
    python -m repro_torch.obs.report BENCH_coloring.json # BENCH schema >= 6 doc
"""
from __future__ import annotations

import json
import sys

from .spans import SpanRecorder
from .trace import RunTrace

__all__ = [
    "format_result",
    "format_trace",
    "format_spans",
    "format_metrics",
    "main",
]


def format_result(label: str, result) -> str:
    """One-line run summary; appends trace headline when one is attached."""
    parts = [f"{label}: colors={result.num_colors}",
             f"iters={result.iterations}",
             f"work={result.work_items}",
             f"padded={result.padded_work}"]
    if not result.converged:
        parts.append("NOT-CONVERGED")
    trace = getattr(result, "trace", None)
    if isinstance(trace, RunTrace):
        tail = trace.tail_step
        parts.append(f"tail@{tail}" if tail >= 0 else "no-tail")
    return "  ".join(parts)


def format_trace(trace: RunTrace, last: int | None = None) -> str:
    """Per-super-step table (most recent ``last`` rows when given)."""
    header = (f"{'step':>5} {'live':>9} {'retired':>9} {'confl':>9} "
              f"{'maxc':>5} {'cells':>11} {'halo_B':>9} {'imbal':>7}  flag")
    lines = [f"trace[{trace.engine}]: {trace.iterations} steps "
             f"({trace.dropped} dropped from ring, cap={trace.cap})", header]
    rows = trace.steps
    first_abs = trace.dropped
    if last is not None and rows.shape[0] > last:
        first_abs += rows.shape[0] - last
        rows = rows[-last:]
    for i, row in enumerate(rows):
        live, retired, confl, maxc, cells, tail, halo, imb = (
            int(v) for v in row)
        flag = "tail" if tail else ""
        if first_abs + i == 0 and not tail:
            flag = "boot" if cells == 0 else flag
        lines.append(f"{first_abs + i:>5} {live:>9} {retired:>9} "
                     f"{confl:>9} {maxc:>5} {cells:>11} {halo:>9} "
                     f"{imb:>7}  {flag}")
    return "\n".join(lines)


def format_spans(spans) -> str:
    """Phase table; ``spans`` is a recorder or a list of ``SpanEvent``."""
    events = spans.events if isinstance(spans, SpanRecorder) else list(spans)
    if not events:
        return "spans: (none recorded)"
    rec = SpanRecorder()
    rec.events = events
    lines = [f"{'phase':<22} {'count':>5} {'total_ms':>10} {'compile_ms':>11}"]
    for name, agg in sorted(rec.by_name().items(),
                            key=lambda kv: -kv[1]["seconds"]):
        lines.append(f"{name:<22} {agg['count']:>5} "
                     f"{agg['seconds'] * 1e3:>10.2f} "
                     f"{agg['compile_seconds'] * 1e3:>11.2f}")
    return "\n".join(lines)


def format_metrics(metrics: dict, title: str = "") -> str:
    """Aligned key/value block for cumulative counters."""
    lines = [title] if title else []
    width = max((len(k) for k in metrics), default=0)
    for k, v in metrics.items():
        if isinstance(v, float):
            v = f"{v:.4g}"
        lines.append(f"  {k:<{width}} : {v}")
    return "\n".join(lines)


def _report_chrome(doc: dict, last: int | None) -> str:
    out = []
    for label, tdict in sorted(doc["otherData"].get("repro", {}).items()):
        out.append(format_trace(RunTrace.from_dict(tdict), last=last))
        out.append("")
    return "\n".join(out).rstrip()


def _report_bench(doc: dict, last: int | None) -> str:
    out = [f"BENCH schema {doc.get('schema')} "
           f"backend={doc.get('backend', '?')} "
           f"engine={doc.get('engine', '?')}"]
    for alg, per_graph in sorted(doc.get("algorithms", {}).items()):
        for name, rec in sorted(per_graph.items()):
            t = rec.get("trace")
            label = f"{alg}/{name}"
            if not t:
                continue  # untraced algorithms carry no section (schema 6)
            out.append(
                f"{label}: supersteps={t['supersteps']} "
                f"tail_step={t['tail_step']} "
                f"final_max_color={t['max_color'][-1] if t['max_color'] else 0}")
            n = len(t["live"])
            show = range(n if last is None else max(0, n - last), n)
            for i in show:
                out.append(
                    f"  step {t['series_from'] + i:>4}: "
                    f"live={t['live'][i]:>8} retired={t['retired'][i]:>8} "
                    f"conflicts={t['conflicts'][i]:>8} "
                    f"maxc={t['max_color'][i]:>4} cells={t['cells'][i]}")
    for name, rec in sorted(doc.get("dynamic", {}).items()):
        label = f"dynamic/{name}"
        rounds = rec.get("rounds_detail")
        if not rounds:
            out.append(f"{label}: no per-round detail")
            continue
        out.append(f"{label}: {len(rounds)} churn rounds, "
                   f"jit misses={rec.get('jit', {}).get('misses', '?')} "
                   f"hits={rec.get('jit', {}).get('hits', '?')}")
        for r in rounds:
            out.append(f"  round {r['round']}: frontier={r['frontier']:>7} "
                       f"work={r['work']:>8} supersteps={r['supersteps']} "
                       f"tail_step={r['tail_step']} "
                       f"cache_hit={r['cache_hit']}")
    return "\n".join(out)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    last = None
    if "--last" in argv:
        i = argv.index("--last")
        last = int(argv[i + 1])
        del argv[i:i + 2]
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.report [--last N] "
              "<chrome_trace.json | BENCH_*.json>", file=sys.stderr)
        return 2
    with open(argv[0]) as fh:
        doc = json.load(fh)
    if "traceEvents" in doc:
        print(_report_chrome(doc, last))
    elif "algorithms" in doc or "dynamic" in doc:
        print(_report_bench(doc, last))
    else:
        print("unrecognized document (want a repro chrome-trace export "
              "or a BENCH schema>=6 doc)", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
