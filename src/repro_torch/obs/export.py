"""Chrome-trace-format export of ``RunTrace`` records (port of
``repro.obs.export``).

Produces the Trace Event Format JSON that chrome://tracing and Perfetto
(https://ui.perfetto.dev) load directly:

* phase spans → ``"ph": "X"`` complete events (one track per run),
* per-super-step series → ``"ph": "C"`` counter events (worklist
  live/retired/conflicts, max color, dispatch cells, halo bytes).

Timestamps are microseconds.  Span events use their real monotonic-clock
offsets; step counters are placed inside the run's super-step-loop span
when one was captured (spread uniformly across its duration, as in
``repro``: the rows carry no per-step clock), else on a synthetic 1 ms/step
axis.  Each exported run gets its own pid so multiple runs (e.g. every
record of a bench document) land as separate named process tracks in one
file.

The full ``RunTrace`` dicts ride along under ``otherData.repro`` (the key
``repro`` writes, so either package's reporter reads either's export) and
``python -m repro_torch.obs.report FILE`` reconstructs text reports from
an exported file without rerunning anything.
"""
from __future__ import annotations

import json

from .trace import RunTrace

__all__ = ["chrome_trace", "export_chrome_trace"]

_STEP_US = 1000.0  # synthetic per-step spacing when no loop span exists


def _coerce(run) -> RunTrace | None:
    trace = getattr(run, "trace", run)
    return trace if isinstance(trace, RunTrace) else None


def chrome_trace(runs) -> dict:
    """Build the Trace Event Format document.

    ``runs`` is a ``RunTrace``, a ``ColoringResult`` carrying one, or a
    ``{label: RunTrace | ColoringResult}`` mapping (one pid per label).
    """
    if not isinstance(runs, dict):
        runs = {"run": runs}
    events: list = []
    other: dict = {}
    for pid, (label, run) in enumerate(sorted(runs.items())):
        trace = _coerce(run)
        if trace is None:
            continue
        other[label] = trace.to_dict()
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": f"repro:{label}"}})
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": trace.engine or "engine"}})

        spans = list(trace.spans)
        t0 = min((e.start for e in spans), default=0.0)
        loop = next((e for e in spans if e.name == "superstep_loop"), None)
        for e in spans:
            events.append({
                "name": e.name, "cat": e.cat, "ph": "X", "pid": pid,
                "tid": 0, "ts": (e.start - t0) * 1e6,
                "dur": max(e.duration * 1e6, 0.01),
                "args": {k: v for k, v in e.meta.items()},
            })

        steps = trace.steps
        n_rows = int(steps.shape[0])
        if n_rows:
            if loop is not None and loop.duration > 0:
                base = (loop.start - t0) * 1e6
                dt = loop.duration * 1e6 / n_rows
            else:
                base, dt = 0.0, _STEP_US
            fields = trace.fields
            for i in range(n_rows):
                ts = base + i * dt
                row = dict(zip(fields, (int(v) for v in steps[i])))
                events.append({"name": "worklist", "ph": "C", "pid": pid,
                               "tid": 0, "ts": ts,
                               "args": {"live": row["live"],
                                        "retired": row["retired"],
                                        "conflicts": row["conflicts"]}})
                events.append({"name": "colors", "ph": "C", "pid": pid,
                               "tid": 0, "ts": ts,
                               "args": {"max_color": row["max_color"]}})
                events.append({"name": "dispatch_cells", "ph": "C",
                               "pid": pid, "tid": 0, "ts": ts,
                               "args": {"cells": row["cells"]}})
                if row["halo_bytes"] or row["imbalance"]:
                    events.append({"name": "halo", "ph": "C", "pid": pid,
                                   "tid": 0, "ts": ts,
                                   "args": {"halo_bytes": row["halo_bytes"],
                                            "imbalance": row["imbalance"]}})
                if row["tail"]:
                    events.append({"name": "serial_tail_step", "ph": "I",
                                   "pid": pid, "tid": 0, "ts": ts,
                                   "s": "p"})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"repro": other, "schema": 1},
    }


def export_chrome_trace(path: str, runs) -> dict:
    """Write the Chrome-trace JSON for ``runs`` to ``path``; returns the doc."""
    doc = chrome_trace(runs)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc
