"""Streaming-serve demo on the port: a service-hosted session over a
mutating graph (the counterpart of ``examples/stream_serve.py``).

    PYTHONPATH=src python examples/port_stream_serve.py [--rounds 8] [--churn 0.01]
    PYTHONPATH=src python examples/port_stream_serve.py --device cpu --rounds 2

A long-lived user graph lives as a pooled session inside a
``repro_torch.ColoringService``; each round a batch of edge updates (the
churn fraction deleted, the same number inserted) goes through
``service.apply_delta`` and a frontier-sized ``service.recolor`` repairs
the coloring, while a naive server re-runs the cold fused engine from
scratch.  Both are validated every round and the walls are reported.
Compaction stays off the hot path (deferred maintenance) and runs in one
explicit ``service.maintain()`` lull at the end.

Reporting goes through ``repro_torch.obs``: per-round lines from
``format_result``, the closing blocks from ``service.session_metrics()``
via ``format_metrics`` plus the service's own counters, and the worker's
spans counted by name.
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, "src")

from repro_torch.core import color_data_driven, is_valid_coloring  # noqa: E402
from repro_torch.dynamic import churn_delta  # noqa: E402
from repro_torch.graphs import build_graph  # noqa: E402
from repro_torch.launch.coloring_service import ColoringService  # noqa: E402
from repro_torch.obs.report import format_metrics, format_result  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="G3_circuit")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--churn", type=float, default=0.01)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    dev = args.device

    g = build_graph(args.graph, args.scale)
    svc = ColoringService(pool_size=4, queue_limit=64, trace=True, device=dev)
    sid = "user-0"
    opened = svc.open_session(sid, g)
    print(f"{args.graph}: n={g.n} m={g.m // 2} edges, "
          f"{args.churn:.1%} churn x {args.rounds} rounds "
          f"(session {sid!r}, pool {svc.metrics()['pool_occupancy']}/"
          f"{svc.metrics()['pool_size']}, device {dev})\n")
    print(f"cold start: {opened['num_colors']} colors, "
          f"converged={opened['converged']}\n")

    # the cold comparator recolors the same mutating graph from scratch;
    # it reads the live session's graph so both sides see identical deltas
    live = svc._touch(sid)

    t_inc = t_cold = 0.0
    ok = True
    for r in range(args.rounds):
        rem, add = churn_delta(live.graph, args.churn, rng)

        t0 = time.perf_counter()
        td = svc.apply_delta(sid, remove_edges=rem, add_edges=add, wait=False)
        inc = svc.recolor(sid)            # the client waits for the repair
        dirty = td.wait()
        t_inc += time.perf_counter() - t0

        t0 = time.perf_counter()
        cold = color_data_driven(live.graph, mode="fused", device=dev)
        t_cold += time.perf_counter() - t0

        valid = (is_valid_coloring(live.graph, np.asarray(svc.colors(sid)))
                 and is_valid_coloring(live.graph, cold.colors))
        ok &= valid
        print(f"round {r}: frontier={dirty.size:5d}  valid={valid}")
        print("  " + format_result("inc ", inc))
        print("  " + format_result("cold", cold))

    print(f"\nwall: incremental={t_inc * 1e3:.0f} ms  "
          f"cold={t_cold * 1e3:.0f} ms  "
          f"speedup={t_cold / max(t_inc, 1e-9):.1f}x")

    # lull-time maintenance: compaction/snapshots deferred off the hot path
    done = svc.maintain(sid)
    print(f"maintenance at the lull: {done[sid] or 'nothing due'}")

    print(format_metrics(svc.session_metrics(sid), "\nsession metrics:"))
    m = svc.metrics()
    print(f"\nservice: {m['admitted']} admitted, {m['completed']} completed, "
          f"{m['rejected']} rejected, queue peak depth <= "
          f"{m['queue_limit']}, engine keys "
          f"{m['session_engine_cache_hits']} hits / "
          f"{m['session_engine_cache_misses']} misses")
    kinds = {}
    for e in svc.take_spans():
        kinds[e.name] = kinds.get(e.name, 0) + 1
    print("worker spans: " + ", ".join(f"{k} x{v}"
                                       for k, v in sorted(kinds.items())))
    svc.shutdown()
    return ok


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
