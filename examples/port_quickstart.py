"""Quickstart on the port: color a sparse graph with every implementation
and compare (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/port_quickstart.py [--n 20000]
    PYTHONPATH=src python examples/port_quickstart.py --device cpu --n 3000

Reproduces the paper's headline result in one screen: the data-driven
speculative-greedy implementation matches serial greedy quality while the
MIS/multi-hash (csrcolor) baseline burns several times more colors.  On the
card (the default) the engines launch the port's CUDA kernels; serial greedy
runs on the host.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.core import (  # noqa: E402
    color_data_driven,
    color_jp,
    color_multihash,
    color_threestep,
    color_topology,
    greedy_serial,
    is_valid_coloring,
    num_colors,
)
from repro_torch.graphs import rmat  # noqa: E402
from repro_torch.graphs.rmat import RMAT_G  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--degree", type=float, default=10.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    g = rmat(args.n, args.degree, RMAT_G, seed=0)
    print(f"graph: n={g.n} m={g.m} dbar={g.avg_degree:.1f} "
          f"maxdeg={g.max_degree}\n")

    t0 = time.perf_counter()
    serial = greedy_serial(g)
    t_serial = time.perf_counter() - t0
    print(f"{'algorithm':28s} {'colors':>6s} {'iters':>5s} {'time':>8s} "
          f"{'speedup':>7s} valid")

    def report(name, colors, iters, t):
        ok = is_valid_coloring(g, colors)
        print(f"{name:28s} {num_colors(colors):6d} {iters:5d} {t*1e3:7.1f}ms "
              f"{t_serial/t:7.2f} valid={ok}")

    report("serial greedy (oracle)", serial, g.n, t_serial)
    for name, fn in [
        ("proposed-opt (SGR)", lambda: color_data_driven(
            g, coarsen_lanes=16384, device=dev)),
        ("proposed-base (SGR)", lambda: color_data_driven(
            g, heuristic="id", firstfit="scan", device=dev)),
        ("topology-driven", lambda: color_topology(g, device=dev)),
        ("3-step GM analogue", lambda: color_threestep(g, device=dev)),
        ("JP (MIS)", lambda: color_jp(g, device=dev)),
        ("csrcolor multi-hash (MIS)", lambda: color_multihash(g, 2, device=dev)),
    ]:
        r = fn()  # warm-up: the kernels' build and the engine's caches
        t0 = time.perf_counter()
        r = fn()   # the colours come back to the host: the call has ended
        report(name, r.colors, r.iterations, time.perf_counter() - t0)


if __name__ == "__main__":
    main()
