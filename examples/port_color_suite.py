"""Color the Table-1 benchmark suite on the port and use the coloring for
chromatic scheduling of a Gauss-Seidel sweep (the counterpart of
``examples/color_suite.py``: same-color rows update concurrently because
they share no edge).

    PYTHONPATH=src python examples/port_color_suite.py [--scale 0.1]
    PYTHONPATH=src python examples/port_color_suite.py --device cpu --scale 0.02
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.core import color_data_driven, is_valid_coloring  # noqa: E402
from repro_torch.core.scheduling import phases, schedule_quality  # noqa: E402
from repro_torch.graphs import build_suite  # noqa: E402


def gauss_seidel_chromatic(g, colors, sweeps=2):
    """Jacobi-within-color Gauss-Seidel on the graph Laplacian: every phase
    updates an independent set, so updates within a phase are safe in
    parallel — the concurrency the coloring 'discovered'."""
    n = g.n
    deg = np.maximum(g.degrees, 1).astype(np.float64)
    x = np.zeros(n)
    b = np.ones(n)
    src, dst = g.edges()
    for _ in range(sweeps):
        for phase in phases(colors):
            # x_i <- (b_i + sum_{j in N(i)} x_j) / (deg_i + 1): vectorized
            acc = np.zeros(n)
            np.add.at(acc, src, x[dst])
            x[phase] = (b[phase] + acc[phase]) / (deg[phase] + 1.0)
    return x


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    print(f"{'graph':15s} {'n':>8s} {'m':>9s} {'colors':>6s} {'iters':>5s} "
          f"{'parallelism':>11s} {'time':>8s}")
    for name, g in build_suite(args.scale).items():
        t0 = time.perf_counter()
        r = color_data_driven(g, coarsen_lanes=16384, device=dev)
        dt = time.perf_counter() - t0
        assert is_valid_coloring(g, r.colors)
        sq = schedule_quality(r.colors)
        print(f"{name:15s} {g.n:8d} {g.m:9d} {r.num_colors:6d} "
              f"{r.iterations:5d} {sq['mean_parallelism']:11.0f} "
              f"{dt*1e3:7.1f}ms")

    # chromatic scheduling demo on one graph
    g = build_suite(args.scale, ["G3_circuit"])["G3_circuit"]
    r = color_data_driven(g, device=dev)
    x = gauss_seidel_chromatic(g, r.colors)
    print(f"\nchromatic Gauss-Seidel on G3_circuit: {r.num_colors} phases, "
          f"residual mean={x.mean():.4f} (finite={np.isfinite(x).all()})")


if __name__ == "__main__":
    main()
