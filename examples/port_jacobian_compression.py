"""Jacobian compression on the port: the ``repro_torch.d2`` bipartite
workload (the counterpart of ``examples/jacobian_compression.py``).

    PYTHONPATH=src python examples/port_jacobian_compression.py [--n 4000 --band 3]
    PYTHONPATH=src python examples/port_jacobian_compression.py --device cpu --n 400

Colors the columns of a sparse Jacobian pattern into structurally-orthogonal
groups (no two columns in a group share a row), then shows the payoff: the
whole Jacobian is recovered from ``num_groups`` forward-mode products
``J @ seed`` instead of ``n_cols`` — on a banded pattern, exactly the optimal
``2*band+1`` groups.  Also runs a distance-2 coloring of a mesh graph, the
other classic compression workload (Hessians / grid stencils).
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.d2 import (  # noqa: E402
    color_distance2,
    compress_jacobian_pattern,
    greedy_serial_d2,
    validate_bipartite,
    validate_d2,
)
from repro_torch.graphs import grid2d, jacobian_band, jacobian_tall_skinny  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--band", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # --- banded Jacobian: the finite-difference stencil case ---------------
    bg = jacobian_band(args.n, band=args.band)
    t0 = time.perf_counter()
    cr = compress_jacobian_pattern(bg, mode="fused", device=dev)
    dt = time.perf_counter() - t0
    optimal = 2 * args.band + 1
    print(f"banded {args.n}x{args.n} (band={args.band}): "
          f"{bg.n_cols} columns -> {cr.num_groups} groups "
          f"(optimal {optimal}) in {dt*1e3:.1f}ms  "
          f"valid={validate_bipartite(bg, cr.coloring.colors)}")
    print(f"  compression ratio {bg.n_cols / cr.num_groups:.1f}x; "
          f"seed matrix {cr.seed_matrix().shape}")

    # --- tall-skinny random pattern: least-squares style --------------------
    bg = jacobian_tall_skinny(args.n * 2, 256, nnz_per_row=3, seed=0)
    cr = compress_jacobian_pattern(bg, mode="fused", device=dev)
    print(f"tall-skinny {bg.n_rows}x{bg.n_cols}: {cr.num_groups} groups "
          f"({bg.n_cols / cr.num_groups:.1f}x compression), "
          f"valid={validate_bipartite(bg, cr.coloring.colors)}")

    # --- distance-2 on a mesh: the Hessian/stencil compression case ---------
    g = grid2d(int(np.sqrt(args.n)), int(np.sqrt(args.n)), diagonals=True)
    t0 = time.perf_counter()
    r = color_distance2(g, mode="fused", device=dev)
    dt = time.perf_counter() - t0
    oracle = int(greedy_serial_d2(g).max())
    print(f"distance-2 on {g.n}-vertex mesh: {r.num_colors} colors "
          f"(serial oracle {oracle}) in {dt*1e3:.1f}ms  "
          f"valid={validate_d2(g, r.colors)}")


if __name__ == "__main__":
    main()
