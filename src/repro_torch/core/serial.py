"""Sequential greedy coloring (Algorithm 1) — the quality oracle and the
paper's CPU baseline.

First-Fit in vertex order with the vertex-stamped ``colorMask`` trick, so
each vertex costs O(deg(v)) without clearing the mask; also
Largest-Degree-First order.  Host-side numpy in both packages: it is the
serial CPU implementation the paper compares against, not a kernel path.
Registered as ``"serial"`` (``color_serial``).  The port also uses it as an
independent oracle for the stall tail, which re-greedies the whole graph
in ``order_tail`` order.
"""
from __future__ import annotations

import numpy as np

from repro_torch.api import register
from repro_torch.core.csr import CSRGraph
from repro_torch.kernels.dispatch import resolve_backend

__all__ = ["greedy_serial", "color_serial"]


def greedy_serial(g: CSRGraph, order: str | np.ndarray = "natural") -> np.ndarray:
    """Color ``g`` greedily; returns int32 colors in [1, max_degree+1]."""
    n = g.n
    colors = np.zeros(n + 1, dtype=np.int32)  # slot n = sentinel (color 0)
    # color_mask[c] == v means color c is forbidden for the current vertex v
    color_mask = np.full(g.max_degree + 2, -1, dtype=np.int64)
    if isinstance(order, str):
        if order == "natural":
            verts = range(n)
        elif order == "largest_degree_first":
            verts = np.argsort(-g.degrees, kind="stable")
        else:
            raise ValueError(f"unknown order {order!r}")
    else:
        verts = order
    R, C = g.row_offsets, g.col_indices
    for v in verts:
        neigh = C[R[v]: R[v + 1]]
        color_mask[colors[neigh]] = v  # stamps color 0 too; search starts at 1
        limit = neigh.shape[0] + 2
        free = np.nonzero(color_mask[1:limit] != v)[0]
        colors[v] = free[0] + 1
    return colors[:n]


@register("serial")
def color_serial(g: CSRGraph, *, order: str | np.ndarray = "natural",
                 device=None):
    """``greedy_serial`` under the shared ``ColoringResult`` contract.

    The sweep runs on the host whatever ``device`` says; ``device`` is
    resolved as every entry point resolves it (``None`` means the card, and
    raises without one), so one ``color(g, ..., device=...)`` call works for
    every algorithm.
    """
    from repro_torch.core.coloring import ColoringResult

    resolve_backend(None, device)
    colors = greedy_serial(g, order)
    return ColoringResult(
        colors,
        iterations=1,           # one sequential sweep
        work_items=g.n,
        padded_work=g.n,
        converged=True,
        algorithm="serial_greedy",
    )
