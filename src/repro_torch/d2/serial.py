"""Sequential greedy distance-2 / bipartite oracles (quality baselines).

Deliberately independent of ``CSRGraph.square`` and the device engine: the
two-hop neighborhood is enumerated directly from the CSR arrays per vertex,
the most obviously-correct formulation, so oracle and engine share no
two-hop code path (``validate_d2`` is independent of both).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import CSRGraph

__all__ = ["greedy_serial_d2", "greedy_serial_bipartite"]


def _order(n: int, degrees: np.ndarray, order) -> "np.ndarray | range":
    if isinstance(order, str):
        if order == "natural":
            return range(n)
        if order == "largest_degree_first":
            return np.argsort(-degrees, kind="stable")
        raise ValueError(f"unknown order {order!r}")
    return order


def _first_free(forbidden: np.ndarray, limit: int) -> int:
    """Smallest color in [1, limit] not present in ``forbidden``."""
    mask = np.zeros(limit + 2, dtype=bool)
    mask[forbidden[(forbidden >= 1) & (forbidden <= limit)]] = True
    return int(np.nonzero(~mask[1:])[0][0]) + 1


def greedy_serial_d2(
    g: CSRGraph, order: str | np.ndarray = "natural"
) -> np.ndarray:
    """Greedy distance-2 coloring; colors in [1, Δ₂+1], Δ₂ ≤ Δ(Δ-1)+Δ."""
    n = g.n
    R, C = g.row_offsets, g.col_indices
    colors = np.zeros(n, dtype=np.int32)
    for v in _order(n, g.degrees, order):
        n1 = C[R[v] : R[v + 1]]
        if n1.size:
            n2 = np.concatenate([C[R[u] : R[u + 1]] for u in n1])
            nbrs = np.concatenate([n1, n2[n2 != v]])
        else:
            nbrs = n1
        colors[v] = _first_free(colors[nbrs], nbrs.shape[0] + 1)
    return colors


def greedy_serial_bipartite(bg, order: str | np.ndarray = "natural") -> np.ndarray:
    """Greedy partial coloring of the column side of a ``BipartiteGraph``.

    Two columns conflict iff a length-2 path through a row connects them —
    the Jacobian-compression rule (structurally-orthogonal columns share a
    color).  Natural order on a banded pattern recovers the optimal count.
    """
    nc = bg.n_cols
    Rc, Cc = bg.col_offsets, bg.col_to_row
    Rr, Cr = bg.row_offsets, bg.row_to_col
    colors = np.zeros(nc, dtype=np.int32)
    for v in _order(nc, bg.col_degrees, order):
        rows = Cc[Rc[v] : Rc[v + 1]]
        if rows.size:
            cols2 = np.concatenate([Cr[Rr[r] : Rr[r + 1]] for r in rows])
            nbrs = cols2[cols2 != v]
        else:
            nbrs = rows  # empty
        colors[v] = _first_free(colors[nbrs], nbrs.shape[0] + 1)
    return colors
