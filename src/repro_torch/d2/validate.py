"""Exact host-side validity checks for distance-2 / bipartite colorings.

Independent of both the engine and the oracles: the distance-2 condition is
checked through its characterization "every vertex's neighbor list is
rainbow" — any two vertices at distance exactly 2 share a middle vertex, so
(with the distance-1 edge check) pairwise-distinct colors inside every
adjacency segment is equivalent to no two vertices within distance ≤ 2
sharing a color.  Fully vectorized via a segment sort.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import CSRGraph

__all__ = ["validate_d2", "validate_bipartite"]


def _segments_rainbow(
    row_offsets: np.ndarray, col_indices: np.ndarray, colors: np.ndarray
) -> bool:
    """True iff within every CSR row, distinct vertices have distinct colors."""
    m = col_indices.shape[0]
    if m == 0:
        return True
    seg = np.repeat(
        np.arange(row_offsets.shape[0] - 1, dtype=np.int64),
        np.diff(row_offsets),
    )
    nc = colors[col_indices]
    order = np.lexsort((nc, seg))
    seg_s, nc_s, vid_s = seg[order], nc[order], col_indices[order]
    dup = (
        (seg_s[1:] == seg_s[:-1])
        & (nc_s[1:] == nc_s[:-1])
        & (vid_s[1:] != vid_s[:-1])  # repeated entries of one vertex are fine
    )
    return not bool(dup.any())


def validate_d2(g: CSRGraph, colors: np.ndarray) -> bool:
    """True iff all colored (>0) and no two vertices within distance ≤ 2 share."""
    colors = np.asarray(colors)
    if colors.shape[0] < g.n or (colors[: g.n] <= 0).any():
        return False
    src, dst = g.edges()
    if bool((colors[src] == colors[dst]).any()):
        return False
    return _segments_rainbow(g.row_offsets, g.col_indices, colors)


def validate_bipartite(bg, colors: np.ndarray) -> bool:
    """True iff every column is colored and every row's columns are rainbow.

    That is the bipartite partial-coloring condition: two columns connected
    by a length-2 path through a row never share a color (the seed-matrix
    correctness condition for Jacobian compression).
    """
    colors = np.asarray(colors)
    if colors.shape[0] < bg.n_cols or (colors[: bg.n_cols] <= 0).any():
        return False
    return _segments_rainbow(bg.row_offsets, bg.row_to_col, colors)
