"""Coloring validity metrics (exact, host-side numpy)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import CSRGraph

__all__ = ["is_valid_coloring", "num_colors"]


def is_valid_coloring(g: CSRGraph, colors: np.ndarray) -> bool:
    """True iff every vertex is colored (>0) and no edge is monochromatic."""
    colors = np.asarray(colors)
    if colors.shape[0] < g.n or (colors[: g.n] <= 0).any():
        return False
    src, dst = g.edges()
    return not bool((colors[src] == colors[dst]).any())


def num_colors(colors: np.ndarray) -> int:
    return int(np.asarray(colors).max(initial=0))
