"""Coloring validity and quality metrics (exact, host-side numpy)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import CSRGraph
from repro_torch.obs.spans import span

__all__ = ["is_valid_coloring", "num_colors", "quality_report"]


def is_valid_coloring(g: CSRGraph, colors: np.ndarray) -> bool:
    """True iff every vertex is colored (>0) and no edge is monochromatic."""
    with span("validate", n=g.n):
        colors = np.asarray(colors)
        if colors.shape[0] < g.n or (colors[: g.n] <= 0).any():
            return False
        src, dst = g.edges()
        return not bool((colors[src] == colors[dst]).any())


def num_colors(colors: np.ndarray) -> int:
    return int(np.asarray(colors).max(initial=0))


def quality_report(g: CSRGraph, colors: np.ndarray) -> dict:
    """Validity, color count, the greedy bound ``Δ + 1`` and class sizes."""
    colors = np.asarray(colors)
    counts = np.bincount(colors[colors > 0])
    return {
        "valid": is_valid_coloring(g, colors),
        "num_colors": num_colors(colors),
        "greedy_bound": g.max_degree + 1,
        "largest_class": int(counts.max(initial=0)),
        "mean_class": float(counts[1:].mean()) if counts.size > 1 else 0.0,
    }
