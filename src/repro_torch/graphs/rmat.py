"""R-MAT recursive-matrix graph generator (Chakrabarti et al., SDM'04).

The paper (§4) generates its two synthetic graphs with R-MAT:

* ``rmat-er`` — (a,b,c,d) = (0.25, 0.25, 0.25, 0.25)  (Erdős–Rényi-like)
* ``rmat-g``  — (a,b,c,d) = (0.45, 0.15, 0.15, 0.25)  (skewed / power-law-ish)

both with 1M vertices and average degree 10.  We reproduce the recipe exactly
(vectorized over edges; one quadrant draw per recursion level) with a
configurable scale.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import CSRGraph, csr_from_edges

__all__ = ["rmat", "RMAT_ER", "RMAT_G"]

RMAT_ER = (0.25, 0.25, 0.25, 0.25)
RMAT_G = (0.45, 0.15, 0.15, 0.25)


def rmat(
    n: int,
    avg_degree: float = 10.0,
    params: tuple[float, float, float, float] = RMAT_G,
    seed: int = 0,
) -> CSRGraph:
    """Generate an undirected R-MAT graph with ~``n * avg_degree / 2`` edges."""
    a, b, c, d = params
    assert abs(a + b + c + d - 1.0) < 1e-9
    levels = int(np.ceil(np.log2(max(n, 2))))
    size = 1 << levels
    m = int(n * avg_degree / 2)
    rng = np.random.default_rng(seed)

    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    # probability of "right half" for column, "bottom half" for row, with a
    # small noise term per level as in the original R-MAT description.
    for lvl in range(levels):
        u = rng.random(m)
        # quadrant thresholds: a | b / c | d  (row-major)
        p_bottom = c + d
        bottom = u >= (a + b)
        # conditional probability of right within top/bottom rows
        right_top = (u >= a) & ~bottom
        right_bottom = u >= (a + b + c)
        right = right_top | right_bottom
        bit = 1 << (levels - 1 - lvl)
        src += bottom * bit
        dst += right * bit
        del p_bottom
    keep = (src < n) & (dst < n)
    return csr_from_edges(n, src[keep], dst[keep])
