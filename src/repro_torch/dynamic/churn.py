"""The churn-workload generator of the streaming engine (port of
``repro.dynamic.churn``): the sliding-window edge stream of the churn
benchmark, the session tests and ``chip_smoke.py``'s streaming runs.
"""
from __future__ import annotations

import numpy as np

__all__ = ["churn_delta"]


def churn_delta(g, frac: float, rng) -> tuple[tuple, tuple]:
    """One churn round: ``(remove_edges, add_edges)`` batches for ``g``.

    Deletes ``frac`` of the undirected edges (chosen by ``rng``) and draws
    the same number of uniform random pairs to insert (self-loops and
    duplicates are dropped by the ``DeltaCSR`` mutation layer, so the
    effective insert count is slightly below the delete count on dense
    graphs — the stream drifts sparse, like real churn).
    """
    src, dst = g.edges()
    und = src < dst
    es, ed = src[und], dst[und]
    k = max(1, int(frac * es.size))
    drop = rng.permutation(es.size)[:k]
    add = (rng.integers(0, g.n, k), rng.integers(0, g.n, k))
    return (es[drop], ed[drop]), add
