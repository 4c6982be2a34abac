"""Topology-driven SGR coloring (paper Alg. 6), the work-inefficient
mapping (port of ``repro.core.topo``).

Every super-step runs lanes for all n vertices; lanes whose vertex is
already colored do no useful work, as the idle CUDA threads of the
topology-driven mapping do.  A ``colored`` mask keeps finalized vertices
from being resolved again (Alg. 6 l.11).  It is the Fig. 3 baseline, so it
is not shrunk to a worklist.

On the card a step is two kernel launches over the dense ``(n, Δmax)``
table, each reading every row by id where it lies: FirstFit is K4
(``firstfit_rows`` over all n ids, up to each degree) and ConflictResolve
is K5 (``conflict_rows``).  K4 is always the bitset FirstFit; ``scan``,
``sort`` and ``bitset`` all return the smallest absent colour in ``[1,
W+1]``, so ``firstfit=`` changes no colour there.  On the CPU the step
takes ``FF_FUNCS[firstfit]`` and ``cr_flags``' plain formulation, as
``repro`` does.  One host sync a step (the uncolored count), as in
``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import register
from repro_torch.core.coloring import ColoringResult, _on_card, cr_flags
from repro_torch.core.csr import CSRGraph, DeviceGraph
from repro_torch.core.firstfit import FF_FUNCS
from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.kernels.firstfit.kernel import firstfit_rows

__all__ = ["color_topology"]


def _topo_step(adj, deg_ext, colors_ext, colored, ids, *, heuristic: str,
               kind: str):
    """One topology-driven super-step over all ``n`` lanes.

    FirstFit reads the step-start colours and writes only where a vertex is
    uncolored; ConflictResolve then reads the colours just written, its
    losers among the not-yet-finalized vertices are cleared, and
    ``colored = ~lose & (c > 0)``.  Updates ``colors_ext`` in place; returns
    ``(colors_ext, colored, uncolored_count)`` with the count on the device.
    """
    n = adj.shape[0]
    ff = FF_FUNCS[kind]  # an unknown kind raises on both devices, as in repro
    cur = colors_ext[:n]
    uncolored = cur == 0
    # FirstFit for every vertex (idle lanes compute but do not write)
    if _on_card(ids):
        c = firstfit_rows(colors_ext, ids, table=adj, deg_ext=deg_ext)
    else:
        c = ff(colors_ext[adj.long()])
    colors_ext[:n] = torch.where(uncolored, c, cur)
    # ConflictResolve for every not-yet-finalized vertex, then clearing
    lose = cr_flags(adj, deg_ext, colors_ext, ids, heuristic) & ~colored
    colors_ext[:n] = torch.where(lose, 0, colors_ext[:n])
    colored = ~lose & (colors_ext[:n] > 0)
    return colors_ext, colored, (~colored).sum()


def topo_steps(dg: DeviceGraph, steps: int, *, heuristic: str, kind: str):
    """Up to ``steps`` topology-driven super-steps from the all-zero start,
    stopping once every vertex is finalized.  Returns ``(colors_ext, iters,
    remaining)``."""
    n = dg.n
    device = dg.adj.device
    ids = torch.arange(n, dtype=torch.int32, device=device)
    colors_ext = torch.zeros((n + 1,), dtype=torch.int32, device=device)
    colored = torch.zeros((n,), dtype=torch.bool, device=device)
    iters, remaining = 0, n
    while remaining > 0 and iters < steps:
        colors_ext, colored, rem = _topo_step(
            dg.adj, dg.degrees, colors_ext, colored, ids,
            heuristic=heuristic, kind=kind)
        remaining = int(rem)
        iters += 1
    return colors_ext, iters, remaining


@register("topology")
def color_topology(
    g: CSRGraph,
    *,
    heuristic: str = "id",
    firstfit: str = "bitset",
    max_iters: int | None = None,
    device=None,
) -> ColoringResult:
    """Topology-driven coloring of ``g``; results equal
    ``repro.core.color_topology``'s field for field.  ``device`` defaults
    to ``"cuda"`` (K4 and K5); ``device="cpu"`` runs the plain versions."""
    device = resolve_backend(None, device)
    n = g.n
    if n == 0:
        return ColoringResult(np.zeros(0, np.int32), 0, 0, 0, True, "topology_sgr")
    max_iters = max_iters or n + 1
    colors_ext, iters, remaining = topo_steps(
        DeviceGraph.from_csr(g, device), max_iters, heuristic=heuristic,
        kind=firstfit)
    return ColoringResult(
        colors_ext[:n].cpu().numpy(),
        iters,
        work_items=iters * n,   # topology-driven: all lanes, every step
        padded_work=iters * n,
        converged=remaining == 0,
        algorithm="topology_sgr",
    )
