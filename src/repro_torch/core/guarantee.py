"""Convergence guarantee ladder (port of ``repro.core.guarantee``).

The speculative engines converge in practice, but "in practice" is not a
contract: a starved iteration budget, a disabled tail, or an injected fault
can leave a run unconverged or its colors corrupt.  The ladder answers
with bounded escalation instead of a raise:

1. **reseed** — deterministically reseed the speculation by flipping the
   conflict heuristic (``degree`` ↔ ``id``): a completely different
   winner/loser trajectory through the same engine, no randomness.
2. **budget_extension** — rerun with the full ``n + 1`` iteration budget
   and the adaptive serial tail enabled; the tail makes convergence certain
   for any finite budget the first run was starved of.
3. **serialize_survivors** — keep every color the failed run got right and
   sequentially FirstFit only the *residual* (uncolored vertices plus the
   loser endpoint of every monochromatic edge) in the engine's tail order
   (degree-descending, id-ascending).  With the complement frozen, the
   residual covers at least one endpoint of every violation, so the sweep
   always ends in a proper coloring of the whole graph.
4. **serial_oracle** — trust nothing: recompute the residual and hand it to
   the Algorithm-1 serial oracle order (ascending ids), falling back to a
   full ``greedy_serial`` recoloring if even the residual state is garbage.
   Unconditionally valid.

Each rung taken is recorded as a ``{"stage": "ladder", "rung": ...}`` entry
in ``ColoringResult.degradations`` and emitted as a ``guarantee_ladder``
span (``repro_torch.obs``), so a degraded-but-valid answer is always
observable: ``color(g, ensure_valid=True)`` never returns an invalid
coloring and never hides what it cost to get there.  The ladder's own work
is host numpy, as in ``repro``; its reruns run on the caller's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.csr import CSRGraph
from repro_torch.core.validate import is_valid_coloring
from repro_torch.obs.spans import span

__all__ = [
    "LADDER_RUNGS",
    "rung_options",
    "residual_vertices",
    "serial_repair",
    "square_graph",
    "ensure_valid_result",
]

LADDER_RUNGS = ("reseed", "budget_extension", "serialize_survivors",
                "serial_oracle")


def rung_options(opts: dict, rung: str) -> dict:
    """The engine options a rerun rung uses: ``reseed`` flips the conflict
    heuristic, ``budget_extension`` restores the engine's full iteration
    budget and its serial tail.  Shared by ``color(ensure_valid=True)`` and
    ``compress_jacobian_pattern``."""
    o = dict(opts)
    if rung == "reseed":
        cur = o.get("heuristic", "degree")
        o["heuristic"] = "id" if cur == "degree" else "degree"
    elif rung == "budget_extension":
        o["max_iters"] = None  # the engine default: always enough
        if o.get("tail_serial", "auto") is None:
            o["tail_serial"] = "auto"
    return o


def residual_vertices(g: CSRGraph, colors: np.ndarray) -> np.ndarray:
    """Vertices that must recolor: uncolored ∪ per-violation loser endpoints.

    Mirrors the engine's loser rule under the ``degree`` heuristic (smaller
    degree loses, ties lose to the larger id) so the residual the ladder
    recolors matches the set the super-step itself would have kept live.
    Recoloring the residual suffices: every monochromatic edge has at least
    one endpoint in it.
    """
    n = g.n
    c = np.zeros(n, np.int64)
    colors = np.asarray(colors)
    take = min(n, colors.shape[0])
    c[:take] = colors[:take]
    bad = c <= 0
    src, dst = g.edges()
    src = src.astype(np.int64)
    dst = dst.astype(np.int64)
    mono = (c[src] == c[dst]) & (c[src] > 0)
    if mono.any():
        deg = g.degrees.astype(np.int64)
        s, d = src[mono], dst[mono]
        lose_s = (deg[s] < deg[d]) | ((deg[s] == deg[d]) & (s > d))
        bad[np.where(lose_s, s, d)] = True
    return np.nonzero(bad)[0].astype(np.int64)


def serial_repair(g: CSRGraph, colors: np.ndarray, residual: np.ndarray,
                  order: str = "tail") -> np.ndarray:
    """Sequentially FirstFit ``residual`` against the frozen complement.

    ``order="tail"`` matches the engine's serial tail (degree-descending,
    id-ascending); ``order="oracle"`` is the Algorithm-1 ascending-id sweep.
    Returns a full length-``n`` color array; the complement keeps its
    colors bit-for-bit.
    """
    n = g.n
    out = np.zeros(n, np.int32)
    colors = np.asarray(colors)
    take = min(n, colors.shape[0])
    out[:take] = colors[:take]
    residual = np.asarray(residual, dtype=np.int64)
    out[residual] = 0
    if order == "tail":
        deg = g.degrees
        residual = residual[np.lexsort((residual, -deg[residual]))]
    elif order != "oracle":
        raise ValueError(f"unknown repair order {order!r}")
    R, C = g.row_offsets, g.col_indices
    # vertex-stamped colorMask (Alg. 1): O(deg(v)) per vertex, no clearing
    color_mask = np.full(g.max_degree + 2, -1, dtype=np.int64)
    for v in residual:
        neigh = C[R[v] : R[v + 1]]
        color_mask[np.clip(out[neigh], 0, color_mask.shape[0] - 1)] = v
        limit = neigh.shape[0] + 2
        free = np.nonzero(color_mask[1:limit] != v)[0]
        out[v] = free[0] + 1
    return out


def square_graph(g: CSRGraph) -> CSRGraph:
    """G² — the distance-2 conflict relation as a distance-1 CSR graph.

    Host-side and O(Σ deg²): built only on the ladder's repair path (the
    engines never materialize it), where correctness outranks cost.
    """
    return g.square()


def _merged(base, colors, iterations_extra, converged, degradations):
    return dataclasses.replace(
        base,
        colors=np.asarray(colors, dtype=np.int32),
        iterations=base.iterations + iterations_extra,
        converged=converged,
        degradations=tuple(degradations),
    )


def ensure_valid_result(g: CSRGraph, result, rerun=None):
    """Walk the ladder until ``result`` validates against ``g``.

    ``g`` is the *conflict* graph — the graph itself for distance-1, its
    square for distance-2, the column-conflict graph for bipartite — so one
    ladder serves every relation.  ``rerun(rung)`` (optional) re-executes
    the failed engine run with the rung's perturbation (``"reseed"`` /
    ``"budget_extension"``) and returns a new ``ColoringResult``, or None
    when the rung does not apply; without it the ladder starts at the
    host-side repair rungs.  Always returns a result with ``converged=True``
    and valid colors; every rung taken lands in ``result.degradations``.
    """
    if result.converged and is_valid_coloring(g, result.colors):
        return result
    degr = list(result.degradations)
    best = result

    # -- rungs 1-2: engine reruns (only useful when convergence failed) ----
    if not best.converged:
        for rung in ("reseed", "budget_extension"):
            if rerun is None:
                break
            with span("guarantee_ladder", rung=rung):
                try:
                    cand = rerun(rung)
                except TypeError:
                    cand = None  # algorithm lacks the rung's knob
            if cand is None:
                degr.append({"stage": "ladder", "rung": rung,
                             "outcome": "unavailable"})
                continue
            ok = bool(cand.converged) and is_valid_coloring(g, cand.colors)
            degr.append({"stage": "ladder", "rung": rung,
                         "outcome": "resolved" if ok else "failed",
                         "iterations": int(cand.iterations)})
            if ok:
                return _merged(best, np.asarray(cand.colors),
                               int(cand.iterations), True, degr)
            if cand.converged:
                best = cand  # converged-but-invalid beats unconverged
                break

    # -- rung 3: serialize the survivors (engine tail order) ----------------
    with span("guarantee_ladder", rung="serialize_survivors"):
        residual = residual_vertices(g, best.colors)
        colors = serial_repair(g, best.colors, residual, order="tail")
        ok = is_valid_coloring(g, colors)
    degr.append({"stage": "ladder", "rung": "serialize_survivors",
                 "outcome": "resolved" if ok else "failed",
                 "residual": int(residual.size)})
    if ok:
        return _merged(best, colors, 1, True, degr)

    # -- rung 4: serial oracle (residual first, whole graph if needed) ------
    with span("guarantee_ladder", rung="serial_oracle"):
        residual = residual_vertices(g, colors)
        colors = serial_repair(g, colors, residual, order="oracle")
        if not is_valid_coloring(g, colors):
            from repro_torch.core.serial import greedy_serial

            colors = greedy_serial(g, "natural")
            residual = np.arange(g.n, dtype=np.int64)
    degr.append({"stage": "ladder", "rung": "serial_oracle",
                 "outcome": "resolved", "residual": int(residual.size)})
    if not is_valid_coloring(g, colors):
        raise RuntimeError("the serial oracle returned an invalid coloring")
    return _merged(best, colors, 1, True, degr)
