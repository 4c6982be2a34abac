"""Distance-2 speculative-greedy coloring on the SGR super-step (port of
``repro.d2.coloring``).

A distance-2 coloring gives distinct colors to any two vertices within
distance ≤ 2 — a distance-1 coloring of the square graph G².  Two
strategies share one result:

* ``precomputed`` — build G² on the host (``CSRGraph.square``) and run the
  distance-1 ragged engine over its ``DeviceCSR``: K1 per degree class and
  K2 for the tail on the card.
* ``onthefly`` — when the G² view would pass the memory budget, compose
  two sentinel-padded gathers per super-step instead (``TwoHopRows``):
  K3 over the composed ``(w, W1·W2 + W1)`` rows, read by id from the two
  tables on the card (``TwoHopRows.lane_source``), and the tail as K2 over
  the composed rows laid out segment by segment
  (``core.coloring._composed_tail``).

Both order conflict losers by the ORIGINAL graph's degree (ties by id), and
the rotated super-step is insensitive to duplicate and self lanes, so the
two strategies give the same colors.  ``d2_sgr_step`` is the classic
two-phase two-hop step, whose FirstFit is K6 (``kernels/d2``) when the hop-1
neighbours belong to the neighbourhood.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import register
from repro_torch.core.coloring import (
    ColoringResult,
    _chunk_bounds,
    _dense_adjacency,
    _graph_device_cache,
    _resolve_classes,
    compact,
    cr_flags,
    ff_apply,
    gather_rows,
    resolve_tail_threshold,
    run_ragged_engine,
    traced_run,
)
from repro_torch.core.csr import CSRGraph, DeviceCSR, PartitionedCSR
from repro_torch.ingest import packed_gather_ok
from repro_torch.kernels.cuda import TwoHopLanes
from repro_torch.kernels.d2.kernel import d2_firstfit
from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.kernels.superstep.kernel import two_hop_tile
from repro_torch.obs.spans import span
from repro_torch.obs.trace import empty_trace

__all__ = ["color_distance2", "d2_sgr_step", "TwoHopRows", "DEFAULT_D2_BUDGET"]

# bytes the precomputed strategy may spend on the (n, W2) square view plus
# the transient two-hop pair expansion; past this, auto composes on the fly
# (a strategy policy, as in repro)
DEFAULT_D2_BUDGET = 256 * 2**20


class TwoHopRows:
    """Composed two-hop row provider: ``ids → adj_a → adj_b``.

    For distance-2 on one graph ``adj_a is adj_b`` and hop-1 neighbours are
    part of the neighbourhood (``include_first_hop=True``); for bipartite
    partial coloring ``adj_a`` is cols→rows, ``adj_b`` rows→cols, and only
    hop-2 (column-side) ids carry colors.  Rows may hold duplicate and self
    lanes.  ``start`` and ``n_colored`` serve a ``PartitionedCSR`` shard's
    slice of ``adj_a`` (worklist ids stay global, ``id - start`` picks the
    local row, ``adj_b`` is the whole second hop), so a shard's composed
    rows are the unsharded ones: the sharded engine's provider.

    On the card K3 reads each hop's rows up to their degrees, read off the
    tables once here (a row's lanes up to its last non-sentinel one:
    ``lane_source``); ``rows`` gathers the full composed tile.
    """

    def __init__(self, adj_a: torch.Tensor, adj_b: torch.Tensor,
                 include_first_hop: bool = True, start: int = 0,
                 n_colored: int | None = None):
        self.adj_a = adj_a
        self.adj_b = adj_b
        self.include_first_hop = bool(include_first_hop)
        self.start = int(start)
        self.n_colored = n_colored
        self.deg_a = _row_degrees(adj_a, int(adj_b.shape[0]))
        self.deg_b = _row_degrees(adj_b, self.n)

    @property
    def device(self) -> torch.device:
        return self.adj_a.device

    @property
    def n(self) -> int:
        """The coloured side's vertex count (global)."""
        return (int(self.adj_a.shape[0]) if self.n_colored is None
                else int(self.n_colored))

    @property
    def width(self) -> int:
        w1, w2 = int(self.adj_a.shape[1]), int(self.adj_b.shape[1])
        return w1 * w2 + (w1 if self.include_first_hop else 0)

    def lane_source(self, width: int | None = None):
        """``(source, W)``: the composed rows by id (``TwoHopLanes``) and
        their width; ``width`` requests are ignored."""
        return TwoHopLanes(self.adj_a, self.adj_b, self.deg_a, self.deg_b,
                           self.include_first_hop, self.start, self.n), self.width

    def rows(self, ids: torch.Tensor, width: int | None = None) -> torch.Tensor:
        """The ``(w, width)`` composed tile; ``width`` requests are ignored."""
        return two_hop_tile(self.adj_a, self.adj_b, self.include_first_hop,
                            self.start, self.n, ids)

    def row1(self, v) -> torch.Tensor:
        return self.rows(torch.tensor([int(v)], dtype=torch.int32,
                                      device=self.device))[0]


def _row_degrees(table: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Each row's lanes up to its last one that is not ``sentinel``: every
    lane past it holds the sentinel, so reading that many changes nothing."""
    lane = torch.arange(1, table.shape[1] + 1, dtype=torch.int32,
                        device=table.device)
    return torch.where(table != sentinel, lane, 0).amax(dim=1).to(torch.int32)


# --------------------------------------------------------------------------
# the classic two-hop super-step
# --------------------------------------------------------------------------

def d2_sgr_step(
    adj_a,
    adj_b,
    deg_ext,
    colors_ext,
    wl,
    *,
    heuristic: str = "degree",
    kind: str = "bitset",
    include_first_hop: bool = True,
    coarsen: int = 1,
):
    """One classic D2 super-step: FirstFit → ConflictResolve → compaction.

    The two-phase formulation of ``repro.d2.d2_sgr_step``.  FirstFit is K6
    over the hop-1 and hop-2 colour tiles when ``include_first_hop`` (its
    plain version on the CPU: ``repro``'s ``use_kernel=True`` branch, whose
    colors equal its FirstFit ``kind`` branch), else ``ff_apply`` over the
    hop-2 id rows (K4 on the card, reading their colours in place).
    ConflictResolve is ``cr_flags`` over the composed id rows (K5 on the
    card, reading colours and degrees in place).  ``coarsen`` chunks the
    worklist; later chunks see earlier chunks' writes.  Updates ``colors_ext`` in place; returns
    ``(colors_ext, new_wl, new_count)``.
    """
    n = colors_ext.shape[0] - 1  # colored-side vertex count (sentinel slot)
    cap = wl.shape[0]

    def rows_for(ids):
        rows1 = gather_rows(adj_a, ids, sentinel=adj_b.shape[0])
        rows2 = gather_rows(adj_b, rows1.reshape(-1), sentinel=n)
        rows2 = rows2.reshape(ids.shape[0], -1)
        if include_first_hop:
            return torch.cat([rows1, rows2], dim=1), rows1, rows2
        return rows2, rows1, rows2

    # the gathered rows do not depend on the colors, so an unchunked step
    # shares them between both phases
    shared = rows_for(wl) if coarsen == 1 else None

    # ---- FirstFit phase (coarsened: later chunks see earlier chunk colors) --
    for lo, hi in _chunk_bounds(cap, coarsen):
        ids = wl[lo:hi]
        rows, rows1, rows2 = shared if shared is not None else rows_for(ids)
        if include_first_hop:
            c = d2_firstfit(colors_ext[rows1.long()], colors_ext[rows2.long()])
            colors_ext[ids.long()] = torch.where(ids < n, c, 0).to(torch.int32)
        else:
            colors_ext = ff_apply(adj_a, colors_ext, ids, kind, rows=rows)

    # ---- ConflictResolve + color clearing --------------------------------
    lose_parts = []
    for lo, hi in _chunk_bounds(cap, coarsen):
        ids = wl[lo:hi]
        rows = shared[0] if shared is not None else rows_for(ids)[0]
        lose = cr_flags(adj_a, deg_ext, colors_ext, ids, heuristic, rows=rows)
        idx = ids.long()
        colors_ext[idx] = torch.where(lose, 0, colors_ext[idx])
        lose_parts.append(lose)
    lose = torch.cat(lose_parts) if len(lose_parts) > 1 else lose_parts[0]

    # ---- worklist compaction ---------------------------------------------
    new_wl, new_count = compact(wl, lose, sentinel=n)
    return colors_ext, new_wl, new_count


# --------------------------------------------------------------------------
# engine plumbing (shared with bipartite.py)
# --------------------------------------------------------------------------

def _d2_classes(n: int, degrees_for_tiling, tiling, full_width: int):
    """``(classes, tile_widths, acc_widths, tail_width)`` of a D2 run:
    degree-tiled classes over ``degrees_for_tiling`` (the gathered side's
    degrees, e.g. G²'s), or one class at the composed rows' ``full_width``
    when it is None."""
    if degrees_for_tiling is None:
        return ([np.arange(n, dtype=np.int32)], [None], [int(full_width)],
                int(full_width))
    classes, tile_widths = _resolve_classes(degrees_for_tiling, (), tiling)
    acc_widths = tile_widths
    tail_width = max(int(np.asarray(degrees_for_tiling).max(initial=0)), 1)
    if len(classes) == 1:
        tile_widths = [None]  # provider serves its natural full width
    return classes, tile_widths, acc_widths, tail_width


def run_d2_engine(
    *, n, provider, deg_ext, tiling, degrees_for_tiling, mode, heuristic,
    kind, coarsen, tail_serial, max_iters, algorithm, deg_bound: int = 2**15,
    trace=False,
) -> ColoringResult:
    """Drive the rotated engine over a D2 row provider (shared with
    bipartite).

    ``degrees_for_tiling`` (the gathered side's degrees, e.g. G²'s) sizes
    the degree-tiled dispatch for a ``DeviceCSR`` provider; composed
    providers gather their full two-hop width and pass ``None``.
    """
    # a DeviceCSR provider has no width: it is tiled by degrees_for_tiling
    classes, tile_widths, acc_widths, tail_width = _d2_classes(
        n, degrees_for_tiling, tiling, getattr(provider, "width", None))
    tail_enabled, thr = resolve_tail_threshold(tail_serial, n)
    return run_ragged_engine(
        n=n, provider=provider, deg_ext=deg_ext, classes=classes,
        tile_widths=tile_widths, acc_widths=acc_widths, tail_width=tail_width,
        mode=mode, heuristic=heuristic, kind=kind, coarsen=coarsen,
        tail_enabled=tail_enabled, tail_threshold=thr, max_iters=max_iters,
        algorithm=algorithm,
        # colors <= tail_width + 1; the loser rule's degrees are bounded by
        # deg_bound (the caller's original or column degrees)
        pack_degrees=packed_gather_ok(max(tail_width, deg_bound)),
        trace=trace,
    )


def resolve_strategy(strategy: str, est_bytes: int, budget: int) -> str:
    if strategy == "auto":
        return "precomputed" if est_bytes <= budget else "onthefly"
    if strategy not in ("precomputed", "onthefly"):
        raise ValueError(
            f"unknown strategy {strategy!r}; options: auto, precomputed, onthefly"
        )
    return strategy


def resolve_d2_strategy(g: CSRGraph, strategy: str, budget: int) -> str:
    """Footprint-gated strategy pick: the estimate is the (n, W2) square
    view plus the transient two-hop pair expansion."""
    w2_bound = max(g.two_hop_degree_bound(), 1)
    pair_bound = g.m + int((g.degrees.astype(np.int64) ** 2).sum())
    return resolve_strategy(strategy, 4 * g.n * w2_bound + 16 * pair_bound,
                            budget)


def resolve_d2_engine(engine: str, coarsen: int, devices, device, backend):
    """``(device, devs)`` for ``color_distance2`` and ``color_bipartite``:
    ``devs`` is the shard devices under ``engine="sharded"`` (validated
    before any one-device fallback, so the options taken never depend on
    how many devices are present), else None."""
    if engine == "sharded":
        from repro_torch.core.distributed import resolve_devices

        if coarsen != 1:
            raise ValueError(
                "engine='sharded' runs the unchunked (coarsen=1) schedule")
        devs = resolve_devices(devices, device, backend)
        return devs[0], devs
    if engine != "ragged":
        raise ValueError(
            f"unknown engine {engine!r}; options: ragged, sharded")
    return resolve_backend(backend, device), None


def run_sharded_d2_engine(
    *, n, devices, plan, provider_kind, prov_np, deg_ext_np,
    degrees_for_tiling, tiling, heuristic, kind, tail_serial, max_iters,
    algorithm, tail_provider, include_first_hop=True, deg_bound: int = 2**15,
    full_width: int | None = None, trace=False,
) -> ColoringResult:
    """Drive the sharded engine over a distance-2 partition plan.

    The sharded sibling of ``run_d2_engine`` (the same class and width
    resolution, the same pack gate), shared by distance-2 and bipartite:
    ``provider_kind`` is ``"csr"`` for the precomputed strategies (shards
    of G² or of the conflict graph, K3 over ``ShardRows`` on the card) and
    ``"twohop"`` for composition on the fly (``TwoHopRows`` over the plan's
    first-hop slices, K3 over ``TwoHopLanes`` with ``start``).
    """
    from repro_torch.core.distributed import run_sharded_engine

    classes, tile_widths, acc_widths, tail_width = _d2_classes(
        n, degrees_for_tiling, tiling, full_width)
    tail_enabled, thr = resolve_tail_threshold(tail_serial, n)
    return run_sharded_engine(
        plan=plan, devices=devices, provider_kind=provider_kind,
        prov_np=prov_np, deg_ext_np=deg_ext_np, classes=classes,
        tile_widths=tile_widths, acc_widths=acc_widths,
        tail_width=tail_width, tail_provider=tail_provider,
        heuristic=heuristic, kind=kind, tail_enabled=tail_enabled,
        tail_threshold=thr, max_iters=max_iters, algorithm=algorithm,
        pack_degrees=packed_gather_ok(max(tail_width, deg_bound)),
        include_first_hop=include_first_hop, trace=trace,
    )


def degrees_ext(degrees: np.ndarray, device: torch.device) -> torch.Tensor:
    """``(n + 1,)`` int32 degrees with 0 in the sentinel slot, on ``device``."""
    return torch.from_numpy(np.concatenate(
        [degrees, np.zeros(1, np.int32)]).astype(np.int32)).to(device)


@register("distance2")
def color_distance2(
    g: CSRGraph,
    *,
    heuristic: str = "degree",
    firstfit: str = "bitset",
    mode: str = "workefficient",
    strategy: str = "auto",
    memory_budget: int = DEFAULT_D2_BUDGET,
    coarsen: int = 1,
    max_iters: int | None = None,
    tiling="auto",
    tail_serial="auto",
    engine: str = "ragged",
    devices=None,
    backend: str | None = None,
    trace=False,
    device=None,
) -> ColoringResult:
    """Distance-2 coloring of ``g`` with the rotated SGR super-step.

    ``strategy="auto"`` precomputes the G² CSR when its estimated footprint
    fits ``memory_budget``, else composes the two hops on the fly per
    super-step.  ``coarsen`` chunks the worklist.  ``device`` defaults to
    ``"cuda"``; ``device="cpu"`` runs the kernels' plain versions.
    ``trace`` attaches a ``RunTrace`` with the phase spans.  Results equal
    ``repro.d2.color_distance2``'s field for field.

    ``engine="sharded"`` runs the same schedule over one shard per entry of
    ``devices`` (``core/distributed.py``): the precomputed strategy shards
    G²'s CSR along a ``PartitionedCSR`` plan, the on-the-fly strategy runs
    ``TwoHopRows`` over the plan's first-hop slices (two-hop reach decides
    the halo sets).  With one device it runs ``ragged`` with
    ``mode="fused"``.
    """
    device, devs = resolve_d2_engine(engine, coarsen, devices, device, backend)
    n = g.n
    if devs is not None:
        if len(devs) > 1 and n > 0:
            return _color_distance2_sharded(
                g, devs, heuristic=heuristic, firstfit=firstfit,
                strategy=strategy, memory_budget=memory_budget,
                tiling=tiling, tail_serial=tail_serial, max_iters=max_iters,
                trace=trace)
        # one device: the ragged fused realization, so colours and
        # accounting do not depend on the device count
        mode = "fused"
    if n == 0:
        result = ColoringResult(np.zeros(0, np.int32), 0, 0, 0, True,
                                algorithm="distance2_sgr")
        if trace:
            result.trace = empty_trace("distance2_sgr")
        return result
    max_iters = max_iters or n + 1

    def run():
        deg_ext = degrees_ext(g.degrees, device)
        if resolve_d2_strategy(g, strategy, memory_budget) == "precomputed":
            with span("csr_build", engine="d2_precomputed"):
                g2 = g.square()
                provider = DeviceCSR.from_csr(g2, device)
            degrees_for_tiling = g2.degrees
        else:
            with span("csr_build", engine="d2_onthefly"):
                adj = _dense_adjacency(g, device)
                provider = TwoHopRows(adj, adj, include_first_hop=True)
            degrees_for_tiling = None
        return run_d2_engine(
            n=n, provider=provider, deg_ext=deg_ext, tiling=tiling,
            degrees_for_tiling=degrees_for_tiling, mode=mode,
            heuristic=heuristic, kind=firstfit, coarsen=coarsen,
            tail_serial=tail_serial, max_iters=max_iters,
            algorithm="distance2_sgr", deg_bound=g.max_degree, trace=trace,
        )

    return traced_run(run, trace)


def _stacked_plan(plan: PartitionedCSR, first_hop: np.ndarray, fill: int):
    """``(plan, its shards' slices of the first hop)``."""
    return plan, plan.stack_rows(first_hop, fill=fill)


def _color_distance2_sharded(
    g: CSRGraph, devices, *, heuristic, firstfit, strategy, memory_budget,
    tiling, tail_serial, max_iters, trace=False,
) -> ColoringResult:
    """The multi-shard realization of ``color_distance2``."""
    n = g.n
    ndev = len(devices)
    max_iters = max_iters or n + 1
    strategy = resolve_d2_strategy(g, strategy, memory_budget)

    def run():
        deg_ext_np = np.concatenate(
            [g.degrees, np.zeros(1, np.int32)]).astype(np.int32)
        if strategy == "precomputed":
            # G² reduces distance-2 to distance-1, so the plan partitions G²
            # directly: its 1-hop boundary is the two-hop reader set of g
            with span("csr_build", engine="d2_precomputed"):
                g2 = g.square()
            with span("partition_plan", ndev=ndev):
                plan = PartitionedCSR.from_graph(g2, ndev)
                prov_np = plan.stack_shards(g2)
            return run_sharded_d2_engine(
                n=n, devices=devices, plan=plan, provider_kind="csr",
                prov_np=prov_np, deg_ext_np=deg_ext_np,
                degrees_for_tiling=g2.degrees, tiling=tiling,
                heuristic=heuristic, kind=firstfit, tail_serial=tail_serial,
                max_iters=max_iters,
                algorithm=f"distance2_sgr_sharded_{ndev}dev",
                tail_provider=DeviceCSR.from_csr(g2, devices[0]),
                deg_bound=g.max_degree, trace=trace,
            )
        with span("csr_build", engine="d2_onthefly"):
            adj_np = _graph_device_cache(g, "dense_np", None, g.padded_adjacency)
            adj = _dense_adjacency(g, devices[0])
        with span("partition_plan", ndev=ndev):
            # the plan is a function of the frozen graph: built once per
            # shard count, where repro rebuilds it every call
            plan, rows_np = _graph_device_cache(
                g, f"d2plan{ndev}", None,
                lambda: _stacked_plan(PartitionedCSR.from_graph(
                    g, ndev, boundary_mode="two_hop"), adj_np, n))
        full_width = adj_np.shape[1] * adj_np.shape[1] + adj_np.shape[1]
        return run_sharded_d2_engine(
            n=n, devices=devices, plan=plan, provider_kind="twohop",
            prov_np=(rows_np, adj_np),
            deg_ext_np=deg_ext_np, degrees_for_tiling=None, tiling=tiling,
            heuristic=heuristic, kind=firstfit, tail_serial=tail_serial,
            max_iters=max_iters, algorithm=f"distance2_sgr_sharded_{ndev}dev",
            tail_provider=TwoHopRows(adj, adj, include_first_hop=True),
            include_first_hop=True, deg_bound=g.max_degree,
            full_width=full_width, trace=trace,
        )

    return traced_run(run, trace)
