"""The batched multi-graph engine: B graphs coloured in one loop of
launches (port of ``repro.core.batch``).

``repro`` lifts the rotated super-step over a leading batch axis with
``jax.vmap``: one program over a stacked ``(B, n_max, W)`` adjacency.  The
port packs the batch into flat global ids instead, so the kernels the
single-graph engines launch serve the batch unchanged:

* vertex ``v`` of graph ``b`` is global id ``b·(n_max+1) + v``, and graph
  ``b``'s sentinel ``n_max`` is ``b·(n_max+1) + n_max`` (a uniform offset,
  so every id order inside a graph is kept: the ``id`` heuristic's
  tie-break and ``order_tail`` decide as ``repro`` does);
* one flat CSR of ``N = B·(n_max+1) − 1`` rows holds every graph's rows
  in global ids; every graph's sentinel and padding rows have degree 0
  and colour 0 and appear in no worklist;
* worklists are ``(B, n_max)``; their padding and a frozen graph's lanes
  hold the single global sentinel ``N``, the last graph's sentinel slot.

One global step is one K3 launch over all ``B·n_max`` worklist entries,
each row read where it lies in the flat CSR (``CsrRows``: its length
from the row starts, so G²'s rows under distance-2 are read whole while
the loser rule reads the original degrees), a per-graph compaction
(``compact_rows``) and one host read of the ``(B,)`` counts.  No dense
``(N, W)`` table is built: one hub graph's width would pad every row of
its bucket (the serving mix's power-law bucket is 13.8 GB as a table,
2 M column ids as a CSR).  The batched tail is one K2 launch over the
concatenated per-graph tails: graphs share no edge, so the dependency
order over the concatenation is each graph's own sequential tail.
``batched_sgr_step`` is K4 then K5, one launch each.  No tile is gathered
on the card.

Each graph sees exactly the schedule of a per-graph ``mode="fused"`` run
(it freezes at its tail threshold or stall while the others go on), and
every result field equals ``repro``'s.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import deque
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core import coloring as _engine
from repro_torch.core.coloring import (
    ColoringResult,
    DenseRows,
    _chunk_bounds,
    _dispatch_tail,
    _stalled_each,
    compact_rows,
    cr_flags,
    ff_apply,
    resolve_tail_threshold,
)
from repro_torch.core.csr import CSRGraph, DeviceCSR, csr_tile, next_pow2
from repro_torch.ingest import INDEX_MAX, packed_gather_ok
from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.obs.spans import SpanRecorder, jit_span, span
from repro_torch.obs.trace import assemble_trace, empty_trace, resolve_trace_cap

__all__ = ["GraphBatch", "SessionBatch", "batched_sgr_step",
           "batched_ragged_step", "color_batch_fused", "color_batch_sharded",
           "open_session_batch", "session_shape_class"]


def _flat_ids(sizes, n_max: int) -> tuple[int, np.ndarray]:
    """``(N, offsets)``: the global sentinel and each graph's id offset;
    raises ``CapacityError`` when a global id would pass int32."""
    B = len(sizes)
    if B * (n_max + 1) - 1 > INDEX_MAX:
        from repro_torch.errors import CapacityError

        raise CapacityError(
            f"a batch of {B} graphs of up to {n_max} vertices needs "
            f"{B * (n_max + 1)} global ids, past int32; split the batch")
    return B * (n_max + 1) - 1, np.arange(B, dtype=np.int64) * (n_max + 1)


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """B CSR graphs packed into one CSR of flat global ids (module doc).

    ``csr`` is a ``DeviceCSR`` of ``N`` vertices whose rows are every
    graph's rows (its ``deg_ext`` the row lengths: G²'s under
    ``distance2``), and ``deg`` ``(N + 1,)`` the loser rule's degrees (the
    original graph's under ``distance2``).  ``table`` is the dense ``(N,
    W)`` view, and ``adj`` and ``deg_ext`` give ``repro``'s ``(B, n_max,
    W)`` and ``(B, n_max + 1)`` layout; the engine reads none of them: K3
    and K2 read ``csr``'s rows where they lie.
    """

    deg: torch.Tensor
    csr: DeviceCSR
    sizes: tuple[int, ...]
    n_max: int
    distance2: bool = False

    @property
    def B(self) -> int:
        return len(self.sizes)

    @property
    def width(self) -> int:
        return self.csr.max_width

    @property
    def sentinel(self) -> int:
        """``N``: the global sentinel id, the last graph's sentinel slot."""
        return self.B * (self.n_max + 1) - 1

    @property
    def device(self) -> torch.device:
        return self.deg.device

    def offsets(self) -> torch.Tensor:
        """Each graph's first global id, ``(B,)`` int32 on the device."""
        return torch.arange(self.B, dtype=torch.int32,
                            device=self.device) * (self.n_max + 1)

    @property
    def deg_ext(self) -> torch.Tensor:
        """``repro``'s ``(B, n_max + 1)`` degrees (a view)."""
        return self.deg.view(self.B, self.n_max + 1)

    @functools.cached_property
    def table(self) -> torch.Tensor:
        """The dense ``(N, W)`` rows in global ids, the sentinel ``N`` past
        each row (built on first use)."""
        ids = torch.arange(self.csr.n, dtype=torch.int32, device=self.device)
        return csr_tile(self.csr.row_starts, self.csr.col_padded, ids, self.width)

    @property
    def adj(self) -> torch.Tensor:
        """``repro``'s ``(B, n_max, W)`` adjacency in per-graph ids, the
        sentinel ``n_max`` in padding (a copy)."""
        if self.B == 0:
            return self.deg.new_zeros((0, self.n_max, self.width))
        pad = torch.full((1, self.width), self.sentinel, dtype=torch.int32,
                         device=self.device)
        full = torch.cat([self.table, pad]).view(self.B, self.n_max + 1,
                                                 self.width)[:, :self.n_max]
        local = full - self.offsets()[:, None, None]
        return torch.where(full == self.sentinel, self.n_max, local)

    @classmethod
    def from_graphs(
        cls,
        graphs: Sequence[CSRGraph],
        width: int | None = None,
        distance2: bool = False,
        validate_input: str | None = None,
        device=None,
    ) -> "GraphBatch":
        """Pack ``graphs`` on ``device`` (default ``"cuda"``); ``width``
        may widen (never narrow) the rows.

        ``distance2=True`` packs each graph's square (G², built on the
        host) and keeps the original degrees for the loser rule, as
        ``repro_torch.d2``'s precomputed strategy does.
        ``validate_input="strict"|"repair"`` runs every member through
        ``repro_torch.ingest.sanitize_csr`` first.  Raises
        ``CapacityError`` when a global id or a CSR offset would pass
        int32.
        """
        device = resolve_backend(None, device)
        graphs = list(graphs)
        if validate_input is not None:
            from repro_torch.ingest import sanitize_csr

            graphs = [sanitize_csr(g, policy=validate_input)[0] for g in graphs]
        sizes = tuple(g.n for g in graphs)
        n_max = max(sizes, default=0)
        adj_graphs = [g.square() for g in graphs] if distance2 else graphs
        need = max((g.max_degree for g in adj_graphs), default=0)
        W = max(need, width or 0, 1)
        N, off = _flat_ids(sizes, n_max)
        N = max(N, 0)
        m = sum(g.m for g in adj_graphs)
        if m + W > INDEX_MAX:
            from repro_torch.errors import CapacityError

            raise CapacityError(
                f"the batch's CSR holds {m} column ids: its int32 row starts "
                "(K2's) would wrap; split the batch")
        deg = np.zeros(N + 1, np.int32)
        lens = np.zeros(N + 1, np.int32) if distance2 else deg
        cols = []
        for b, (g, ag) in enumerate(zip(graphs, adj_graphs)):
            if g.n:
                deg[off[b]: off[b] + g.n] = g.degrees
                lens[off[b]: off[b] + g.n] = ag.degrees
                cols.append(ag.col_indices.astype(np.int32) + np.int32(off[b]))
        row_starts = np.zeros(N + 1, np.int32)
        np.cumsum(lens[:N], out=row_starts[1:])
        col = np.concatenate(cols + [np.full(W, N, np.int32)])

        def up(a):
            return torch.from_numpy(a).to(device)

        deg_t = up(deg)
        csr = DeviceCSR(up(row_starts), up(col), up(lens) if distance2 else deg_t,
                        N, W)
        return cls(deg_t, csr, sizes, n_max, distance2)


# the zero-vertex graph: padding for a batch count (the coloring service);
# in flat ids it costs n_max + 1 id slots and no row
_EMPTY = CSRGraph(np.zeros(1, np.int64), np.zeros(0, np.int32))


def _flat_state(adj, deg_ext, colors_ext, wl):
    """``repro``'s ``(B, …)`` step arguments as flat global-id tensors:
    ``(table, deg, colors, wl2d, offsets, N)``."""
    B, L, W = adj.shape
    N = B * (L + 1) - 1
    off = torch.arange(B, dtype=torch.int32, device=adj.device) * (L + 1)
    pad = torch.full((B, 1, W), L, dtype=adj.dtype, device=adj.device)
    table = (torch.cat([adj, pad], 1) + off[:, None, None]).reshape(-1, W)[:N]
    wl2d = torch.where(wl < L, wl + off[:, None], N).to(torch.int32)
    return (table.contiguous(), deg_ext.reshape(-1).contiguous(),
            colors_ext.reshape(-1).clone(), wl2d, off, N)


def _local_out(colors, wl2d, counts, off, B: int, L: int):
    """Flat step outputs back in ``repro``'s per-graph ids."""
    N = B * (L + 1) - 1
    wl = torch.where(wl2d < N, wl2d - off[:, None], L)
    return colors.view(B, L + 1), wl, counts


def batched_sgr_step(adj, deg_ext, colors_ext, wl, *, heuristic: str = "degree",
                     kind: str = "bitset", coarsen_ff: int = 1,
                     coarsen_cr: int = 1):
    """The classic ``sgr_step`` over a leading batch axis: ``(B, …)`` in,
    ``(B, …)`` out, as ``repro``'s vmapped step.

    ``adj`` ``(B, n_max, W)``, ``deg_ext`` and ``colors_ext`` ``(B, n_max +
    1)``, ``wl`` ``(B, n_max)`` (sentinel ``n_max``).  FirstFit runs in
    ``coarsen_ff`` chunks of every graph's worklist at once (one K4 launch
    a chunk on the card), then ConflictResolve in ``coarsen_cr`` chunks
    (one K5 launch each), then a per-graph compaction.  Returns
    ``(colors_ext, wl, counts)``.
    """
    B, L, _ = adj.shape
    if B == 0 or L == 0:
        return (colors_ext.clone(), wl.clone(),
                torch.zeros((B,), dtype=torch.int32, device=wl.device))
    table, deg, colors, wl2d, off, N = _flat_state(adj, deg_ext, colors_ext, wl)
    for lo, hi in _chunk_bounds(L, coarsen_ff):
        colors = ff_apply(table, colors, wl2d[:, lo:hi].reshape(-1), kind,
                          deg_ext=deg)
    lose_parts = []
    for lo, hi in _chunk_bounds(L, coarsen_cr):
        ids = wl2d[:, lo:hi].reshape(-1)
        lose = cr_flags(table, deg, colors, ids, heuristic)
        idx = ids.long()
        colors[idx] = torch.where(lose, 0, colors[idx])
        lose_parts.append(lose.view(B, hi - lo))
    new_wl, counts = compact_rows(wl2d, torch.cat(lose_parts, 1), N)
    return _local_out(colors, new_wl, counts, off, B, L)


def batched_ragged_step(adj, deg_ext, colors_ext, wl, *,
                        heuristic: str = "degree", kind: str = "bitset"):
    """The rotated super-step over a leading batch axis: one K3 launch over
    every graph's worklist on the card, then a per-graph compaction.
    Arguments and results as ``batched_sgr_step``."""
    B, L, W = adj.shape
    if B == 0 or L == 0:
        return (colors_ext.clone(), wl.clone(),
                torch.zeros((B,), dtype=torch.int32, device=wl.device))
    table, deg, colors, wl2d, off, N = _flat_state(adj, deg_ext, colors_ext, wl)
    provider = DenseRows(table, None, sentinel=N)
    colors, new_wl, counts = _engine.ragged_superstep(
        provider, deg, colors, wl2d.reshape(-1), heuristic=heuristic, kind=kind,
        width=W, rows_per_group=L)
    return _local_out(colors, new_wl, counts, off, B, L)


def _run_batch(batch: GraphBatch, thrs: np.ndarray, max_iters: int, *,
               heuristic: str, kind: str, tail_enabled: bool, trace_cap: int):
    """The speculative phase: a graph freezes at its threshold or stall.

    A host loop of global steps, each one ``ragged_superstep`` over every
    live graph's worklist and one read of the ``(B,)`` counts.  With
    ``trace_cap`` it keeps the last ``trace_cap`` rows of ``[live_in,
    live_out, max_color]`` per graph per step (``live_in = -1`` for a
    frozen or finished graph), the per-graph maxima on the device until
    the end.  Returns ``(colors, wl, counts, prev, iters_b, work_b, it,
    rows)``.
    """
    B, L, N = batch.B, batch.n_max, batch.sentinel
    dev = batch.device
    sizes = np.asarray(batch.sizes, np.int64)
    off = batch.offsets()
    lane = torch.arange(L, dtype=torch.int32, device=dev)
    in_graph = lane[None, :] < torch.from_numpy(sizes).to(dev)[:, None]
    wl = torch.where(in_graph, off[:, None] + lane[None, :], N).to(torch.int32)
    # bootstrap identity: every real vertex takes colour 1 (see coloring.py)
    colors = torch.zeros((N + 1,), dtype=torch.int32, device=dev)
    colors.view(B, L + 1)[:, :L] = in_graph.to(torch.int32)
    counts = sizes.copy()
    prev = sizes.copy()
    iters_b = (sizes > 0).astype(np.int64)
    work_b = np.zeros(B, np.int64)
    active = counts > (thrs if tail_enabled else 0)
    rows = deque(maxlen=trace_cap) if trace_cap else None
    it = 1
    while active.any() and it < max_iters:
        act = torch.from_numpy(active).to(dev)
        wl_in = torch.where(act[:, None], wl, N)
        colors, wl_new, cnt_t = _engine.ragged_superstep(
            batch.csr, batch.deg, colors, wl_in.reshape(-1), heuristic=heuristic,
            kind=kind, width=batch.width, rows_per_group=L)
        cnt = cnt_t.cpu().numpy().astype(np.int64)  # the step's one host read
        new_counts = np.where(active, cnt, counts)
        new_prev = np.where(active, counts, prev)
        wl = torch.where(act[:, None], wl_new, wl)
        iters_b += active
        work_b += np.where(active, cnt, 0)
        if rows is not None:
            maxc = colors.view(B, L + 1)[:, :L].amax(dim=1)
            rows.append((np.where(active, counts, -1), np.where(active, cnt, -1),
                         maxc))
        still = active & (new_counts > 0) & (it + 1 < max_iters)
        if tail_enabled:
            still &= (new_counts > thrs) & ~_stalled_each(iters_b, new_counts,
                                                          new_prev)
        counts, prev, active = new_counts, new_prev, still
        it += 1
    return colors, wl, counts, prev, iters_b, work_b, it, rows


def _run_batch_tail(batch: GraphBatch, colors, wl, run_tail: np.ndarray,
                    stalled: np.ndarray):
    """The serial tail of every graph that runs one, as one K2 launch.

    Stalled graphs discard their speculation and serialize all their
    vertices; threshold-frozen ones their remaining worklists.  Each
    graph's tail is put in ``order_tail`` order on its own row, and the
    rows' real entries, concatenated graph by graph, make K2's worklist.
    """
    B, L, N = batch.B, batch.n_max, batch.sentinel
    dev = batch.device
    off = batch.offsets()
    lane = torch.arange(L, dtype=torch.int32, device=dev)
    sizes = torch.tensor(batch.sizes, dtype=torch.int32, device=dev)
    full_wl = torch.where(lane[None, :] < sizes[:, None],
                          off[:, None] + lane[None, :], N)
    wl = torch.where(torch.from_numpy(stalled).to(dev)[:, None], full_wl, wl)
    wl = torch.where(torch.from_numpy(run_tail).to(dev)[:, None], wl, N)
    ids = torch.sort(wl, dim=1, stable=True).values  # id-ascending, N last
    key = torch.where(ids < N, -batch.deg[ids.long()], torch.iinfo(torch.int32).max)
    ordered = torch.gather(ids, 1, torch.argsort(key, dim=1, stable=True))
    tail = ordered[ordered < N].to(torch.int32)
    return _dispatch_tail(batch.csr, colors, tail, width=batch.width)


def _width_key(g: CSRGraph, distance2: bool) -> int:
    return next_pow2(max(g.two_hop_degree_bound() if distance2
                         else g.max_degree, 1))


def color_batch_fused(
    graphs: "Iterable[CSRGraph] | GraphBatch",
    *,
    heuristic: str = "degree",
    firstfit: str = "bitset",
    max_iters: int | None = None,
    distance2: bool = False,
    tail_serial="auto",
    backend: str | None = None,
    trace=False,
    device=None,
) -> list[ColoringResult]:
    """Colour B graphs in one batched loop; one result each.

    Graphs (not a pre-packed ``GraphBatch``) are grouped into sub-batches
    by the pow2 of their row width, so one skewed graph does not pad every
    other's rows; results do not depend on the grouping.  The loop runs
    until every graph converges, freezes at its tail threshold or stalls
    (a frozen graph's lanes turn sentinel, and its ``iterations`` count
    only its live steps); one tail launch then finishes every frozen
    worklist.  ``padded_work`` charges every graph ``n_max × W`` cells per
    global step, the capacity cost of batching; ``work_items`` counts its
    live worklist entries.

    ``distance2=True`` packs each graph's square, as ``repro_torch.d2``'s
    precomputed strategy colours it.  ``trace=True`` attaches a per-graph
    ``RunTrace`` from one shared ring: a graph's rows cover the global
    steps it was live in.  ``device`` defaults to ``"cuda"``; a
    ``GraphBatch`` runs where it lies.  Every field equals ``repro``'s.
    """
    if isinstance(graphs, GraphBatch):
        if graphs.distance2 != distance2:
            raise ValueError(
                f"GraphBatch was packed with distance2={graphs.distance2} but "
                f"color_batch_fused was called with distance2={distance2}; "
                f"re-pack with GraphBatch.from_graphs(graphs, distance2=...)"
            )
        batch = graphs
        resolve_backend(backend, batch.device)
    else:
        device = resolve_backend(backend, device)
        graphs = list(graphs)
        keys = [_width_key(g, distance2) for g in graphs]
        if len(set(keys)) > 1:
            by_key: dict[int, list[int]] = {}
            for i, k in enumerate(keys):
                by_key.setdefault(k, []).append(i)
            results: list = [None] * len(graphs)
            for idxs in by_key.values():
                sub = color_batch_fused(
                    GraphBatch.from_graphs([graphs[i] for i in idxs],
                                           distance2=distance2, device=device),
                    heuristic=heuristic, firstfit=firstfit, max_iters=max_iters,
                    distance2=distance2, tail_serial=tail_serial,
                    backend=backend, trace=trace)
                for i, r in zip(idxs, sub):
                    results[i] = r
            return results
        batch = GraphBatch.from_graphs(graphs, distance2=distance2, device=device)
    algo = "batched_fused_sgr_d2" if distance2 else "batched_fused_sgr"
    if batch.B == 0:
        return []
    if batch.n_max == 0:
        out = [ColoringResult(np.zeros(0, np.int32), 0, 0, 0, True, algo)
               for _ in range(batch.B)]
        if trace:
            for r in out:
                r.trace = empty_trace(algo)
        return out
    max_iters = max_iters or batch.n_max + 1
    trace_cap = resolve_trace_cap(trace, max_iters)

    def run():
        tail_enabled, _ = resolve_tail_threshold(tail_serial, batch.n_max)
        thrs = np.asarray(
            [resolve_tail_threshold(tail_serial, n)[1] for n in batch.sizes],
            dtype=np.int64)
        pack = packed_gather_ok(batch.width)
        loop_key = ("batch", batch.B, batch.n_max, batch.width, heuristic,
                    firstfit, batch.device.type, tail_enabled, pack, max_iters,
                    trace_cap)
        with span("superstep_loop", mode="batched", B=batch.B), \
                jit_span("batched_loop", loop_key):
            colors, wl, counts, prev, iters_b, work_b, it, ring = _run_batch(
                batch, thrs, max_iters, heuristic=heuristic, kind=firstfit,
                tail_enabled=tail_enabled, trace_cap=trace_cap)
        steps = it - 1
        sizes = np.asarray(batch.sizes, dtype=np.int64)
        run_tail = tail_enabled & (counts > 0) & (iters_b < max_iters)
        stalled = run_tail & (counts > thrs) & _stalled_each(iters_b, counts, prev)
        counts_pre = counts.copy()
        if run_tail.any():
            with span("serial_tail", live=int(counts[run_tail].sum())):
                colors = _run_batch_tail(batch, colors, wl, run_tail, stalled)
            iters_b += run_tail
            work_b += np.where(stalled, sizes, np.where(run_tail, counts, 0))
            counts = np.where(run_tail, 0, counts)
        L = batch.n_max
        host = colors.view(batch.B, L + 1)[:, :L].cpu().numpy()
        ordered = []
        if ring:
            maxc = torch.stack([r[2] for r in ring]).cpu().numpy()
            ordered = [np.stack([r[0], r[1], m], -1) for r, m in zip(ring, maxc)]
        cells = L * batch.width
        out = []
        for b, n in enumerate(batch.sizes):
            # the bootstrap step processes all n vertices; work_b holds the
            # live counts of every later step (as the fused driver's)
            res = ColoringResult(
                host[b, :n].copy(), int(iters_b[b]),
                int(work_b[b]) + n if n else 0,
                steps * cells + (cells if run_tail[b] else 0),
                converged=int(counts[b]) == 0, algorithm=algo)
            if trace_cap:
                # a graph's live steps are a prefix of the global steps, so
                # its kept rows stay contiguous; drop the boot row whenever
                # the ring overwrote any of its early live steps
                spec = [(int(r[b, 0]), int(r[b, 1]), int(r[b, 2]))
                        for r in ordered if int(r[b, 0]) >= 0]
                k_b = int(iters_b[b]) - (1 if n else 0) - int(run_tail[b])
                rows_b = ([(n, 0, n, 1, 0, 0, 0, 0)]
                          if n and len(spec) == k_b else [])
                rows_b += [(li, li - lo, lo, mc, cells, 0, 0, 0)
                           for li, lo, mc in spec]
                if run_tail[b]:
                    rows_b.append((int(counts_pre[b]), int(counts_pre[b]), 0,
                                   int(host[b, :n].max(initial=0)), cells, 1,
                                   0, 0))
                res.trace = assemble_trace(rows_b, int(iters_b[b]), trace_cap,
                                           algo)
            out.append(res)
        return out

    if not trace:
        return run()
    with SpanRecorder() as rec:
        out = run()
    for r in out:
        if r.trace is not None:
            r.trace.spans = rec.events
    return out


def session_shape_class(session) -> tuple:
    """The pow2 shape class a session's recolor buckets under:
    ``(pow2 n, pow2 max_degree)``, the two quantities its engine keys
    derive from (``ColoringSession.metrics``).  Same-class sessions fed
    similar frontiers present repeating keys."""
    g = session.delta.graph()
    return (next_pow2(max(session.n, 1)), next_pow2(max(g.max_degree, 1)))


class SessionBatch:
    """Per-graph ``ColoringSession``s for B-graph churn.

    B graphs are held open as sessions; mutations arrive per graph
    (``apply_delta(b, ...)``), and one ``recolor()`` sweep repairs exactly
    the sessions whose graphs are dirty.  Clean graphs return their
    committed colouring as a zero-work no-op and launch nothing, so a
    sweep's work follows the churned frontier, not ``Σ n_i``.  Sessions are
    independent, so each graph's colours equal those of a standalone
    session fed the same deltas.  A sweep runs the dirty sessions grouped by
    ``session_shape_class``; results come back in graph order.  Takes a
    ``ColorOptions`` (``options=``) or the loose session kwargs, as
    ``open_session``.
    """

    def __init__(self, graphs: "Iterable[CSRGraph]", *, options=None, **opts):
        from repro_torch.dynamic import ColoringSession

        if options is not None or opts:
            from repro_torch.options import ColorOptions

            opts = ColorOptions.normalize(options, **opts).session_kwargs()
        self.sessions = [ColoringSession(g, **opts) for g in graphs]

    @property
    def B(self) -> int:
        return len(self.sessions)

    def apply_delta(self, b: int, **delta) -> np.ndarray:
        """Mutate graph ``b``; returns the ids it dirtied."""
        return self.sessions[b].apply_delta(**delta)

    def dirty(self) -> list[int]:
        """Indices of graphs with a pending (non-empty) frontier."""
        return [b for b, s in enumerate(self.sessions) if s.frontier().size]

    def buckets(self) -> "dict[tuple, list[int]]":
        """Dirty graph indices grouped by shape class (dispatch order)."""
        out: dict[tuple, list[int]] = {}
        for b, s in enumerate(self.sessions):
            if s.pending_dirty:
                out.setdefault(session_shape_class(s), []).append(b)
        return out

    def recolor(self, *, full: bool = False) -> list[ColoringResult]:
        """Repair every dirty session; one (possibly no-op) result a graph."""
        results: list = [None] * self.B
        for _, idxs in sorted(self.buckets().items()):
            for b in idxs:
                results[b] = self.sessions[b].recolor(full=full)
        for b, s in enumerate(self.sessions):
            if results[b] is None:
                results[b] = s.recolor(full=full)
        return results

    def results(self) -> list[ColoringResult]:
        return [s.result for s in self.sessions]

    def validate(self) -> bool:
        return all(s.validate() for s in self.sessions)

    def metrics(self) -> dict:
        """Engine-key accounting summed over the sessions and per bucket."""
        per_bucket: dict = {}
        hits = misses = 0
        for s in self.sessions:
            m = s.metrics()
            agg = per_bucket.setdefault(
                repr(session_shape_class(s)),
                {"sessions": 0, "engine_cache_hits": 0, "engine_cache_misses": 0})
            agg["sessions"] += 1
            agg["engine_cache_hits"] += m["engine_cache_hits"]
            agg["engine_cache_misses"] += m["engine_cache_misses"]
            hits += m["engine_cache_hits"]
            misses += m["engine_cache_misses"]
        return {"engine_cache_hits": hits, "engine_cache_misses": misses,
                "buckets": per_bucket}


def open_session_batch(graphs: "Iterable[CSRGraph]", *, options=None,
                       **opts) -> SessionBatch:
    """Open per-graph streaming sessions over ``graphs``."""
    return SessionBatch(graphs, options=options, **opts)


def color_batch_sharded(
    graphs: "Iterable[CSRGraph]",
    *,
    devices=None,
    heuristic: str = "degree",
    firstfit: str = "bitset",
    max_iters: int | None = None,
    distance2: bool = False,
    tail_serial="auto",
    backend: str | None = None,
    trace=False,
    device=None,
) -> list[ColoringResult]:
    """Place a multi-graph batch across devices; ``repro``'s two regimes,
    each field for field ``repro``'s at the same device count:

    * ``B >= ndev`` — shard per graph: the width-bucketed sub-batches of
      ``color_batch_fused``, each padded with empty graphs to a multiple of
      the device count as ``repro`` pads its batch axis (so ``n_max`` and
      ``W`` are ``repro``'s).  Graphs share nothing, so placement is a pure
      performance policy: the port packs each sub-batch whole on one
      device, the sub-batches in turn on ``devices[0]``, ``devices[1]``,
      …, where ``repro`` splits one sub-batch's batch axis over its mesh.
    * ``B < ndev`` — partition within graph: too few graphs to fill the
      devices, so each runs the sharded engine (the halo exchange) over all
      of them in turn.

    ``devices=None`` means every visible card (``[cpu]`` under
    ``device="cpu"``); one device, or no graph, runs ``color_batch_fused``.
    """
    from repro_torch.core.distributed import resolve_devices

    devices = resolve_devices(devices, device, backend)
    ndev = len(devices)
    graphs = list(graphs)
    B = len(graphs)
    opts = dict(heuristic=heuristic, firstfit=firstfit,
                max_iters=max_iters, tail_serial=tail_serial, trace=trace)
    if ndev <= 1 or B == 0:
        return color_batch_fused(graphs, distance2=distance2, backend=backend,
                                 device=devices[0], **opts)
    if B < ndev:
        if distance2:
            from repro_torch.d2.coloring import color_distance2

            return [color_distance2(g, engine="sharded", devices=devices,
                                    backend=backend, **opts) for g in graphs]
        return [_engine.color_data_driven(g, engine="sharded", devices=devices,
                                          backend=backend, **opts)
                for g in graphs]
    by_key: dict[int, list[int]] = {}
    for i, g in enumerate(graphs):
        by_key.setdefault(_width_key(g, distance2), []).append(i)
    results: list = [None] * B
    for j, idxs in enumerate(by_key.values()):
        sub = [graphs[i] for i in idxs]
        sub += [_EMPTY] * ((-len(sub)) % ndev)  # no-op graphs to a device multiple
        batch = GraphBatch.from_graphs(sub, distance2=distance2,
                                       device=devices[j % ndev])
        res = color_batch_fused(batch, distance2=distance2, backend=backend,
                                **opts)
        for i, r in zip(idxs, res):
            results[i] = r
    return results
