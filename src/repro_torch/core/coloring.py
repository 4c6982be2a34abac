"""Data-driven speculative-greedy coloring (paper Alg. 7) in PyTorch.

The port of ``repro.core.coloring``: three engines over one schedule, in
two modes.

* ``ragged`` (default) — the rotated super-step over CSR storage, with
  degree-tiled worklist classes and the adaptive serial tail
  (``run_ragged_engine``).  A class sub-step is one K1 launch
  (``kernels/superstep/csr_kernel.superstep_csr``) when the worklist is
  unchunked and degrees fit the packed gather word; otherwise the engine
  gathers ``(w, W)`` tiles and launches K3 (``kernels/superstep/kernel``).
  The tail is one K2 launch (``serial_tail_csr``), or one per segment over
  composed two-hop rows (``repro_torch.d2``).  The tail's function is
  sequential greedy in ``order_tail`` order; K2 computes it with every
  entry at once, each waiting only for its earlier neighbours, so it is
  bounded by the depth of that order's dependencies, not by the tail's
  length.
* ``padded`` — the same schedule over the dense ``(n, Δmax)`` adjacency
  table (``DenseRows``): K3 for every class, K2 for the tail.
* ``classic`` — the two-phase super-step (``sgr_step``): FirstFit (K4,
  ``kernels/firstfit``), then ConflictResolve (K5, ``kernels/conflict``)
  and colour clearing, then compaction.

``mode="workefficient"`` re-slices each class's worklist to the next power
of two of its live count every step; ``mode="fused"`` dispatches full
capacity every step (``repro``'s single device program, here a host loop),
which changes only the work accounting.  On CPU tensors the kernel wrappers
take their plain versions, and ``ff_apply``/``cr_flags``/the K3 branch take
``repro``'s pure formulations where ``repro`` does with no kernel backend.

Tensors live on one explicit device.  ``repro``'s arrays are immutable;
here ``colors_ext`` is updated in place where the reference builds a new
array.  That is safe where the reference's reads and writes meet in the
same order: a class sub-step's first chunk reads the iteration-start
snapshot (cloned when several classes share a step), later chunks read the
accumulating state, and every gather is taken before the write it feeds.

``trace=`` records one telemetry row per super-step, ``repro``'s rows
field for field (``repro_torch.obs``), in a ``HostRing``.  The loops here
are host loops that already read each step's live counts; the only other
field, the step's maximum colour, is kept as a 0-d tensor on the device
and read with the rest at the end, so a traced step takes no host sync
beyond the untraced one.  ``trace=False`` runs the untraced code
unchanged.

``engine="sharded"`` (several shards, one controller) is
``core/distributed.py``.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial

import numpy as np
import torch

from repro_torch.api import register
from repro_torch.core.csr import (
    CSRGraph,
    DeviceCSR,
    auto_tile_thresholds,
    gather_rows,
    next_pow2,
)
from repro_torch.core.firstfit import FF_FUNCS
from repro_torch.core.heuristics import (
    HEURISTICS,
    conflict_lose_flags,
    conflict_lose_lanes,
)
from repro_torch.ingest import PACKED_GATHER_MAX_DEG, packed_gather_ok
from repro_torch.kernels.conflict.kernel import conflict_rows
from repro_torch.kernels.cuda import TableRows
from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.kernels.firstfit.kernel import firstfit_rows
from repro_torch.kernels.superstep.csr_kernel import (
    serial_tail_csr,
    serial_tail_rows,
    superstep_csr,
)
from repro_torch.kernels.superstep.kernel import superstep_rows
from repro_torch.obs.spans import SpanRecorder, jit_span, span
from repro_torch.obs.trace import (
    HostRing,
    assemble_trace,
    empty_trace,
    resolve_trace_cap,
)

__all__ = [
    "ColoringResult",
    "DenseRows",
    "color_data_driven",
    "color_fused",
    "compact",
    "compact_rows",
    "cr_flags",
    "ff_apply",
    "fused_result",
    "gather_rows",
    "order_tail",
    "provider_tail",
    "ragged_superstep",
    "resolve_tail_threshold",
    "run_fused_loop",
    "run_ragged_engine",
    "run_workefficient_loop",
    "serial_tail_step",
    "sgr_step",
    "traced_run",
]

# Adaptive tail-serialization: the worklist "stalls" when a super-step
# retires less than 1 - STALL_NUM/STALL_DEN of it.  Integer math, as in
# ``repro``, so every driver decides identically.
STALL_NUM, STALL_DEN = 9, 10


@dataclasses.dataclass
class ColoringResult:
    colors: np.ndarray       # (n,) int32 on the host
    iterations: int
    work_items: int          # worklist entries live across super-steps
    padded_work: int         # gather cells dispatched: Σ lanes × tile width
    converged: bool
    algorithm: str = "data_driven_sgr"
    # the sharded engine's bytes of boundary colours a shard receives per
    # super-step, averaged over the run; 0 on the single-device engines
    halo_bytes_per_step: float = 0.0
    # ``(width, cells)`` per degree class that dispatched work, plus a final
    # full-width entry for the serial tail; partitions ``padded_work``
    class_cells: tuple = ()
    # a ``repro_torch.obs.RunTrace`` when the run was traced (``trace=``)
    trace: object = None
    # every deviation from the clean path, as JSON-safe dicts with a "stage"
    # key: ingest repairs (``validate_input=``) and guarantee-ladder rungs
    # (``ensure_valid=``); empty on a healthy run
    degradations: tuple = ()

    @property
    def num_colors(self) -> int:
        return int(self.colors.max(initial=0))


def _on_card(t: torch.Tensor) -> bool:
    """Whether the engine launches kernels for ``t`` (a CUDA tensor)."""
    return t.device.type == "cuda"


# --------------------------------------------------------------------------
# phase helpers
# --------------------------------------------------------------------------

def ff_apply(adj, colors_ext, ids, kind: str, rows=None, deg_ext=None):
    """FirstFit the worklist chunk ``ids`` and write colors (sentinel-safe).

    On the card the FirstFit is one K4 launch reading ``adj``'s rows where
    they lie (up to each degree in ``deg_ext`` when given), or the gathered
    ``rows``; on the CPU it is ``FF_FUNCS[kind]`` over the gathered tile.
    Every row reads the colours from before the chunk.  Updates
    ``colors_ext`` in place.
    """
    n = adj.shape[0]
    if _on_card(ids):
        c = (firstfit_rows(colors_ext, ids, table=adj, deg_ext=deg_ext)
             if rows is None else firstfit_rows(colors_ext, ids, rows=rows))
    else:
        rows = gather_rows(adj, ids) if rows is None else rows
        c = FF_FUNCS[kind](colors_ext[rows.long()])
    colors_ext[ids.long()] = torch.where(ids < n, c, 0).to(torch.int32)
    return colors_ext


def cr_flags(adj, deg_ext, colors_ext, ids, heuristic: str, rows=None):
    """Conflict flags for the worklist chunk ``ids`` (True = loses, recolor).

    On the card one K5 launch reading ``adj``'s rows where they lie (up to
    each degree), or the gathered ``rows``, with colours and degrees read in
    place; on the CPU ``conflict_lose_flags`` over the gathered tiles.
    """
    if _on_card(ids):
        return (conflict_rows(colors_ext, deg_ext, ids, heuristic, table=adj)
                if rows is None else
                conflict_rows(colors_ext, deg_ext, ids, heuristic, rows=rows))
    rows = gather_rows(adj, ids) if rows is None else rows
    idx, ridx = ids.long(), rows.long()
    return conflict_lose_flags(ids, rows, colors_ext[idx], colors_ext[ridx],
                               deg_ext[idx], deg_ext[ridx], heuristic)


def compact(ids: torch.Tensor, flags: torch.Tensor, sentinel: int):
    """Prefix-sum worklist compaction (the paper's CUB scan, §3.1).

    Returns ``(out, count)``: the flagged ids packed to the front, the rest
    ``sentinel``.  Unflagged ids scatter to a trash slot at ``cap`` where
    ``repro`` drops them with ``mode="drop"``.
    """
    cap = ids.shape[0]
    pos = torch.cumsum(flags.to(torch.int32), 0, dtype=torch.int32) - 1
    out = torch.full((cap + 1,), sentinel, dtype=ids.dtype, device=ids.device)
    out[torch.where(flags, pos, cap).long()] = ids
    return out[:cap], flags.sum(dtype=torch.int32)


def compact_rows(ids: torch.Tensor, flags: torch.Tensor, sentinel: int):
    """``compact`` on each row of ``(B, L)`` worklists at once (``repro``'s
    vmapped ``compact``): returns ``(out, counts)``, ``(B, L)`` and
    ``(B,)`` int32."""
    B, L = ids.shape
    pos = torch.cumsum(flags.to(torch.int32), 1, dtype=torch.int32) - 1
    out = torch.full((B, L + 1), sentinel, dtype=ids.dtype, device=ids.device)
    out.scatter_(1, torch.where(flags, pos, L).long(), ids)
    return out[:, :L], flags.sum(1, dtype=torch.int32)


def _chunk_bounds(cap: int, nchunks: int):
    nchunks = max(1, min(nchunks, cap))
    size = math.ceil(cap / nchunks)
    return [(i * size, min((i + 1) * size, cap)) for i in range(nchunks)
            if i * size < cap]


# --------------------------------------------------------------------------
# classic super-step: FirstFit -> ConflictResolve(+clear) -> compaction
# --------------------------------------------------------------------------

def sgr_step(adj, deg_ext, colors_ext, wl, *, heuristic: str = "degree",
             kind: str = "bitset", coarsen_ff: int = 1, coarsen_cr: int = 1,
             reuse_rows: bool = False):
    """The classic two-phase super-step over the dense table ``adj``.

    FirstFit in ``coarsen_ff`` chunks (later chunks see earlier chunks'
    colors), then ConflictResolve in ``coarsen_cr`` chunks, each clearing
    its losers before the next chunk reads; ``reuse_rows`` gathers the rows
    once for both phases when neither is chunked.  On the card K4 and K5
    read ``adj``'s rows where they lie, so nothing is gathered and
    ``reuse_rows`` has nothing to reuse.  ``adj`` pads each row past its
    degree in ``deg_ext`` with the sentinel, as ``padded_adjacency`` does.
    Updates ``colors_ext`` in place; returns ``(colors_ext, new_wl,
    new_count)``.
    """
    n = adj.shape[0]
    cap = wl.shape[0]
    rows_all = gather_rows(adj, wl) if (
        reuse_rows and coarsen_ff == 1 and coarsen_cr == 1
        and not _on_card(wl)) else None
    for lo, hi in _chunk_bounds(cap, coarsen_ff):
        colors_ext = ff_apply(adj, colors_ext, wl[lo:hi], kind, rows=rows_all,
                              deg_ext=deg_ext)
    lose_parts = []
    for lo, hi in _chunk_bounds(cap, coarsen_cr):
        ids = wl[lo:hi]
        lose = cr_flags(adj, deg_ext, colors_ext, ids, heuristic, rows=rows_all)
        idx = ids.long()
        colors_ext[idx] = torch.where(lose, 0, colors_ext[idx])
        lose_parts.append(lose)
    lose = torch.cat(lose_parts) if len(lose_parts) > 1 else lose_parts[0]
    new_wl, new_count = compact(wl, lose, sentinel=n)
    return colors_ext, new_wl, new_count


# --------------------------------------------------------------------------
# the rotated super-step — ONE gather serves both phases
# --------------------------------------------------------------------------

def ragged_superstep(provider, deg_ext, colors_ext, wl, *,
                     heuristic: str = "degree", kind: str = "bitset",
                     coarsen: int = 1, colors_read=None,
                     pack_degrees: bool = False, width: int | None = None,
                     rows_per_group: int = 0):
    """One rotated super-step: ConflictResolve + FirstFit + compaction.

    ``provider`` serves each worklist id's sentinel-padded row of width
    ``W``: a ``DeviceCSR`` (cut to the class ``width``), a ``DenseRows``
    dense table or a composed ``TwoHopRows``.  ``coarsen`` chunks the
    worklist; later chunks read earlier chunks' writes.  ``colors_read`` is
    the snapshot the first chunk reads (the iteration-start colors when
    several classes share a super-step).

    An unchunked step over a ``DeviceCSR`` with ``pack_degrees`` is one K1
    launch over the packed ``color | deg << 16`` words.  On the card every
    other step is one K3 launch a chunk over ``provider.lane_source``'s
    rows, read by id where they lie with the colours read in place: no
    tile is gathered.  On the CPU it gathers ``provider.rows(ids, width)``
    and runs ``repro``'s formulation with FirstFit ``kind``.  Updates
    ``colors_ext`` in place, after each launch, from its ``(w,)`` outputs.

    ``rows_per_group=L`` compacts each consecutive group of ``L`` worklist
    entries on its own (the batched engine's graphs, ``compact_rows``): the
    new worklist is then ``(B, L)`` and the count ``(B,)``.
    """
    n = colors_ext.shape[0] - 1
    read = colors_ext if colors_read is None else colors_read
    chunk_bounds = _chunk_bounds(wl.shape[0], coarsen)
    # the packed words would have to track earlier chunks' writes
    use_csr = (pack_degrees and len(chunk_bounds) == 1
               and isinstance(provider, DeviceCSR))
    on_card = _on_card(wl)
    if on_card and not use_csr:
        source, W = provider.lane_source(width)
    need_parts = []
    for lo, hi in chunk_bounds:
        ids = wl[lo:hi]
        if use_csr:
            packed = read + (deg_ext << 16)
            new_c, need = superstep_csr(
                provider.row_starts, provider.col_padded, packed, ids,
                provider.max_width if width is None else width, heuristic)
        elif on_card:
            new_c, need = superstep_rows(read, deg_ext, ids, heuristic,
                                         source=source, W=W)
        else:
            rows = provider.rows(ids, width)
            idx, ridx = ids.long(), rows.long()
            my_c, nc = read[idx], read[ridx]
            my_d, nd = deg_ext[idx], deg_ext[ridx]
            same, lose_lane = conflict_lose_lanes(ids, rows, my_c, nc,
                                                  my_d, nd, heuristic)
            need = lose_lane.any(dim=1) | (my_c == 0)
            # lanes I beat are provably recoloring too: refit as cleared
            ff_nc = torch.where(same & ~lose_lane, 0, nc)
            new_c = torch.where(need, FF_FUNCS[kind](ff_nc), my_c)
        valid = ids < n
        need_parts.append(need & valid)
        colors_ext[ids.long()] = torch.where(valid, new_c, 0).to(torch.int32)
        read = colors_ext  # later chunks observe earlier chunks' writes
    need = torch.cat(need_parts) if len(need_parts) > 1 else need_parts[0]
    if rows_per_group:
        return (colors_ext,) + compact_rows(wl.view(-1, rows_per_group),
                                            need.view(-1, rows_per_group), n)
    new_wl, new_count = compact(wl, need, sentinel=n)
    return colors_ext, new_wl, new_count


def serial_tail_step(row1_fn, colors_ext, wl, kind: str = "bitset"):
    """Sequential FirstFit over ``wl`` through a row provider.

    The row-provider formulation of the tail (``repro``'s ``fori_loop``
    driver): clear the worklist's colors, then refit each vertex in order
    against the current state.  ``row1_fn(v) -> (W,)`` is the sentinel-padded
    row of one vertex.  Updates ``colors_ext`` in place.  The engines run
    the same function as one K2 launch (``serial_tail_csr``), which computes
    it in dependency order: a vertex's colour depends only on the fixed
    colours outside the worklist and the final colours of its neighbours
    earlier in it, so every entry runs at once and waits only for those
    (Jones-Plassmann with the worklist position as priority).
    """
    n = colors_ext.shape[0] - 1
    colors_ext[wl.long()] = 0  # sentinel entries write slot n: 0
    for v in wl.tolist():
        nc = colors_ext[row1_fn(v).long()]
        ff = FF_FUNCS[kind](nc[None, :])[0]
        colors_ext[v] = ff if v < n else 0
    return colors_ext


def provider_tail(provider, colors_ext, wl, *, kind="bitset"):
    """``serial_tail_step`` over a row provider's ``row1`` (``repro``'s,
    which caches its compilation); updates ``colors_ext`` in place."""
    return serial_tail_step(provider.row1, colors_ext, wl, kind)


def order_tail(wl: torch.Tensor, deg_ext: torch.Tensor) -> torch.Tensor:
    """Canonical serial-tail order: degree-descending, ties id-ascending.

    Sentinels sort last.  Both sorts are stable, as ``jnp.sort`` and
    ``jnp.argsort(stable=True)`` are in ``repro``.
    """
    n = deg_ext.shape[0] - 1
    ids = torch.sort(wl, stable=True).values
    key = torch.where(ids < n, -deg_ext[ids.long()], torch.iinfo(torch.int32).max)
    return ids[torch.argsort(key, stable=True)]


def resolve_tail_threshold(tail_serial, n: int) -> tuple[bool, int]:
    """(enabled, live-count threshold) from the ``tail_serial`` option.

    ``"auto"`` picks ``min(1024, max(32, n // 64))``; ``None``/``0``
    disables the threshold and the stall detector; an int is an explicit
    threshold.
    """
    if tail_serial in (None, 0, False):
        return False, 0
    if tail_serial == "auto":
        return True, int(min(1024, max(32, n // 64)))
    return True, max(1, int(tail_serial))


def _stalled(iters: int, total: int, prev: int) -> bool:
    """Worklist stall: a post-bootstrap step retired < 1/STALL_DEN of it.

    ``iters >= 3`` skips the bootstrap step and the first conflict wave.
    """
    return iters >= 3 and total * STALL_DEN >= STALL_NUM * prev


def _stalled_each(iters: np.ndarray, total: np.ndarray,
                  prev: np.ndarray) -> np.ndarray:
    """``_stalled`` element-wise over ``(B,)`` host arrays (the batched
    driver's per-graph test), in int64 so no product wraps."""
    iters, total, prev = (np.asarray(a, np.int64) for a in (iters, total, prev))
    return (iters >= 3) & (total * STALL_DEN >= STALL_NUM * prev)


def _class_cells(acc_widths, cells_k, tail_width: int, tail_cells: int):
    """``ColoringResult.class_cells``: ``(width, cells)`` per class.

    Zero-cell classes are dropped; a serial-tail pass adds one final
    full-width entry.  The entries partition ``padded_work``.
    """
    out = [(int(w), int(c)) for w, c in zip(acc_widths, cells_k) if c]
    if tail_cells:
        out.append((int(tail_width), int(tail_cells)))
    return tuple(out)


# --------------------------------------------------------------------------
# row providers and the tail
# --------------------------------------------------------------------------

class DenseRows:
    """Dense padded-adjacency row provider (the ``padded`` engine layout).

    ``rows``/``row1``/``lane_source`` mirror the ``DeviceCSR`` provider
    protocol; ``width`` requests are ignored — a dense table always serves
    its full (Δmax) width, which is the bandwidth difference the engines
    A/B (on the card K3 reads each row up to its degree, which changes no
    answer: the table pads with the sentinel).  ``csr`` is the same graph's
    ``DeviceCSR``: the serial tail reads it (see ``_dispatch_tail``).
    """

    def __init__(self, adj: torch.Tensor, csr: DeviceCSR,
                 sentinel: int | None = None):
        self.adj = adj
        self.csr = csr
        self.sentinel = int(adj.shape[0]) if sentinel is None else int(sentinel)

    @property
    def device(self) -> torch.device:
        return self.adj.device

    def lane_source(self, width: int | None = None):
        """``(source, W)``: the table by id (``TableRows``) and its width."""
        return TableRows(self.adj), int(self.adj.shape[1])

    def rows(self, ids, width: int | None = None):
        return gather_rows(self.adj, ids, self.sentinel)

    def row1(self, v):
        n = self.adj.shape[0]
        v = int(v)
        if v >= n:
            return torch.full_like(self.adj[0], self.sentinel)
        return self.adj[max(v, 0)]


# cells of composed rows one serial-tail segment materializes: 2^26 int32
# cells are 256 MiB, the composed gathers' transients a few times that, and
# row starts (position x width) stay far below 2^31
TAIL_SEGMENT_CELLS = 2**26


def _dispatch_tail(provider, colors_ext, wl, *, width: int):
    """The serial tail as K2 launches (their plain version on the CPU).

    K2 walks CSR rows.  For the dense provider it reads the graph's
    ``DeviceCSR`` rather than the dense table recast as CSR (row starts
    ``v · Δmax``, which overflow int32 once ``n · Δmax >= 2^31``): a row's
    first ``deg(v)`` lanes hold the same neighbors in both layouts and the
    dense pad lanes read color 0, so both compute ``serial_tail_step``'s
    function — every FirstFit ``kind`` returns the smallest free color.
    A composed provider (``repro_torch.d2.TwoHopRows``) has no CSR: see
    ``_composed_tail``.
    """
    csr = provider if isinstance(provider, DeviceCSR) else getattr(provider, "csr", None)
    if csr is None:
        return _composed_tail(provider, colors_ext, wl, width)
    return serial_tail_csr(csr.row_starts, csr.col_padded, csr.deg_ext,
                           colors_ext, wl, width)


def _composed_tail(provider, colors_ext, wl, width: int):
    """``serial_tail_step`` over a composed row provider, as K2 launches.

    Clears the whole tail's colors, then walks it in consecutive segments of
    at most ``TAIL_SEGMENT_CELLS // width`` entries: each segment's rows are
    materialized as one flat array (entry i's row starts at ``i · width``,
    every row has degree ``width``, sentinel lanes read color 0) and K2 runs
    over it.  K2 first clears its segment's colors, which are already 0, so
    the launches together compute ``serial_tail_step`` over the whole tail;
    self and duplicate lanes read 0 or a settled color, as there.
    """
    colors_ext[wl.long()] = 0
    seg = max(1, TAIL_SEGMENT_CELLS // width)
    for lo in range(0, int(wl.shape[0]), seg):
        ids = wl[lo:lo + seg]
        rows = provider.rows(ids)
        k = int(ids.shape[0])
        starts = torch.arange(0, k * width, width, dtype=torch.int32,
                              device=wl.device)
        degs = torch.full((k,), width, dtype=torch.int32, device=wl.device)
        serial_tail_rows(starts, degs, rows.reshape(-1), colors_ext, ids, width)
    return colors_ext


def _tiled_superstep(provider, deg_ext, colors_ext, wls, *, widths, heuristic,
                     kind, chunks, pack_degrees=False):
    """One degree-tiled super-step: one sub-step per class.

    Every class's first chunk reads the iteration-start snapshot and the
    classes' writes are disjoint, so the result equals one full-width step
    over the union worklist.
    """
    snapshot = colors_ext.clone() if len(wls) > 1 else None
    new_wls, counts = [], []
    for wl_k, w_k, c_k in zip(wls, widths, chunks):
        colors_ext, wl_k, cnt_k = ragged_superstep(
            provider, deg_ext, colors_ext, wl_k, heuristic=heuristic,
            kind=kind, coarsen=c_k, colors_read=snapshot,
            pack_degrees=pack_degrees, width=w_k)
        new_wls.append(wl_k)
        counts.append(cnt_k)
    return colors_ext, new_wls, counts


# --------------------------------------------------------------------------
# the ragged engine (degree-tiled dispatch + adaptive tail)
# --------------------------------------------------------------------------

def run_ragged_engine(
    *,
    n: int,
    provider,
    deg_ext,
    classes: list,
    tile_widths: list,
    acc_widths: list,
    tail_width: int,
    mode: str = "workefficient",
    heuristic: str = "degree",
    kind: str = "bitset",
    coarsen: int = 1,
    coarsen_lanes: int | None = None,
    tail_enabled: bool = True,
    tail_threshold: int = 0,
    max_iters: int,
    algorithm: str = "data_driven_sgr",
    pack_degrees: bool = False,
    colors_init=None,
    stall_serializes_all: bool = True,
    class_counts=None,
    trace=False,
) -> ColoringResult:
    """Drive the rotated super-step to convergence over degree-tiled classes.

    ``classes`` partitions the vertices (wide-first order); class ``k``
    gathers ``provider.rows(ids, tile_widths[k])`` tiles and ``padded_work``
    charges ``lanes × acc_widths[k]`` cells.  When the live count drops to
    ``tail_threshold`` or the worklist stalls, the rest goes to ONE serial
    tail over the full-width rows; a stall discards the speculation and
    re-greedies the whole graph.  ``mode`` picks the re-sliced
    (``workefficient``) or full-capacity (``fused``) schedule.  ``trace``
    (``True`` or a ring capacity) attaches a ``RunTrace`` of one row per
    super-step, as ``repro`` records them.

    ``colors_init`` warm-starts the engine (incremental recoloring): an
    ``(n + 1,)`` colour array whose entries outside the worklists stay
    fixed, so ``classes`` need only hold the live frontier and the work
    accounting charges that frontier, not n; no bootstrap step is skipped.
    ``stall_serializes_all=False`` keeps a stall's tail to the live
    worklist instead of re-greedying the whole graph.  ``class_counts``
    gives each class's true live count when its worklist carries trailing
    sentinel padding; only the accounting and the tail and stall tests read
    it, as the sentinel lanes are inert.
    """
    if pack_degrees and not packed_gather_ok(tail_width):
        from repro_torch.errors import CapacityError

        raise CapacityError(
            f"pack_degrees=True with tail_width={tail_width}: degrees must "
            f"stay < {PACKED_GATHER_MAX_DEG} to fit the packed gather word "
            "(color | deg << 16, int32); rerun with pack_degrees=False")
    if mode not in ("workefficient", "fused"):
        raise ValueError(f"unknown mode {mode!r}")
    device = provider.device
    caps0 = [int(c.shape[0]) for c in classes]
    counts_init = (caps0 if class_counts is None
                   else [int(c) for c in class_counts])
    boot_iters = 0
    if colors_init is not None:
        colors_ext = torch.as_tensor(colors_init, dtype=torch.int32).to(
            device).clone()
        if colors_ext.shape != (n + 1,):
            raise ValueError(f"colors_init has shape {tuple(colors_ext.shape)}, "
                             f"expected ({n + 1},)")
    else:
        colors_ext = torch.zeros((n + 1,), dtype=torch.int32, device=device)
        # Bootstrap identity: the first rotated step of an unchunked
        # worklist FirstFits every vertex against an all-zero tile, so
        # everyone takes color 1 and the worklist is unchanged.
        # Materialize that constant (never on a warm start: the rows read
        # fixed colours, not zeros).
        skip_bootstrap = coarsen <= 1 and (
            coarsen_lanes is None or coarsen_lanes >= max(caps0, default=1))
        if skip_bootstrap and max_iters >= 1:
            colors_ext[:n] = 1
            boot_iters = 1
    wls = [torch.from_numpy(np.asarray(c, np.int32)).to(device) for c in classes]
    trace_cap = resolve_trace_cap(trace, max_iters)
    rows = HostRing(trace_cap) if trace_cap else None
    if rows is not None and boot_iters:
        rows.append(n, 0, n, 1, 0)
    run = _run_ragged_fused if mode == "fused" else _run_ragged_workefficient
    result = run(n, provider, deg_ext, wls, tile_widths, acc_widths, tail_width,
                 colors_ext, boot_iters, heuristic, kind, coarsen, coarsen_lanes,
                 tail_enabled, tail_threshold, max_iters, algorithm, pack_degrees,
                 rows, counts_init, stall_serializes_all)
    if rows is not None:
        result.trace = assemble_trace(rows.rows(), result.iterations, trace_cap,
                                      f"{algorithm}:{mode}")
    return result


def _run_tail(provider, deg_ext, colors_ext, tail, tail_width: int, total: int,
              stalled: bool, rows):
    """Order ``tail`` and run the serial tail over it, the ``total`` live
    entries it drains recorded on ``rows``; returns ``(colors_ext,
    tail_cells)``."""
    with span("serial_tail", live=total, stalled=stalled):
        tail_wl = order_tail(tail, deg_ext)
        colors_ext = _dispatch_tail(provider, colors_ext, tail_wl,
                                    width=tail_width)
    tail_cells = int(tail_wl.shape[0]) * tail_width
    if rows is not None:
        # the tail drains the live worklist; a stall-serialization also
        # re-greedies settled vertices, which shows in cells, not in live
        rows.append(total, total, 0, colors_ext.max(), tail_cells, tail=1)
    return colors_ext, tail_cells


def _run_ragged_workefficient(
    n, provider, deg_ext, wls, tile_widths, acc_widths, tail_width,
    colors_ext, boot_iters, heuristic, kind, coarsen, coarsen_lanes,
    tail_enabled, tail_threshold, max_iters, algorithm, pack_degrees, rows,
    counts_init, stall_serializes_all,
):
    """The host loop: each class re-sliced to the next pow2 of its count."""
    K = len(wls)
    caps = [int(w.shape[0]) for w in wls]
    counts = list(counts_init)
    iters = boot_iters
    work = n if boot_iters else 0
    padded = 0
    cells_k = [0] * K
    total = sum(counts)
    prev = total
    stalled = False
    with span("superstep_loop", mode="workefficient"):
        while total > 0 and iters < max_iters:
            if tail_enabled and total <= tail_threshold:
                break
            if tail_enabled and _stalled(iters, total, prev):
                stalled = True
                break
            prev = total
            sliced, chunk_l = [], []
            step_cells = 0
            for k in range(K):
                cap = min(next_pow2(max(counts[k], 1)), caps[k])
                sliced.append(wls[k][:cap])
                chunk_l.append(max(1, math.ceil(cap / coarsen_lanes))
                               if coarsen_lanes else coarsen)
                work += counts[k]
                if counts[k]:
                    padded += cap * acc_widths[k]
                    cells_k[k] += cap * acc_widths[k]
                    step_cells += cap * acc_widths[k]
            shapes = tuple(int(w.shape[0]) for w in sliced)
            with jit_span("superstep", ("tiled", type(provider).__name__, shapes,
                                        tuple(tile_widths), heuristic, kind,
                                        provider.device.type, tuple(chunk_l),
                                        pack_degrees, n)):
                colors_ext, wls, cnts = _tiled_superstep(
                    provider, deg_ext, colors_ext, sliced, widths=tile_widths,
                    heuristic=heuristic, kind=kind, chunks=chunk_l,
                    pack_degrees=pack_degrees)
            counts = [int(c) for c in cnts]
            iters += 1
            new_total = sum(counts)
            if rows is not None:
                rows.append(total, total - new_total, new_total,
                            colors_ext.max(), step_cells)
            total = new_total
    converged = total == 0
    tail_cells = 0
    if total > 0 and iters < max_iters and tail_enabled:
        if stalled and stall_serializes_all:
            # speculation failed to make progress — discard it and run one
            # clean largest-degree-first sequential greedy over the graph
            tail = torch.arange(n, dtype=torch.int32, device=colors_ext.device)
        else:
            live = torch.cat([wls[k][:counts[k]] for k in range(K) if counts[k]])
            tail = torch.full((min(next_pow2(total), n),), n, dtype=torch.int32,
                              device=colors_ext.device)
            tail[:total] = live
        colors_ext, tail_cells = _run_tail(provider, deg_ext, colors_ext, tail,
                                           tail_width, total, stalled, rows)
        work += n if stalled and stall_serializes_all else total
        padded += tail_cells
        iters += 1
        converged = True
    return ColoringResult(
        colors_ext[:n].cpu().numpy(), iters, work, padded, converged,
        algorithm=algorithm,
        class_cells=_class_cells(acc_widths, cells_k, tail_width, tail_cells),
    )


def _run_ragged_fused(
    n, provider, deg_ext, wls, tile_widths, acc_widths, tail_width,
    colors_ext, boot_iters, heuristic, kind, coarsen, coarsen_lanes,
    tail_enabled, tail_threshold, max_iters, algorithm, pack_degrees, rows,
    counts_init, stall_serializes_all,
):
    """``repro``'s single-program schedule (``_fused_spec_loop``) as a host
    loop: every step dispatches every class at full capacity, so the work
    accounting charges ``spec_steps × Σ caps × acc_widths`` cells."""
    K = len(wls)
    caps = [int(w.shape[0]) for w in wls]
    # cold runs partition all n vertices, so the initial live count is n;
    # warm starts charge the true counts of their padded frontier buffers
    init_total = sum(counts_init)
    chunks = [coarsen] * K
    if coarsen_lanes:
        chunks = [max(1, math.ceil(c / coarsen_lanes)) for c in caps]
    cells_per_step = sum(c * w for c, w in zip(caps, acc_widths))
    loop_key = ("fused_spec", type(provider).__name__, tuple(caps),
                tuple(tile_widths), heuristic, kind, provider.device.type,
                tuple(chunks), tail_enabled, max_iters, boot_iters,
                pack_degrees, n, 0 if rows is None else rows.cap)
    counts = list(counts_init)
    it, work, prev = boot_iters, 0, init_total
    with span("superstep_loop", mode="fused"), jit_span("fused_spec_loop",
                                                        loop_key):
        while True:
            total = sum(counts)
            go = total > 0 and it < max_iters
            if tail_enabled:
                go = go and total > tail_threshold and not _stalled(it, total, prev)
            if not go:
                break
            prev = total
            colors_ext, wls, cnts = _tiled_superstep(
                provider, deg_ext, colors_ext, wls, widths=tile_widths,
                heuristic=heuristic, kind=kind, chunks=chunks,
                pack_degrees=pack_degrees)
            counts = [int(c) for c in cnts]
            it += 1
            work += sum(counts)
            if rows is not None:
                rows.append(prev, prev - sum(counts), sum(counts),
                            colors_ext.max(), cells_per_step)
    total = sum(counts)
    iters = it
    work_items = work + init_total
    spec_steps = iters - boot_iters
    cells_k = [spec_steps * c * w for c, w in zip(caps, acc_widths)]
    padded = sum(cells_k)
    converged = total == 0
    tail_cells = 0
    if total > 0 and iters < max_iters and tail_enabled:
        stalled = total > tail_threshold and _stalled(iters, total, prev)
        if stalled and stall_serializes_all:
            tail = torch.arange(n, dtype=torch.int32, device=colors_ext.device)
        else:
            tail = torch.cat(wls) if K > 1 else wls[0]
        colors_ext, tail_cells = _run_tail(provider, deg_ext, colors_ext, tail,
                                           tail_width, total, stalled, rows)
        work_items += n if stalled and stall_serializes_all else total
        padded += tail_cells
        iters += 1
        converged = True
    return ColoringResult(
        colors_ext[:n].cpu().numpy(), iters, work_items, padded, converged,
        algorithm=algorithm,
        class_cells=_class_cells(acc_widths, cells_k, tail_width, tail_cells),
    )


# --------------------------------------------------------------------------
# generic loops for the classic step
# --------------------------------------------------------------------------
# Both loops are generic over the super-step: ``step(colors_ext, wl) ->
# (colors_ext, wl, count)``.  The classic engine instantiates them with
# ``sgr_step``.

def run_fused_loop(step, colors_ext, wl0, count0, max_iters: int,
                   trace_cap: int = 0, cells_per_step: int = 0):
    """Full-capacity steps until the worklist empties or ``max_iters``.

    Returns ``(colors_ext, wl, count, iters, work)`` where ``work`` is the
    sum of post-step live counts (the first full-capacity step is charged by
    the caller, matching the paper's work accounting).  With ``trace_cap >
    0`` one trace row a step is kept in a ring of that capacity, returned as
    a sixth element (``rows()`` gives them in step order).
    """
    wl, count = wl0, int(count0)
    it = work = 0
    rows = HostRing(trace_cap) if trace_cap else None
    while count > 0 and it < max_iters:
        prev = count
        colors_ext, wl, cnt = step(colors_ext, wl)
        count = int(cnt)
        it += 1
        work += count
        if rows is not None:
            rows.append(prev, prev - count, count, colors_ext.max(),
                        cells_per_step)
    if rows is not None:
        return colors_ext, wl, count, it, work, rows
    return colors_ext, wl, count, it, work


def fused_result(colors_ext, n: int, count, it, work, width: int = 1,
                 algorithm: str = "data_driven_sgr") -> ColoringResult:
    """Shared result assembly for fused loops (paper work accounting).

    Every super-step dispatches full capacity, so ``padded_work`` is
    ``iters * n * width`` gather cells and the first step's n live items are
    charged on top of the post-step counts accumulated in ``work``.
    """
    iters = int(it)
    return ColoringResult(
        colors_ext[:n].cpu().numpy(),
        iters,
        int(work) + n,
        iters * n * width,
        converged=int(count) == 0,
        algorithm=algorithm,
    )


def run_workefficient_loop(step, colors_ext, wl0, count0: int, max_iters: int):
    """Host loop re-slicing the worklist to the next pow2 of the live count.

    Returns ``(colors_ext, iters, work, padded, converged)``; ``padded``
    counts dispatched lanes (multiply by the tile width for gather cells).
    """
    wl, count = wl0, int(count0)
    iters = work = padded = 0
    while count > 0 and iters < max_iters:
        cap = min(next_pow2(count), wl.shape[0])
        colors_ext, wl, cnt = step(colors_ext, wl[:cap])
        work += count
        padded += cap
        count = int(cnt)
        iters += 1
    return colors_ext, iters, work, padded, count == 0


def _resolve_classes(degrees: np.ndarray, buckets, tiling):
    """(classes, widths) for the degree-tiled dispatch, wide-first order.

    Explicit ``buckets`` win; otherwise ``tiling`` is ``"auto"`` (log-spaced
    thresholds from the degree histogram), an explicit threshold tuple, or
    ``None``/``()`` for a single full-width class.  Degree-0 vertices join
    the narrowest class; empty classes are dropped.
    """
    degrees = np.asarray(degrees)
    n = int(degrees.size)
    dmax = max(int(degrees.max(initial=0)), 1)
    if buckets:
        thresholds = tuple(buckets)
    elif tiling == "auto":
        thresholds = auto_tile_thresholds(degrees)
    elif not tiling:
        thresholds = ()
    else:
        thresholds = tuple(tiling)
    if not thresholds:
        return [np.arange(n, dtype=np.int32)], [dmax]
    bounds = list(thresholds) + [dmax]
    widths = [min(max(b, 1), dmax) for b in bounds]
    classes, lo = [], 0
    for hi in bounds:
        classes.append(
            np.where((degrees > lo) & (degrees <= hi))[0].astype(np.int32))
        lo = hi
    zero = np.where(degrees == 0)[0].astype(np.int32)
    if zero.size:
        classes[0] = np.concatenate([zero, classes[0]])
    order = np.argsort([-w for w in widths], kind="stable")
    pairs = [(classes[i], widths[i]) for i in order if classes[i].size]
    if not pairs:
        return [np.arange(n, dtype=np.int32)], [dmax]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _graph_device_cache(g: CSRGraph, key: str, device: torch.device, build):
    """Memoize a device view of the (frozen) host graph per ``(key, device)``.

    The host graph is immutable, so its device forms (the CSR arrays, the
    dense table) are pure functions of the object and the device: repeated
    ``color()`` calls skip the upload, as ``repro`` caches its device views
    on the graph.
    """
    cache = getattr(g, "_device_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(g, "_device_cache", cache)
    if (key, device) not in cache:
        cache[key, device] = build()
    return cache[key, device]


def _device_csr(g: CSRGraph, device: torch.device) -> DeviceCSR:
    return _graph_device_cache(g, "dcsr", device,
                               lambda: DeviceCSR.from_csr(g, device))


def _dense_adjacency(g: CSRGraph, device: torch.device) -> torch.Tensor:
    """The ``(n, Δmax)`` padded adjacency on ``device`` (cached)."""
    return _graph_device_cache(
        g, "dense", device,
        lambda: torch.from_numpy(g.padded_adjacency()).to(device))


# --------------------------------------------------------------------------
# the classic engine
# --------------------------------------------------------------------------

def _prepare(g: CSRGraph, buckets, device):
    """Dense tables (one width per class), degrees and the classes."""
    dense = _dense_adjacency(g, device)
    deg_ext = _device_csr(g, device).deg_ext
    if buckets:
        classes = g.degree_buckets(buckets)
        bounds = list(buckets) + [max(g.max_degree, 1)]
        widths = [min(max(hi, 1), dense.shape[1]) for hi in bounds]
        # large-degree classes first (aligns with the degree heuristic)
        order = np.argsort([-w for w in widths], kind="stable")
        classes = [classes[i] for i in order]
        widths = [widths[i] for i in order]
    else:
        classes = [np.arange(g.n, dtype=np.int32)]
        widths = [dense.shape[1]]
    return [dense[:, :w] for w in widths], deg_ext, classes


def _color_classic(g, heuristic, firstfit, coarsen_ff, coarsen_cr,
                   coarsen_lanes, buckets, mode, max_iters, reuse_rows, device,
                   trace_cap=0):
    """The two-phase engine (FirstFit kernel + ConflictResolve kernel)."""
    n = g.n
    adjs, deg_ext, classes = _prepare(g, buckets, device)
    colors_ext = torch.zeros((n + 1,), dtype=torch.int32, device=device)
    if mode == "fused":
        if buckets:  # an assert in repro
            raise ValueError(
                "classic fused mode runs single-class (full-width) only")
        return _run_fused(n, adjs[0], deg_ext, colors_ext, heuristic, firstfit,
                          coarsen_ff, coarsen_cr, max_iters, reuse_rows,
                          trace_cap)
    if mode != "workefficient":
        raise ValueError(f"unknown mode {mode!r}")

    widths = [int(a.shape[1]) for a in adjs]
    # per-class worklists (class membership is static: degrees never change)
    wls = [torch.from_numpy(ids).to(device) for ids in classes]
    counts = [int(ids.shape[0]) for ids in classes]
    iters = work = padded = 0
    rows = HostRing(trace_cap) if trace_cap else None
    with span("superstep_loop", mode=mode):
        while sum(counts) > 0 and iters < max_iters:
            live_in = sum(counts)
            step_cells = 0
            new_wls, new_counts = [], []
            for k, (wl, count, adj_k) in enumerate(zip(wls, counts, adjs)):
                if count == 0:
                    new_wls.append(wl[:1])
                    new_counts.append(0)
                    continue
                cap = min(next_pow2(count), wl.shape[0])
                if coarsen_lanes:
                    coarsen_ff = max(1, math.ceil(cap / coarsen_lanes))
                colors_ext, wl_out, cnt = sgr_step(
                    adj_k, deg_ext, colors_ext, wl[:cap], heuristic=heuristic,
                    kind=firstfit, coarsen_ff=coarsen_ff, coarsen_cr=coarsen_cr,
                    reuse_rows=reuse_rows)
                work += count
                padded += cap * widths[k]
                step_cells += cap * widths[k]
                new_wls.append(wl_out)
                new_counts.append(int(cnt))
            wls, counts = new_wls, new_counts
            iters += 1
            if rows is not None:
                new_total = sum(counts)
                rows.append(live_in, live_in - new_total, new_total,
                            colors_ext.max(), step_cells)
    result = ColoringResult(colors_ext[:n].cpu().numpy(), iters, work, padded,
                            converged=sum(counts) == 0)
    if rows is not None:
        result.trace = assemble_trace(rows.rows(), iters, trace_cap,
                                      "classic:workefficient")
    return result


def _run_fused(n, adj, deg_ext, colors_ext, heuristic, kind, coarsen_ff,
               coarsen_cr, max_iters, reuse_rows=False, trace_cap=0):
    step = partial(sgr_step, adj, deg_ext, heuristic=heuristic, kind=kind,
                   coarsen_ff=coarsen_ff, coarsen_cr=coarsen_cr,
                   reuse_rows=reuse_rows)
    wl0 = torch.arange(n, dtype=torch.int32, device=colors_ext.device)
    width = int(adj.shape[1])
    with span("superstep_loop", mode="fused"):
        out = run_fused_loop(step, colors_ext, wl0, n, max_iters,
                             trace_cap=trace_cap, cells_per_step=n * width)
    colors_ext, _, count, it, work = out[:5]
    result = fused_result(colors_ext, n, count, it, work, width=width)
    if trace_cap:
        result.trace = assemble_trace(out[5].rows(), it, trace_cap,
                                      "classic:fused")
    return result


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

@register("data_driven")
def color_data_driven(
    g: CSRGraph,
    *,
    heuristic: str = "degree",
    firstfit: str = "bitset",
    coarsen_ff: int = 1,
    coarsen_cr: int = 1,
    coarsen_lanes: int | None = None,
    buckets: tuple[int, ...] = (),
    mode: str = "workefficient",
    max_iters: int | None = None,
    reuse_rows: bool = False,
    engine: str = "ragged",
    tiling="auto",
    tail_serial="auto",
    devices=None,
    backend: str | None = None,
    trace=False,
    device=None,
) -> ColoringResult:
    """Color ``g`` with the paper's optimized data-driven SGR algorithm.

    ``engine`` is ``ragged`` (CSR storage, the default), ``padded`` (the
    same schedule over the dense table), ``classic`` (the two-phase
    super-step) or ``sharded`` (the multi-shard engine of
    ``core/distributed.py``, one shard per entry of ``devices``: every
    visible card by default, ``[cpu]`` under ``device="cpu"``; with one
    device it runs ``ragged`` with ``mode="fused"``, the sharded schedule's
    accounting, so results never depend on how many devices are present);
    ``mode`` is ``workefficient`` or ``fused``.  ``device`` defaults to
    ``"cuda"``, where the engines launch K1–K5; ``device="cpu"`` runs their
    plain versions.  ``trace`` (``True`` or a ring capacity) attaches a
    ``RunTrace`` with the phase spans.  Results equal ``repro.color(g,
    ...)``'s field for field (colors, iterations, work_items, padded_work,
    class_cells, converged, algorithm, halo_bytes_per_step, the trace's
    rows), the sharded engine's at the same device count.
    """
    if engine == "sharded":
        from repro_torch.core.distributed import resolve_devices

        devs = resolve_devices(devices, device, backend)
        device = devs[0]
    else:
        device = resolve_backend(backend, device)
    if engine not in ("ragged", "padded", "classic", "sharded"):
        raise ValueError(
            f"unknown engine {engine!r}; options: ragged, padded, classic, "
            "sharded")
    if heuristic not in HEURISTICS:
        raise ValueError(f"unknown heuristic {heuristic!r}; options: {HEURISTICS}")
    if firstfit not in FF_FUNCS:
        raise ValueError(f"unknown firstfit {firstfit!r}; options: {sorted(FF_FUNCS)}")
    n = g.n
    if n == 0:
        result = ColoringResult(np.zeros(0, np.int32), 0, 0, 0, True)
        if trace:
            result.trace = empty_trace("data_driven_sgr")
        return result
    max_iters = max_iters or n + 1

    def run(engine=engine, mode=mode):
        if engine == "classic":
            return _color_classic(g, heuristic, firstfit, coarsen_ff,
                                  coarsen_cr, coarsen_lanes, buckets, mode,
                                  max_iters, reuse_rows, device,
                                  trace_cap=resolve_trace_cap(trace, max_iters))
        if engine == "sharded":
            # validated before the one-device fallback, so the options taken
            # never depend on how many devices are present
            if coarsen_ff != 1 or coarsen_cr != 1 or coarsen_lanes:
                raise ValueError(
                    "engine='sharded' runs the uncoarsened (coarsen=1) "
                    "schedule; coarsen_ff/coarsen_cr/coarsen_lanes are not "
                    "supported")
            if len(devs) > 1:
                from repro_torch.core.distributed import color_distributed

                return color_distributed(
                    g, devices=devs, heuristic=heuristic, firstfit=firstfit,
                    buckets=buckets, tiling=tiling, tail_serial=tail_serial,
                    max_iters=max_iters, trace=trace)
            # one device: the sharded schedule is the ragged fused one
            engine, mode = "ragged", "fused"
        with span("partition_plan"):
            classes, widths = _resolve_classes(g.degrees, buckets, tiling)
        dmax = max(g.max_degree, 1)
        with span("csr_build", engine=engine):
            csr = _device_csr(g, device)
            if engine == "ragged":
                provider, tile_widths, acc_widths = csr, widths, widths
            else:
                provider = DenseRows(_dense_adjacency(g, device), csr)
                tile_widths = [None] * len(widths)
                acc_widths = [dmax] * len(widths)
        tail_enabled, thr = resolve_tail_threshold(tail_serial, n)
        return run_ragged_engine(
            n=n,
            provider=provider,
            deg_ext=csr.deg_ext,
            classes=classes,
            tile_widths=tile_widths,
            acc_widths=acc_widths,
            tail_width=dmax,
            mode=mode,
            heuristic=heuristic,
            kind=firstfit,
            coarsen=max(int(coarsen_ff), int(coarsen_cr)),
            coarsen_lanes=coarsen_lanes,
            tail_enabled=tail_enabled,
            tail_threshold=thr,
            max_iters=max_iters,
            pack_degrees=packed_gather_ok(dmax),
            trace=trace,
        )

    return traced_run(run, trace)


def traced_run(run, trace) -> ColoringResult:
    """``run()``; with ``trace`` inside a recorder of its own, whose spans
    land on ``result.trace.spans`` (an outer recorder still sees them)."""
    if not trace:
        return run()
    with SpanRecorder() as rec:
        result = run()
    if result.trace is not None:
        result.trace.spans = rec.events
    return result


@register("fused")
def color_fused(g: CSRGraph, **opts) -> ColoringResult:
    """``data_driven`` with every super-step at full capacity (``mode="fused"``)."""
    opts.pop("mode", None)
    return color_data_driven(g, mode="fused", **opts)
