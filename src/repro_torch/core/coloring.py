"""Data-driven speculative-greedy coloring (paper Alg. 7) in PyTorch.

The port of ``repro.core.coloring``'s default path: the ``ragged`` engine
in ``workefficient`` mode.  A host loop drives the rotated super-step over
degree-tiled worklist classes; the adaptive serial tail finishes the run
(``run_ragged_engine``).  Each class sub-step is one K1 launch
(``kernels/superstep/csr_kernel.superstep_csr``) and the tail one K2 launch
(``serial_tail_csr``); on CPU tensors both take their plain versions.

Tensors live on one explicit device.  ``repro``'s arrays are immutable;
here ``colors_ext`` is updated in place where the reference builds a new
array, which is safe because a super-step's kernels read only the packed
snapshot built before any class writes.

Options outside this slice raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api import register
from repro_torch.core.csr import CSRGraph, DeviceCSR, auto_tile_thresholds, next_pow2
from repro_torch.core.firstfit import FF_FUNCS
from repro_torch.core.heuristics import HEURISTICS, conflict_lose_lanes
from repro_torch.ingest import PACKED_GATHER_MAX_DEG, packed_gather_ok
from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.kernels.superstep.csr_kernel import serial_tail_csr, superstep_csr

__all__ = [
    "ColoringResult",
    "color_data_driven",
    "compact",
    "order_tail",
    "ragged_superstep",
    "resolve_tail_threshold",
    "run_ragged_engine",
    "serial_tail_step",
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
    # ``(width, cells)`` per degree class that dispatched work, plus a final
    # full-width entry for the serial tail; partitions ``padded_work``
    class_cells: tuple = ()

    @property
    def num_colors(self) -> int:
        return int(self.colors.max(initial=0))


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


def ragged_superstep(provider: DeviceCSR, deg_ext, colors_ext, wl, *,
                     heuristic: str = "degree", kind: str = "bitset",
                     colors_read=None, pack_degrees: bool = False,
                     width: int | None = None):
    """One rotated super-step: ConflictResolve + FirstFit + compaction.

    ``colors_read`` is the snapshot the step reads (the iteration-start
    colors when several classes share a super-step); writes go to
    ``colors_ext`` in place.  With ``pack_degrees`` the step is one K1
    launch over the packed ``color | deg << 16`` words.  Without it (degrees
    past the packed budget) only the CPU has a formulation here — the
    gathered-tile kernel K3 that ``repro`` uses there is not ported yet.
    """
    n = colors_ext.shape[0] - 1
    read = colors_ext if colors_read is None else colors_read
    width = provider.max_width if width is None else width
    if pack_degrees:
        packed = read + (deg_ext << 16)
        new_c, need = superstep_csr(provider.row_starts, provider.col_padded,
                                    packed, wl, width, heuristic)
    elif wl.device.type != "cpu":
        raise NotImplementedError(
            f"degrees >= {PACKED_GATHER_MAX_DEG} overflow the packed gather "
            "word; repro runs the gathered-tile kernel K3 "
            "(kernels/superstep/kernel.py:superstep_kernel) there, which is "
            "not ported to CUDA yet (ROADMAP Queue B, K3)")
    else:
        rows = provider.rows(wl, width)
        my_c = read[wl.long()]
        same, lose_lane = conflict_lose_lanes(
            wl, rows, my_c, read[rows.long()], deg_ext[wl.long()],
            deg_ext[rows.long()], heuristic)
        need = lose_lane.any(dim=1) | (my_c == 0)
        ff_nc = torch.where(same & ~lose_lane, 0, read[rows.long()])
        new_c = torch.where(need, FF_FUNCS[kind](ff_nc), my_c)
    valid = wl < n
    need = need & valid
    colors_ext[wl.long()] = torch.where(valid, new_c, 0).to(torch.int32)
    new_wl, new_count = compact(wl, need, sentinel=n)
    return colors_ext, new_wl, new_count


def _tiled_superstep(provider, deg_ext, colors_ext, wls, *, widths, heuristic,
                     kind, pack_degrees=False):
    """One degree-tiled super-step: one sub-step per class.

    Every class speculates against the iteration-start snapshot and the
    classes' writes are disjoint, so the result equals one full-width step
    over the union worklist.
    """
    snapshot = colors_ext.clone() if len(wls) > 1 else None
    new_wls, counts = [], []
    for wl_k, w_k in zip(wls, widths):
        colors_ext, wl_k, cnt_k = ragged_superstep(
            provider, deg_ext, colors_ext, wl_k, heuristic=heuristic,
            kind=kind, colors_read=snapshot, pack_degrees=pack_degrees,
            width=w_k)
        new_wls.append(wl_k)
        counts.append(cnt_k)
    return colors_ext, new_wls, counts


def serial_tail_step(row1_fn, colors_ext, wl, kind: str = "bitset"):
    """Sequential FirstFit over ``wl`` through a row provider.

    The row-provider formulation of the tail (``repro``'s ``fori_loop``
    driver): clear the worklist's colors, then refit each vertex in order
    against the current state.  ``row1_fn(v) -> (W,)`` is the sentinel-padded
    row of one vertex.  Updates ``colors_ext`` in place.  The CSR engine
    runs the same computation as one K2 launch (``serial_tail_csr``).
    """
    n = colors_ext.shape[0] - 1
    colors_ext[wl.long()] = 0  # sentinel entries write slot n: 0
    for v in wl.tolist():
        nc = colors_ext[row1_fn(v).long()]
        ff = FF_FUNCS[kind](nc[None, :])[0]
        colors_ext[v] = ff if v < n else 0
    return colors_ext


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


def _class_cells(widths, cells_k, tail_width: int, tail_cells: int):
    """``ColoringResult.class_cells``: ``(width, cells)`` per class.

    Zero-cell classes are dropped; a serial-tail pass adds one final
    full-width entry.  The entries partition ``padded_work``.
    """
    out = [(int(w), int(c)) for w, c in zip(widths, cells_k) if c]
    if tail_cells:
        out.append((int(tail_width), int(tail_cells)))
    return tuple(out)


def _dispatch_tail(provider: DeviceCSR, colors_ext, wl, *, width: int):
    """The serial tail as one K2 launch (plain version on the CPU)."""
    return serial_tail_csr(provider.row_starts, provider.col_padded,
                           provider.deg_ext, colors_ext, wl, width)


def run_ragged_engine(
    *,
    n: int,
    provider: DeviceCSR,
    deg_ext,
    classes: list,
    widths: list,
    tail_width: int,
    mode: str = "workefficient",
    heuristic: str = "degree",
    kind: str = "bitset",
    coarsen: int = 1,
    coarsen_lanes: int | None = None,
    tail_enabled: bool = True,
    tail_threshold: int = 0,
    max_iters: int,
    pack_degrees: bool = False,
    colors_init=None,
) -> ColoringResult:
    """Drive the rotated super-step to convergence over degree-tiled classes.

    ``classes`` partitions the vertices (wide-first order); class ``k``
    gathers at ``widths[k]`` and ``padded_work`` charges
    ``lanes × widths[k]`` cells.  When the live count drops to
    ``tail_threshold`` or the worklist stalls, the rest goes to ONE serial
    tail over the full-width rows; a stall discards the speculation and
    re-greedies the whole graph.
    """
    if mode == "fused":
        raise NotImplementedError(
            "mode='fused' (the single-program loop) is not ported yet "
            "(ROADMAP A4)")
    if mode != "workefficient":
        raise ValueError(f"unknown mode {mode!r}")
    if colors_init is not None:
        raise NotImplementedError(
            "colors_init= (warm-started recoloring) is not ported yet "
            "(ROADMAP A9)")
    caps0 = [int(c.shape[0]) for c in classes]
    if coarsen > 1 or (coarsen_lanes is not None
                       and coarsen_lanes < max(caps0, default=1)):
        raise NotImplementedError(
            "coarsen_ff / coarsen_cr / coarsen_lanes that chunk the worklist "
            "are not ported yet (ROADMAP A4)")
    if pack_degrees and not packed_gather_ok(tail_width):
        from repro_torch.errors import CapacityError

        raise CapacityError(
            f"pack_degrees=True with tail_width={tail_width}: degrees must "
            f"stay < {PACKED_GATHER_MAX_DEG} to fit the packed gather word "
            "(color | deg << 16, int32); rerun with pack_degrees=False")
    device = provider.device
    # Bootstrap identity: the first rotated step of an unchunked worklist
    # FirstFits every vertex against an all-zero tile, so everyone takes
    # color 1 and the worklist is unchanged.  Materialize that constant.
    boot_iters = 0
    colors_ext = torch.zeros((n + 1,), dtype=torch.int32, device=device)
    if max_iters >= 1:
        colors_ext[:n] = 1
        boot_iters = 1

    K = len(classes)
    wls = [torch.from_numpy(np.asarray(c, np.int32)).to(device) for c in classes]
    counts = list(caps0)
    iters = boot_iters
    work = n if boot_iters else 0
    padded = 0
    cells_k = [0] * K
    total = sum(counts)
    prev = total
    stalled = False
    while total > 0 and iters < max_iters:
        if tail_enabled and total <= tail_threshold:
            break
        if tail_enabled and _stalled(iters, total, prev):
            stalled = True
            break
        prev = total
        sliced = []
        for k in range(K):
            cap = min(next_pow2(max(counts[k], 1)), caps0[k])
            sliced.append(wls[k][:cap])
            work += counts[k]
            if counts[k]:
                padded += cap * widths[k]
                cells_k[k] += cap * widths[k]
        colors_ext, wls, cnts = _tiled_superstep(
            provider, deg_ext, colors_ext, sliced, widths=widths,
            heuristic=heuristic, kind=kind, pack_degrees=pack_degrees)
        counts = [int(c) for c in cnts]
        iters += 1
        total = sum(counts)
    converged = total == 0
    tail_cells = 0
    if total > 0 and iters < max_iters and tail_enabled:
        if stalled:
            # speculation failed to make progress — discard it and run one
            # clean largest-degree-first sequential greedy over the graph
            tail = torch.arange(n, dtype=torch.int32, device=device)
        else:
            live = torch.cat([wls[k][:counts[k]] for k in range(K) if counts[k]])
            tail = torch.full((min(next_pow2(total), n),), n, dtype=torch.int32,
                              device=device)
            tail[:total] = live
        tail_wl = order_tail(tail, deg_ext)
        colors_ext = _dispatch_tail(provider, colors_ext, tail_wl,
                                    width=tail_width)
        work += n if stalled else total
        tail_cells = int(tail_wl.shape[0]) * tail_width
        padded += tail_cells
        iters += 1
        converged = True
    return ColoringResult(
        colors_ext[:n].cpu().numpy(), iters, work, padded, converged,
        class_cells=_class_cells(widths, cells_k, tail_width, tail_cells),
    )


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


def _device_csr(g: CSRGraph, device: torch.device) -> DeviceCSR:
    """``DeviceCSR.from_csr(g, device)``, memoized on the (frozen) graph.

    The host graph is immutable, so its device form is a pure function of
    the object and the device: repeated ``color()`` calls skip the upload,
    as ``repro`` caches its device views on the graph.
    """
    cache = getattr(g, "_device_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(g, "_device_cache", cache)
    if device not in cache:
        cache[device] = DeviceCSR.from_csr(g, device)
    return cache[device]


_ENGINE_ITEMS = {"padded": "A4", "classic": "A4", "sharded": "A11"}


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
    engine: str = "ragged",
    tiling="auto",
    tail_serial="auto",
    backend: str | None = None,
    trace=False,
    device=None,
) -> ColoringResult:
    """Color ``g`` with the paper's optimized data-driven SGR algorithm.

    ``device`` defaults to ``"cuda"``: the super-steps run K1 and the tail
    K2 on the card.  ``device="cpu"`` runs their plain versions.  Results
    equal ``repro.color(g)``'s field for field (colors, iterations,
    work_items, padded_work, class_cells, converged).
    """
    device = resolve_backend(backend, device)
    if engine != "ragged":
        if engine in _ENGINE_ITEMS:
            raise NotImplementedError(
                f"engine={engine!r} is not ported yet "
                f"(ROADMAP {_ENGINE_ITEMS[engine]})")
        raise ValueError(
            f"unknown engine {engine!r}; options: ragged, padded, classic, "
            "sharded")
    if trace:
        raise NotImplementedError("trace= telemetry is not ported yet (ROADMAP A6)")
    if heuristic not in HEURISTICS:
        raise ValueError(f"unknown heuristic {heuristic!r}; options: {HEURISTICS}")
    if firstfit not in FF_FUNCS:
        raise ValueError(f"unknown firstfit {firstfit!r}; options: {sorted(FF_FUNCS)}")
    n = g.n
    if n == 0:
        return ColoringResult(np.zeros(0, np.int32), 0, 0, 0, True)
    max_iters = max_iters or n + 1
    classes, widths = _resolve_classes(g.degrees, buckets, tiling)
    dmax = max(g.max_degree, 1)
    provider = _device_csr(g, device)
    tail_enabled, thr = resolve_tail_threshold(tail_serial, n)
    return run_ragged_engine(
        n=n,
        provider=provider,
        deg_ext=provider.deg_ext,
        classes=classes,
        widths=widths,
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
    )
