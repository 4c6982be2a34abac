"""K5: the conflict (loser) test over each worklist row's neighbours.

Counterpart of ``repro.kernels.conflict`` (``conflict_tpu``).  The kernel
is hand-written CUDA, ``conflict_rows_kernel`` in
``repro_torch/csrc/tile_kernels.cu`` (its header says what it replaces,
what bounds it and how its design answers that).  It reads a row's lanes
from one of three sources, through two wrappers:

* ``conflict_rows`` — neighbour ids from a table (row ``ids[i]``, read up
  to the vertex's degree) or from a tile of id rows the caller gathered
  (row ``i``); colours and degrees from ``colors_ext`` and ``deg_ext`` in
  place.  The classic engine's ``cr_flags`` calls it on the card;
* ``conflict_tile`` — ``(w, W)`` tiles of ids, colours and degrees the
  caller gathered.

Each launches the kernel for CUDA tensors and takes its plain version
(``conflict_rows_ref``, ``conflict_tile_ref``) for CPU tensors; nothing
else decides the path.  ``lanes=`` forces a layout (lanes a row, one of
``ROW_LANES``); by default ``row_lanes`` picks it from the width.  Each
wrapper's ``.launches`` is raised by one where the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.csr import gather_rows
from repro_torch.core.heuristics import HEURISTICS, conflict_lose_flags
from repro_torch.kernels import build
from repro_torch.kernels.cuda import (
    check,
    on_cpu,
    row_lanes,
    row_source,
    stream,
    tile_shape,
)

__all__ = ["conflict_rows", "conflict_rows_ref", "conflict_tile", "conflict_tile_ref"]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("tile_kernels")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_conflict_tile.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    lib.repro_conflict_tile.restype = i32
    lib.repro_conflict_rows.argtypes = [ptr, ptr, i64, i32, ptr, ptr, ptr] + [i32] * 5 + [ptr]
    lib.repro_conflict_rows.restype = i32
    return lib


def _check_heuristic(heuristic: str) -> None:
    if heuristic not in HEURISTICS:
        raise ValueError(f"unknown heuristic {heuristic!r}; options: {HEURISTICS}")


def conflict_tile_ref(ids, nid, my_c, nc, my_d, nd, heuristic: str = "degree"):
    """Plain version of K5: True where row ``i``'s vertex shares its nonzero
    colour with a neighbour that beats it under ``heuristic``."""
    return conflict_lose_flags(ids, nid, my_c, nc, my_d, nd, heuristic)


def conflict_tile(ids, nid, my_c, nc, my_d, nd, heuristic: str = "degree", *,
                  lanes: int | None = None):
    """Loser flags (bool ``(w,)``) for speculative conflicts.

    ``ids``/``my_c``/``my_d`` are ``(w,)``: each row's vertex, its colour and
    degree; ``nid``/``nc``/``nd`` are ``(w, W)``: its neighbours' ids
    (sentinel in pads), colours (0 in pads) and degrees (0 in pads).
    """
    _check_heuristic(heuristic)
    w, W = tile_shape(ids, nid, my_c, nc, my_d, nd)
    cpu = on_cpu(ids, nid, my_c, nc, my_d, nd)
    lanes = row_lanes(W, lanes, bitset=False, full=True)
    if w == 0:
        return torch.zeros((0,), dtype=torch.bool, device=ids.device)
    if cpu:
        return conflict_tile_ref(ids, nid, my_c, nc, my_d, nd, heuristic)
    lib = _lib()
    lose = torch.empty((w,), dtype=torch.int32, device=ids.device)
    rc = lib.repro_conflict_tile(
        ids.data_ptr(), my_c.data_ptr(), my_d.data_ptr(), nid.data_ptr(),
        nc.data_ptr(), nd.data_ptr(), lose.data_ptr(), w, W,
        int(heuristic == "degree"), lanes, stream(ids.device))
    conflict_tile.launches += 1
    check(lib, rc, "conflict_tile")
    return lose.bool()


conflict_tile.launches = 0


def conflict_rows_ref(colors_ext, deg_ext, ids, heuristic: str = "degree", *,
                      table=None, rows=None):
    """Plain version of ``conflict_rows``: gather the rows at full width
    (``gather_rows`` of ``table``, or ``rows``), then the colours and
    degrees of the rows' vertices and lanes, then ``conflict_tile_ref``."""
    rows = gather_rows(table, ids) if rows is None else rows
    idx, ridx = ids.long(), rows.long()
    return conflict_tile_ref(ids, rows, colors_ext[idx], colors_ext[ridx],
                             deg_ext[idx], deg_ext[ridx], heuristic)


def conflict_rows(colors_ext, deg_ext, ids, heuristic: str = "degree", *,
                  table=None, rows=None, lanes: int | None = None):
    """Loser flags (bool ``(w,)``) of the worklist rows ``ids``.

    Exactly one row source: ``table`` (``(n, W)`` neighbour ids padded with
    the sentinel ``n`` past each row's degree, as ``padded_adjacency``
    makes them; row ``ids[i]``, read up to ``deg_ext[v]`` lanes,
    all-sentinel for ids ``>= n``; may be a column slice of a wider table)
    or ``rows`` (``(w, W)``, row ``i``, ids in ``[0, n]``).  Colours and
    degrees come from ``colors_ext`` and ``deg_ext`` (``n + 1`` slots each,
    slot ``n`` = 0).
    """
    _check_heuristic(heuristic)
    src, w, W, cpu = row_source(colors_ext, ids, table, rows, deg_ext)
    lanes = row_lanes(W, lanes, bitset=False, full=rows is not None)
    if w == 0:
        return torch.zeros((0,), dtype=torch.bool, device=ids.device)
    if cpu:
        return conflict_rows_ref(colors_ext, deg_ext, ids, heuristic, table=table,
                                 rows=rows)
    lib = _lib()
    lose = torch.empty((w,), dtype=torch.int32, device=ids.device)
    rc = lib.repro_conflict_rows(
        ids.data_ptr(), src.data_ptr(), src.stride(0), int(rows is None),
        colors_ext.data_ptr(), deg_ext.data_ptr(), lose.data_ptr(), w, W,
        colors_ext.shape[0] - 1, int(heuristic == "degree"), lanes, stream(ids.device))
    conflict_rows.launches += 1
    check(lib, rc, "conflict_rows")
    return lose.bool()


conflict_rows.launches = 0
