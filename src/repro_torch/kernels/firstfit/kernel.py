"""K4: bitset FirstFit over each worklist row's neighbour colours.

Counterpart of ``repro.kernels.firstfit`` (``firstfit_bitset_tpu``).  The
kernel is hand-written CUDA, ``firstfit_rows_kernel`` in
``repro_torch/csrc/tile_kernels.cu`` (its header says what it replaces,
what bounds it and how its design answers that).  It reads a row's lanes
from one of three sources, through two wrappers:

* ``firstfit_rows`` — neighbour ids from a table (row ``ids[i]``, read up
  to the vertex's degree) or from a tile of id rows the caller gathered
  (row ``i``), their colours from ``colors_ext`` in place.  The classic
  engine's ``ff_apply`` calls it on the card;
* ``firstfit_tile`` — a ``(w, W)`` tile of colours the caller gathered.

Each launches the kernel for CUDA tensors and takes its plain version
(``firstfit_rows_ref``, ``firstfit_tile_ref``) for CPU tensors; nothing
else decides the path.  ``lanes=`` forces a layout (lanes a row, one of
``ROW_LANES``); by default ``row_lanes`` picks it from the width.  Each
wrapper's ``.launches`` is raised by one where the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.csr import gather_rows
from repro_torch.core.firstfit import firstfit_bitset
from repro_torch.kernels import build
from repro_torch.kernels.cuda import check, on_cpu, row_lanes, row_source, stream

__all__ = ["firstfit_rows", "firstfit_rows_ref", "firstfit_tile", "firstfit_tile_ref"]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("tile_kernels")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_firstfit_tile.argtypes = [ptr, ptr, i32, i32, i32, ptr]
    lib.repro_firstfit_tile.restype = i32
    lib.repro_firstfit_rows.argtypes = [ptr, ptr, i64, i32, ptr, ptr, ptr] + [i32] * 4 + [ptr]
    lib.repro_firstfit_rows.restype = i32
    return lib


def firstfit_tile_ref(nc: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: the smallest colour in ``[1, W+1]`` absent from
    each row of ``nc`` (0 = no colour), as int32 ``(w,)``."""
    return firstfit_bitset(nc)


def firstfit_tile(nc: torch.Tensor, *, lanes: int | None = None) -> torch.Tensor:
    """FirstFit over padded neighbour colours ``(w, W)`` -> colours ``(w,)``."""
    if nc.dim() != 2:
        raise ValueError(f"nc must be a (w, W) tile, got shape {tuple(nc.shape)}")
    w, W = nc.shape
    cpu = on_cpu(nc)
    lanes = row_lanes(W, lanes, full=True)
    if w == 0:
        return torch.zeros((0,), dtype=torch.int32, device=nc.device)
    if cpu:
        return firstfit_tile_ref(nc)
    lib = _lib()
    out = torch.empty((w,), dtype=torch.int32, device=nc.device)
    rc = lib.repro_firstfit_tile(nc.data_ptr(), out.data_ptr(), w, W, lanes,
                                 stream(nc.device))
    firstfit_tile.launches += 1
    check(lib, rc, "firstfit_tile")
    return out


firstfit_tile.launches = 0


def firstfit_rows_ref(colors_ext, ids, *, table=None, rows=None) -> torch.Tensor:
    """Plain version of ``firstfit_rows``: gather the rows at full width
    (``gather_rows`` of ``table``, or ``rows``), then their colours, then
    ``firstfit_tile_ref``."""
    rows = gather_rows(table, ids) if rows is None else rows
    return firstfit_tile_ref(colors_ext[rows.long()])


def firstfit_rows(colors_ext, ids, *, table=None, deg_ext=None, rows=None,
                  lanes: int | None = None) -> torch.Tensor:
    """FirstFit of each worklist row's neighbour colours -> int32 ``(w,)``.

    Exactly one row source: ``table`` (``(n, W)`` neighbour ids padded with
    the sentinel ``n``; row ``ids[i]``, all-sentinel for ids ``>= n``; may
    be a column slice of a wider table) or ``rows`` (``(w, W)``, row ``i``,
    ids in ``[0, n]``).  Colours come from ``colors_ext`` (``n + 1`` slots,
    slot ``n`` = 0).  With ``table``, ``deg_ext`` (the table's degrees,
    ``n + 1`` slots) lets the kernel read a row only up to its degree, which
    gives the same answer where the table pads every row past its degree
    with ``n``, as ``padded_adjacency`` does.
    """
    src, w, W, cpu = row_source(colors_ext, ids, table, rows, deg_ext)
    lanes = row_lanes(W, lanes, full=rows is not None)
    if w == 0:
        return torch.zeros((0,), dtype=torch.int32, device=ids.device)
    if cpu:
        return firstfit_rows_ref(colors_ext, ids, table=table, rows=rows)
    lib = _lib()
    out = torch.empty((w,), dtype=torch.int32, device=ids.device)
    deg_ptr = None if deg_ext is None or rows is not None else deg_ext.data_ptr()
    rc = lib.repro_firstfit_rows(
        ids.data_ptr(), src.data_ptr(), src.stride(0), int(rows is None),
        colors_ext.data_ptr(), deg_ptr, out.data_ptr(), w, W,
        colors_ext.shape[0] - 1, lanes, stream(ids.device))
    firstfit_rows.launches += 1
    check(lib, rc, "firstfit_rows")
    return out


firstfit_rows.launches = 0
