"""K3: the rotated superstep, over rows read where they lie or gathered tiles.

Counterpart of ``repro.kernels.superstep`` (``superstep_tpu``): the
conflict test, the refit of the lanes a row beats, and FirstFit in one
pass.  The kernel is hand-written CUDA, ``superstep_rows_kernel`` in
``repro_torch/csrc/tile_kernels.cu`` (its header says what it replaces,
what bounds it and how its design answers that); K1
(``csr_kernel.superstep_csr``) runs the same body over packed CSR words.
Two wrappers launch it:

* ``superstep_rows`` — each worklist row read by id from a row source
  (``kernels.cuda``: ``TableRows``, the dense table up to each degree;
  ``CsrRows``, a ``DeviceCSR``'s rows; ``TwoHopLanes``, composed two-hop
  rows), its colours from ``read`` and degrees from ``deg_ext`` in place.
  The engine's card branch calls it (``core.coloring.ragged_superstep``);
* ``superstep_tile`` — the caller's gathered ``(w, W)`` tiles: the TPU
  kernel's signature.

Each launches the kernel for CUDA tensors and takes its plain version
(``superstep_rows_ref``, ``superstep_tile_ref``) for CPU tensors; nothing
else decides the path.  ``lanes=`` forces a layout (lanes a row, one of
``ROW_LANES``); by default ``row_lanes`` picks it from the width and the
source.  ``superstep_tile.launches`` is raised by one where either wrapper
launches the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.csr import csr_tile, gather_rows
from repro_torch.core.firstfit import firstfit_bitset
from repro_torch.core.heuristics import HEURISTICS, conflict_lose_lanes
from repro_torch.kernels import build
from repro_torch.kernels.cuda import (
    CsrRows,
    TableRows,
    TwoHopLanes,
    check,
    on_cpu,
    row_lanes,
    stream,
    superstep_source,
    tile_shape,
)

__all__ = ["source_tile", "superstep_rows", "superstep_rows_ref", "superstep_tile",
           "superstep_tile_ref", "two_hop_tile"]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("tile_kernels")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_superstep_tile.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    lib.repro_superstep_tile.restype = i32
    lib.repro_superstep_rows.argtypes = [ptr, ptr, ptr, i64, i32, ptr, ptr, ptr, ptr] + \
        [i32] * 5 + [ptr]
    lib.repro_superstep_rows.restype = i32
    lib.repro_superstep_two_hop.argtypes = (
        [ptr, ptr, i64, i32, ptr, i32, ptr, i64, i32, ptr] + [i32] * 3
        + [ptr] * 4 + [i32] * 5 + [ptr])
    lib.repro_superstep_two_hop.restype = i32
    return lib


def superstep_tile_ref(ids, nid, my_c, nc, my_d, nd, heuristic: str = "degree"):
    """Plain version of K3: ``(new_colors, need)`` for the tile's rows.

    ``need`` marks rows that lose a conflict or are uncoloured; they take
    the bitset FirstFit of their row with the lanes they beat cleared.
    """
    same, lose_lane = conflict_lose_lanes(ids, nid, my_c, nc, my_d, nd, heuristic)
    need = lose_lane.any(dim=1) | (my_c == 0)
    ff = firstfit_bitset(torch.where(same & ~lose_lane, 0, nc))
    return torch.where(need, ff, my_c).to(torch.int32), need


def _check_heuristic(heuristic: str) -> None:
    if heuristic not in HEURISTICS:
        raise ValueError(f"unknown heuristic {heuristic!r}; options: {HEURISTICS}")


def _empty(device):
    return (torch.zeros((0,), dtype=torch.int32, device=device),
            torch.zeros((0,), dtype=torch.bool, device=device))


def superstep_tile(ids, nid, my_c, nc, my_d, nd, heuristic: str = "degree", *,
                   lanes: int | None = None):
    """Fused conflict check + FirstFit over one ``(w, W)`` neighbour tile.

    Arguments as for ``conflict_tile``.  Returns ``(new_colors, need)``:
    int32 and bool ``(w,)``.  Sentinel masking is the caller's job — the
    kernel has no notion of the vertex count, as in ``repro``.
    """
    _check_heuristic(heuristic)
    w, W = tile_shape(ids, nid, my_c, nc, my_d, nd)
    cpu = on_cpu(ids, nid, my_c, nc, my_d, nd)
    lanes = row_lanes(W, lanes, full=True)
    if w == 0:
        return _empty(ids.device)
    if cpu:
        return superstep_tile_ref(ids, nid, my_c, nc, my_d, nd, heuristic)
    lib = _lib()
    newc = torch.empty((w,), dtype=torch.int32, device=ids.device)
    need = torch.empty((w,), dtype=torch.int32, device=ids.device)
    rc = lib.repro_superstep_tile(
        ids.data_ptr(), my_c.data_ptr(), my_d.data_ptr(), nid.data_ptr(),
        nc.data_ptr(), nd.data_ptr(), newc.data_ptr(), need.data_ptr(), w, W,
        int(heuristic == "degree"), lanes, stream(ids.device))
    superstep_tile.launches += 1
    check(lib, rc, "superstep_tile")
    return newc, need.bool()


superstep_tile.launches = 0


# --------------------------------------------------------------------------
# rows read where they lie
# --------------------------------------------------------------------------

def two_hop_tile(adj_a, adj_b, include_first_hop: bool, start: int, n: int,
                 ids) -> torch.Tensor:
    """The composed ``(w, W1·W2 [+ W1])`` id tile of ``ids`` over ``adj_a``
    then ``adj_b``, as ``repro``'s ``TwoHopRows.rows`` gathers it: local row
    ``ids - start`` (clamped), masked for ids ``>= n`` or past ``adj_a``'s
    rows; the hop-1 ids index ``adj_b`` (sentinel rows past its rows) and,
    with ``include_first_hop``, lead the row, masked rows remapped to ``n``.
    """
    n_rows = int(adj_a.shape[0])
    n_mid = int(adj_b.shape[0])
    lidx = ids - start
    rows1 = adj_a[lidx.clamp(0, max(n_rows - 1, 0)).long()]
    valid = (ids < n) & (lidx < n_rows)
    rows1 = torch.where(valid[:, None], rows1, n_mid)
    if n_mid:
        rows2 = gather_rows(adj_b, rows1.reshape(-1), sentinel=n)
    else:  # no mid-side ids: every lane is a sentinel
        rows2 = torch.full((rows1.numel(), adj_b.shape[1]), n, dtype=rows1.dtype,
                           device=rows1.device)
    rows2 = rows2.reshape(ids.shape[0], -1)
    if include_first_hop:
        # hop-1 fill ids index the mid side; remap masked lanes to the
        # colored-side sentinel so they stay inert through colors_ext
        rows1 = torch.where(valid[:, None], rows1, n)
        return torch.cat([rows1, rows2], dim=1)
    return rows2


def source_tile(source, ids, n: int, W: int) -> torch.Tensor:
    """The full-width id tile ``source`` holds for ``ids``: what the engine's
    row provider gathers on the CPU (lanes past a row's degree and rows of
    ids ``>= n`` read the sentinel ``n``)."""
    if isinstance(source, TableRows):
        return gather_rows(source.table[:, :W], ids)
    if isinstance(source, CsrRows):
        return csr_tile(source.row_starts, source.col, ids, W)
    return two_hop_tile(source.adj_a, source.adj_b, source.include_first_hop,
                        source.start, n, ids)


def superstep_rows_ref(read, deg_ext, ids, heuristic: str = "degree", *, source,
                       W: int):
    """Plain version of K3 over a row source, on CPU tensors: gathers the
    source's tile (``source_tile``) and runs ``superstep_tile_ref``."""
    n = read.shape[0] - 1
    rows = source_tile(source, ids, n, W)
    idx, ridx = ids.long(), rows.long()
    return superstep_tile_ref(ids, rows, read[idx], read[ridx], deg_ext[idx],
                              deg_ext[ridx], heuristic)


def superstep_rows(read, deg_ext, ids, heuristic: str = "degree", *, source, W: int,
                   lanes: int | None = None):
    """The rotated superstep over each worklist id's row, read where it lies.

    ``read`` (the colours the step reads) and ``deg_ext`` are ``(n + 1,)``
    with 0 in slot ``n``; ``ids`` (ids in ``[0, n]``, ``n`` = sentinel) pick
    the rows of ``source`` (``TableRows``, ``CsrRows`` or ``TwoHopLanes``);
    ``W`` is the row width: FirstFit's range is ``[1, W+1]``, a table's rows
    and CSR rows are cut to ``W`` lanes, two-hop rows are ``source.width``
    wide.  Returns ``(new_colors, need)``, int32 and bool ``(w,)``, as
    ``superstep_tile`` over the tile the source holds; sentinel masking is
    the caller's.  Nothing is gathered on the card, and ``read`` is never
    written.
    """
    _check_heuristic(heuristic)
    W = int(W)
    cpu = superstep_source(read, deg_ext, ids, source, W)
    lanes = row_lanes(W, lanes)
    w = int(ids.shape[0])
    n = read.shape[0] - 1
    if w == 0:
        return _empty(ids.device)
    if cpu:
        return superstep_rows_ref(read, deg_ext, ids, heuristic, source=source, W=W)
    lib = _lib()
    newc = torch.empty((w,), dtype=torch.int32, device=ids.device)
    need = torch.empty((w,), dtype=torch.int32, device=ids.device)
    rule = int(heuristic == "degree")
    tail = (newc.data_ptr(), need.data_ptr(), w, W, n, rule, lanes, stream(ids.device))
    if isinstance(source, TwoHopLanes):
        a, b = source.adj_a, source.adj_b
        rc = lib.repro_superstep_two_hop(
            ids.data_ptr(), a.data_ptr(), a.stride(0), int(a.shape[1]),
            source.deg_a.data_ptr(), int(a.shape[0]), b.data_ptr(), b.stride(0),
            int(b.shape[1]), source.deg_b.data_ptr(), int(b.shape[0]), int(source.start),
            int(source.include_first_hop), read.data_ptr(), deg_ext.data_ptr(), *tail)
    elif isinstance(source, CsrRows):
        rc = lib.repro_superstep_rows(
            ids.data_ptr(), source.col.data_ptr(), source.row_starts.data_ptr(), 0, 1,
            read.data_ptr(), deg_ext.data_ptr(), *tail)
    else:
        t = source.table
        rc = lib.repro_superstep_rows(
            ids.data_ptr(), t.data_ptr(), None, t.stride(0), 0, read.data_ptr(),
            deg_ext.data_ptr(), *tail)
    superstep_tile.launches += 1
    check(lib, rc, "superstep_rows")
    return newc, need.bool()
