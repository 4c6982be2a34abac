"""What the kernel wrappers share: device checks, the stream, launch errors.

A wrapper launches its CUDA kernel for CUDA tensors and takes its plain
version for CPU tensors; ``on_cpu`` decides which, and raises on a mix of
devices or on what the kernels do not take.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

__all__ = ["MAX_SMEM", "ROW_LANES", "WARPS_PER_BLOCK", "CsrRows", "TableRows",
           "TwoHopLanes", "check", "check_bitset_width", "on_cpu", "row_lanes",
           "row_source", "stream", "superstep_source", "tile_shape"]

# shared memory one block may use (H100: 227 KB)
MAX_SMEM = 227 * 1024


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA ones; raises on a mix.

    On the card every tensor must be contiguous int32 (the kernels read raw
    int32 pointers); shapes are the wrapper's to check.
    """
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        for t in tensors:
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise ValueError(
                    "the CUDA kernels take contiguous int32 tensors, got "
                    f"{t.dtype} of shape {tuple(t.shape)}")
        return False
    raise ValueError(
        f"tensors must all lie on the CPU or all on one CUDA device, got "
        f"{sorted(str(t.device) for t in tensors)}")


def stream(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as the launchers take it."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


# warps a block of K2 (warp layout) or K6 runs, each with its own FirstFit bitset
WARPS_PER_BLOCK = 8
# lanes a row of K1, K3, K4 or K5 may take (a thread, or a group of a warp), and the
# threads of one of their blocks: 256 / lanes rows, each with a bitset
ROW_LANES = (1, 4, 8, 16, 32)
ROW_THREADS = 256
# the default layout: a thread a row up to ROW_THREAD_MAX lanes, then groups
# of ROW_GROUP lanes; rows read at full width past ROW_GROUP_MAX take a warp
ROW_THREAD_MAX = 16
ROW_GROUP = 8
ROW_GROUP_MAX = 64


def _bitsets_fit(W: int, bitsets: int) -> bool:
    return bitsets * ((int(W) + 32) // 32) * 4 <= MAX_SMEM


def check_bitset_width(W: int, bitsets: int = WARPS_PER_BLOCK) -> None:
    """Raise if a block's ``bitsets`` FirstFit bitsets at width ``W`` pass
    ``MAX_SMEM``."""
    if not _bitsets_fit(W, bitsets):
        raise ValueError(
            f"tile width W={W} needs more shared memory for {bitsets} FirstFit "
            "bitsets than a block has")


def row_lanes(W: int, lanes: int | None = None, bitset: bool = True,
              full: bool = False) -> int:
    """Lanes a row of K1, K3, K4 or K5 takes at width ``W``: ``lanes`` if given (a
    layout forced, checked), else a thread a row up to ``ROW_THREAD_MAX``,
    then ``ROW_GROUP`` lanes; rows read at ``full`` width (gathered rows or
    tiles, not a table read up to each degree) take a warp past
    ``ROW_GROUP_MAX``, and so does any width where K4's bitsets for
    ``ROW_GROUP`` lanes a row would not fit a block.  With ``bitset`` (the
    FirstFit of K1, K3 and K4) raises where the layout's bitsets pass a
    block's shared memory."""
    if lanes is None:
        lanes = 1 if W <= ROW_THREAD_MAX else ROW_GROUP
        if (full and W > ROW_GROUP_MAX) or (
                bitset and not _bitsets_fit(W, ROW_THREADS // lanes)):
            lanes = 32
    elif lanes not in ROW_LANES:
        raise ValueError(f"lanes must be one of {ROW_LANES}, got {lanes}")
    if bitset and W >= 32:
        check_bitset_width(W, ROW_THREADS // lanes)
    return lanes


def row_source(colors_ext, ids, table, rows, deg_ext=None):
    """Check the arguments of ``firstfit_rows`` and ``conflict_rows``.

    Returns ``(src, w, W, cpu)``: the row source (``table``, an int32
    ``(n, W)`` table whose rows are unit-stride, a column slice of a wider
    one allowed; or ``rows``, ``(w, W)``), the row count, the width and
    ``on_cpu``'s answer.  Raises unless exactly one source is given and the
    shapes and devices agree.
    """
    if (table is None) == (rows is None):
        raise ValueError("give exactly one of table= and rows=")
    src = table if rows is None else rows
    if src.dim() != 2:
        raise ValueError(f"{'table' if rows is None else 'rows'} must be 2-D, "
                         f"got shape {tuple(src.shape)}")
    if ids.dim() != 1:
        raise ValueError(f"ids must be 1-D, got shape {tuple(ids.shape)}")
    n = colors_ext.shape[0] - 1
    w, W = int(ids.shape[0]), int(src.shape[1])
    if rows is None and table.shape[0] != n:
        raise ValueError(f"table has {table.shape[0]} rows, colors_ext {n + 1} slots")
    if rows is not None and rows.shape[0] != w:
        raise ValueError(f"rows has {rows.shape[0]} rows for {w} ids")
    if deg_ext is not None and deg_ext.shape != colors_ext.shape:
        raise ValueError(f"deg_ext has shape {tuple(deg_ext.shape)}, colors_ext "
                         f"{tuple(colors_ext.shape)}")
    cpu = on_cpu(colors_ext, ids, *(() if deg_ext is None else (deg_ext,)),
                 *(() if rows is None else (rows,)))
    if rows is None:
        if table.device != ids.device:
            raise ValueError(
                f"tensors must all lie on the CPU or all on one CUDA device, got "
                f"the table on {table.device} and the rest on {ids.device}")
        if not cpu and (table.dtype != torch.int32
                        or (W > 1 and table.stride(1) != 1)
                        or table.stride(0) < W):
            raise ValueError(
                "the CUDA kernels take an int32 table with unit-stride rows, got "
                f"{table.dtype} of shape {tuple(table.shape)}, strides "
                f"{table.stride()}")
    return src, w, W, cpu


# --------------------------------------------------------------------------
# where K3 reads a row (``superstep_rows``); each engine row provider says
# which through its ``lane_source`` method
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TableRows:
    """Source (a): row ``v`` of ``table`` (``(n, >= W)`` int32, unit-stride
    rows; the sentinel ``n`` past each degree), read up to ``min(deg_ext[v],
    W)`` lanes.  The ``padded`` engine's ``DenseRows``."""
    table: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CsrRows:
    """Source (d): row ``v`` is ``col[R[v] : R[v] + min(R[v+1] - R[v], W)]``
    (``R`` = ``row_starts``), its length from ``R``.  A ``DeviceCSR``."""
    row_starts: torch.Tensor
    col: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TwoHopLanes:
    """Source (f): composed two-hop rows, ``ids → adj_a → adj_b``, as
    ``repro_torch.d2.TwoHopRows`` gathers them.

    ``adj_a`` is ``(n_rows, W1)`` (the sentinel ``n_mid`` past each row's
    degree), ``adj_b`` ``(n_mid, W2)`` (the sentinel ``n_colored``); ``deg_a``
    and ``deg_b`` give each row's lanes to read, so every lane at or past a
    row's degree must hold its table's sentinel.  Worklist id ``v`` reads
    local row ``v - start``.  With ``include_first_hop`` the hop-1 ids are
    lanes too, which needs ``n_mid == n_colored`` (one graph, distance-2).
    """
    adj_a: torch.Tensor
    adj_b: torch.Tensor
    deg_a: torch.Tensor
    deg_b: torch.Tensor
    include_first_hop: bool
    start: int
    n_colored: int

    @property
    def width(self) -> int:
        """The composed row's width: ``W1 · W2`` (+ ``W1`` with the hop-1
        lanes)."""
        w1, w2 = int(self.adj_a.shape[1]), int(self.adj_b.shape[1])
        return w1 * w2 + (w1 if self.include_first_hop else 0)


def _unit_rows(name: str, t: torch.Tensor, cpu: bool) -> None:
    """Raise unless ``t`` is a 2-D table the kernels can read by row."""
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if not cpu and (t.dtype != torch.int32 or (t.shape[1] > 1 and t.stride(1) != 1)
                    or t.stride(0) < t.shape[1]):
        raise ValueError(
            f"the CUDA kernels take an int32 {name} with unit-stride rows, got "
            f"{t.dtype} of shape {tuple(t.shape)}, strides {t.stride()}")


def superstep_source(read, deg_ext, ids, source, W: int) -> bool:
    """Check the arguments of ``superstep_rows`` and return ``on_cpu``'s
    answer.

    ``read`` and ``deg_ext`` are ``(n + 1,)``, ``ids`` 1-D; every tensor of
    ``source`` lies on their device.  ``W`` is at least 1; a table holds at
    least ``W`` columns; two-hop rows are ``source.width`` wide and colour
    the ``n`` vertices of ``read``.  Raises on anything else.
    """
    if ids.dim() != 1:
        raise ValueError(f"ids must be 1-D, got shape {tuple(ids.shape)}")
    if read.dim() != 1 or deg_ext.shape != read.shape:
        raise ValueError(f"read and deg_ext must be (n + 1,), got shapes "
                         f"{tuple(read.shape)} and {tuple(deg_ext.shape)}")
    if int(W) < 1:
        raise ValueError(f"row width W={W} must be at least 1")
    n = read.shape[0] - 1
    if isinstance(source, TableRows):
        tensors = (source.table,)
    elif isinstance(source, CsrRows):
        tensors = (source.row_starts, source.col)
    elif isinstance(source, TwoHopLanes):
        tensors = (source.adj_a, source.adj_b, source.deg_a, source.deg_b)
    else:
        raise TypeError(f"unknown row source {type(source).__name__}")
    for t in tensors:
        if t.device != ids.device:
            raise ValueError(
                f"tensors must all lie on the CPU or all on one CUDA device, got "
                f"the row source on {t.device} and ids on {ids.device}")
    cpu = on_cpu(read, deg_ext, ids)
    if isinstance(source, TableRows):
        _unit_rows("table", source.table, cpu)
        if source.table.shape[0] != n or source.table.shape[1] < W:
            raise ValueError(f"table has shape {tuple(source.table.shape)}, expected "
                             f"({n}, >= {W})")
    elif isinstance(source, CsrRows):
        if source.row_starts.shape != read.shape or source.col.dim() != 1:
            raise ValueError(
                f"row_starts must be (n + 1,) = {tuple(read.shape)} and col 1-D, got "
                f"{tuple(source.row_starts.shape)} and {tuple(source.col.shape)}")
        if not cpu:
            on_cpu(source.row_starts, source.col)
    else:
        for name in ("adj_a", "adj_b"):
            _unit_rows(name, getattr(source, name), cpu)
        n_rows, n_mid = source.adj_a.shape[0], source.adj_b.shape[0]
        if source.n_colored != n or W != source.width or n_rows == 0:
            raise ValueError(
                f"two-hop rows colour {source.n_colored} vertices {source.width} lanes "
                f"wide over {n_rows} rows; read has {n} and W={W}")
        if source.include_first_hop and n_mid != n:
            raise ValueError(
                f"hop-1 lanes need the mid side to be the coloured side: n_mid={n_mid}, "
                f"n={n}")
        if (source.deg_a.shape[0] < n_rows or source.deg_b.shape[0] < n_mid
                or source.deg_a.dim() != 1 or source.deg_b.dim() != 1):
            raise ValueError(
                f"deg_a and deg_b need a word a row: shapes {tuple(source.deg_a.shape)}, "
                f"{tuple(source.deg_b.shape)} for {n_rows} and {n_mid} rows")
        if not cpu:
            on_cpu(source.deg_a, source.deg_b)
    return cpu


def tile_shape(ids, nid, my_c, nc, my_d, nd) -> tuple[int, int]:
    """``(w, W)`` of K3's and K5's arguments: three ``(w,)`` row vectors and
    three ``(w, W)`` tiles.  Raises on any other shapes."""
    if nid.dim() != 2:
        raise ValueError(f"nid must be a (w, W) tile, got shape {tuple(nid.shape)}")
    w, W = nid.shape
    for name, t, shape in (("ids", ids, (w,)), ("my_c", my_c, (w,)),
                           ("my_d", my_d, (w,)), ("nc", nc, (w, W)),
                           ("nd", nd, (w, W))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    return int(w), int(W)
