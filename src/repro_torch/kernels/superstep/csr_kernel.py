"""K1 and K2: the CSR-resident superstep and the serial tail.

Counterparts of ``repro.kernels.superstep.csr_kernel``.  The kernels are
hand-written CUDA: K1 is ``superstep_rows_kernel`` in
``repro_torch/csrc/tile_kernels.cu`` over CSR rows of packed words (K3's
body, see ``kernel``), K2 is in ``repro_torch/csrc/superstep_csr.cu``
(their headers say what each replaces, what bounds it and how its design
answers that).  Each kernel has here:

* a wrapper (``superstep_csr``; ``serial_tail_csr``, and for rows the
  caller lays out ``serial_tail_rows``) that launches the kernel for CUDA
  tensors and takes the plain version for CPU tensors — nothing else
  decides the path, and a CUDA tensor never reaches the plain version;
* a plain PyTorch version (``superstep_csr_ref``, ``serial_tail_csr_ref``,
  ``serial_tail_rows_ref``) on CPU tensors.  K1's repeats the kernel's
  arithmetic; K2's is the sequential walk that defines the function, which
  the kernel computes in dependency order, every entry at once (its rank
  table comes from ``tail_ranks``, which runs on either device);
* a launch counter, ``superstep_csr.launches`` and
  ``serial_tail_csr.launches``, raised by one where the kernel is launched
  and nowhere else.

All arrays are int32.  ``row_starts``/``col_padded``/``deg_ext`` are the
``DeviceCSR`` arrays; ``packed`` is the ``(n + 1,)`` ``color | deg << 16``
table with slot ``n`` = 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.csr import csr_tile
from repro_torch.core.heuristics import HEURISTICS
from repro_torch.ingest import PACKED_GATHER_MAX_DEG
from repro_torch.kernels import build
from repro_torch.kernels.cuda import check, check_bitset_width, on_cpu, row_lanes, stream
from repro_torch.kernels.superstep.kernel import superstep_tile_ref

__all__ = [
    "serial_tail_csr",
    "serial_tail_csr_ref",
    "serial_tail_rows",
    "serial_tail_rows_ref",
    "superstep_csr",
    "superstep_csr_ref",
    "tail_ranks",
]

_LIB = "superstep_csr"


@functools.cache
def _k1_lib() -> ctypes.CDLL:
    """K1's library, the row-resident kernels' (built at first use)."""
    lib = build.load("tile_kernels")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.repro_superstep_csr.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.repro_superstep_csr.restype = i32
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    """K2's library (built at first use), its signature declared."""
    lib = build.load(_LIB)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.repro_serial_tail_csr.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    lib.repro_serial_tail_csr.restype = i32
    return lib


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """``cuda.on_cpu`` for the 1-D arrays K1 and K2 take."""
    for t in tensors:
        if t.dim() != 1:
            raise ValueError(f"K1 and K2 take 1-D tensors, got shape {tuple(t.shape)}")
    return on_cpu(*tensors)


# --------------------------------------------------------------------------
# K1: the CSR-resident rotated superstep
# --------------------------------------------------------------------------

def superstep_csr_ref(row_starts, col_padded, packed, wl, W: int,
                      heuristic: str = "degree"):
    """Plain version of K1 on CPU tensors: ``(new_colors, need)`` for ``wl``.

    Gathers the ``(w, W)`` row tile from C, masks lanes at or past each
    row's length ``R[v+1] - R[v]`` to the sentinel ``n`` (packed word 0:
    inert), decides conflicts on the packed words and FirstFits the refit
    tile.  The row length is the CSR's own, the loser rule's degree the
    packed one: they differ over G² (distance-2), where the packed degree
    is the original graph's.
    """
    mypk = packed[wl.long()]
    my_c = mypk & 0xFFFF
    my_d = mypk >> 16
    nid = csr_tile(row_starts, col_padded, wl, W)
    npk = packed[nid.long()]
    return superstep_tile_ref(wl, nid, my_c, npk & 0xFFFF, my_d, npk >> 16, heuristic)


def superstep_csr(row_starts, col_padded, packed, wl, W: int,
                  heuristic: str = "degree", *, lanes: int | None = None):
    """Fused row gather + conflict check + FirstFit straight from CSR.

    Returns ``(new_colors, need)`` for the worklist ``wl`` (ids in
    ``[0, n]``, ``n`` = sentinel).  Sentinel masking (``wl < n``) is the
    caller's job, as in ``repro``.  ``W`` is the degree-class width and
    must cover every worklist degree; the packed word needs
    ``W < PACKED_GATHER_MAX_DEG``.  ``lanes=`` forces a layout (lanes a
    row), as for K3.
    """
    if heuristic not in HEURISTICS:
        raise ValueError(f"unknown heuristic {heuristic!r}; options: {HEURISTICS}")
    if not 1 <= int(W) < PACKED_GATHER_MAX_DEG:
        raise ValueError(f"class width W={W} outside [1, {PACKED_GATHER_MAX_DEG})")
    w = wl.shape[0]
    n = row_starts.shape[0] - 1
    cpu = _on_cpu(row_starts, col_padded, packed, wl)
    lanes = row_lanes(int(W), lanes)
    if w == 0 or n == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=wl.device),
                torch.zeros((0,), dtype=torch.bool, device=wl.device))
    if cpu:
        return superstep_csr_ref(row_starts, col_padded, packed, wl, W, heuristic)
    if packed.shape[0] != n + 1:
        raise ValueError(f"packed has {packed.shape[0]} slots, expected n + 1 = {n + 1}")
    lib = _k1_lib()
    newc = torch.empty((w,), dtype=torch.int32, device=wl.device)
    need = torch.empty((w,), dtype=torch.int32, device=wl.device)
    rc = lib.repro_superstep_csr(
        wl.data_ptr(), row_starts.data_ptr(), col_padded.data_ptr(),
        packed.data_ptr(), newc.data_ptr(), need.data_ptr(),
        w, int(W), n, int(heuristic == "degree"), lanes, stream(wl.device))
    superstep_csr.launches += 1
    check(lib, rc, "superstep_csr")
    return newc, need.bool()


superstep_csr.launches = 0


# --------------------------------------------------------------------------
# K2: the serial tail, every entry at once in dependency order
# --------------------------------------------------------------------------
# K2 reads, for the i-th worklist entry, the row ``col[starts[i] :
# starts[i] + min(degs[i], W)]``.  ``serial_tail_csr`` takes those from the
# CSR arrays (``R[v]``, ``deg(v)``); ``serial_tail_rows`` takes them as
# given, for rows laid out by the caller (the composed two-hop rows of
# ``repro_torch.d2``).  Both launch the one kernel and count into
# ``serial_tail_csr.launches``.
#
# The function is sequential greedy in worklist order; the kernel computes
# it as Jones-Plassmann with the position as priority (the header of
# ``csrc/superstep_csr.cu`` gives the read rule and why it cannot
# deadlock).  Precondition: the worklist's real ids (``< n``) are distinct,
# as every caller's compacted worklist is.

# rows up to this width take one thread per entry, wider ones a warp
THREAD_ROW_MAX = 32


def serial_tail_rows_ref(starts, degs, col, colors_ext, wl, W: int):
    """Plain version of K2 on CPU tensors; updates ``colors_ext`` in place.

    Clears the worklist's colors, then gives each entry in order the
    smallest color in ``[1, W+1]`` absent from its row's current colors
    (sentinel ids ``>= n`` write slot ``n`` = 0).  Walks Python lists: the
    loop is sequential by definition.
    """
    n = colors_ext.shape[0] - 1
    order = wl.tolist()
    S = starts.tolist()
    D = degs.tolist()
    C = col.tolist()
    colors = colors_ext.tolist()
    for v in order:
        colors[v] = 0  # sentinel entries write slot n: 0
    for v, s, d in zip(order, S, D):
        if v >= n:
            colors[n] = 0
            continue
        taken = {colors[u] for u in C[s: s + min(d, W)]}
        c = 1
        while c in taken:
            c += 1
        colors[v] = c
    colors_ext.copy_(torch.tensor(colors, dtype=torch.int32))
    return colors_ext


def serial_tail_csr_ref(row_starts, col_padded, deg_ext, colors_ext, wl, W: int):
    """Plain version of K2 over the CSR arrays (see ``serial_tail_rows_ref``)."""
    n = row_starts.shape[0] - 1
    return serial_tail_rows_ref(row_starts[wl.clamp(0, max(n - 1, 0)).long()],
                                deg_ext[wl.clamp(0, n).long()], col_padded,
                                colors_ext, wl, W)


def tail_ranks(wl, n: int) -> torch.Tensor:
    """K2's ``rank`` table: ``(n + 1,)`` int32 on ``wl``'s device.

    ``rank[wl[i]] = i`` for each real id ``wl[i] < n``; ``-1`` for every
    vertex outside the worklist and for the sentinel slot ``n``.
    """
    rank = torch.full((n + 1,), -1, dtype=torch.int32, device=wl.device)
    rank[wl.long()] = torch.arange(wl.shape[0], dtype=torch.int32, device=wl.device)
    rank[n] = -1  # sentinel entries all landed here
    return rank


def _launch_tail(starts, degs, col, colors_ext, wl, W: int, per_thread: bool):
    """One K2 launch on the card in the given layout (``serial_tail_rows``
    picks it from ``W``): clears the worklist's colors, builds ``rank`` and
    a zeroed ticket counter, and launches."""
    n = colors_ext.shape[0] - 1
    rank = tail_ranks(wl, n)
    colors_ext.index_fill_(0, wl.long(), 0)  # sentinel entries clear slot n
    ticket = torch.zeros((1,), dtype=torch.int32, device=wl.device)
    lib = _lib()
    rc = lib.repro_serial_tail_csr(
        wl.data_ptr(), starts.data_ptr(), degs.data_ptr(), col.data_ptr(),
        rank.data_ptr(), colors_ext.data_ptr(), ticket.data_ptr(),
        wl.shape[0], int(W), n, int(per_thread), stream(wl.device))
    serial_tail_csr.launches += 1
    check(lib, rc, "serial_tail_csr")
    return colors_ext


def serial_tail_rows(starts, degs, col, colors_ext, wl, W: int):
    """The serial tail as one K2 launch over rows given per worklist entry.

    Entry i of ``wl`` (``order_tail`` order; real ids distinct) reads
    ``col[starts[i] : starts[i] + min(degs[i], W)]``; ``W`` bounds every
    row.  Updates ``colors_ext`` (``n + 1`` slots, slot ``n`` = 0) in place
    and returns it.
    """
    n = colors_ext.shape[0] - 1
    T = wl.shape[0]
    cpu = _on_cpu(starts, degs, col, colors_ext, wl)
    if starts.shape[0] != T or degs.shape[0] != T:
        raise ValueError(f"starts and degs need one entry per worklist entry ({T})")
    if T == 0 or n == 0:
        return colors_ext
    if cpu:
        return serial_tail_rows_ref(starts, degs, col, colors_ext, wl, W)
    check_bitset_width(W)
    return _launch_tail(starts, degs, col, colors_ext, wl, W,
                        per_thread=int(W) <= THREAD_ROW_MAX)


def serial_tail_csr(row_starts, col_padded, deg_ext, colors_ext, wl, W: int):
    """The serial tail fused into one kernel over the CSR arrays.

    ``wl`` arrives in ``order_tail`` order; ``W`` is the full gather width
    (>= every worklist degree).  Updates ``colors_ext`` in place and
    returns it.
    """
    n = row_starts.shape[0] - 1
    cpu = _on_cpu(row_starts, col_padded, deg_ext, colors_ext, wl)
    if wl.shape[0] == 0 or n == 0:
        return colors_ext
    if cpu:
        return serial_tail_csr_ref(row_starts, col_padded, deg_ext, colors_ext,
                                   wl, W)
    if colors_ext.shape[0] != n + 1:
        raise ValueError(
            f"colors_ext has {colors_ext.shape[0]} slots, expected n + 1 = {n + 1}")
    starts = row_starts[wl.clamp(0, max(n - 1, 0))]
    degs = deg_ext[wl.clamp(0, n)]
    return serial_tail_rows(starts, degs, col_padded, colors_ext, wl, W)


serial_tail_csr.launches = 0
