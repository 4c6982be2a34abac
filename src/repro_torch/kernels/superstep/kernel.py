"""K3: the rotated superstep over gathered ``(w, W)`` tiles.

Counterpart of ``repro.kernels.superstep`` (``superstep_tpu``): the
conflict test, the refit of the lanes a row beats, and FirstFit in one
pass.  The kernel is hand-written CUDA, ``superstep_tile_kernel`` in
``repro_torch/csrc/tile_kernels.cu`` (its header says what it replaces,
what bounds it and how its design answers that).  Here:

* ``superstep_tile`` launches it for CUDA tensors and takes the plain
  version for CPU tensors; nothing else decides the path;
* ``superstep_tile_ref`` is the plain version;
* ``superstep_tile.launches`` is raised by one where the kernel launches.

The engine runs it wherever K1 cannot: the dense ``padded`` provider,
chunked worklists, and degrees past the packed gather word.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.firstfit import firstfit_bitset
from repro_torch.core.heuristics import HEURISTICS, conflict_lose_lanes
from repro_torch.kernels import build
from repro_torch.kernels.cuda import (
    check,
    check_bitset_width,
    on_cpu,
    stream,
    tile_shape,
)

__all__ = ["superstep_tile", "superstep_tile_ref"]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("tile_kernels")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.repro_superstep_tile.argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
    lib.repro_superstep_tile.restype = i32
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


def superstep_tile(ids, nid, my_c, nc, my_d, nd, heuristic: str = "degree"):
    """Fused conflict check + FirstFit over one ``(w, W)`` neighbour tile.

    Arguments as for ``conflict_tile``.  Returns ``(new_colors, need)``:
    int32 and bool ``(w,)``.  Sentinel masking is the caller's job — the
    kernel has no notion of the vertex count, as in ``repro``.
    """
    if heuristic not in HEURISTICS:
        raise ValueError(f"unknown heuristic {heuristic!r}; options: {HEURISTICS}")
    w, W = tile_shape(ids, nid, my_c, nc, my_d, nd)
    cpu = on_cpu(ids, nid, my_c, nc, my_d, nd)
    if w == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=ids.device),
                torch.zeros((0,), dtype=torch.bool, device=ids.device))
    if cpu:
        return superstep_tile_ref(ids, nid, my_c, nc, my_d, nd, heuristic)
    check_bitset_width(W)
    lib = _lib()
    newc = torch.empty((w,), dtype=torch.int32, device=ids.device)
    need = torch.empty((w,), dtype=torch.int32, device=ids.device)
    rc = lib.repro_superstep_tile(
        ids.data_ptr(), my_c.data_ptr(), my_d.data_ptr(), nid.data_ptr(),
        nc.data_ptr(), nd.data_ptr(), newc.data_ptr(), need.data_ptr(), w, W,
        int(heuristic == "degree"), stream(ids.device))
    superstep_tile.launches += 1
    check(lib, rc, "superstep_tile")
    return newc, need.bool()


superstep_tile.launches = 0
