"""K5: the conflict (loser) test over gathered ``(w, W)`` tiles.

Counterpart of ``repro.kernels.conflict`` (``conflict_tpu``).  The kernel
is hand-written CUDA, ``conflict_tile_kernel`` in
``repro_torch/csrc/tile_kernels.cu`` (its header says what it replaces,
what bounds it and how its design answers that).  Here:

* ``conflict_tile`` launches it for CUDA tensors and takes the plain
  version for CPU tensors; nothing else decides the path;
* ``conflict_tile_ref`` is the plain version;
* ``conflict_tile.launches`` is raised by one where the kernel launches.

The classic engine's ``cr_flags`` calls it on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.heuristics import HEURISTICS, conflict_lose_flags
from repro_torch.kernels import build
from repro_torch.kernels.cuda import check, on_cpu, stream, tile_shape

__all__ = ["conflict_tile", "conflict_tile_ref"]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("tile_kernels")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.repro_conflict_tile.argtypes = [ptr] * 7 + [i32] * 3 + [ptr]
    lib.repro_conflict_tile.restype = i32
    return lib


def conflict_tile_ref(ids, nid, my_c, nc, my_d, nd, heuristic: str = "degree"):
    """Plain version of K5: True where row ``i``'s vertex shares its nonzero
    colour with a neighbour that beats it under ``heuristic``."""
    return conflict_lose_flags(ids, nid, my_c, nc, my_d, nd, heuristic)


def conflict_tile(ids, nid, my_c, nc, my_d, nd, heuristic: str = "degree"):
    """Loser flags (bool ``(w,)``) for speculative conflicts.

    ``ids``/``my_c``/``my_d`` are ``(w,)``: each row's vertex, its colour and
    degree; ``nid``/``nc``/``nd`` are ``(w, W)``: its neighbours' ids
    (sentinel in pads), colours (0 in pads) and degrees (0 in pads).
    """
    if heuristic not in HEURISTICS:
        raise ValueError(f"unknown heuristic {heuristic!r}; options: {HEURISTICS}")
    w, W = tile_shape(ids, nid, my_c, nc, my_d, nd)
    cpu = on_cpu(ids, nid, my_c, nc, my_d, nd)
    if w == 0:
        return torch.zeros((0,), dtype=torch.bool, device=ids.device)
    if cpu:
        return conflict_tile_ref(ids, nid, my_c, nc, my_d, nd, heuristic)
    lib = _lib()
    lose = torch.empty((w,), dtype=torch.int32, device=ids.device)
    rc = lib.repro_conflict_tile(
        ids.data_ptr(), my_c.data_ptr(), my_d.data_ptr(), nid.data_ptr(),
        nc.data_ptr(), nd.data_ptr(), lose.data_ptr(), w, W,
        int(heuristic == "degree"), stream(ids.device))
    conflict_tile.launches += 1
    check(lib, rc, "conflict_tile")
    return lose.bool()


conflict_tile.launches = 0
