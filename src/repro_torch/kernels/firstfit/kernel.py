"""K4: bitset FirstFit over a gathered ``(w, W)`` neighbour-colour tile.

Counterpart of ``repro.kernels.firstfit`` (``firstfit_bitset_tpu``).  The
kernel is hand-written CUDA, ``firstfit_tile_kernel`` in
``repro_torch/csrc/tile_kernels.cu`` (its header says what it replaces,
what bounds it and how its design answers that).  Here:

* ``firstfit_tile`` launches it for a CUDA tensor and takes the plain
  version for a CPU tensor; nothing else decides the path;
* ``firstfit_tile_ref`` is the plain version;
* ``firstfit_tile.launches`` is raised by one where the kernel launches.

The classic engine's ``ff_apply`` calls it on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.firstfit import firstfit_bitset
from repro_torch.kernels import build
from repro_torch.kernels.cuda import check, check_bitset_width, on_cpu, stream

__all__ = ["firstfit_tile", "firstfit_tile_ref"]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("tile_kernels")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.repro_firstfit_tile.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.repro_firstfit_tile.restype = i32
    return lib


def firstfit_tile_ref(nc: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: the smallest colour in ``[1, W+1]`` absent from
    each row of ``nc`` (0 = no colour), as int32 ``(w,)``."""
    return firstfit_bitset(nc)


def firstfit_tile(nc: torch.Tensor) -> torch.Tensor:
    """FirstFit over padded neighbour colours ``(w, W)`` -> colours ``(w,)``."""
    if nc.dim() != 2:
        raise ValueError(f"nc must be a (w, W) tile, got shape {tuple(nc.shape)}")
    w, W = nc.shape
    cpu = on_cpu(nc)
    if w == 0:
        return torch.zeros((0,), dtype=torch.int32, device=nc.device)
    if cpu:
        return firstfit_tile_ref(nc)
    check_bitset_width(W)
    lib = _lib()
    out = torch.empty((w,), dtype=torch.int32, device=nc.device)
    rc = lib.repro_firstfit_tile(nc.data_ptr(), out.data_ptr(), w, W,
                                 stream(nc.device))
    firstfit_tile.launches += 1
    check(lib, rc, "firstfit_tile")
    return out


firstfit_tile.launches = 0
