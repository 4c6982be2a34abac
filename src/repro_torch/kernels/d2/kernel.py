"""K6: bitset FirstFit over the union of two neighbour-colour tiles.

Counterpart of ``repro.kernels.d2`` (``d2_firstfit_bitset_tpu``).  The
kernel is hand-written CUDA, ``d2_firstfit_kernel`` in
``repro_torch/csrc/d2_kernels.cu`` (its header says what it replaces, what
bounds it and how its design answers that).  Here:

* ``d2_firstfit`` launches it for CUDA tensors and takes the plain version
  for CPU tensors; nothing else decides the path;
* ``d2_firstfit_ref`` is the plain version;
* ``d2_firstfit.launches`` is raised by one where the kernel launches.

``repro_torch.d2.d2_sgr_step`` calls it in its FirstFit phase when the
hop-1 neighbours are part of the neighbourhood (``include_first_hop``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.firstfit import firstfit_bitset
from repro_torch.kernels import build
from repro_torch.kernels.cuda import check, check_bitset_width, on_cpu, stream

__all__ = ["d2_firstfit", "d2_firstfit_ref"]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("d2_kernels")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.repro_d2_firstfit.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
    lib.repro_d2_firstfit.restype = i32
    return lib


def d2_firstfit_ref(nc1: torch.Tensor, nc2: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: the smallest colour in ``[1, W1+W2+1]`` absent
    from row i of ``nc1`` and row i of ``nc2`` (0 = no colour), as int32
    ``(w,)``.  It concatenates the tiles; the kernel does not."""
    return firstfit_bitset(torch.cat([nc1, nc2], dim=1))


def d2_firstfit(nc1: torch.Tensor, nc2: torch.Tensor) -> torch.Tensor:
    """FirstFit over hop-1 ``(w, W1)`` and hop-2 ``(w, W2)`` colour tiles ->
    colours ``(w,)`` in ``[1, W1+W2+1]``."""
    if nc1.dim() != 2 or nc2.dim() != 2 or nc1.shape[0] != nc2.shape[0]:
        raise ValueError(
            f"nc1 and nc2 must be (w, W1) and (w, W2) tiles, got shapes "
            f"{tuple(nc1.shape)} and {tuple(nc2.shape)}")
    (w, W1), W2 = nc1.shape, nc2.shape[1]
    cpu = on_cpu(nc1, nc2)
    if w == 0:
        return torch.zeros((0,), dtype=torch.int32, device=nc1.device)
    if cpu:
        return d2_firstfit_ref(nc1, nc2)
    check_bitset_width(W1 + W2)
    lib = _lib()
    out = torch.empty((w,), dtype=torch.int32, device=nc1.device)
    rc = lib.repro_d2_firstfit(nc1.data_ptr(), nc2.data_ptr(), out.data_ptr(),
                               w, W1, W2, stream(nc1.device))
    d2_firstfit.launches += 1
    check(lib, rc, "d2_firstfit")
    return out


d2_firstfit.launches = 0
