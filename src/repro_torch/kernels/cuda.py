"""What the kernel wrappers share: device checks, the stream, launch errors.

A wrapper launches its CUDA kernel for CUDA tensors and takes its plain
version for CPU tensors; ``on_cpu`` decides which, and raises on a mix of
devices or on what the kernels do not take.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["MAX_SMEM", "WARPS_PER_BLOCK", "check", "check_bitset_width", "on_cpu",
           "stream", "tile_shape"]

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


# warps a block of K1, K3, K4 or K6 runs, each with its own FirstFit bitset
WARPS_PER_BLOCK = 8


def check_bitset_width(W: int) -> None:
    """Raise if a block's FirstFit bitsets at width ``W`` pass ``MAX_SMEM``."""
    if WARPS_PER_BLOCK * ((int(W) + 32) // 32) * 4 > MAX_SMEM:
        raise ValueError(
            f"tile width W={W} needs more shared memory for its FirstFit "
            "bitsets than a block has")


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
