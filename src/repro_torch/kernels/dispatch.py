"""Device and backend resolution for the port's entry points.

The port has one rule where ``repro`` has a policy knob: a kernel wrapper
launches its hand-written CUDA kernel for CUDA tensors and takes its plain
PyTorch version for CPU tensors.  There is no backend that runs the plain
versions on the card, so ``backend=`` only validates the request:

* ``None`` / ``"auto"`` — whatever the device implies;
* ``"cuda"`` — insists on the kernels, and raises for a CPU device.

``device=None`` means ``"cuda"``: entry points run on the card unless the
caller asks for the CPU, and raise when there is no card.
"""
from __future__ import annotations

import torch

__all__ = ["BACKENDS", "resolve_backend"]

BACKENDS = ("auto", "cuda")


def resolve_backend(backend: str | None, device=None) -> torch.device:
    """Validate ``backend=`` against ``device=`` and return the device."""
    if backend not in (None, *BACKENDS):
        raise ValueError(
            f"unknown backend {backend!r}; options: None, {', '.join(BACKENDS)}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev} is neither a CUDA device nor the CPU")
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError(
            f"backend='cuda' runs the CUDA kernels and needs a CUDA device, "
            f"got device={dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev
