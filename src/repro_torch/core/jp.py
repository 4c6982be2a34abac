"""Jones–Plassmann MIS coloring (paper Alg. 3) and the csrcolor multi-hash
MIS (port of ``repro.core.jp``).

These are the quality foils: MIS-based methods assign one fresh color per
independent set, so they need far more colors than greedy (the paper
measures csrcolor at 3.9–31x the serial color count, Fig. 8).

* ``color_jp``        — Alg. 3: per-round hashed priorities, local strict
                        maxima form the independent set, one color a round.
* ``color_multihash`` — the CUSPARSE csrcolor trick: ``nhash`` hash
                        functions a round; the local maxima and minima of
                        each give ``2 * nhash`` independent sets (colors) a
                        round.

``repro`` has no Pallas kernel here, so the rounds are plain torch on both
devices.  Its hash is uint32 arithmetic, which torch lacks (no ``>>`` or
``*`` for ``torch.uint32`` on the CPU): the port computes it in int64 masked
to 32 bits, with each multiplication split so no product leaves int64.
Priorities are then non-negative int64, so comparing them signed is
comparing them unsigned, as ``repro`` does.  A vertex's ``(priority, id)``
pair is folded into one order-preserving int64 key, ``priority << 31 | id``
(ids are below 2^31), so "beats a neighbour, ties broken by id" is one
comparison, and a round pass is one gather of the neighbours' keys through
the dense table plus a row max or min.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import register
from repro_torch.core.coloring import ColoringResult
from repro_torch.core.csr import CSRGraph, DeviceGraph
from repro_torch.kernels.dispatch import resolve_backend

__all__ = ["color_jp", "color_multihash"]

_MASK32 = 0xFFFFFFFF
_KEY_MAX = torch.iinfo(torch.int64).max


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64 ``h`` in ``[0, 2^32)`` and a 32-bit
    constant ``c``; ``c`` is split in 16-bit halves so every product stays
    below 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK32


def _hash32(x: torch.Tensor, salt: int) -> torch.Tensor:
    """``repro``'s murmur3 finalizer on ids, as int64 in ``[0, 2^32)``.

    ``x`` holds the ids as integers; they are taken mod 2^32 first, which is
    ``repro``'s int32 wrap followed by ``astype(uint32)``.
    """
    h = (_mul32(x & _MASK32, 0xCC9E2D51) + (salt & _MASK32)) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _local_extreme(adj_flat: torch.Tensor, width: int, uncol: torch.Tensor,
                   key: torch.Tensor, mode: str) -> torch.Tensor:
    """True where a vertex's key is a strict local max (``mode="max"``) or
    min among its uncolored neighbours.

    Colored neighbours and sentinel lanes (id ``n``) read a key every vertex
    beats (-1 for max, the int64 maximum for min), so they never block, as
    ``repro``'s ``beats | ~uncol_ext[rows]`` has it.
    """
    n = key.shape[0]
    fill = -1 if mode == "max" else _KEY_MAX
    masked = torch.where(uncol, key, fill)
    masked_ext = torch.cat([masked, masked.new_full((1,), fill)])
    neigh = masked_ext.index_select(0, adj_flat).view(n, width)
    if mode == "max":
        return key > neigh.amax(dim=1)
    return key < neigh.amin(dim=1)


def _mis_round(adj_flat, width: int, colors_ext, base_color: int,
               round_idx: int, *, nhash: int, modes):
    """One MIS round: ``nhash`` hashes, an independent set per hash and mode.

    The uncolored set is fixed at the round's start for every hash and mode;
    only ``assigned`` advances.  Updates ``colors_ext`` in place; returns
    ``(colors_ext, uncolored_count, next_color)`` with the count on the
    device.
    """
    n = colors_ext.shape[0] - 1
    ids = torch.arange(n, dtype=torch.int64, device=colors_ext.device)
    uncol = colors_ext[:n] == 0
    new_colors = colors_ext[:n].clone()
    assigned = ~uncol
    color = base_color
    x = ids + round_idx * 7919
    for j in range(nhash):
        pri = _hash32(x, 0x9E3779B9 + 131 * j)
        key = (pri << 31) | ids  # (priority, id), compared in that order
        for mode in modes:
            sel = _local_extreme(adj_flat, width, uncol, key, mode)
            sel = sel & uncol & ~assigned
            new_colors = torch.where(sel, color, new_colors)
            assigned = assigned | sel
            color += 1
    colors_ext[:n] = new_colors
    return colors_ext, (new_colors == 0).sum(), color


def _run_mis(g: CSRGraph, nhash: int, modes: tuple, algorithm: str,
             device) -> ColoringResult:
    device = resolve_backend(None, device)
    n = g.n
    if n == 0:
        return ColoringResult(np.zeros(0, np.int32), 0, 0, 0, True, algorithm)
    dg = DeviceGraph.from_csr(g, device)
    adj_flat = dg.adj.reshape(-1)  # int32 indices, read as they lie
    colors_ext = torch.zeros((n + 1,), dtype=torch.int32, device=device)
    remaining, iters, color = n, 0, 1
    while remaining > 0 and iters < n + 1:
        colors_ext, rem, color = _mis_round(
            adj_flat, dg.D, colors_ext, color, iters, nhash=nhash, modes=modes)
        remaining = int(rem)
        iters += 1
    return ColoringResult(
        colors_ext[:n].cpu().numpy(),
        iters,
        work_items=iters * n,
        padded_work=iters * n,
        converged=remaining == 0,
        algorithm=algorithm,
    )


@register("jp")
def color_jp(g: CSRGraph, *, device=None) -> ColoringResult:
    """Alg. 3: one independent set (local maxima), one color a round.
    ``device`` defaults to ``"cuda"``; ``device="cpu"`` runs on the CPU."""
    return _run_mis(g, nhash=1, modes=("max",), algorithm="jp_mis",
                    device=device)


@register("multihash")
def color_multihash(g: CSRGraph, nhash: int = 2, *, device=None) -> ColoringResult:
    """csrcolor analogue: ``2 * nhash`` independent sets (colors) a round."""
    return _run_mis(g, nhash=nhash, modes=("max", "min"),
                    algorithm=f"multihash_mis_{nhash}", device=device)
