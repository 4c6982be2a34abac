"""3-step GM analogue (Grosset et al., the paper's motivating baseline;
port of ``repro.core.threestep``).

The original: (1) partition the graph, (2) color and detect conflicts on
the GPU for a few rounds, (3) ship the remaining conflicts back to the CPU
and fix them serially.  The paper shows it is often slower than pure serial
because of the host round trip and the serialized tail.

The structure is reproduced: ``device_rounds`` topology-driven super-steps
(K4 and K5 over the dense table on the card, ``core.topo``), then a host
serial fix-up of everything still uncolored.  ``result.serial_tail`` counts
the vertices the host fixed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.api import register
from repro_torch.core.coloring import ColoringResult
from repro_torch.core.csr import CSRGraph, DeviceGraph
from repro_torch.core.topo import topo_steps
from repro_torch.kernels.dispatch import resolve_backend

__all__ = ["color_threestep"]


def _serial_fixup(g: CSRGraph, colors: np.ndarray) -> np.ndarray:
    """Greedy-color the uncolored vertices on the host (step 3)."""
    colors = np.concatenate([colors.astype(np.int32), np.zeros(1, np.int32)])
    color_mask = np.full(g.max_degree + 2, -1, dtype=np.int64)
    R, C = g.row_offsets, g.col_indices
    for v in np.nonzero(colors[: g.n] == 0)[0]:
        neigh = C[R[v]: R[v + 1]]
        color_mask[colors[neigh]] = v
        limit = neigh.shape[0] + 2
        free = np.nonzero(color_mask[1:limit] != v)[0]
        colors[v] = free[0] + 1
    return colors[: g.n]


@register("threestep")
def color_threestep(
    g: CSRGraph,
    *,
    device_rounds: int = 2,
    firstfit: str = "scan",
    device=None,
) -> ColoringResult:
    """The 3-step baseline; results, ``serial_tail`` included, equal
    ``repro.core.color_threestep``'s.  ``device`` defaults to ``"cuda"``
    (K4 and K5 for the device rounds); ``device="cpu"`` runs the plain
    versions."""
    device = resolve_backend(None, device)
    n = g.n
    if n == 0:
        return ColoringResult(np.zeros(0, np.int32), 0, 0, 0, True, "threestep_gm")
    colors_ext, iters, _ = topo_steps(DeviceGraph.from_csr(g, device),
                                      device_rounds, heuristic="id",
                                      kind=firstfit)
    colors = colors_ext[:n].cpu().numpy()
    serial_tail = int((colors == 0).sum())
    colors = _serial_fixup(g, colors)
    res = ColoringResult(
        colors,
        iters,
        work_items=iters * n + serial_tail,
        padded_work=iters * n + serial_tail,
        converged=True,
        algorithm="threestep_gm",
    )
    res.serial_tail = serial_tail  # vertices fixed serially on the host
    return res
