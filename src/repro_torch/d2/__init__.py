"""Distance-2 and bipartite partial coloring (port of ``repro.d2``).

* ``color_distance2``    — distance-2 coloring of a ``CSRGraph``
                           (registered as ``"distance2"``)
* ``color_bipartite``    — partial coloring of one side of a
                           ``BipartiteGraph`` (registered as ``"bipartite"``)
* ``compress_jacobian_pattern`` — structurally-orthogonal column groups
                           and the seed matrix of a Jacobian pattern
* ``d2_sgr_step``        — the classic two-hop super-step (K6 on the card)
* ``greedy_serial_d2`` / ``greedy_serial_bipartite`` — quality oracles
* ``validate_d2`` / ``validate_bipartite`` — exact host-side validity checks
"""
from repro_torch.d2.bipartite import (
    BipartiteGraph,
    CompressionResult,
    color_bipartite,
    compress_jacobian_pattern,
)
from repro_torch.d2.coloring import color_distance2, d2_sgr_step
from repro_torch.d2.serial import greedy_serial_bipartite, greedy_serial_d2
from repro_torch.d2.validate import validate_bipartite, validate_d2

__all__ = [
    "BipartiteGraph",
    "CompressionResult",
    "color_bipartite",
    "color_distance2",
    "compress_jacobian_pattern",
    "d2_sgr_step",
    "greedy_serial_bipartite",
    "greedy_serial_d2",
    "validate_bipartite",
    "validate_d2",
]
