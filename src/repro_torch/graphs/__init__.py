"""numpy graph generators: a copy of ``repro.graphs`` without the Jacobian
(bipartite) patterns, which arrive with the distance-2 slice (A8)."""
from repro_torch.graphs.generators import (
    erdos_renyi,
    grid2d,
    grid3d,
    honeycomb,
    power_law,
    road,
    small_world,
    stencil27,
)
from repro_torch.graphs.rmat import RMAT_ER, RMAT_G, rmat
from repro_torch.graphs.suite import SUITE, build_graph

__all__ = [
    "RMAT_ER",
    "RMAT_G",
    "rmat",
    "erdos_renyi",
    "grid2d",
    "grid3d",
    "honeycomb",
    "power_law",
    "road",
    "small_world",
    "stencil27",
    "SUITE",
    "build_graph",
]
