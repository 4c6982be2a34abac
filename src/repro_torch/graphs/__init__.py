"""numpy graph generators: a copy of ``repro.graphs``, the Jacobian
(bipartite) patterns included."""
from repro_torch.graphs.generators import (
    erdos_renyi,
    grid2d,
    grid3d,
    honeycomb,
    jacobian_band,
    jacobian_tall_skinny,
    power_law,
    road,
    small_world,
    stencil27,
)
from repro_torch.graphs.rmat import RMAT_ER, RMAT_G, rmat
from repro_torch.graphs.suite import SUITE, build_graph, build_suite, serving_mix

__all__ = [
    "RMAT_ER",
    "RMAT_G",
    "rmat",
    "erdos_renyi",
    "grid2d",
    "grid3d",
    "honeycomb",
    "jacobian_band",
    "jacobian_tall_skinny",
    "power_law",
    "road",
    "small_world",
    "stencil27",
    "SUITE",
    "build_graph",
    "build_suite",
    "serving_mix",
]
