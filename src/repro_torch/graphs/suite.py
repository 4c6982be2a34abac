"""Table-1 stand-in benchmark suite.

A copy of ``repro.graphs.suite``: each UF-collection graph of the paper's
Table 1 is replaced by a generator whose (d̄, σ, topology family) matches the
published statistics.  ``scale`` multiplies the nominal vertex count (the
paper's originals range 0.3M–50M vertices).

name          paper (n, m, d̄, σ)            stand-in
europe.osm    50.9M 108.1M  2.1  0.23       road()            road network
hugebubbles   21.2M  63.6M  3.0  0          honeycomb()       adaptive mesh (deg=3)
rmat-er        1.0M  10.0M 10.0 10.83       rmat(RMAT_ER)     paper's own recipe
rmat-g         1.0M  10.0M 10.0 123.3       rmat(RMAT_G)      paper's own recipe
Hamrle3        1.4M  11.0M  7.6  7.2        small_world(k=8)  circuit sim
thermal2       1.2M   8.6M  7.0  0.7        grid2d(diag)      thermal FEM
atmosmodd      1.3M   8.8M  6.9  0.1        grid3d()          atmosphere stencil
G3_circuit     1.6M   7.7M  4.8  0.4        grid2d()          circuit sim
ASIC_320ks     0.3M   1.8M  5.7 63.2        power_law(5.7)    circuit, skewed
parabolic_fem  0.5M   3.7M  7.0  0.02       grid3d()          FEM stencil
kkt_power      2.1M  14.6M  7.1 54.8        power_law(7.1)    optimization, skewed
nlpkkt160      8.3M 229.5M 27.5  7.3        stencil27()       optimization, dense-ish
cage15         5.2M  99.2M 19.2 32.9        erdos_renyi(19)+  electrophoresis
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.csr import CSRGraph
from repro_torch.graphs import generators as G
from repro_torch.graphs.rmat import RMAT_ER, RMAT_G, rmat

__all__ = ["SUITE", "build_graph", "build_suite", "serving_mix"]

# name -> callable(scale) -> CSRGraph.  Nominal n at scale=1.0 is ~64k-128k
# vertices per graph (the whole suite colors in seconds on one CPU core).
SUITE: dict[str, Callable[[float], CSRGraph]] = {
    "europe.osm": lambda s: G.road(int(131072 * s), shortcut_frac=0.05, seed=1),
    "hugebubbles": lambda s: G.honeycomb(int(256 * s**0.5) or 2, 512),
    "rmat-er": lambda s: rmat(int(65536 * s), 10.0, RMAT_ER, seed=2),
    "rmat-g": lambda s: rmat(int(65536 * s), 10.0, RMAT_G, seed=3),
    "Hamrle3": lambda s: G.small_world(int(98304 * s), k=8, rewire=0.05, seed=4),
    "thermal2": lambda s: G.grid2d(int(256 * s**0.5) or 2, 384, diagonals=True),
    "atmosmodd": lambda s: G.grid3d(int(48 * s ** (1 / 3)) or 2, 48, 48),
    "G3_circuit": lambda s: G.grid2d(int(320 * s**0.5) or 2, 384),
    "ASIC_320ks": lambda s: G.power_law(int(49152 * s), 5.7, seed=5),
    "parabolic_fem": lambda s: G.grid3d(int(40 * s ** (1 / 3)) or 2, 40, 40),
    "kkt_power": lambda s: G.power_law(int(98304 * s), 7.1, seed=6),
    "nlpkkt160": lambda s: G.stencil27(int(32 * s ** (1 / 3)) or 2, 32, 32),
    "cage15": lambda s: G.erdos_renyi(int(65536 * s), 19.2, seed=7),
}


def build_graph(name: str, scale: float = 1.0) -> CSRGraph:
    return SUITE[name](scale)


def build_suite(scale: float = 1.0, names: list[str] | None = None):
    names = names or list(SUITE)
    return {name: build_graph(name, scale) for name in names}


def serving_mix(B: int, scale: float = 1.0) -> list[CSRGraph]:
    """B heterogeneous graphs cycling topology family, size, and density.

    The stand-in for a serving workload (many users, many graph shapes),
    the batched engine's traffic mix.
    """
    gens = [
        lambda i: G.erdos_renyi(int(2000 * scale) + 37 * i, 6.0, seed=i),
        lambda i: G.power_law(int(2500 * scale) + 53 * i, 7.0, seed=i),
        lambda i: G.grid2d(int(30 * max(scale, 0.1)) + i % 7, 40),
        lambda i: G.small_world(int(1800 * scale) + 29 * i, 6, seed=i),
        lambda i: G.road(int(1500 * scale) + 41 * i, seed=i),
    ]
    return [gens[i % len(gens)](i) for i in range(B)]
