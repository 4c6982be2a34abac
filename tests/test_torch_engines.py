"""The port's classic, padded, fused and chunked engines against repro:
``repro_torch.color(g, device="cpu", ...)`` equals ``repro.color(g, ...)``
(no kernel backend) in every field.

Graphs come from ``repro.graphs`` (SUITE at scale 0.02), the adversarial
shapes of ``tests/test_differential.py``, and a 32,769-vertex star whose
hub's degree overflows the packed gather word; they reach the port through
``CSRGraph.from_numpy``.  The engines are integer-only and deterministic,
so the bar is equality: colors bit for bit, and iterations, work_items,
padded_work, class_cells, converged and algorithm exactly.
"""
import functools

import numpy as np
import pytest

import repro
from repro.core import CSRGraph, csr_from_edges
from repro.graphs import SUITE, build_graph, erdos_renyi

import repro_torch
from repro_torch.core.csr import CSRGraph as TGraph
from repro_torch.core.validate import is_valid_coloring

FIELDS = ("iterations", "work_items", "padded_work", "class_cells", "converged",
          "algorithm")

ENGINES = {
    "classic": dict(engine="classic"),
    "classic-fused": dict(engine="classic", mode="fused"),
    "padded": dict(engine="padded"),
    "padded-fused": dict(engine="padded", mode="fused"),
    "ragged-fused": dict(mode="fused"),
    "ragged-chunked": dict(coarsen_lanes=2048),
}


def _star(n):
    return csr_from_edges(n, np.zeros(n - 1, np.int64),
                          np.arange(1, n, dtype=np.int64))


def _clique(k=9):
    src, dst = np.triu_indices(k, 1)
    return csr_from_edges(k, src, dst)


def _isolated():
    rng = np.random.default_rng(3)
    return csr_from_edges(12, rng.integers(0, 6, 20), rng.integers(0, 6, 20))


def _threshold():
    # disjoint K5 (degree 4) and K9 (degree 8): every vertex sits on an
    # explicit tile threshold (4, 8)
    s5, d5 = np.triu_indices(5, 1)
    s9, d9 = np.triu_indices(9, 1)
    return csr_from_edges(14, np.concatenate([s5, s9 + 5]),
                          np.concatenate([d5, d9 + 5]))


ADVERSARIAL = {
    "empty": lambda: CSRGraph(np.zeros(1, np.int64), np.zeros(0, np.int32)),
    "single": lambda: CSRGraph(np.zeros(2, np.int64), np.zeros(0, np.int32)),
    "star": lambda: _star(9),
    "clique": _clique,
    "isolated": _isolated,
    "threshold": _threshold,
}


@functools.lru_cache(maxsize=None)
def _graph(name: str, scale: float = 0.02):
    if name in ADVERSARIAL:
        return ADVERSARIAL[name]()
    if name == "overflow-star":  # hub degree 2^15 > PACKED_GATHER_MAX_DEG
        return _star(32769)
    if name == "er300":
        return erdos_renyi(300, 5.0, seed=1)
    return build_graph(name, scale)


def _assert_same(g, *args, **opts):
    want = repro.color(g, *args, **opts)
    got = repro_torch.color(TGraph.from_numpy(g.row_offsets, g.col_indices),
                            *args, device="cpu", **opts)
    assert got.colors.dtype == np.int32
    np.testing.assert_array_equal(want.colors, got.colors)
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    if g.n:
        assert is_valid_coloring(TGraph.from_numpy(g.row_offsets, g.col_indices),
                                 got.colors)
    return got


# every SUITE graph once, the engines taken in turn
SUITE_CASES = [(name, list(ENGINES)[i % len(ENGINES)])
               for i, name in enumerate(SUITE)]


@pytest.mark.parametrize("name,engine", SUITE_CASES)
def test_suite_graph_matches_repro(name, engine):
    _assert_same(_graph(name), **ENGINES[engine])


@pytest.mark.parametrize("engine", ["classic", "classic-fused", "padded",
                                    "ragged-fused"])
@pytest.mark.parametrize("name", list(ADVERSARIAL))
def test_adversarial_shape_matches_repro(name, engine):
    _assert_same(_graph(name), **ENGINES[engine])


# option variants on rmat-g at 0.05, which tiles into several degree classes
VARIANTS = {
    "classic-buckets": dict(engine="classic", buckets=(4, 16)),
    "classic-reuse-rows": dict(engine="classic", reuse_rows=True),
    "classic-fused-reuse-rows": dict(engine="classic", mode="fused",
                                     reuse_rows=True),
    "classic-coarsen": dict(engine="classic", coarsen_ff=3, coarsen_cr=2),
    "classic-coarsen-lanes": dict(engine="classic", coarsen_lanes=512),
    "classic-id-sort": dict(engine="classic", heuristic="id", firstfit="sort"),
    "padded-scan": dict(engine="padded", firstfit="scan"),
    "padded-fused-id": dict(engine="padded", mode="fused", heuristic="id"),
    "ragged-fused-chunked": dict(mode="fused", coarsen_lanes=700),
    "ragged-fused-tail-none": dict(mode="fused", tail_serial=None),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_option_variant_matches_repro(variant):
    _assert_same(_graph("rmat-g", 0.05), **VARIANTS[variant])


# the options that raised NotImplementedError (ROADMAP A4) before the
# classic, padded, fused and chunked engines were ported
FORMERLY_UNPORTED = [
    ("engine-padded", (), dict(engine="padded")),
    ("engine-classic", (), dict(engine="classic")),
    ("mode-fused", (), dict(mode="fused")),
    ("coarsen-ff", (), dict(coarsen_ff=2)),
    ("coarsen-cr", (), dict(coarsen_cr=3)),
    ("coarsen-lanes", (), dict(coarsen_lanes=64, heuristic="id")),
    ("algorithm-fused", ("fused",), {}),
]


@pytest.mark.parametrize("args,opts", [c[1:] for c in FORMERLY_UNPORTED],
                         ids=[c[0] for c in FORMERLY_UNPORTED])
def test_a4_option_matches_repro(args, opts):
    _assert_same(_graph("er300"), *args, **opts)


def test_packed_overflow_star_matches_repro():
    """Degrees past the packed word: repro runs its gathered-tile path in
    every class (K3 on the card).  The tail is off so repro's own run stays
    short; the tail over this graph is held by the card test."""
    got = _assert_same(_graph("overflow-star"), tail_serial=None)
    assert got.num_colors == 2


def test_classic_fused_with_buckets_fails_as_in_repro():
    g = _graph("threshold")
    with pytest.raises(AssertionError):
        repro.color(g, engine="classic", mode="fused", buckets=(4,))
    with pytest.raises(ValueError, match="single-class"):
        repro_torch.color(TGraph.from_numpy(g.row_offsets, g.col_indices),
                          device="cpu", engine="classic", mode="fused",
                          buckets=(4,))
