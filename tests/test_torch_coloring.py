"""The port's whole slice against repro: ``repro_torch.color(g, device="cpu")``
equals ``repro.color(g)`` in every field.

Graphs come from ``repro.graphs`` (and the adversarial shapes of
``tests/test_differential.py``) and reach the port through
``CSRGraph.from_numpy``.  The engine is integer-only and deterministic, so
the bar is equality: colors bit for bit, and iterations, work_items,
padded_work, class_cells and converged exactly.
"""
import functools

import numpy as np
import pytest

import repro
from repro.core import CSRGraph, csr_from_edges
from repro.graphs import SUITE, build_graph

import repro_torch
from repro_torch.core.csr import CSRGraph as TGraph
from repro_torch.core.validate import is_valid_coloring
from repro_torch.graphs import build_graph as t_build_graph

SUITE_SCALE = 0.02
FIELDS = ("iterations", "work_items", "padded_work", "class_cells", "converged")


def _star(n=9):
    return csr_from_edges(n, np.zeros(n - 1, np.int64),
                          np.arange(1, n, dtype=np.int64))


def _clique(k=9):
    src, dst = np.triu_indices(k, 1)
    return csr_from_edges(k, src, dst)


def _isolated():
    rng = np.random.default_rng(3)
    return csr_from_edges(12, rng.integers(0, 6, 20), rng.integers(0, 6, 20))


def _threshold():
    # two disjoint cliques K5 (degree 4) and K9 (degree 8): every vertex sits
    # on an explicit tile threshold (4, 8)
    s5, d5 = np.triu_indices(5, 1)
    s9, d9 = np.triu_indices(9, 1)
    return csr_from_edges(14, np.concatenate([s5, s9 + 5]),
                          np.concatenate([d5, d9 + 5]))


ADVERSARIAL = {
    "empty": lambda: CSRGraph(np.zeros(1, np.int64), np.zeros(0, np.int32)),
    "single": lambda: CSRGraph(np.zeros(2, np.int64), np.zeros(0, np.int32)),
    "star": _star,
    "clique": _clique,
    "isolated": _isolated,
    "threshold": _threshold,
}


@functools.lru_cache(maxsize=None)
def _graph(name: str, scale: float = SUITE_SCALE):
    if name in ADVERSARIAL:
        return ADVERSARIAL[name]()
    return build_graph(name, scale)


def _assert_same(g, **opts):
    want = repro.color(g, **opts)
    got = repro_torch.color(TGraph.from_numpy(g.row_offsets, g.col_indices),
                            device="cpu", **opts)
    assert got.colors.dtype == np.int32
    np.testing.assert_array_equal(want.colors, got.colors)
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.algorithm == want.algorithm
    if g.n:
        assert is_valid_coloring(TGraph.from_numpy(g.row_offsets, g.col_indices),
                                 got.colors)
    return got


@pytest.mark.parametrize("name", list(SUITE) + list(ADVERSARIAL))
def test_color_default_matches_repro(name):
    _assert_same(_graph(name))


# option variants, each on graphs that exercise it: rmat-g tiles into three or
# four degree classes, thermal2 stalls into the whole-graph tail, the
# adversarial shapes sit on class boundaries.  Scales keep repro's per-shape
# compiles few where a variant runs many super-steps.
VARIANTS = {
    "heuristic-id": dict(heuristic="id"),
    "tail-none": dict(tail_serial=None),
    "tail-int": dict(tail_serial=64),
    "tiling-none": dict(tiling=None),
    "tiling-tuple": dict(tiling=(8, 32)),
    "buckets": dict(buckets=(4, 8)),
    "firstfit-scan": dict(firstfit="scan"),
}
_SMALL = [("threshold", None), ("star", None)]
_CASES = {
    "heuristic-id": [("rmat-g", 0.032), ("thermal2", 0.02)] + _SMALL,
    "tail-none": [("rmat-er", 0.035)] + _SMALL,
}
CASES = [(name, scale, variant) for variant in VARIANTS
         for name, scale in _CASES.get(
             variant, [("rmat-g", 0.05), ("thermal2", 0.02)] + _SMALL)]


@pytest.mark.parametrize("name,scale,variant", CASES)
def test_color_options_match_repro(name, scale, variant):
    g = _graph(name, scale) if scale else _graph(name)
    _assert_same(g, **VARIANTS[variant])


def test_color_options_object_equals_kwargs():
    ref = _graph("rmat-er")
    g = TGraph.from_numpy(ref.row_offsets, ref.col_indices)
    a = repro_torch.color(g, device="cpu", heuristic="id", tiling=None)
    b = repro_torch.color(g, repro_torch.ColorOptions(
        heuristic="id", extra={"tiling": None, "device": "cpu"}))
    np.testing.assert_array_equal(a.colors, b.colors)
    assert all(getattr(a, f) == getattr(b, f) for f in FIELDS)


@pytest.mark.parametrize("name", sorted(SUITE))
def test_graph_copies_match_repro(name):
    want = build_graph(name, SUITE_SCALE)
    got = t_build_graph(name, SUITE_SCALE)
    np.testing.assert_array_equal(want.row_offsets, got.row_offsets)
    np.testing.assert_array_equal(want.col_indices, got.col_indices)
    assert want.row_offsets.dtype == got.row_offsets.dtype
    assert want.col_indices.dtype == got.col_indices.dtype
