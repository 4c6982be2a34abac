"""Distance-2 and bipartite coloring of the PyTorch port against repro.d2.

Graphs come from ``repro.graphs`` (the four ``tests/test_d2.py`` fixtures,
SUITE at scale 0.005, the Jacobian patterns) and reach the port through
their numpy arrays: ``CSRGraph.from_numpy`` and ``BipartiteGraph``'s four
halves.  Everything is integer arithmetic, so the bar is equality: colors
bit for bit, and iterations, work_items, padded_work, class_cells,
converged and algorithm exactly.  K6's plain version is held against
``repro``'s oracle and its Pallas kernel in interpret mode, and
``d2_sgr_step`` against ``repro``'s step by step, with and without its
kernels.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.d2 as R
import repro.d2.coloring as RC
from repro.core import CSRGraph, csr_from_edges
from repro.core.csr import compose_pairs
from repro.graphs import (
    SUITE,
    build_graph,
    erdos_renyi,
    grid2d,
    jacobian_band,
    jacobian_tall_skinny,
    power_law,
    road,
)
from repro.kernels.d2.ops import d2_firstfit_bitset_tpu
from repro.kernels.d2.ref import d2_firstfit_ref as repro_d2_ref

import repro_torch
import repro_torch.core.coloring as TCC
import repro_torch.d2 as T
import repro_torch.d2.coloring as TC
from repro_torch import graphs as tgraphs
from repro_torch.core import csr as tcsr
from repro_torch.errors import NonConvergenceError
from repro_torch.kernels.d2.kernel import d2_firstfit, d2_firstfit_ref

FIELDS = ("iterations", "work_items", "padded_work", "class_cells", "converged",
          "algorithm")

FIXTURES = {
    "er": lambda: erdos_renyi(300, 6.0, seed=0),
    "grid": lambda: grid2d(12, 15),
    "powerlaw": lambda: power_law(300, 5.0, seed=1),
    "road": lambda: road(250, seed=2),
}


@functools.lru_cache(maxsize=None)
def _graph(name: str):
    if name in FIXTURES:
        return FIXTURES[name]()
    if name == "empty":
        return CSRGraph(np.zeros(1, np.int64), np.zeros(0, np.int32))
    if name == "edgeless":
        return csr_from_edges(4, np.zeros(0, int), np.zeros(0, int))
    return build_graph(name, 0.005)


def _tg(g) -> tcsr.CSRGraph:
    return tcsr.CSRGraph.from_numpy(g.row_offsets, g.col_indices)


def _tb(bg) -> T.BipartiteGraph:
    return T.BipartiteGraph(bg.row_offsets, bg.row_to_col, bg.col_offsets,
                            bg.col_to_row)


def _assert_same(a, b):
    np.testing.assert_array_equal(a.colors, b.colors)
    assert b.colors.dtype == np.int32
    for f in FIELDS:
        assert getattr(a, f) == getattr(b, f), (f, getattr(a, f), getattr(b, f))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# host-side two-hop views and generators
# --------------------------------------------------------------------------

@pytest.mark.parametrize("gname", [*FIXTURES, "empty", "edgeless"])
def test_two_hop_views_match_repro(gname):
    g = _graph(gname)
    tg = _tg(g)
    g2, t2 = g.square(), tg.square()
    np.testing.assert_array_equal(g2.row_offsets, t2.row_offsets)
    np.testing.assert_array_equal(g2.col_indices, t2.col_indices)
    assert g.two_hop_degree_bound() == tg.two_hop_degree_bound()
    for got, want in zip(
            tcsr.compose_pairs(g.row_offsets, g.col_indices, g.row_offsets,
                               g.col_indices),
            compose_pairs(g.row_offsets, g.col_indices, g.row_offsets,
                          g.col_indices)):
        np.testing.assert_array_equal(got, want)
    for v in range(min(g.n, 5)):
        np.testing.assert_array_equal(g.neighbors(v), tg.neighbors(v))


def test_jacobian_generators_match_repro():
    pairs = [(jacobian_band(60, band=2), tgraphs.jacobian_band(60, band=2)),
             (jacobian_band(30, band=3, n_cols=25),
              tgraphs.jacobian_band(30, band=3, n_cols=25)),
             (jacobian_tall_skinny(400, 24, nnz_per_row=3, seed=1),
              tgraphs.jacobian_tall_skinny(400, 24, nnz_per_row=3, seed=1))]
    for want, got in pairs:
        assert isinstance(got, T.BipartiteGraph)
        for f in ("row_offsets", "row_to_col", "col_offsets", "col_to_row"):
            np.testing.assert_array_equal(getattr(want, f), getattr(got, f))
        cw, cg = want.column_conflict_graph(), got.column_conflict_graph()
        np.testing.assert_array_equal(cw.row_offsets, cg.row_offsets)
        np.testing.assert_array_equal(cw.col_indices, cg.col_indices)
        assert want.conflict_degree_bound() == got.conflict_degree_bound()
        for a, b in zip(want.padded_halves(), got.padded_halves()):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# color_distance2
# --------------------------------------------------------------------------

D2_CASES = {
    "precomputed": ("er", dict(strategy="precomputed")),
    "onthefly": ("er", dict(strategy="onthefly")),
    "precomputed-fused": ("powerlaw", dict(strategy="precomputed", mode="fused")),
    "onthefly-fused": ("road", dict(strategy="onthefly", mode="fused")),
    "id-precomputed": ("grid", dict(strategy="precomputed", heuristic="id")),
    "id-onthefly": ("grid", dict(strategy="onthefly", heuristic="id")),
    "degree-onthefly": ("road", dict(strategy="onthefly", heuristic="degree")),
    "coarsen-onthefly": ("er", dict(strategy="onthefly", coarsen=4)),
    "coarsen-precomputed": ("er", dict(strategy="precomputed", coarsen=4)),
    "tail-none-onthefly": ("road", dict(strategy="onthefly", tail_serial=None)),
    "tail-none-precomputed": ("grid", dict(strategy="precomputed", tail_serial=None)),
    "tail-16-onthefly": ("grid", dict(strategy="onthefly", tail_serial=16)),
    "tail-16-precomputed": ("road", dict(strategy="precomputed", tail_serial=16)),
    "memory-budget-1": ("grid", dict(memory_budget=1)),
    "untiled": ("powerlaw", dict(strategy="precomputed", tiling=None)),
    "max-iters-2": ("er", dict(strategy="onthefly", max_iters=2)),
    "firstfit-scan": ("road", dict(strategy="onthefly", firstfit="scan")),
    "empty": ("empty", {}),
    "edgeless": ("edgeless", {}),
    "edgeless-onthefly": ("edgeless", dict(strategy="onthefly")),
}


@pytest.mark.parametrize("case", list(D2_CASES))
def test_distance2_matches_repro(case):
    gname, opts = D2_CASES[case]
    g = _graph(gname)
    want = repro.color(g, "distance2", **opts)
    got = repro_torch.color(_tg(g), "distance2", device="cpu", **opts)
    _assert_same(want, got)
    if want.converged and g.n:
        assert T.validate_d2(_tg(g), got.colors)


@pytest.mark.parametrize("name", list(SUITE))
def test_distance2_suite_matches_repro(name):
    """Every SUITE graph at scale 0.005 with the default options (``auto``
    picks ``precomputed`` at this size); the fixtures above cover
    ``onthefly``."""
    g = _graph(name)
    _assert_same(R.color_distance2(g), T.color_distance2(_tg(g), device="cpu"))


def test_composed_tail_in_segments_matches_repro(monkeypatch):
    """The composed-row tail walks the tail in segments of
    ``TAIL_SEGMENT_CELLS // width`` entries; tiny segments (here 3 and 1
    rows) give the same result as repro's one sequential pass."""
    g = _graph("er")
    opts = dict(strategy="onthefly", tail_serial=10**6)  # the whole run is tail
    want = R.color_distance2(g, **opts)
    assert want.class_cells[-1][1] == want.class_cells[-1][0] * g.n
    width = want.class_cells[-1][0]
    for cells in (3 * width + 1, 1):
        monkeypatch.setattr(TCC, "TAIL_SEGMENT_CELLS", cells)
        _assert_same(want, T.color_distance2(_tg(g), device="cpu", **opts))


@pytest.mark.parametrize("gname", ["er", "grid"])
def test_two_hop_rows_match_repro(gname):
    g = _graph(gname)
    adj = g.padded_adjacency()
    ids = np.concatenate([np.arange(0, g.n, 7), [g.n, g.n]]).astype(np.int32)
    want = RC.TwoHopRows(jnp.asarray(adj), jnp.asarray(adj)).rows(jnp.asarray(ids))
    prov = TC.TwoHopRows(_t(adj), _t(adj))
    got = prov.rows(_t(ids))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert prov.width == got.shape[1] and prov.device == torch.device("cpu")
    np.testing.assert_array_equal(np.asarray(want)[1], prov.row1(ids[1]).numpy())
    bg = jacobian_tall_skinny(200, 16, nnz_per_row=4, seed=3)
    c2r, r2c = bg.padded_halves()
    ids = np.array([0, 3, 15, 16, 16], np.int32)
    want = RC.TwoHopRows(jnp.asarray(c2r), jnp.asarray(r2c), False).rows(
        jnp.asarray(ids))
    got = TC.TwoHopRows(_t(c2r), _t(r2c), False).rows(_t(ids))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_d2_strategy_resolution_matches_repro():
    for gname in FIXTURES:
        g = _graph(gname)
        for budget in (1, 10**5, RC.DEFAULT_D2_BUDGET):
            assert (RC.resolve_d2_strategy(g, "auto", budget)
                    == TC.resolve_d2_strategy(_tg(g), "auto", budget))
    assert TC.DEFAULT_D2_BUDGET == RC.DEFAULT_D2_BUDGET
    with pytest.raises(ValueError, match="unknown strategy"):
        T.color_distance2(_tg(_graph("er")), strategy="square", device="cpu")


# --------------------------------------------------------------------------
# bipartite and Jacobian compression
# --------------------------------------------------------------------------

BIPARTITE = {
    "band1": lambda: jacobian_band(60, band=1),
    "band2": lambda: jacobian_band(60, band=2),
    "band3": lambda: jacobian_band(60, band=3),
    "tall-skinny": lambda: jacobian_tall_skinny(400, 24, nnz_per_row=3, seed=1),
    # repro's on-the-fly gather cannot index an empty row side
    "no-rows": lambda: R.BipartiteGraph.from_coo(0, 5, np.zeros(0, int),
                                                 np.zeros(0, int)),
    "empty": lambda: R.BipartiteGraph.from_coo(0, 0, np.zeros(0, int),
                                               np.zeros(0, int)),
}
BIPARTITE_CASES = [(name, s) for name in BIPARTITE
                   for s in ("precomputed", "onthefly")
                   if (name, s) != ("no-rows", "onthefly")]


@pytest.mark.parametrize("name,strategy", BIPARTITE_CASES)
def test_bipartite_matches_repro(name, strategy):
    bg = BIPARTITE[name]()
    want = repro.color(bg, "bipartite", strategy=strategy)
    got = repro_torch.color(_tb(bg), "bipartite", strategy=strategy, device="cpu")
    _assert_same(want, got)
    if name.startswith("band"):
        assert got.num_colors == 2 * int(name[-1]) + 1
    if bg.n_cols:
        assert T.validate_bipartite(_tb(bg), got.colors)


def test_bipartite_without_rows_on_the_fly():
    """No row side at all: every column is alone, so both strategies give
    every column color 1 (``repro``'s on-the-fly gather cannot index the
    empty row side, so the port's precomputed run is the reference)."""
    bg = _tb(BIPARTITE["no-rows"]())
    fly = T.color_bipartite(bg, strategy="onthefly", device="cpu")
    _assert_same(T.color_bipartite(bg, strategy="precomputed", device="cpu"), fly)
    assert (fly.colors == 1).all()


def test_bipartite_options_match_repro():
    bg = jacobian_tall_skinny(400, 24, nnz_per_row=3, seed=1)
    for opts in (dict(mode="fused"), dict(heuristic="id", coarsen=3,
                                          strategy="onthefly"),
                 dict(tail_serial=None, strategy="precomputed"),
                 dict(memory_budget=1)):
        _assert_same(R.color_bipartite(bg, **opts),
                     T.color_bipartite(_tb(bg), device="cpu", **opts))


def test_compress_jacobian_pattern_matches_repro():
    bg = jacobian_band(50, band=2)
    want = R.compress_jacobian_pattern(bg)
    got = T.compress_jacobian_pattern(_tb(bg), device="cpu")
    assert got.num_groups == want.num_groups == 5
    for a, b in zip(want.groups, got.groups):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(want.seed_matrix(), got.seed_matrix())
    _assert_same(want.coloring, got.coloring)
    pattern = np.array([[1, 1, 0, 0], [0, 1, 1, 0], [0, 0, 1, 1]], bool)
    rows, cols = np.nonzero(pattern)
    for spelling in (pattern, (3, 4, rows, cols)):
        want = R.compress_jacobian_pattern(spelling)
        got = T.compress_jacobian_pattern(spelling, device="cpu")
        assert got.num_groups == want.num_groups == 2
        np.testing.assert_array_equal(want.coloring.colors, got.coloring.colors)
        np.testing.assert_array_equal(want.seed_matrix(), got.seed_matrix())


def test_compress_unconverged_raises():
    bg = _tb(jacobian_band(40, band=2))
    with pytest.raises(NonConvergenceError, match="did not converge"):
        T.compress_jacobian_pattern(bg, max_iters=1, on_fail="raise",
                                    device="cpu")
    # on_fail="ladder" (the default) is ported: the starved run is repaired
    # through the guarantee ladder, as in repro
    want = R.compress_jacobian_pattern(jacobian_band(40, band=2), max_iters=1)
    got = T.compress_jacobian_pattern(bg, max_iters=1, device="cpu")
    assert T.validate_bipartite(bg, got.coloring.colors)
    assert got.coloring.degradations == want.coloring.degradations
    assert any(d["stage"] == "ladder" for d in got.coloring.degradations)
    np.testing.assert_array_equal(want.seed_matrix(), got.seed_matrix())
    with pytest.raises(ValueError, match="unknown on_fail"):
        T.compress_jacobian_pattern(bg, on_fail="retry", device="cpu")
    assert issubclass(NonConvergenceError, (RuntimeError, ValueError))


# --------------------------------------------------------------------------
# K6 and the classic two-hop super-step
# --------------------------------------------------------------------------

def _d2_tiles(w, W1, W2, seed):
    """Random hop-1 / hop-2 colour tiles with zeros, colours past the bound,
    and (for W1 + W2 >= 32) rows holding every colour 1..W1+W2."""
    rng = np.random.default_rng(seed)
    hi = W1 + W2 + 3
    nc1 = rng.integers(0, hi, (w, W1)).astype(np.int32)
    nc2 = rng.integers(0, hi, (w, W2)).astype(np.int32)
    if W1 + W2 >= 32:
        for i in range(min(w, 4)):
            perm = rng.permutation(W1 + W2) + 1
            nc1[i], nc2[i] = perm[:W1], perm[W1:]
    return nc1, nc2


@pytest.mark.parametrize("w,W1,W2", [(0, 4, 16), (7, 3, 9), (64, 1, 31),
                                     (40, 8, 64), (33, 26, 40), (9, 33, 130)])
def test_k6_plain_matches_repro(w, W1, W2):
    nc1, nc2 = _d2_tiles(w, W1, W2, seed=w + W1 + W2)
    want = np.asarray(repro_d2_ref(jnp.asarray(nc1), jnp.asarray(nc2)))
    if w:
        np.testing.assert_array_equal(want, np.asarray(d2_firstfit_bitset_tpu(
            jnp.asarray(nc1), jnp.asarray(nc2), interpret=True)))
    d2_firstfit.launches = 0
    got = d2_firstfit(_t(nc1), _t(nc2))
    assert got.dtype == torch.int32 and got.shape == (w,)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(want, d2_firstfit_ref(_t(nc1), _t(nc2)).numpy())
    assert d2_firstfit.launches == 0
    if w and W1 + W2 >= 32:
        assert (got[:4] == W1 + W2 + 1).all()


def test_k6_wrapper_checks_shapes():
    with pytest.raises(ValueError, match=r"\(w, W1\)"):
        d2_firstfit(torch.zeros((4, 2), dtype=torch.int32),
                    torch.zeros((5, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(w, W1\)"):
        d2_firstfit(torch.zeros(4, dtype=torch.int32),
                    torch.zeros((4, 2), dtype=torch.int32))


def _step_inputs(kind: str):
    """``(adj_a, adj_b, deg_ext, n)`` for a distance-2 graph or the column
    side of a Jacobian pattern."""
    if kind == "d2":
        g = erdos_renyi(120, 4.0, seed=3)
        adj = g.padded_adjacency()
        return adj, adj, np.concatenate([g.degrees, [0]]).astype(np.int32), g.n
    bg = jacobian_tall_skinny(300, 40, nnz_per_row=4, seed=2)
    c2r, r2c = bg.padded_halves()
    deg = np.concatenate([bg.col_degrees, [0]]).astype(np.int32)
    return c2r, r2c, deg, bg.n_cols


@pytest.mark.parametrize("use_kernel", [False, True], ids=["jax", "pallas"])
@pytest.mark.parametrize("coarsen", [1, 3])
@pytest.mark.parametrize("include_first_hop", [True, False], ids=["d2", "bipartite"])
def test_d2_sgr_step_matches_repro_step_by_step(include_first_hop, coarsen,
                                                use_kernel):
    adj_a, adj_b, deg, n = _step_inputs("d2" if include_first_hop else "bip")
    opts = dict(heuristic="degree", kind="bitset",
                include_first_hop=include_first_hop, coarsen=coarsen)
    wl = np.concatenate([np.arange(n), np.full(5, n)]).astype(np.int32)
    colors = np.zeros(n + 1, np.int32)
    j = (jnp.asarray(colors), jnp.asarray(wl))
    t = (_t(colors), _t(wl))
    count, steps = n, 0
    while count and steps < 6:
        jc, jwl, jcount = R.d2_sgr_step(jnp.asarray(adj_a), jnp.asarray(adj_b),
                                        jnp.asarray(deg), *j,
                                        use_kernel=use_kernel, **opts)
        tc, twl, tcount = T.d2_sgr_step(_t(adj_a), _t(adj_b), _t(deg), *t, **opts)
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        np.testing.assert_array_equal(np.asarray(jwl), twl.numpy())
        assert int(jcount) == int(tcount)
        count, steps = int(tcount), steps + 1
        j, t = (jc, jwl), (tc, twl)
    assert count < n


def test_d2_sgr_step_with_id_rule_and_scan_matches_repro():
    adj_a, adj_b, deg, n = _step_inputs("d2")
    wl = np.arange(n, dtype=np.int32)
    want = R.d2_sgr_step(jnp.asarray(adj_a), jnp.asarray(adj_b), jnp.asarray(deg),
                         jnp.zeros(n + 1, jnp.int32), jnp.asarray(wl),
                         heuristic="id", kind="scan")
    got = T.d2_sgr_step(_t(adj_a), _t(adj_b), _t(deg),
                        torch.zeros(n + 1, dtype=torch.int32), _t(wl),
                        heuristic="id", kind="scan")
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# --------------------------------------------------------------------------
# oracles, validators, the public surface
# --------------------------------------------------------------------------

@pytest.mark.parametrize("gname", list(FIXTURES))
def test_serial_oracles_and_validators_match_repro(gname):
    g, tg = _graph(gname), _tg(_graph(gname))
    for order in ("natural", "largest_degree_first"):
        want = R.greedy_serial_d2(g, order=order)
        got = T.greedy_serial_d2(tg, order=order)
        np.testing.assert_array_equal(want, got)
        assert T.validate_d2(tg, got) and R.validate_d2(g, got)
    d1 = repro.color(g).colors  # distance-1 colors: rarely distance-2 valid
    assert T.validate_d2(tg, d1) == R.validate_d2(g, d1)
    bad = want.copy()
    bad[0] = 0
    assert not T.validate_d2(tg, bad) and not R.validate_d2(g, bad)


def test_bipartite_oracle_and_validator_match_repro():
    bg = jacobian_tall_skinny(200, 16, nnz_per_row=4, seed=3)
    tb = _tb(bg)
    for order in ("natural", "largest_degree_first"):
        want = R.greedy_serial_bipartite(bg, order=order)
        np.testing.assert_array_equal(want, T.greedy_serial_bipartite(tb, order=order))
        assert T.validate_bipartite(tb, want)
    ones = np.ones(bg.n_cols, np.int32)
    assert T.validate_bipartite(tb, ones) == R.validate_bipartite(bg, ones) is False


def test_distance2_surface():
    assert {"distance2", "bipartite"} <= set(repro_torch.algorithms())
    assert repro_torch.get_algorithm("distance2") is T.color_distance2
    assert repro_torch.get_algorithm("bipartite") is T.color_bipartite
    g = _tg(_graph("er"))
    for opts, err, match in (
            (dict(engine="sharded", coarsen=2), ValueError, "coarsen=1"),
            (dict(engine="padded"), ValueError, "unknown engine"),
            (dict(backend="cuda"), ValueError, "needs a CUDA device"),
            (dict(mode="eager"), ValueError, "unknown mode")):
        with pytest.raises(err, match=match):
            repro_torch.color(g, "distance2", device="cpu", **opts)
    # engine="sharded" is ported (ROADMAP A11): one device runs the fused call
    sh = repro_torch.color(g, "distance2", device="cpu", engine="sharded")
    fused = repro_torch.color(g, "distance2", device="cpu", mode="fused")
    np.testing.assert_array_equal(sh.colors, fused.colors)
    assert (sh.padded_work, sh.work_items) == (fused.padded_work, fused.work_items)
    for backend in (None, "auto"):
        assert repro_torch.color(g, "distance2", device="cpu",
                                 backend=backend).converged
    # trace= is ported (ROADMAP A6): the rows equal repro's
    traced = repro_torch.color(g, "distance2", device="cpu", trace=True)
    want = R.color_distance2(_graph("er"), trace=True)
    np.testing.assert_array_equal(want.trace.steps, traced.trace.steps)
    assert traced.trace.check(traced) == []
