"""Streaming sessions of the port (``repro_torch.dynamic``) against
``repro.dynamic``.

Mirrors ``tests/test_dynamic.py`` on the same inputs, the port's session or
overlay beside ``repro``'s: every round's ``ColoringResult`` field for
field, ``frontier()``, ``pending_dirty``, ``metrics()`` and trace rows
equal, the overlay's graph equal after every mutation.  Adds
``colors_init=`` on its own, ``SessionBatch`` sweeps, the ladder's
``degradations`` and the options path.
"""
import numpy as np
import pytest
import torch

import repro
import repro.core.coloring as rcoloring
from repro import api as rapi
from repro.core import open_session_batch as r_open_session_batch
from repro.core.csr import DeviceCSR as RDeviceCSR
from repro.dynamic import DeltaCSR as RDelta
from repro.dynamic import churn_delta as r_churn
from repro.dynamic import open_session as r_open
from repro.graphs import build_graph, erdos_renyi, grid2d, power_law

import repro_torch
import repro_torch.core.coloring as tcoloring
from repro_torch import api
from repro_torch.core import (
    CSRGraph,
    SessionBatch,
    color_data_driven,
    is_valid_coloring,
    open_session_batch,
)
from repro_torch.core.csr import DeviceCSR, csr_from_edges
from repro_torch.core.serial import color_serial
from repro_torch.dynamic import (
    ColoringSession,
    DeltaCSR,
    churn_delta,
    open_session,
)
from repro_torch.errors import NonConvergenceError
from repro_torch.options import ColorOptions

FIELDS = ("iterations", "work_items", "padded_work", "class_cells", "converged",
          "algorithm", "degradations")


def _tg(g) -> CSRGraph:
    return CSRGraph.from_numpy(g.row_offsets, g.col_indices)


def _same_graph(want, got):
    np.testing.assert_array_equal(want.row_offsets, got.row_offsets)
    np.testing.assert_array_equal(want.col_indices, got.col_indices)


def _assert_same(want, got):
    np.testing.assert_array_equal(want.colors, got.colors)
    for f in FIELDS:
        assert getattr(want, f) == getattr(got, f), f
    if want.trace is not None:
        np.testing.assert_array_equal(want.trace.steps, got.trace.steps)
        assert want.trace.iterations == got.trace.iterations
        assert want.trace.engine == got.trace.engine


class Twin:
    """A ``repro`` session and a port session on the CPU, driven in step."""

    def __init__(self, g, **opts):
        self.ref = r_open(g, **opts)
        self.port = open_session(_tg(g), device="cpu", **opts)
        self.check(self.ref.result, self.port.result)

    def check(self, want, got):
        _assert_same(want, got)
        np.testing.assert_array_equal(self.ref.frontier(), self.port.frontier())
        assert self.ref.pending_dirty == self.port.pending_dirty
        assert self.ref.metrics() == self.port.metrics()
        _same_graph(self.ref.graph, self.port.graph)

    def apply(self, **delta):
        want = self.ref.apply_delta(**delta)
        got = self.port.apply_delta(**delta)
        np.testing.assert_array_equal(want, got)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(self.ref.frontier(), self.port.frontier())
        assert self.ref.pending_dirty == self.port.pending_dirty
        return got

    def recolor(self, **kw):
        want = self.ref.recolor(**kw)
        got = self.port.recolor(**kw)
        self.check(want, got)
        return got

    def churn(self, frac, rng):
        rem, add = r_churn(self.ref.graph, frac, rng)
        self.apply(remove_edges=rem, add_edges=add)
        return rem, add


# --------------------------------------------------------------------------
# DeltaCSR: overlay semantics against repro's and a rebuilt-from-scratch CSR
# --------------------------------------------------------------------------


def _ref_apply(edges: set, op: str, a, b):
    for x, y in zip(np.atleast_1d(a), np.atleast_1d(b)):
        x, y = int(x), int(y)
        if x == y:
            continue
        if op == "add":
            edges.add((min(x, y), max(x, y)))
        else:
            edges.discard((min(x, y), max(x, y)))


def _ref_graph(n: int, edges: set):
    if not edges:
        return csr_from_edges(n, np.zeros(0, np.int64), np.zeros(0, np.int64))
    arr = np.array(sorted(edges), dtype=np.int64)
    return csr_from_edges(n, arr[:, 0], arr[:, 1])


def _both(method, *args):
    """Call ``method`` on both overlays; the dirtied ids must agree."""
    want = getattr(_both.ref, method)(*args)
    got = getattr(_both.port, method)(*args)
    np.testing.assert_array_equal(want, got)
    assert want.dtype == got.dtype
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delta_random_sequence_matches_scratch_rebuild(seed):
    g0 = erdos_renyi(300, 5.0, seed=seed)
    _both.ref = RDelta(g0, compact_frac=0.2)
    _both.port = d = DeltaCSR(_tg(g0), compact_frac=0.2)
    src, dst = g0.edges()
    und = src < dst
    ref = set(zip(src[und].tolist(), dst[und].tolist()))
    rng = np.random.default_rng(seed + 100)
    for step in range(30):
        k = int(rng.integers(1, 20))
        if rng.random() < 0.5:
            a = rng.integers(0, d.n, k)
            b = rng.integers(0, d.n, k)
            _both("add_edges", a, b)
            _ref_apply(ref, "add", a, b)
        else:
            cs, cd = d.graph().edges()
            if cs.size:
                pick = rng.integers(0, cs.size, k)
                a, b = cs[pick], cd[pick]
            else:
                a = rng.integers(0, d.n, k)
                b = rng.integers(0, d.n, k)
            _both("remove_edges", a, b)
            _ref_apply(ref, "del", a, b)
        assert (d.overlay_size, d.compactions, d.m) == (
            _both.ref.overlay_size, _both.ref.compactions, _both.ref.m)
        if step % 7 == 3:
            _same_graph(_ref_graph(d.n, ref), d.graph())
            _same_graph(_both.ref.graph(), d.graph())
    gc = d.compact()
    _same_graph(_ref_graph(d.n, ref), gc)
    np.testing.assert_array_equal(gc.degrees, _ref_graph(d.n, ref).degrees)
    assert d.overlay_size == 0


def test_delta_noop_mutations_dirty_nothing():
    g = grid2d(6, 6)
    d = DeltaCSR(_tg(g))
    src, dst = g.edges()
    assert d.add_edges(src[:5], dst[:5]).size == 0
    assert d.remove_edges([0, 1], [35, 30]).size == 0
    assert d.overlay_size == 0
    np.testing.assert_array_equal(d.graph().col_indices, g.col_indices)
    assert d.add_edges([3, 3], [3, 3]).size == 0
    with pytest.raises(ValueError, match="out of range"):
        d.add_edges([0], [36])
    with pytest.raises(ValueError, match="differ in length"):
        d.add_edges([0, 1], [2])


def test_delta_add_remove_roundtrip_restores_graph():
    g = erdos_renyi(120, 4.0, seed=9)
    d = DeltaCSR(_tg(g))
    assert set(d.add_edges([0, 1], [50, 60]).tolist()) == {0, 1, 50, 60}
    assert set(d.remove_edges([0, 1], [50, 60]).tolist()) == {0, 1, 50, 60}
    _same_graph(g, d.compact())


def test_delta_vertex_semantics():
    g = grid2d(5, 5)
    _both.ref, _both.port = RDelta(g), DeltaCSR(_tg(g))
    d = _both.port
    np.testing.assert_array_equal(_both("add_vertices", 3), [25, 26, 27])
    assert d.n == 28 and d.graph().n == 28
    _both("add_edges", [25, 26], [0, 25])
    assert d.graph().degrees[25] == 2
    touched = _both("remove_vertices", [25])
    assert {25, 0, 26} <= set(touched.tolist())
    assert d.n == 28 and d.graph().degrees[25] == 0
    assert d.graph().degrees[0] == g.degrees[0]
    assert _both("remove_vertices", [25]).size == 0
    touched = _both("remove_vertices", [26, 27, 0])
    assert 27 not in touched and 26 not in touched and 0 in touched
    _same_graph(_both.ref.graph(), d.graph())


def test_delta_auto_compaction_preserves_graph():
    g = erdos_renyi(150, 4.0, seed=3)
    _both.ref, _both.port = RDelta(g, compact_frac=0.01), DeltaCSR(
        _tg(g), compact_frac=0.01)
    d2 = DeltaCSR(_tg(g), compact_frac=1e9)
    rng = np.random.default_rng(5)
    for _ in range(10):
        a, b = rng.integers(0, 150, 30), rng.integers(0, 150, 30)
        _both("add_edges", a, b)
        d2.add_edges(a, b)
    assert _both.port.compactions == _both.ref.compactions > 0
    assert d2.compactions == 0
    np.testing.assert_array_equal(_both.port.graph().col_indices,
                                  d2.graph().col_indices)


def test_delta_state_arrays_round_trip_through_repro():
    g = erdos_renyi(100, 4.0, seed=4)
    d = DeltaCSR(_tg(g))
    d.add_edges([0, 1, 2], [50, 60, 70])
    d.remove_vertices([3])
    d.add_vertices(2)
    state = d.state_arrays()
    want = RDelta(g)
    want.add_edges([0, 1, 2], [50, 60, 70])
    want.remove_vertices([3])
    want.add_vertices(2)
    for k, v in want.state_arrays().items():
        np.testing.assert_array_equal(v, state[k])
        assert np.asarray(v).dtype == np.asarray(state[k]).dtype
    back = DeltaCSR.from_state(state, compactions=4)
    _same_graph(want.graph(), back.graph())
    assert back.compactions == 4 and back.n == 102


def test_delta_validate_input():
    bad = CSRGraph(np.array([0, 1, 1, 1], np.int64), np.array([1], np.int32))
    d = DeltaCSR(bad, validate_input="repair")
    want = RDelta(repro.core.CSRGraph(bad.row_offsets, bad.col_indices),
                  validate_input="repair")
    assert d.ingest_report.repairs == want.ingest_report.repairs
    _same_graph(want.graph(), d.graph())
    with pytest.raises(ValueError):
        DeltaCSR(bad, validate_input="strict")


# --------------------------------------------------------------------------
# colors_init= on its own
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fused", "workefficient"])
def test_colors_init_warm_start_matches_repro(mode):
    """A warm start over a padded frontier with true class counts, a stall
    kept to the live worklist: every field and trace row as repro's."""
    g = grid2d(12, 12)
    rng = np.random.default_rng(3)
    colors = np.concatenate([rng.integers(1, 4, g.n), [0]]).astype(np.int32)
    frontier = np.sort(rng.choice(g.n, 40, replace=False)).astype(np.int32)
    colors[frontier] = 0
    wl = np.concatenate([frontier, np.full(24, g.n, np.int32)])
    kw = dict(n=g.n, classes=[wl], tile_widths=[8], acc_widths=[8],
              tail_width=8, mode=mode, tail_enabled=True, tail_threshold=4,
              max_iters=g.n + 1, stall_serializes_all=False, class_counts=[40],
              trace=True)
    rd = RDeviceCSR.from_csr(g)
    td = DeviceCSR.from_csr(_tg(g), "cpu")
    want = rcoloring.run_ragged_engine(provider=rd, deg_ext=rd.deg_ext,
                                       colors_init=colors, **kw)
    got = tcoloring.run_ragged_engine(provider=td, deg_ext=td.deg_ext,
                                      colors_init=colors, **kw)
    _assert_same(want, got)
    assert got.iterations > 0 and got.work_items >= 40
    fixed = np.setdiff1d(np.arange(g.n), frontier)
    # the frontier may conflict with nothing outside: the fixed part stays
    np.testing.assert_array_equal(got.colors[fixed], colors[fixed])


# --------------------------------------------------------------------------
# ColoringSession
# --------------------------------------------------------------------------


def test_churn_delta_matches_repro():
    g = erdos_renyi(300, 5.0, seed=5)
    want = r_churn(g, 0.03, np.random.default_rng(14))
    got = churn_delta(_tg(g), 0.03, np.random.default_rng(14))
    for w, t in zip(want, got):
        for a, b in zip(w, t):
            np.testing.assert_array_equal(a, b)


def test_open_session_from_coo_and_graph():
    g = erdos_renyi(200, 5.0, seed=1)
    src, dst = g.edges()
    s1 = open_session(src, dst, n=g.n, device="cpu")
    s2 = open_session(_tg(g), device="cpu")
    np.testing.assert_array_equal(s1.colors, s2.colors)
    np.testing.assert_array_equal(s1.colors, r_open(src, dst, n=g.n).colors)
    assert s1.validate() and s2.validate()
    with pytest.raises(ValueError, match="max endpoint"):
        open_session([0, 5], [1, 2], n=3, device="cpu")
    with pytest.raises(TypeError, match="CSRGraph"):
        open_session("nope", device="cpu")


def test_cold_session_matches_fused_ragged():
    g = power_law(600, 6.0, seed=7)
    t = Twin(g)
    ref = color_data_driven(_tg(g), mode="fused", engine="ragged", device="cpu")
    np.testing.assert_array_equal(t.port.colors, ref.colors)


def test_empty_delta_recolor_is_bit_identical_noop():
    g = erdos_renyi(300, 5.0, seed=2)
    t = Twin(g, trace=True)
    before = t.port.colors.copy()
    r = t.recolor()
    np.testing.assert_array_equal(r.colors, before)
    assert (r.work_items, r.padded_work, r.iterations) == (0, 0, 0)
    assert r.converged and r.trace.iterations == 0
    src, dst = g.edges()
    t.apply(add_edges=(src[:3], dst[:3]))
    assert t.port.frontier().size == 0
    assert t.recolor().work_items == 0


@pytest.mark.parametrize("mode", ["fused", "workefficient"])
def test_recolor_after_churn_is_valid(mode):
    g = erdos_renyi(800, 6.0, seed=4)
    t = Twin(g, mode=mode, trace=True)
    rng = np.random.default_rng(11)
    for _ in range(3):
        t.churn(0.02, rng)
        r = t.recolor()
        assert r.converged and r.algorithm == "dynamic_sgr"
        assert r.trace.check(r) == [] and r.trace.spans
        oracle = color_serial(t.port.graph, device="cpu")
        assert is_valid_coloring(t.port.graph, r.colors)
        assert is_valid_coloring(t.port.graph, oracle.colors)


def test_insertion_conflict_is_repaired():
    g = grid2d(10, 10)
    t = Twin(g)
    c = t.port.colors
    same = np.argwhere(c[:, None] == c[None, :])
    u, v = next(p for p in same if p[0] < p[1])
    t.apply(add_edges=([int(u)], [int(v)]))
    r = t.recolor()
    assert r.colors[u] != r.colors[v] and t.port.validate()


def test_deletion_only_churn_stays_valid():
    g = erdos_renyi(400, 6.0, seed=6)
    t = Twin(g)
    src, dst = g.edges()
    und = src < dst
    t.apply(remove_edges=(src[und][:40], dst[und][:40]))
    r = t.recolor()
    assert t.port.validate() and r.converged and r.work_items < g.n


def test_vertex_stream_grow_and_remove():
    g = erdos_renyi(200, 5.0, seed=8)
    t = Twin(g)
    ids = t.apply(add_vertices=2, add_edges=([200, 200, 201], [0, 201, 5]))
    assert {200, 201} <= set(ids.tolist())
    r = t.recolor()
    assert t.port.n == 202 and r.colors.shape[0] == 202 and t.port.validate()
    t.apply(remove_vertices=[200])
    r = t.recolor()
    assert t.port.validate() and r.colors[200] == 1


def test_full_escape_hatch_is_bit_identical_to_cold():
    g = power_law(700, 6.0, seed=10)
    t = Twin(g)
    t.churn(0.05, np.random.default_rng(13))
    r = t.recolor(full=True)
    assert t.port.delta.overlay_size == 0
    ref = color_data_driven(t.port.delta.graph(), mode="fused", engine="ragged",
                            device="cpu")
    np.testing.assert_array_equal(r.colors, ref.colors)
    assert r.work_items == ref.work_items and t.port.frontier().size == 0


def test_incremental_work_is_frontier_proportional():
    g = build_graph("G3_circuit", 0.02)
    t = Twin(g)
    t.churn(0.01, np.random.default_rng(21))
    r = t.recolor()
    cold = color_data_driven(t.port.graph, mode="fused", device="cpu")
    assert t.port.validate() and cold.work_items >= 5 * r.work_items


def test_session_survives_many_rounds_with_compaction():
    g = erdos_renyi(500, 5.0, seed=14)
    t = Twin(g, compact_frac=0.05)
    rng = np.random.default_rng(15)
    for _ in range(6):
        t.churn(0.03, rng)
        t.recolor()
        assert t.port.validate()
    assert t.port.delta.compactions == t.ref.delta.compactions > 0


def test_maintenance_hooks_match_repro(tmp_path):
    """Deferred maintenance: the same owed steps and actions as repro's."""
    g = erdos_renyi(300, 5.0, seed=3)
    t = Twin(g, compact_frac=0.01, defer_maintenance=True, snapshot_every=2)
    t.ref.attach_durable(str(tmp_path / "r"))
    t.port.attach_durable(str(tmp_path / "t"))
    rng = np.random.default_rng(2)
    for _ in range(2):
        t.churn(0.05, rng)
        t.recolor()
        assert t.ref.maintenance_due() == t.port.maintenance_due()
    assert t.port.maintenance_due()["compact"]
    assert t.ref.maintain() == t.port.maintain() == ["compact", "snapshot"]
    t.check(t.ref.result, t.port.result)
    with pytest.raises(RuntimeError, match="durable"):
        open_session(_tg(g), device="cpu").checkpoint()


# --------------------------------------------------------------------------
# batch sessions, the ladder and the api layer
# --------------------------------------------------------------------------


def test_session_batch_only_dirty_graphs_pay():
    graphs = [erdos_renyi(250 + 17 * i, 5.0, seed=i) for i in range(4)]
    ref = r_open_session_batch(graphs)
    sb = open_session_batch([_tg(g) for g in graphs], device="cpu")
    assert isinstance(sb, SessionBatch) and sb.B == 4
    rng = np.random.default_rng(16)
    rem, add = r_churn(graphs[2], 0.05, rng)
    for s in (ref, sb):
        s.apply_delta(2, remove_edges=rem, add_edges=add)
    assert sb.dirty() == ref.dirty() == [2]
    assert sb.buckets() == ref.buckets()
    before = [s.colors.copy() for s in sb.sessions]
    want, got = ref.recolor(), sb.recolor()
    for a, b in zip(want, got):
        _assert_same(a, b)
    for b in (0, 1, 3):
        np.testing.assert_array_equal(got[b].colors, before[b])
        assert got[b].work_items == 0
    assert got[2].work_items > 0 and sb.validate()
    assert sb.metrics() == ref.metrics()
    solo = ColoringSession(_tg(graphs[2]), device="cpu")
    solo.apply_delta(remove_edges=rem, add_edges=add)
    np.testing.assert_array_equal(solo.recolor().colors, got[2].colors)
    for a, b in zip(ref.results(), sb.results()):
        np.testing.assert_array_equal(a.colors, b.colors)


def test_api_registration_and_cold_parity():
    assert "dynamic" in api.algorithms()
    assert repro_torch.algorithms() == repro.algorithms()
    g = erdos_renyi(300, 5.0, seed=17)
    r = api.color(_tg(g), algorithm="dynamic", device="cpu")
    ref = api.color(_tg(g), algorithm="fused", engine="ragged", device="cpu")
    np.testing.assert_array_equal(r.colors, ref.colors)
    _assert_same(rapi.color(g, algorithm="dynamic"), r)
    assert repro_torch.open_session(_tg(g), device="cpu").validate()


def test_open_session_options_path_bit_identical():
    g = erdos_renyi(200, 5.0, seed=0)
    a = repro_torch.open_session(_tg(g), heuristic="id", device="cpu")
    b = repro_torch.open_session(_tg(g), options=ColorOptions(heuristic="id"),
                                 device="cpu")
    np.testing.assert_array_equal(a.colors, b.colors)
    assert a._heuristic == b._heuristic == "id"
    with pytest.raises(ValueError, match="engine"):
        ColorOptions(engine="sharded").session_kwargs()
    assert ColorOptions(ensure_valid=True).session_kwargs() == {"on_fail": "ladder"}


def test_recolor_nonconvergence_raises_and_preserves_state():
    g = erdos_renyi(400, 6.0, seed=18)
    t = Twin(g)
    before = t.port.colors.copy()
    for s in (t.ref, t.port):
        s._tail_serial = None
        s._max_iters = 1
    t.churn(0.05, np.random.default_rng(19))
    with pytest.raises(RuntimeError, match="before converging"):
        t.ref.recolor()
    with pytest.raises(NonConvergenceError, match="before converging"):
        t.port.recolor()
    np.testing.assert_array_equal(t.port.colors, before)
    assert t.port.frontier().size > 0
    np.testing.assert_array_equal(t.ref.frontier(), t.port.frontier())


def test_session_ladder_degradations_match_repro():
    """on_fail="ladder": the cold run and a starved recolor escalate through
    the same rungs with the same outcomes as repro's."""
    g = erdos_renyi(300, 6.0, seed=11)
    t = Twin(g, on_fail="ladder", max_iters=1, tail_serial=False)
    k = np.arange(40)
    src, dst = np.meshgrid(k, k)
    t.apply(add_edges=(src.ravel(), dst.ravel()))
    r = t.recolor()
    assert r.converged and t.port.validate()
    assert any(d["stage"] == "ladder" for d in r.degradations)


def test_session_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        open_session(_tg(grid2d(3, 3)))
