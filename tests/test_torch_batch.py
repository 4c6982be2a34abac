"""The batched engine of the port (``repro_torch.core.batch``) against
``repro.core.batch``.

Mirrors ``tests/test_batch.py`` on the same inputs with exact equality
(colours, iterations, work_items, padded_work, class_cells, converged,
algorithm, degradations, trace rows), and adds the port's own cases: the
flat layout's id tie-break, a graph frozen inside a live batch, ``B == 0``
and ``n_max == 0``, traced runs with a small ring, batched distance-2,
``validate_input=`` and ``ensure_valid=`` through ``color_batch``, and the
capacity guard of the flat ids.
"""
import functools

import numpy as np
import pytest
import torch

import repro
import repro.core.batch as rbatch
from repro.core import csr_from_edges as r_csr_from_edges
from repro.graphs import (
    build_graph,
    erdos_renyi,
    grid2d,
    honeycomb,
    power_law,
    road,
    serving_mix,
    small_world,
)

import repro_torch
import repro_torch.core.batch as tbatch
from repro_torch.core import (
    CSRGraph,
    GraphBatch,
    batched_sgr_step,
    color_batch_fused,
    color_data_driven,
    is_valid_coloring,
)
from repro_torch.errors import CapacityError, IngestError

FIELDS = ("iterations", "work_items", "padded_work", "class_cells", "converged",
          "algorithm", "degradations")


def _tg(g) -> CSRGraph:
    return CSRGraph.from_numpy(g.row_offsets, g.col_indices)


def _assert_same(want, got, trace=False):
    np.testing.assert_array_equal(want.colors, got.colors)
    assert got.colors.dtype == np.int32
    for f in FIELDS:
        assert getattr(want, f) == getattr(got, f), f
    if trace:
        np.testing.assert_array_equal(want.trace.steps, got.trace.steps)
        assert want.trace.iterations == got.trace.iterations
        assert want.trace.engine == got.trace.engine
        assert want.trace.cap == got.trace.cap
        assert got.trace.check(got) == want.trace.check(want)


def _assert_all_same(want, got, trace=False):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        _assert_same(a, b, trace)


@functools.cache
def _mixed_graphs():
    """B=9 heterogeneous graphs, as ``tests/test_batch.py`` builds them."""
    return (
        erdos_renyi(300, 5.0, seed=2),
        grid2d(15, 20),
        power_law(500, 6.0, seed=3),
        honeycomb(10, 12),
        road(200, seed=4),
        small_world(350, 6, seed=5),
        erdos_renyi(64, 3.0, seed=6),
        power_law(900, 8.0, seed=7),
        erdos_renyi(1200, 10.0, seed=8),
    )


@functools.cache
def _repro_batch(key, **opts):
    return tuple(repro.core.color_batch_fused(_GRAPHS[key](), **opts))


_GRAPHS = {
    "mixed": _mixed_graphs,
    "mixed4": lambda: _mixed_graphs()[:4],
    "uniform": lambda: tuple(erdos_renyi(256, 6.0, seed=s) for s in range(5)),
    "tails": lambda: (build_graph("rmat-g", 0.01), build_graph("G3_circuit", 0.01),
                      grid2d(4, 5)),
}


def _port(key, **opts):
    return color_batch_fused([_tg(g) for g in _GRAPHS[key]()], device="cpu",
                             **opts)


def test_graphbatch_packing():
    graphs = _mixed_graphs()
    want = rbatch.GraphBatch.from_graphs(graphs)
    batch = GraphBatch.from_graphs([_tg(g) for g in graphs], device="cpu")
    assert (batch.B, batch.n_max, batch.width, batch.sizes) == (
        want.B, want.n_max, want.width, want.sizes)
    np.testing.assert_array_equal(np.asarray(want.adj), batch.adj.numpy())
    np.testing.assert_array_equal(np.asarray(want.deg_ext), batch.deg_ext.numpy())
    # the flat layout: graph b's vertex v is b * (n_max + 1) + v, the CSR
    # holds every graph's rows, and its dense view pads with the sentinel N
    n1 = batch.n_max + 1
    assert batch.table.shape == (batch.B * n1 - 1, batch.width)
    assert batch.sentinel == batch.B * n1 - 1 == batch.csr.n
    R = batch.csr.row_starts.numpy()
    C = batch.csr.col_padded.numpy()
    for b, g in enumerate(graphs):
        for v in range(0, g.n, max(1, g.n // 7)):
            nb = g.neighbors(v) + b * n1
            assert (batch.table[b * n1 + v, : nb.size].numpy() == nb).all()
            assert (batch.table[b * n1 + v, nb.size:].numpy() == batch.sentinel).all()
            assert (C[R[b * n1 + v]: R[b * n1 + v + 1]] == nb).all()
        assert (batch.deg[b * n1 + g.n: (b + 1) * n1].numpy() == 0).all()
        assert (np.diff(R[b * n1 + g.n: (b + 1) * n1 + 1]) == 0).all()


def test_graphbatch_distance2_packing_matches_repro():
    graphs = serving_mix(4, 0.05)
    want = rbatch.GraphBatch.from_graphs(graphs, distance2=True, width=7)
    got = GraphBatch.from_graphs([_tg(g) for g in graphs], distance2=True,
                                 width=7, device="cpu")
    assert got.distance2 and (got.width, got.sizes) == (want.width, want.sizes)
    np.testing.assert_array_equal(np.asarray(want.adj), got.adj.numpy())
    np.testing.assert_array_equal(np.asarray(want.deg_ext), got.deg_ext.numpy())
    # the CSR's row lengths are G^2's; the loser rule keeps the degrees of G
    n1 = got.n_max + 1
    for b, g in enumerate(graphs):
        sq = g.square()
        np.testing.assert_array_equal(
            got.csr.deg_ext[b * n1: b * n1 + g.n].numpy(), sq.degrees)


def test_batch_colors_valid_and_bit_identical_to_fused():
    """One batched call over B >= 8 graphs == repro's, and == per-graph
    fused runs of the port, bit for bit."""
    graphs = [_tg(g) for g in _mixed_graphs()]
    results = _port("mixed")
    _assert_all_same(_repro_batch("mixed"), results)
    for g, r in zip(graphs, results):
        assert is_valid_coloring(g, r.colors) and r.converged
        single = color_data_driven(g, mode="fused", device="cpu")
        np.testing.assert_array_equal(r.colors, single.colors)
        assert r.iterations == single.iterations


@pytest.mark.parametrize("heuristic,ff", [("id", "scan"), ("degree", "sort")])
def test_batch_heuristic_and_firstfit_options(heuristic, ff):
    _assert_all_same(_repro_batch("mixed4", heuristic=heuristic, firstfit=ff),
                     _port("mixed4", heuristic=heuristic, firstfit=ff))


def _step_inputs(graphs, seed=None):
    batch = rbatch.GraphBatch.from_graphs(graphs)
    n_max = batch.n_max
    ids = np.arange(n_max, dtype=np.int32)
    sizes = np.asarray(batch.sizes, np.int32)
    wl = np.where(ids[None, :] < sizes[:, None], ids[None, :], n_max).astype(np.int32)
    colors = np.zeros((batch.B, n_max + 1), np.int32)
    if seed is not None:  # a random state full of equal colours: conflicts
        rng = np.random.default_rng(seed)
        colors[:, :n_max] = rng.integers(0, 4, (batch.B, n_max))
        colors[:, :n_max][ids[None, :] >= sizes[:, None]] = 0
    return batch, colors, wl


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("coarsen", [(1, 1), (2, 3)], ids=["plain", "chunked"])
def test_batched_sgr_step_matches_per_graph_step(coarsen):
    """One batched classic step == repro's vmapped one, state for state."""
    graphs = [erdos_renyi(128, 5.0, seed=10), grid2d(8, 16), road(100, seed=11)]
    batch, colors, wl = _step_inputs(graphs)
    kw = dict(coarsen_ff=coarsen[0], coarsen_cr=coarsen[1])
    want = rbatch.batched_sgr_step(batch.adj, batch.deg_ext, colors, wl, **kw)
    got = batched_sgr_step(*_torch(batch.adj, batch.deg_ext, colors, wl), **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("heuristic", ["id", "degree"])
def test_flat_layout_keeps_the_id_tie_break(heuristic):
    """The flat ids add one offset per graph, so every order inside a graph
    is kept: from a state full of same-colour conflicts, the batched
    rotated step (``id``: the smaller id loses; ``degree``: ties to the
    larger id) equals repro's vmapped one, and the table's ids keep each
    row's order."""
    graphs = [erdos_renyi(90, 6.0, seed=3), grid2d(6, 9), erdos_renyi(70, 8.0, seed=4)]
    batch, colors, wl = _step_inputs(graphs, seed=9)
    want = rbatch.batched_ragged_step(batch.adj, batch.deg_ext, colors, wl,
                                      heuristic=heuristic)
    got = tbatch.batched_ragged_step(*_torch(batch.adj, batch.deg_ext, colors, wl),
                                     heuristic=heuristic)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert int(np.asarray(want[2]).sum()) > 0  # conflicts were decided
    flat = GraphBatch.from_graphs([_tg(g) for g in graphs], device="cpu")
    off = np.arange(flat.B) * (flat.n_max + 1)
    rows = np.concatenate([flat.table.numpy().reshape(-1),
                           np.full(flat.width, flat.sentinel)]).reshape(
        flat.B, flat.n_max + 1, flat.width)[:, :flat.n_max]
    assert (np.diff(rows, axis=2) >= 0).all()  # sorted rows stay sorted
    real = rows < flat.sentinel
    local = np.where(real, rows - off[:, None, None], flat.n_max)
    np.testing.assert_array_equal(local, np.asarray(batch.adj))


def test_batch_uniform_sizes():
    graphs = [_tg(g) for g in _GRAPHS["uniform"]()]
    results = _port("uniform")
    _assert_all_same(_repro_batch("uniform"), results)
    for g, r in zip(graphs, results):
        assert is_valid_coloring(g, r.colors)


def test_batch_edge_cases():
    """``B == 0``, a batch whose ``n_max == 0``, and empty and edgeless
    graphs inside a real batch, traced and not."""
    assert color_batch_fused([], device="cpu") == []
    empty = r_csr_from_edges(0, np.zeros(0, int), np.zeros(0, int))
    edgeless = r_csr_from_edges(5, np.zeros(0, int), np.zeros(0, int))
    for graphs in ([empty, empty], [empty, edgeless, erdos_renyi(100, 4.0, seed=12)]):
        for trace in (False, True):
            want = repro.core.color_batch_fused(graphs, trace=trace)
            got = color_batch_fused([_tg(g) for g in graphs], device="cpu",
                                    trace=trace)
            _assert_all_same(want, got, trace)
    assert (got[1].colors == 1).all()  # isolated vertices take colour 1
    only_empty = color_batch_fused([_tg(empty)] * 2, device="cpu")
    assert all(r.colors.shape == (0,) and r.converged for r in only_empty)


def test_batch_via_api():
    graphs = _mixed_graphs()[:3]
    want = repro.color_batch(graphs)
    got = repro_torch.color_batch([_tg(g) for g in graphs], device="cpu")
    _assert_all_same(want, got)
    assert all(r.algorithm == "batched_fused_sgr" for r in got)
    loop = repro_torch.color_batch([_tg(g) for g in graphs], "serial", device="cpu")
    _assert_all_same(repro.color_batch(graphs, "serial"), loop)


def test_batch_work_accounting():
    graphs = _mixed_graphs()[:4]
    results = _port("mixed4")
    steps = max(r.iterations for r in results)
    n_max = max(g.n for g in graphs)
    for g, r in zip(graphs, results):
        assert r.work_items >= g.n
        assert r.padded_work >= steps * n_max
        assert r.iterations <= steps
    _assert_all_same(_repro_batch("mixed4"), results)


def test_batch_traces_and_tails_match_repro():
    """Traced batches whose graphs run the tail (a stall on the grid, the
    threshold on rmat-g) or freeze at once (a 20-vertex grid under its
    threshold of 32, frozen inside a live batch): rows equal repro's, with
    the default ring and with a 3-row ring that drops early rows."""
    for cap in (True, 3):
        want = _repro_batch("tails", trace=cap)
        got = _port("tails", trace=cap)
        _assert_all_same(want, got, trace=True)
        assert all(r.trace.spans for r in got)
    plain = _port("tails")
    _assert_all_same(_repro_batch("tails"), plain)
    tails = [r.class_cells for r in plain]
    assert any(r.trace.tail_step >= 0 for r in got) and tails
    frozen = got[2]
    assert frozen.iterations == 2  # the boot step, then straight to the tail
    names = {s.name for s in got[0].trace.spans}
    assert {"superstep_loop", "serial_tail", "batched_loop"} <= names


@pytest.mark.parametrize("heuristic", ["degree", "id"])
def test_batch_distance2_matches_repro(heuristic):
    graphs = serving_mix(4, 0.05)
    want = repro.color_batch(graphs, "distance2", heuristic=heuristic, trace=True)
    got = repro_torch.color_batch([_tg(g) for g in graphs], "distance2",
                                  heuristic=heuristic, device="cpu", trace=True)
    _assert_all_same(want, got, trace=True)
    assert all(r.algorithm == "batched_fused_sgr_d2" for r in got)
    # one pre-packed batch: no width buckets, so padded_work differs from
    # the bucketed call's; equal to repro's pre-packed call
    want = rbatch.color_batch_fused(
        rbatch.GraphBatch.from_graphs(graphs, distance2=True), distance2=True,
        heuristic=heuristic, trace=True)
    packed = GraphBatch.from_graphs([_tg(g) for g in graphs], distance2=True,
                                    device="cpu")
    _assert_all_same(want, color_batch_fused(packed, distance2=True,
                                             heuristic=heuristic, trace=True),
                     trace=True)
    with pytest.raises(ValueError, match="distance2"):
        color_batch_fused(packed)


def test_prepacked_graphbatch_matches_repro():
    graphs = serving_mix(5, 0.05)
    want = rbatch.color_batch_fused(rbatch.GraphBatch.from_graphs(graphs, width=40))
    got = color_batch_fused(GraphBatch.from_graphs(
        [_tg(g) for g in graphs], width=40, device="cpu"))
    _assert_all_same(want, got)


def test_validate_input_and_ensure_valid_through_color_batch():
    bad = repro.core.CSRGraph(np.array([0, 2, 3, 3], np.int64),
                              np.array([1, 1, 0], np.int32))  # dup + asymmetric
    graphs = [bad, erdos_renyi(200, 6.0, seed=1)]
    tg = [_tg(g) for g in graphs]
    want = repro.color_batch(graphs, validate_input="repair")
    got = repro_torch.color_batch(tg, validate_input="repair", device="cpu")
    _assert_all_same(want, got)
    assert got[0].degradations
    with pytest.raises(IngestError):
        repro_torch.color_batch(tg, validate_input="strict", device="cpu")
    with pytest.raises(IngestError):
        GraphBatch.from_graphs([tg[0]], validate_input="strict", device="cpu")
    assert GraphBatch.from_graphs([tg[0]], validate_input="repair",
                                  device="cpu").B == 1
    starved = dict(max_iters=1, tail_serial=False, ensure_valid=True)
    want = repro.color_batch(graphs[1:], **starved)
    got = repro_torch.color_batch(tg[1:], device="cpu", **starved)
    _assert_all_same(want, got)
    assert [d["rung"] for d in got[0].degradations]


def test_color_batch_refuses_what_it_cannot_honor():
    g = [_tg(erdos_renyi(50, 4.0, seed=1))]
    with pytest.raises(ValueError, match="coarsen_ff"):
        repro_torch.color_batch(g, coarsen_ff=2, device="cpu")
    with pytest.raises(ValueError, match="tiling"):
        repro_torch.color_batch(g, "fused", tiling=(4, 32), device="cpu")
    with pytest.raises(ValueError, match="devices="):
        repro_torch.color_batch(g, devices=[0], device="cpu")
    with pytest.raises(ValueError, match="mixes the CPU and CUDA"):
        repro_torch.color_batch(g, engine="sharded", devices=["cpu", "cuda"])
    with pytest.raises(ValueError, match="options"):
        tbatch.color_batch_sharded(g, devices=["cpu"] * 2, backend="pallas")
    # engine="sharded" is ported (ROADMAP A11): one device is the batched engine
    _assert_all_same(repro_torch.color_batch(g, device="cpu"),
                     repro_torch.color_batch(g, engine="sharded", device="cpu"))
    with pytest.raises(ValueError, match="unknown batch engine"):
        repro_torch.color_batch(g, engine="ragged", device="cpu")


def test_flat_ids_capacity_guard():
    assert tbatch._flat_ids((3, 5), 5)[0] == 2 * 6 - 1
    with pytest.raises(CapacityError, match="int32"):
        tbatch._flat_ids((2**30, 2**30), 2**30)


def test_color_batch_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.color_batch([_tg(grid2d(3, 3))])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphBatch.from_graphs([_tg(grid2d(3, 3))])
