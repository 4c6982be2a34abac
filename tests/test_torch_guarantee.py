"""Ingest and the guarantee ladder in the port against repro.

Mirrors ``tests/test_ingest.py`` (defect detection, repair, capacity
budgets, API wiring) and the ladder tests of ``tests/test_faultlab.py``
and ``tests/test_d2.py``: ``sanitize_csr`` gives the same graph and the
same report as ``repro``'s on every defect, under both policies, and
``ensure_valid=True`` takes the same rungs with the same outcomes on
distance-1, distance-2 and bipartite runs.  The batched and partitioned
front doors (``GraphBatch``, ``PartitionedCSR``) refuse and repair as
``repro``'s do.
"""
import dataclasses

import numpy as np
import pytest

import repro
import repro.core.guarantee as rguar
import repro.ingest as ringest
from repro.core import CSRGraph as RGraph
from repro.core import csr_from_edges as r_csr_from_edges
from repro.core.coloring import ColoringResult as RResult
from repro.graphs import erdos_renyi, jacobian_band

import repro_torch
import repro_torch.core.guarantee as tguar
from repro_torch import IngestError
from repro_torch.core import CSRGraph, csr_from_edges, is_valid_coloring
from repro_torch.core.coloring import ColoringResult
from repro_torch.d2 import BipartiteGraph, compress_jacobian_pattern, validate_bipartite
from repro_torch.errors import ReproError
from repro_torch.ingest import (
    INDEX_MAX,
    PACKED_GATHER_MAX_DEG,
    PACKED_HALO_MAX_N,
    IngestReport,
    packed_gather_ok,
    packed_halo_ok,
    sanitize_csr,
)

RESULT_FIELDS = ("iterations", "converged", "algorithm", "degradations",
                 "work_items", "padded_work", "class_cells")


def _dirty(offsets, cols):
    return np.asarray(offsets, np.int64), np.asarray(cols, np.int32)


def _report_fields(rep):
    return (rep.n, rep.m, rep.policy, rep.issues, rep.repairs, rep.hazards,
            rep.ok, rep.summary(), rep.degradations())


def _same_graph(want, got):
    np.testing.assert_array_equal(want.row_offsets, got.row_offsets)
    np.testing.assert_array_equal(want.col_indices, got.col_indices)
    assert want.row_offsets.dtype == got.row_offsets.dtype
    assert want.col_indices.dtype == got.col_indices.dtype


def _tg(g) -> CSRGraph:
    return CSRGraph.from_numpy(g.row_offsets, g.col_indices)


def _tb(bg) -> BipartiteGraph:
    return BipartiteGraph(bg.row_offsets, bg.row_to_col, bg.col_offsets,
                          bg.col_to_row)


# --------------------------------------------------------------------------
# sanitize_csr against repro, defect by defect
# --------------------------------------------------------------------------

DEFECTS = [
    ([0, 1, 1, 1], [1], "asymmetric"),
    ([0, 2, 3], [0, 1, 0], "self_loop"),
    ([0, 2, 3], [1, 1, 0], "duplicate_edge"),
    ([0, 2, 3], [-1, 1, 0], "col_negative"),
    ([0, 2, 3], [1, 5, 0], "col_out_of_range"),
    ([0, 2, 4, 6], [1, 2, 2, 0, 0, 1], "row_unsorted"),
    ([0, 2, 1, 3], [1, 2, 0], "indptr_nonmonotone"),
    ([1, 2, 3], [1, 0], "indptr_first_nonzero"),
    ([0, 1, 5], [1, 0], "indptr_last_mismatch"),
    ([0, 3, 5, 6], [1, 1, 0, 0, 0, 1], "self_loop"),
    ([0, 3, 4], [-1, 1, 9, 0], "col_negative"),
]


@pytest.mark.parametrize("offsets,cols,issue", DEFECTS,
                         ids=[f"{d[2]}-{i}" for i, d in enumerate(DEFECTS)])
def test_strict_raises_with_repros_report(offsets, cols, issue):
    with pytest.raises(ringest.IngestError) as want:
        ringest.sanitize_csr(*_dirty(offsets, cols), policy="strict")
    with pytest.raises(IngestError) as got:
        sanitize_csr(*_dirty(offsets, cols), policy="strict")
    assert issue in got.value.report.issues
    assert _report_fields(got.value.report) == _report_fields(want.value.report)
    assert str(got.value) == str(want.value)
    assert got.value.payload() == want.value.payload()
    assert got.value.report.repairs == ()


@pytest.mark.parametrize("offsets,cols,issue", DEFECTS,
                         ids=[f"{d[2]}-{i}" for i, d in enumerate(DEFECTS)])
def test_repair_gives_repros_graph_and_report(offsets, cols, issue):
    want_g, want = ringest.sanitize_csr(*_dirty(offsets, cols), policy="repair")
    got_g, got = sanitize_csr(*_dirty(offsets, cols), policy="repair")
    assert isinstance(got_g, CSRGraph)
    _same_graph(want_g, got_g)
    assert _report_fields(got) == _report_fields(want)
    assert got.repairs
    _, again = sanitize_csr(got_g, policy="strict")  # repaired output is clean
    assert again.ok


def test_repair_without_symmetry_matches_repro():
    args = _dirty([0, 3, 4], [1, 1, 2, 0])
    want_g, want = ringest.sanitize_csr(*args, policy="repair",
                                        require_symmetric=False)
    got_g, got = sanitize_csr(*args, policy="repair", require_symmetric=False)
    _same_graph(want_g, got_g)
    assert _report_fields(got) == _report_fields(want)


def test_random_dirty_inputs_match_repro():
    rng = np.random.default_rng(5)
    for _ in range(20):
        n = int(rng.integers(2, 12))
        m = int(rng.integers(0, 20))
        counts = rng.multinomial(m, np.ones(n) / n)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        cols = rng.integers(-2, n + 2, m).astype(np.int32)
        for policy in ("strict", "repair"):
            try:
                want = ringest.sanitize_csr(offsets, cols, policy=policy)
            except ringest.IngestError as e:
                with pytest.raises(IngestError) as got:
                    sanitize_csr(offsets, cols, policy=policy)
                assert _report_fields(got.value.report) == _report_fields(e.report)
                continue
            got = sanitize_csr(offsets, cols, policy=policy)
            _same_graph(want[0], got[0])
            assert _report_fields(got[1]) == _report_fields(want[1])
            assert sanitize_csr(got[0], policy="strict")[1].ok


def test_clean_graph_passes_unchanged():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    g = csr_from_edges(40, src, dst)
    out, report = sanitize_csr(g, policy="strict")
    assert out is g
    assert report.ok and report.degradations() == ()
    assert "clean" in report.summary()
    _, want = ringest.sanitize_csr(r_csr_from_edges(40, src, dst), policy="strict")
    assert _report_fields(report) == _report_fields(want)
    raw, rep = sanitize_csr(g.row_offsets, g.col_indices, policy="repair")
    _same_graph(g, raw)
    assert rep.ok


def test_empty_graph_is_clean():
    out, report = sanitize_csr(*_dirty([0], []), policy="strict")
    assert report.ok and out.n == 0 and out.m == 0


def test_bad_shapes_and_dtypes_always_raise():
    with pytest.raises(IngestError) as e:
        sanitize_csr(np.zeros((2, 2), np.int64), np.zeros(0, np.int32))
    assert e.value.report.issues == {"indptr_shape": 1}
    with pytest.raises(IngestError) as e:
        sanitize_csr(np.array([0.0, 1.0]), np.array([0.5]), policy="repair")
    assert e.value.report.issues == {"non_integer_dtype": 1}


def test_unknown_policy_and_mixed_arguments():
    with pytest.raises(ValueError, match="unknown policy"):
        sanitize_csr(*_dirty([0], []), policy="lenient")
    g = csr_from_edges(3, np.array([0]), np.array([1]))
    with pytest.raises(TypeError, match="not both"):
        sanitize_csr(g, g.col_indices)


def test_capacity_budgets_match_repro():
    assert (PACKED_GATHER_MAX_DEG, PACKED_HALO_MAX_N, INDEX_MAX) == (
        ringest.PACKED_GATHER_MAX_DEG, ringest.PACKED_HALO_MAX_N,
        ringest.INDEX_MAX)
    for d in (-1, 0, PACKED_GATHER_MAX_DEG - 1, PACKED_GATHER_MAX_DEG, 2**15, 2**16):
        assert packed_gather_ok(d) == ringest.packed_gather_ok(d)
        assert packed_gather_ok(4, color_bound=d) == ringest.packed_gather_ok(
            4, color_bound=d)
    for n in (-1, 0, PACKED_HALO_MAX_N - 1, PACKED_HALO_MAX_N, 2**16):
        assert packed_halo_ok(n) == ringest.packed_halo_ok(n)


def test_ingest_error_is_structured():
    assert issubclass(IngestError, (ReproError, ValueError))
    rep = IngestReport(n=2, m=3, policy="strict", issues={"self_loop": 1})
    err = IngestError(rep)
    assert err.payload() == {"error": "IngestError", "message": rep.summary(),
                             "issues": {"self_loop": 1}, "repairs": []}
    import repro_torch.errors

    assert repro_torch.IngestError is repro_torch.errors.IngestError is IngestError
    assert "IngestError" in dir(repro_torch)


# --------------------------------------------------------------------------
# the API's front door
# --------------------------------------------------------------------------

def _bad_pair():
    off, cols = np.array([0, 1, 1, 1], np.int64), np.array([1], np.int32)
    return RGraph(off, cols), CSRGraph(off, cols)


def test_color_validate_input_strict_and_repair():
    rbad, bad = _bad_pair()
    with pytest.raises(IngestError):
        repro_torch.color(bad, validate_input="strict", device="cpu")
    want = repro.color(rbad, validate_input="repair")
    got = repro_torch.color(bad, validate_input="repair", device="cpu")
    np.testing.assert_array_equal(want.colors, got.colors)
    for f in RESULT_FIELDS:
        assert getattr(want, f) == getattr(got, f), f
    assert any(d["stage"] == "ingest_repair" for d in got.degradations)
    assert got.converged


@pytest.mark.parametrize("algorithm", ["topology", "jp", "serial", "distance2"])
def test_validate_input_repair_on_every_algorithm(algorithm):
    rbad, bad = _bad_pair()
    want = repro.color(rbad, algorithm, validate_input="repair")
    got = repro_torch.color(bad, algorithm, validate_input="repair", device="cpu")
    np.testing.assert_array_equal(want.colors, got.colors)
    assert want.degradations == got.degradations != ()


def test_batch_and_partition_validate_input():
    from repro.core.batch import GraphBatch as RBatch
    from repro.core.csr import PartitionedCSR as RPlan

    from repro_torch.core import GraphBatch, PartitionedCSR

    rbad, bad = _bad_pair()
    with pytest.raises(IngestError):
        GraphBatch.from_graphs([bad], validate_input="strict", device="cpu")
    batch = GraphBatch.from_graphs([bad], validate_input="repair", device="cpu")
    assert batch.B == RBatch.from_graphs([rbad], validate_input="repair").B == 1
    with pytest.raises(IngestError):
        PartitionedCSR.from_graph(bad, 2, validate_input="strict")
    want = RPlan.from_graph(rbad, 2, validate_input="repair")
    got = PartitionedCSR.from_graph(bad, 2, validate_input="repair")
    assert got.n == want.n == 3
    np.testing.assert_array_equal(want.starts, got.starts)
    for a, b in zip(want.boundary + want.recv, got.boundary + got.recv):
        np.testing.assert_array_equal(a, b)


def test_color_validate_input_rejects_non_csr():
    with pytest.raises(TypeError, match="CSRGraph"):
        repro_torch.color(object(), validate_input="strict", device="cpu")
    bg = _tb(jacobian_band(20, band=1))
    with pytest.raises(TypeError, match="CSRGraph"):
        repro_torch.color(bg, "bipartite", validate_input="strict", device="cpu")


# --------------------------------------------------------------------------
# the guarantee ladder against repro
# --------------------------------------------------------------------------

def _starved_graph():
    rng = np.random.default_rng(11)
    n = 300
    src, dst = rng.integers(0, n, 2200), rng.integers(0, n, 2200)
    return r_csr_from_edges(n, src, dst), csr_from_edges(n, src, dst)


LADDER_CASES = [
    ("data_driven", dict(engine="classic", max_iters=1, tail_serial=False)),
    ("data_driven", dict(max_iters=1, tail_serial=False)),
    ("data_driven", dict(max_iters=1)),
    ("data_driven", dict(engine="padded", mode="fused", max_iters=2,
                         tail_serial=False)),
    ("fused", dict(max_iters=2, tail_serial=False, heuristic="id")),
    ("topology", dict(max_iters=1)),
    ("distance2", dict(max_iters=1, tail_serial=False)),
    ("distance2", dict(max_iters=1, tail_serial=False, strategy="onthefly")),
    ("jp", {}),
    ("threestep", dict(device_rounds=1)),
    ("serial", {}),
]


@pytest.mark.parametrize("algorithm,opts", LADDER_CASES,
                         ids=[f"{a}-{i}" for i, (a, _) in enumerate(LADDER_CASES)])
def test_ladder_degradations_match_repro(algorithm, opts):
    rg, g = _starved_graph()
    want = repro.color(rg, algorithm, ensure_valid=True, **opts)
    got = repro_torch.color(g, algorithm, ensure_valid=True, device="cpu", **opts)
    np.testing.assert_array_equal(want.colors, got.colors)
    for f in RESULT_FIELDS:
        assert getattr(want, f) == getattr(got, f), f
    assert got.converged
    if algorithm == "distance2":
        from repro_torch.d2 import validate_d2

        assert validate_d2(g, got.colors)
    else:
        assert is_valid_coloring(g, got.colors)


def test_ladder_on_bipartite_matches_repro():
    bg = jacobian_band(60, band=2)
    opts = dict(max_iters=1, tail_serial=False)
    want = repro.color(bg, "bipartite", ensure_valid=True, **opts)
    got = repro_torch.color(_tb(bg), "bipartite", ensure_valid=True,
                            device="cpu", **opts)
    np.testing.assert_array_equal(want.colors, got.colors)
    assert want.degradations == got.degradations
    assert [d["rung"] for d in got.degradations] == ["reseed", "budget_extension"]
    assert validate_bipartite(_tb(bg), got.colors)


def test_ladder_spans_land_on_the_trace():
    rg, g = _starved_graph()
    opts = dict(engine="classic", max_iters=1, tail_serial=False)
    want = repro.color(rg, ensure_valid=True, trace=True, **opts)
    got = repro_torch.color(g, ensure_valid=True, trace=True, device="cpu", **opts)
    names = [s.name for s in got.trace.spans]
    assert names == [s.name for s in want.trace.spans]
    assert "guarantee_ladder" in names
    assert [s.meta for s in got.trace.spans if s.name == "guarantee_ladder"] == [
        {"rung": "reseed"}, {"rung": "budget_extension"}]
    np.testing.assert_array_equal(want.trace.steps, got.trace.steps)


def test_converged_valid_run_takes_no_rung():
    rg, g = _starved_graph()
    got = repro_torch.color(g, ensure_valid=True, device="cpu")
    assert got.degradations == () and got.converged


def _corrupt(colors, seed):
    rng = np.random.default_rng(seed)
    out = np.array(colors, np.int32)
    idx = rng.choice(out.shape[0], out.shape[0] // 10, replace=False)
    out[idx] = out[(idx + 1) % out.shape[0]]
    out[idx[:3]] = 0
    return out


@pytest.mark.parametrize("with_rerun", [False, True])
def test_serialize_survivors_matches_repro(with_rerun):
    """A converged but invalid result skips the reruns and is repaired by
    serializing the residual; an unconverged one whose reruns lack the knob
    records them unavailable."""
    rg, g = _starved_graph()
    good = repro.color(rg).colors
    bad = _corrupt(good, 3)
    want_in = RResult(bad, 4, 0, 0, not with_rerun)
    got_in = ColoringResult(bad.copy(), 4, 0, 0, not with_rerun)

    def refuse(rung):
        raise TypeError("no such knob")

    rerun = refuse if with_rerun else None
    want = rguar.ensure_valid_result(rg, want_in, rerun)
    got = tguar.ensure_valid_result(g, got_in, rerun)
    np.testing.assert_array_equal(want.colors, got.colors)
    assert want.degradations == got.degradations
    assert (want.iterations, want.converged) == (got.iterations, got.converged)
    rungs = [d["rung"] for d in got.degradations]
    assert rungs[-1] == "serialize_survivors"
    if with_rerun:
        assert rungs[:2] == ["reseed", "budget_extension"]
        assert {d["outcome"] for d in got.degradations[:2]} == {"unavailable"}
    assert is_valid_coloring(g, got.colors)


def test_residual_and_serial_repair_match_repro():
    rg, g = _starved_graph()
    rng = np.random.default_rng(0)
    colors = rng.integers(-5, 10**6, g.n).astype(np.int32)
    colors[:10] = 0
    colors[10:20] = -3
    colors[20:60] = 7
    res = tguar.residual_vertices(g, colors)
    np.testing.assert_array_equal(res, rguar.residual_vertices(rg, colors))
    assert res.size >= 20
    for order in ("tail", "oracle"):
        for r in (res, np.arange(g.n)):
            want = rguar.serial_repair(rg, colors, r, order=order)
            got = tguar.serial_repair(g, colors, r, order=order)
            np.testing.assert_array_equal(want, got)
    assert is_valid_coloring(g, tguar.serial_repair(g, colors, np.arange(g.n),
                                                    order="oracle"))
    with pytest.raises(ValueError, match="unknown repair order"):
        tguar.serial_repair(g, colors, res, order="random")
    assert tguar.LADDER_RUNGS == rguar.LADDER_RUNGS


def test_square_graph_matches_repro():
    g = erdos_renyi(120, 4.0, seed=2)
    _same_graph(rguar.square_graph(g), tguar.square_graph(_tg(g)))


# --------------------------------------------------------------------------
# compress_jacobian_pattern's ladder
# --------------------------------------------------------------------------

def test_compress_unconverged_goes_through_the_ladder():
    bg = jacobian_band(40, band=2)
    want = repro.d2.compress_jacobian_pattern(bg, max_iters=1)
    got = compress_jacobian_pattern(_tb(bg), max_iters=1, device="cpu")
    assert validate_bipartite(_tb(bg), got.coloring.colors)
    assert any(d.get("stage") == "ladder" for d in got.coloring.degradations)
    assert got.coloring.degradations == want.coloring.degradations
    np.testing.assert_array_equal(got.coloring.colors, want.coloring.colors)
    np.testing.assert_array_equal(got.seed_matrix(), want.seed_matrix())
    assert got.num_groups == want.num_groups
    assert dataclasses.is_dataclass(got.coloring)


def test_compress_ladder_without_a_tail_matches_repro():
    bg = jacobian_band(40, band=2)
    want = repro.d2.compress_jacobian_pattern(bg, max_iters=1, tail_serial=None)
    got = compress_jacobian_pattern(_tb(bg), max_iters=1, tail_serial=None,
                                    device="cpu")
    assert got.coloring.degradations == want.coloring.degradations
    np.testing.assert_array_equal(got.seed_matrix(), want.seed_matrix())
