"""Telemetry in the port (``repro_torch.obs``) against repro's: rings,
traces, spans, export and report.

Mirrors ``tests/test_obs.py`` but for the batched and streaming tests,
whose engines the port does not have yet (ROADMAP A7, A9):

* ring and record mechanics;
* engine integration: every engine called with ``trace=True`` attaches a
  ``RunTrace`` whose rows equal ``repro``'s row for row (the bootstrap and
  tail rows, ring drops at a small ``trace=`` cap included) and whose
  invariants hold; ``trace=False`` leaves every other field bit-identical;
* hand-built oracles (edgeless graph, clique, forced tail);
* spans (first dispatch against warm), the Chrome-trace export and the text
  report.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro
from repro.core import CSRGraph as RGraph
from repro.core import csr_from_edges as r_csr_from_edges
from repro.graphs import build_graph, erdos_renyi, grid2d, jacobian_band

import repro_torch
from repro_torch.core import CSRGraph, color_data_driven, csr_from_edges, is_valid_coloring
from repro_torch.d2 import BipartiteGraph, color_distance2
from repro_torch.obs import (
    NF,
    HostRing,
    RunTrace,
    chrome_trace,
    empty_trace,
    export_chrome_trace,
    jit_span,
    recorder,
    resolve_trace_cap,
    ring_init,
    ring_rows,
    span,
)
from repro_torch.obs import report as obs_report
from repro_torch.obs.spans import jit_key_seen

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("iterations", "work_items", "padded_work", "class_cells", "converged",
          "algorithm", "degradations")
GRAPHS = {
    "er": lambda: erdos_renyi(300, 5.0, seed=1),
    # 3,277 vertices: past 2048, so the auto tiling makes degree classes
    "rmat-g": lambda: build_graph("rmat-g", 0.05),
    # a grid cascades: the stall detector hands it to the serial tail
    "grid": lambda: grid2d(24, 24, diagonals=True),
}
_CACHE: dict = {}


def _graph(name):
    if name not in _CACHE:
        g = GRAPHS[name]()
        _CACHE[name] = (g, CSRGraph.from_numpy(g.row_offsets, g.col_indices))
    return _CACHE[name]


def _tb(bg) -> BipartiteGraph:
    return BipartiteGraph(bg.row_offsets, bg.row_to_col, bg.col_offsets,
                          bg.col_to_row)


def _assert_same_trace(want, got):
    """``got`` (the port's traced result) equals ``want`` (repro's)."""
    np.testing.assert_array_equal(want.colors, got.colors)
    for f in FIELDS:
        assert getattr(want, f) == getattr(got, f), f
    tw, tg = want.trace, got.trace
    np.testing.assert_array_equal(tw.steps, tg.steps)
    assert tg.steps.dtype == np.int64 and tg.steps.shape[1] == NF
    assert (tw.iterations, tw.engine, tw.cap, tw.dropped, tw.tail_step) == (
        tg.iterations, tg.engine, tg.cap, tg.dropped, tg.tail_step)
    assert [e.name for e in tw.spans] == [e.name for e in tg.spans]
    assert tg.check(got) == tw.check(want) == []


def _assert_coherent(result):
    t = result.trace
    assert isinstance(t, RunTrace)
    assert t.check(result) == [], t.check(result)
    s = t.steps
    if s.shape[0] == 0:
        return t
    if t.dropped == 0:
        assert int(t.series("retired").sum()) == int(s[0, 0])
        assert int(t.series("cells").sum()) == result.padded_work
    assert int(s[-1, 3]) == result.num_colors
    return t


# ---------------------------------------------------------------- mechanics


def test_resolve_trace_cap():
    assert resolve_trace_cap(False) == 0
    assert resolve_trace_cap(None) == 0
    assert resolve_trace_cap(0) == 0
    assert resolve_trace_cap(-3) == 0
    assert resolve_trace_cap(True) == 512
    assert resolve_trace_cap(7) == 7
    assert resolve_trace_cap(True, max_iters=10) == 12
    assert resolve_trace_cap(4, max_iters=100) == 4


def test_host_ring_drop_oldest():
    ring = HostRing(3)
    for i in range(5):
        ring.append(live=10 - i, retired=1, conflicts=9 - i, max_color=i,
                    cells=i)
    rows = ring.rows()
    assert ring.recorded == 5
    assert rows.shape == (3, NF)
    np.testing.assert_array_equal(rows[:, 0], [8, 7, 6])
    assert HostRing(2).rows().shape == (0, NF)


def test_host_ring_reads_tensor_fields_at_the_end():
    """The engines pass each step's max colour as a 0-d tensor; the ring
    keeps it unread until ``rows()``, which gives the same rows as ints."""
    colors = torch.zeros(5, dtype=torch.int32)
    ring, plain = HostRing(4), HostRing(4)
    for step in range(6):
        colors[step % 5] = step + 1
        ring.append(6 - step, 1, 5 - step, colors.max(), 10 * step, tail=step == 5)
        plain.append(6 - step, 1, 5 - step, int(colors.max()), 10 * step,
                     tail=int(step == 5))
    assert ring.recorded == plain.recorded == 6
    np.testing.assert_array_equal(ring.rows(), plain.rows())
    assert ring.rows().dtype == np.int64
    np.testing.assert_array_equal(ring.rows()[:, 3], [3, 4, 5, 6])


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_ring_rows_wrap(kind):
    cap = 4
    buf = ring_init(cap) if kind == "torch" else np.zeros((cap, NF), np.int32)
    assert tuple(buf.shape) == (cap, NF)
    for s in range(6):  # writes at s % cap
        buf[s % cap, 0] = 100 + s
    rows = ring_rows(buf, 6)
    np.testing.assert_array_equal(rows[:, 0], [102, 103, 104, 105])
    assert ring_rows(buf, 0).shape == (0, NF)
    assert ring_rows(buf, 2).shape == (2, NF)


def test_ring_init_is_int32_zeros_on_the_device():
    buf = ring_init(5, device="cpu")
    assert buf.dtype == torch.int32 and buf.device.type == "cpu"
    assert int(buf.abs().sum()) == 0


def test_runtrace_roundtrip_and_summary():
    steps = np.array([[8, 0, 8, 1, 0, 0, 0, 0],
                      [8, 5, 3, 2, 64, 0, 0, 0],
                      [3, 3, 0, 3, 24, 1, 0, 0]], np.int64)
    t = RunTrace(steps=steps, iterations=3, engine="unit")
    assert t.check() == []
    assert t.tail_step == 2
    t2 = RunTrace.from_dict(t.to_dict())
    np.testing.assert_array_equal(t2.steps, t.steps)
    s = t.summary(max_points=2)
    assert s["supersteps"] == 3 and s["series_from"] == 1
    assert s["live"] == [8, 3] and s["conflicts"] == [3, 0]
    assert "halo_bytes" not in s


def test_runtrace_check_catches_broken_rows():
    steps = np.array([[8, 0, 8, 1, 0, 0, 0, 0],
                      [8, 4, 3, 2, 64, 0, 0, 0]], np.int64)
    assert any("retired + conflicts" in b
               for b in RunTrace(steps=steps, iterations=2).check())
    steps2 = np.array([[8, 0, 8, 1, 0, 0, 0, 0],
                       [5, 5, 0, 2, 64, 0, 0, 0]], np.int64)
    assert any("continuity" in b
               for b in RunTrace(steps=steps2, iterations=2).check())


# ---------------------------------------------- engine rows against repro


# repro compiles one fused program a shape, so classic fused runs on er only
ENGINE_CASES = [(name, engine, mode) for name in ("er", "rmat-g")
                for engine in ("ragged", "padded", "classic")
                for mode in ("workefficient", "fused")
                if not (name == "rmat-g" and engine == "classic" and mode == "fused")]


@pytest.mark.parametrize("name,engine,mode", ENGINE_CASES)
def test_trace_rows_match_repro(name, engine, mode):
    g, t = _graph(name)
    want = repro.color(g, engine=engine, mode=mode, trace=True)
    got = repro_torch.color(t, engine=engine, mode=mode, trace=True,
                            device="cpu")
    _assert_same_trace(want, got)
    _assert_coherent(got)
    assert "superstep_loop" in {e.name for e in got.trace.spans}


@pytest.mark.parametrize("mode", ["workefficient", "fused"])
def test_stall_tail_rows_match_repro(mode):
    """A grid stalls: the tail row drains the live worklist while cells
    charge the whole-graph re-greedy."""
    g, t = _graph("grid")
    want = repro.color(g, mode=mode, trace=True)
    got = repro_torch.color(t, mode=mode, trace=True, device="cpu")
    _assert_same_trace(want, got)
    assert got.trace.tail_step >= 0
    assert "serial_tail" in {e.name for e in got.trace.spans}


@pytest.mark.parametrize("opts", [dict(coarsen_lanes=64), dict(tail_serial=None),
                                  dict(tail_serial=None, max_iters=3)],
                         ids=["chunked", "no-tail", "starved"])
def test_trace_rows_match_repro_on_options(opts):
    g, t = _graph("er")
    want = repro.color(g, trace=True, **opts)
    got = repro_torch.color(t, trace=True, device="cpu", **opts)
    _assert_same_trace(want, got)


@pytest.mark.parametrize("strategy", ["precomputed", "onthefly"])
def test_distance2_trace_matches_repro(strategy):
    g, t = _graph("er")
    want = repro.color(g, "distance2", strategy=strategy, trace=True)
    got = color_distance2(t, strategy=strategy, trace=True, device="cpu")
    _assert_same_trace(want, got)
    names = {e.name for e in got.trace.spans}
    assert {"csr_build", "superstep_loop"} <= names
    engine = "d2_precomputed" if strategy == "precomputed" else "d2_onthefly"
    assert any(e.meta.get("engine") == engine for e in got.trace.spans)


@pytest.mark.parametrize("strategy", ["precomputed", "onthefly"])
def test_bipartite_trace_matches_repro(strategy):
    bg = jacobian_band(300, band=2)
    want = repro.color(bg, "bipartite", strategy=strategy, trace=True)
    got = repro_torch.color(_tb(bg), "bipartite", strategy=strategy, trace=True,
                            device="cpu")
    _assert_same_trace(want, got)


def test_trace_off_leaves_everything_else_bit_identical():
    g, t = _graph("rmat-g")
    for opts in ({}, dict(mode="fused"), dict(engine="classic"),
                 dict(engine="padded", mode="fused")):
        off = repro_torch.color(t, device="cpu", **opts)
        on = repro_torch.color(t, device="cpu", trace=True, **opts)
        assert off.trace is None and on.trace is not None
        np.testing.assert_array_equal(off.colors, on.colors)
        for f in FIELDS:
            assert getattr(off, f) == getattr(on, f), (opts, f)
    off = color_distance2(t, device="cpu", strategy="onthefly")
    assert off.trace is None


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_ring_wraparound_matches_repro(cap):
    g, t = _graph("grid")
    for mode in ("workefficient", "fused"):
        want = repro.color(g, mode=mode, tail_serial=False, trace=cap)
        got = repro_torch.color(t, mode=mode, tail_serial=False, trace=cap,
                                device="cpu")
        _assert_same_trace(want, got)
        full = repro_torch.color(t, mode=mode, tail_serial=False, trace=True,
                                 device="cpu").trace
        tr = got.trace
        assert tr.iterations == full.iterations
        assert tr.dropped == tr.iterations - cap > 0
        assert tr.check() == []
        np.testing.assert_array_equal(tr.steps, full.steps[-cap:])


def test_ring_wraparound_with_a_tail_matches_repro():
    g, t = _graph("grid")
    for engine in ("ragged", "classic"):
        want = repro.color(g, engine=engine, trace=2)
        got = repro_torch.color(t, engine=engine, trace=2, device="cpu")
        _assert_same_trace(want, got)


def test_single_graph_work_linkage():
    g, t = _graph("er")
    for mode in ("workefficient", "fused"):
        on = repro_torch.color(t, mode=mode, tail_serial=False, trace=True,
                               device="cpu")
        tr = _assert_coherent(on)
        assert tr.iterations == on.iterations and tr.tail_step == -1
        if mode == "workefficient":
            assert int(tr.series("live").sum()) == on.work_items
        else:
            assert int(tr.series("conflicts").sum()) == on.work_items


# -------------------------------------------------------- hand-built oracles


def test_edgeless_graph_oracle():
    n = 17
    g = CSRGraph(np.zeros(n + 1, np.int64), np.zeros(0, np.int32))
    r = color_data_driven(g, mode="fused", tail_serial=False, trace=True,
                          device="cpu")
    tr = r.trace
    np.testing.assert_array_equal(tr.series("live"), [n, n])
    np.testing.assert_array_equal(tr.series("conflicts"), [n, 0])
    np.testing.assert_array_equal(tr.series("retired"), [0, n])
    assert int(tr.steps[-1, 3]) == 1
    want = repro.color(RGraph(np.zeros(n + 1, np.int64), np.zeros(0, np.int32)),
                       mode="fused", tail_serial=False, trace=True)
    np.testing.assert_array_equal(want.trace.steps, tr.steps)


def test_clique_oracle():
    k = 6
    src, dst = np.triu_indices(k, 1)
    g = csr_from_edges(k, src.astype(np.int64), dst.astype(np.int64))
    r = color_data_driven(g, mode="fused", tail_serial=False, trace=True,
                          device="cpu")
    assert is_valid_coloring(g, r.colors) and r.num_colors == k
    tr = r.trace
    assert int(tr.steps[-1, 3]) == k == int(np.max(r.colors))
    conf = tr.series("conflicts")
    assert all(conf[i] > conf[i + 1] for i in range(len(conf) - 1))
    want = repro.color(r_csr_from_edges(k, src.astype(np.int64),
                                        dst.astype(np.int64)),
                       mode="fused", tail_serial=False, trace=True)
    np.testing.assert_array_equal(want.trace.steps, tr.steps)


def test_serial_tail_row_semantics():
    g, t = _graph("er")
    r = color_data_driven(t, mode="fused", tail_serial=t.n, trace=True,
                          device="cpu")
    tr = r.trace
    assert tr.tail_step >= 0
    last = tr.steps[-1]
    assert int(last[5]) == 1 and int(last[2]) == 0
    assert tr.tail_step == tr.dropped + tr.steps.shape[0] - 1
    assert tr.check(r) == []
    _assert_same_trace(repro.color(g, mode="fused", tail_serial=g.n, trace=True), r)


@pytest.mark.parametrize("algorithm", ["data_driven", "distance2", "bipartite"])
def test_empty_graph_trace(algorithm):
    if algorithm == "bipartite":
        g = BipartiteGraph.from_coo(3, 0, np.zeros(0), np.zeros(0))
    else:
        g = CSRGraph(np.zeros(1, np.int64), np.zeros(0, np.int32))
    r = repro_torch.color(g, algorithm, trace=True, device="cpu")
    assert r.trace is not None and r.trace.engine == r.algorithm
    assert r.trace.iterations == 0 and r.trace.check(r) == []
    assert empty_trace("x").tail_step == -1


# ------------------------------------------------------------------- spans


def test_span_noop_without_recorder():
    with span("never_kept"):
        pass
    with recorder() as rec:
        with span("kept", answer=42):
            pass
    assert [e.name for e in rec.events] == ["kept"]
    assert rec.events[0].meta == {"answer": 42}


def test_jit_span_first_dispatch_then_warm():
    key = ("test_torch_obs", "unique-key-A")
    with recorder() as rec:
        with jit_span("dispatch", key):
            pass
        with jit_span("dispatch", key):
            pass
    assert [e.cat for e in rec.events] == ["compile", "execute"]
    agg = rec.by_name()["dispatch"]
    assert agg["count"] == 2
    assert agg["compile_seconds"] <= agg["seconds"]


def test_jit_key_registry_advances_unrecorded():
    key = ("test_torch_obs", "unique-key-B")
    with jit_span("dispatch", key):
        pass
    assert jit_key_seen(key) is True
    with recorder() as rec:
        with jit_span("dispatch", key):
            pass
    assert rec.events[0].cat == "execute"


def test_engine_first_dispatch_then_warm():
    """The port's engine keys: a shape never dispatched before in the
    process is labelled compile, the same call again execute."""
    g = CSRGraph.from_numpy(*_star_arrays(37))
    with recorder() as first:
        repro_torch.color(g, device="cpu", mode="fused")
        repro_torch.color(g, device="cpu", mode="fused")
    cats = [e.cat for e in first.events if e.name == "fused_spec_loop"]
    assert cats == ["compile", "execute"]
    with recorder() as warm:
        repro_torch.color(g, device="cpu")
        repro_torch.color(g, device="cpu")
    cats = [e.cat for e in warm.events if e.name == "superstep"]
    assert cats[0] == "compile" and set(cats[len(cats) // 2:]) == {"execute"}


def _star_arrays(n):
    g = r_csr_from_edges(n, np.zeros(n - 1, np.int64),
                         np.arange(1, n, dtype=np.int64))
    return g.row_offsets, g.col_indices


def test_engine_spans_visible_to_outer_recorder():
    _, t = _graph("er")
    with recorder() as rec:
        r = color_data_driven(t, mode="fused", trace=True, device="cpu")
    names = {e.name for e in rec.events}
    assert {"csr_build", "superstep_loop"} <= names
    assert {"csr_build", "superstep_loop"} <= {e.name for e in r.trace.spans}


def test_validate_span():
    _, t = _graph("er")
    with recorder() as rec:
        assert is_valid_coloring(t, repro_torch.color(t, device="cpu").colors)
    ev = [e for e in rec.events if e.name == "validate"]
    assert len(ev) == 1 and ev[0].meta == {"n": t.n}


# ------------------------------------------------------- export and report


def test_chrome_export_roundtrip(tmp_path):
    _, t = _graph("er")
    r = color_data_driven(t, mode="fused", trace=True, device="cpu")
    path = tmp_path / "trace.json"
    export_chrome_trace(str(path), {"fused/er": r})
    doc = json.loads(path.read_text())
    assert {e["ph"] for e in doc["traceEvents"]} <= {"M", "X", "C", "I"}
    assert any(e["ph"] == "X" and e["name"] == "superstep_loop"
               for e in doc["traceEvents"])
    counters = [e for e in doc["traceEvents"] if e["ph"] == "C"]
    assert len([e for e in counters if e["name"] == "worklist"]) \
        == r.trace.steps.shape[0]
    back = RunTrace.from_dict(doc["otherData"]["repro"]["fused/er"])
    np.testing.assert_array_equal(back.steps, r.trace.steps)
    assert obs_report.main([str(path)]) == 0


def test_chrome_export_matches_repro_on_the_same_rows():
    """Counter events are a function of the rows; spans' clocks differ."""
    g, t = _graph("er")
    want = repro.obs.chrome_trace({"x": repro.color(g, trace=True)})
    got = chrome_trace({"x": repro_torch.color(t, trace=True, device="cpu")})
    assert want["otherData"] == got["otherData"]

    def counters(doc):
        return [(e["name"], e.get("args")) for e in doc["traceEvents"]
                if e["ph"] in ("C", "I", "M")]
    assert counters(want) == counters(got)


def test_chrome_export_skips_untraced_runs():
    _, t = _graph("er")
    doc = chrome_trace({"off": color_data_driven(t, device="cpu")})
    assert doc["traceEvents"] == [] and doc["otherData"]["repro"] == {}


def test_report_formats_match_repro():
    g, t = _graph("er")
    want = repro.color(g, mode="fused", trace=True)
    r = color_data_driven(t, mode="fused", trace=True, device="cpu")
    line = obs_report.format_result("fused", r)
    assert line == repro.obs.report.format_result("fused", want)
    assert "colors=" in line and "work=" in line
    table = obs_report.format_trace(r.trace, last=3)
    assert table == repro.obs.report.format_trace(want.trace, last=3)
    assert obs_report.format_spans(r.trace.spans).count("\n") >= 1
    assert obs_report.format_spans([]) == "spans: (none recorded)"
    block = obs_report.format_metrics({"a": 1, "bb": 2.5}, "t:")
    assert block.splitlines()[0] == "t:" and " a " in block


def test_report_bench_document(tmp_path, capsys):
    doc = {
        "schema": 6, "backend": "jax", "engine": "ragged",
        "algorithms": {"fused": {"g": {
            "colors": 3, "valid": True,
            "trace": {"supersteps": 2, "tail_step": -1, "series_from": 0,
                      "live": [4, 4], "retired": [0, 4],
                      "conflicts": [4, 0], "max_color": [1, 3],
                      "cells": [0, 32]},
        }}},
        "dynamic": {"g": {
            "rounds_detail": [{"round": 0, "frontier": 9, "work": 40,
                               "supersteps": 3, "tail_step": 2,
                               "cache_hit": False}],
            "jit": {"hits": 0, "misses": 1},
        }},
    }
    p = tmp_path / "BENCH_x.json"
    p.write_text(json.dumps(doc))
    assert obs_report.main([str(p)]) == 0
    ours = capsys.readouterr().out
    assert repro.obs.report.main([str(p)]) == 0
    assert ours == capsys.readouterr().out
    assert obs_report.main([str(tmp_path / "missing--"), "x"]) == 2
    q = tmp_path / "other.json"
    q.write_text("{}")
    assert obs_report.main([str(q)]) == 2


def test_report_module_runs_as_a_script(tmp_path):
    _, t = _graph("er")
    path = tmp_path / "trace.json"
    export_chrome_trace(str(path), {"r": color_data_driven(t, trace=True,
                                                           device="cpu")})
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", "--last", "2", str(path)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "trace[data_driven_sgr:workefficient]" in out.stdout
