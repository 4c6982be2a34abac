"""The port's sharded engine (``repro_torch.core.distributed``) against
``repro``'s.

* The partition plan and the halo words, host numpy only: ``balanced_starts``,
  ``PartitionedCSR`` (both boundary modes, the bipartite plan, every array
  it builds) and ``pack``/``unpack``/``check_halo_words`` equal ``repro``'s
  array for array.
* The engine at several shards.  ``repro`` runs its sharded engine over a
  mesh of devices, which one process gets only with
  ``--xla_force_host_platform_device_count`` set before JAX starts; so one
  module-scoped fixture runs ``repro`` once, in a subprocess with 8 host
  devices, over the fixed ``CASES`` list, and writes every result field
  (trace rows and span names of the traced cases too) to a file.  The port
  runs the same cases with ``devices=["cpu"] * k`` and must equal it in
  every field, ``padded_work`` and ``halo_bytes_per_step`` included.
* One device and the errors: ``engine="sharded"`` on one device is the
  ragged fused call, as in ``repro``; the error messages are ``repro``'s.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import repro
import repro.core.csr as rcsr
import repro.ingest as ringest
from repro.d2 import BipartiteGraph as RBipartite
from repro.graphs import build_graph, jacobian_band, road, serving_mix
from repro.graphs.suite import SUITE

import repro_torch
import repro_torch.core.csr as tcsr
import repro_torch.ingest as tingest
from repro_torch.core import color_distributed
from repro_torch.core.coloring import ColoringResult
from repro_torch.d2 import BipartiteGraph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

FIELDS = ("iterations", "work_items", "padded_work", "class_cells", "converged",
          "algorithm", "halo_bytes_per_step")

# (id, kind, graph, shard count, options); a graph is ("suite", name, scale),
# ("road", n, seed), ("band", n_rows, band) or ("mix", count, scale)
D1_GRAPHS = {"rmat-g": ("suite", "rmat-g", 0.02),
             "ASIC_320ks": ("suite", "ASIC_320ks", 0.02),
             "nlpkkt160": ("suite", "nlpkkt160", 0.02)}
CASES = [
    (f"d1-{g}-{k}-degree", "d1", spec, k, {})
    for g, spec in D1_GRAPHS.items() for k in (2, 3, 8)
] + [
    (f"d1-{g}-{k}-id", "d1", D1_GRAPHS[g], k, {"heuristic": "id"})
    for g, k in (("rmat-g", 8), ("ASIC_320ks", 2), ("nlpkkt160", 3))
] + [
    ("d1-notail", "d1", D1_GRAPHS["rmat-g"], 3, {"tail_serial": None, "tiling": None}),
    ("d1-unpacked", "d1", ("road", 40000, 9), 3, {}),
    ("d1-traced", "d1", D1_GRAPHS["nlpkkt160"], 3, {"trace": True}),
    ("d2-precomputed", "d2", ("suite", "rmat-g", 0.02), 8, {"strategy": "precomputed"}),
    ("d2-onthefly", "d2", ("suite", "rmat-g", 0.02), 8,
     {"strategy": "onthefly", "trace": True}),
    ("bip-precomputed", "bip", ("band", 3000, 3), 8, {"strategy": "precomputed"}),
    ("bip-onthefly", "bip", ("band", 3000, 3), 8, {"strategy": "onthefly"}),
    ("batch-wide", "batch", ("mix", 6, 0.05), 2, {}),
    ("batch-narrow", "batch", ("mix", 2, 0.05), 3, {"trace": True}),
]
CASE_IDS = [c[0] for c in CASES]

# the reference: repro over a mesh of k of 8 host devices, every case in one
# process; the same graph specs are built from the same numpy seeds here
REFERENCE = r"""
import json, pickle, sys
import jax
import repro
from repro.core import color_batch_sharded
from repro.graphs import build_graph, jacobian_band, road, serving_mix

def graph(spec):
    kind, a, b = spec
    if kind == "suite":
        return build_graph(a, b)
    if kind == "road":
        return road(a, seed=b)
    if kind == "band":
        return jacobian_band(a, band=b)
    return serving_mix(a, b)

def fields(r):
    out = {f: getattr(r, f) for f in ("colors", "iterations", "work_items",
           "padded_work", "class_cells", "converged", "algorithm",
           "halo_bytes_per_step")}
    if r.trace is not None:
        out["steps"] = r.trace.steps
        out["trace_iterations"] = r.trace.iterations
        out["spans"] = [e.name for e in r.trace.spans]
    return out

cases, path = json.loads(sys.argv[1]), sys.argv[2]
assert jax.device_count() == 8
out = {}
for cid, kind, spec, k, opts in cases:
    g, devs = graph(spec), jax.devices()[:k]
    if kind == "d1":
        r = repro.color(g, engine="sharded", devices=devs, **opts)
    elif kind == "d2":
        r = repro.color(g, "distance2", engine="sharded", devices=devs, **opts)
    elif kind == "bip":
        r = repro.color(g, "bipartite", engine="sharded", devices=devs, **opts)
    else:  # repro.color_batch passes devices= twice with engine="sharded"
        r = color_batch_sharded(g, devices=devs, **opts)
    out[cid] = [fields(x) for x in r] if kind == "batch" else fields(r)
with open(path, "wb") as f:
    pickle.dump(out, f)
"""


def _graph(spec):
    kind, a, b = spec
    if kind == "suite":
        return build_graph(a, b)
    if kind == "road":
        return road(a, seed=b)
    if kind == "band":
        return jacobian_band(a, band=b)
    return serving_mix(a, b)


def _tg(g):
    if isinstance(g, RBipartite):
        return BipartiteGraph(g.row_offsets, g.row_to_col, g.col_offsets,
                              g.col_to_row)
    return tcsr.CSRGraph.from_numpy(g.row_offsets, g.col_indices)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded") / "reference.pkl"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE, json.dumps(CASES), str(path)],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_same(want: dict, got: ColoringResult):
    np.testing.assert_array_equal(want["colors"], got.colors)
    for f in FIELDS:
        assert want[f] == getattr(got, f), (f, want[f], getattr(got, f))
    if "steps" in want:
        np.testing.assert_array_equal(want["steps"], got.trace.steps)
        assert want["trace_iterations"] == got.trace.iterations
        assert want["spans"] == [e.name for e in got.trace.spans]
        assert got.trace.check(got) == []
    else:
        assert got.trace is None


# --------------------------------------------------------------------------
# the engine at several shards, against repro at as many devices
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_matches_repro(reference, case):
    cid, kind, spec, k, opts = case
    g = _graph(spec)
    devs = ["cpu"] * k
    if kind == "batch":
        got = repro_torch.color_batch([_tg(x) for x in g], engine="sharded",
                                      devices=devs, **opts)
        assert len(got) == len(reference[cid])
        for want, r in zip(reference[cid], got):
            _assert_same(want, r)
        return
    algorithm = {"d1": "data_driven", "d2": "distance2", "bip": "bipartite"}[kind]
    got = repro_torch.color(_tg(g), algorithm, engine="sharded", devices=devs,
                            **opts)
    _assert_same(reference[cid], got)


def test_sharded_colours_equal_the_single_device_call(reference):
    """``repro``'s invariant: every shard count gives the single-device
    colours and iterations (``tests/test_sharded.py``)."""
    for cid, kind, spec, k, opts in CASES:
        if kind != "d1":
            continue
        one = repro_torch.color(_tg(_graph(spec)), device="cpu", **opts)
        np.testing.assert_array_equal(one.colors, reference[cid]["colors"])
        assert one.iterations == reference[cid]["iterations"], cid


# --------------------------------------------------------------------------
# the partition plan and the halo words, host numpy
# --------------------------------------------------------------------------

def _assert_plans_equal(want, got, g_want=None, g_got=None, rows=None):
    assert (want.n, want.ndev, want.n_loc, want.halo_words) == (
        got.n, got.ndev, got.n_loc, got.halo_words)
    for name in ("starts", "lens"):
        np.testing.assert_array_equal(getattr(want, name), getattr(got, name))
    for name in ("interior", "boundary", "recv"):
        a, b = getattr(want, name), getattr(got, name)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(want.owners(), got.owners())
    np.testing.assert_array_equal(want.boundary_masks(), got.boundary_masks())
    if g_want is not None:
        for x, y in zip(want.stack_shards(g_want), got.stack_shards(g_got)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    if rows is not None:
        for fill in (0, want.n):
            np.testing.assert_array_equal(want.stack_rows(rows, fill),
                                          got.stack_rows(rows, fill))


NDEVS = (1, 2, 3, 5, 8)


@pytest.mark.parametrize("name", sorted(SUITE))
def test_plan_matches_repro(name):
    g = build_graph(name, 0.02)
    tg = _tg(g)
    rows = g.padded_adjacency()
    for ndev in NDEVS:
        w = np.diff(g.row_offsets).astype(np.int64) + 1
        np.testing.assert_array_equal(rcsr.balanced_starts(w, ndev),
                                      tcsr.balanced_starts(w, ndev))
        for mode in ("edge", "two_hop"):
            _assert_plans_equal(
                rcsr.PartitionedCSR.from_graph(g, ndev, boundary_mode=mode),
                tcsr.PartitionedCSR.from_graph(tg, ndev, boundary_mode=mode),
                g, tg, rows if mode == "two_hop" else None)


@pytest.mark.parametrize("shape", [(3000, 3), (517, 8)], ids=["band3", "band8"])
def test_bipartite_plan_matches_repro(shape):
    bg = jacobian_band(shape[0], band=shape[1])
    tb = _tg(bg)
    c2r, _ = bg.padded_halves()
    for ndev in NDEVS:
        _assert_plans_equal(rcsr.PartitionedCSR.from_bipartite(bg, ndev),
                            tcsr.PartitionedCSR.from_bipartite(tb, ndev),
                            rows=c2r)


def test_plan_edge_cases_match_repro():
    for w, ndev in ((np.zeros(0, np.int64), 3), (np.ones(2, np.int64), 5),
                    (np.asarray([100, 1, 1, 1]), 3), (np.arange(7), 0)):
        np.testing.assert_array_equal(rcsr.balanced_starts(w, ndev),
                                      tcsr.balanced_starts(w, ndev))
    g = road(300, seed=1)
    with pytest.raises(ValueError, match="boundary_mode") as want:
        rcsr.PartitionedCSR.from_graph(g, 2, boundary_mode="nope")
    with pytest.raises(ValueError, match="boundary_mode") as got:
        tcsr.PartitionedCSR.from_graph(_tg(g), 2, boundary_mode="nope")
    assert str(want.value) == str(got.value)


def test_plan_validate_input_matches_repro():
    from repro_torch.errors import IngestError

    rows = np.asarray([0, 2, 3, 3, 4])
    cols = np.asarray([1, 2, 0, 3], np.int32)  # 0->2 and 3->2 lack reverses
    rg, tg = rcsr.CSRGraph(rows, cols), tcsr.CSRGraph(rows, cols)
    with pytest.raises(IngestError):
        tcsr.PartitionedCSR.from_graph(tg, 2, validate_input="strict")
    want = rcsr.PartitionedCSR.from_graph(rg, 2, validate_input="repair")
    got = tcsr.PartitionedCSR.from_graph(tg, 2, validate_input="repair")
    _assert_plans_equal(want, got)


def test_halo_words_match_repro():
    from repro import faultlab as rfaultlab

    rng = np.random.default_rng(4)
    for n in (1, 200, 2**15 - 1):
        ids = rng.integers(0, n + 1, 257)
        colors = np.where(ids == n, 0, rng.integers(1, min(n, 40) + 1, 257))
        words = tingest.pack_halo_words(ids, colors)
        np.testing.assert_array_equal(words, ringest.pack_halo_words(ids, colors))
        for a, b in zip(tingest.unpack_halo_words(words),
                        ringest.unpack_halo_words(words)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tingest.unpack_halo_words(words)[0], ids)
        assert tingest.check_halo_words(words, n).size == 0
        if n > 2**14:
            continue  # the injector's out-of-range ids pass int32 there
        poisoned = rfaultlab.poison_halo_words(words, n, fraction=0.3, seed=n)
        got = tingest.check_halo_words(poisoned, n)
        np.testing.assert_array_equal(got, ringest.check_halo_words(poisoned, n))
        assert got.dtype == np.int64 and got.size
    # the sentinel must carry colour 0
    bad = tingest.pack_halo_words([5], [1])
    assert tingest.check_halo_words(bad, 5).tolist() == [0]


def test_halo_word_budget_boundary():
    assert tingest.packed_halo_ok(2**15 - 1) and not tingest.packed_halo_ok(2**15)
    for n in (2**15 - 1, 2**15):
        assert tingest.packed_halo_ok(n) == ringest.packed_halo_ok(n)
    assert tingest.__all__ == ringest.__all__


# --------------------------------------------------------------------------
# one device, the API and the errors
# --------------------------------------------------------------------------

def _one_device_graph():
    return build_graph("rmat-g", 0.02)


def test_one_device_is_the_ragged_fused_call():
    g = _one_device_graph()
    want = repro.color(g, engine="sharded")  # one JAX device here
    fused = repro_torch.color(_tg(g), device="cpu", mode="fused")
    for got in (repro_torch.color(_tg(g), engine="sharded", device="cpu"),
                repro_torch.color(_tg(g), engine="sharded", devices=["cpu"])):
        np.testing.assert_array_equal(want.colors, got.colors)
        np.testing.assert_array_equal(fused.colors, got.colors)
        for f in FIELDS:
            assert getattr(want, f) == getattr(got, f) == getattr(fused, f), f
    assert got.halo_bytes_per_step == 0.0


@pytest.mark.parametrize("kind", ["d2", "bip"])
def test_one_device_distance2_and_bipartite(kind):
    if kind == "d2":
        g, algorithm = build_graph("rmat-g", 0.02), "distance2"
    else:
        g, algorithm = jacobian_band(3000, band=3), "bipartite"
    want = repro.color(g, algorithm, engine="sharded", strategy="onthefly")
    got = repro_torch.color(_tg(g), algorithm, engine="sharded", device="cpu",
                            strategy="onthefly")
    np.testing.assert_array_equal(want.colors, got.colors)
    for f in FIELDS:
        assert getattr(want, f) == getattr(got, f), f


def test_one_shard_runs_the_whole_sharded_machinery():
    """``color_distributed`` on one device still shards (one shard): it
    equals ``repro``'s on one device and the fused call in accounting."""
    g = _one_device_graph()
    want = repro.core.color_distributed(g)
    got = color_distributed(_tg(g), devices=["cpu"], trace=True)
    fused = repro_torch.color(_tg(g), device="cpu", mode="fused")
    np.testing.assert_array_equal(want.colors, got.colors)
    for f in FIELDS:
        assert getattr(want, f) == getattr(got, f), f
    for f in ("iterations", "work_items", "padded_work"):
        assert getattr(got, f) == getattr(fused, f), f
    assert got.algorithm == "sharded_sgr_1dev" and got.trace.check(got) == []


def test_one_device_batch_is_the_batched_engine():
    graphs = serving_mix(3, 0.05)
    want = repro.color_batch(graphs, engine="sharded")
    got = repro_torch.color_batch([_tg(g) for g in graphs], engine="sharded",
                                  device="cpu")
    for w, r in zip(want, got):
        np.testing.assert_array_equal(w.colors, r.colors)
        for f in FIELDS:
            assert getattr(w, f) == getattr(r, f), f


def test_empty_graph_on_several_shards():
    empty = tcsr.CSRGraph(np.zeros(1, np.int64), np.zeros(0, np.int32))
    r = repro_torch.color(empty, engine="sharded", devices=["cpu"] * 3)
    assert r.colors.size == 0 and r.converged and r.algorithm == "data_driven_sgr"
    r = color_distributed(empty, devices=["cpu"] * 3, trace=True)
    assert r.algorithm == "sharded_sgr_3dev" and r.trace.iterations == 0


def _message(call):
    with pytest.raises(ValueError) as e:
        call()
    return str(e.value)


def test_errors_match_repro():
    from repro.d2 import color_distance2 as r_d2

    from repro_torch.d2 import color_distance2 as t_d2

    g = _one_device_graph()
    tg = _tg(g)
    cpu3 = ["cpu"] * 3
    ragged = _message(lambda: repro.color(g, heuristic="nope"))
    for call in (lambda: repro_torch.color(tg, engine="sharded", devices=cpu3,
                                           heuristic="nope"),
                 lambda: color_distributed(tg, devices=cpu3, heuristic="nope"),
                 lambda: repro_torch.color(tg, device="cpu", heuristic="nope")):
        assert _message(call) == ragged
    for opts in (dict(coarsen_lanes=32), dict(coarsen_ff=2), dict(coarsen_cr=3)):
        assert _message(lambda: repro_torch.color(
            tg, engine="sharded", devices=cpu3, **opts)) == _message(
            lambda: repro.color(g, engine="sharded", **opts))
    assert _message(lambda: t_d2(tg, engine="sharded", devices=cpu3, coarsen=2)) \
        == _message(lambda: r_d2(g, engine="sharded", coarsen=2))
    for call in (lambda: repro_torch.color(tg, device="cpu", engine="nope"),
                 lambda: t_d2(tg, device="cpu", engine="nope")):
        assert "sharded" in _message(call)
    want = _message(lambda: repro.color_batch([g], devices=[object()]))
    got = _message(lambda: repro_torch.color_batch([tg], devices=cpu3, device="cpu"))
    assert want.split(";")[0] == got.split(";")[0]


def test_devices_may_not_mix_the_cpu_and_a_card():
    tg = _tg(_one_device_graph())
    for devs in (["cpu", "cuda"], ["cuda:0", "cpu", "cpu"]):
        with pytest.raises(ValueError, match="mixes the CPU and CUDA"):
            repro_torch.color(tg, engine="sharded", devices=devs)
        with pytest.raises(ValueError, match="mixes the CPU and CUDA"):
            repro_torch.color_batch([tg] * 4, engine="sharded", devices=devs)
    with pytest.raises(ValueError, match="disagrees"):
        repro_torch.color(tg, engine="sharded", devices=["cpu"] * 2, device="cuda")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        repro_torch.color(tg, engine="sharded", devices=["cpu"] * 2, backend="cuda")


def test_session_options_refuse_the_sharded_engine():
    from repro.options import ColorOptions as ROptions

    from repro_torch.options import ColorOptions

    with pytest.raises(ValueError, match="engine='sharded' does not apply"):
        ROptions(engine="sharded").session_kwargs()
    with pytest.raises(ValueError, match="engine='sharded' does not apply"):
        ColorOptions(engine="sharded").session_kwargs()


def test_coloring_result_fields_match_repro_in_order():
    import dataclasses

    from repro.core.coloring import ColoringResult as RResult

    want = [(f.name, f.default) for f in dataclasses.fields(RResult)]
    got = [(f.name, f.default) for f in dataclasses.fields(ColoringResult)]
    assert [w[0] for w in want] == [g[0] for g in got]
    assert [w[1] for w in want] == [g[1] for g in got]


def test_core_all_equals_repro():
    import repro.core

    import repro_torch.core

    assert repro_torch.core.__all__ == repro.core.__all__
    assert tcsr.__all__.count("balanced_starts") == 1
    assert set(rcsr.__all__) <= set(tcsr.__all__)
