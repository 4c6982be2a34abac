"""The coloring service of the port (``repro_torch.launch.coloring_service``)
against ``repro.launch.coloring_service``.

The first part mirrors ``tests/test_service.py`` test for test on
``device="cpu"``.  The second holds the two services against each other on
the same synchronous request sequence (results field for field,
``metrics()`` key for key apart from timing, span names) and checks that a
spill directory written by ``repro``'s service restores in the port's.

As in ``tests/test_service.py``, submissions are synchronous (one request a
micro-batch) except where the point is the async path itself: how async
requests happen to coalesce depends on timing, so nothing here asserts it.
"""
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import csr_from_edges as r_csr_from_edges
from repro.launch import coloring_service as rsvc_mod
from repro.options import UNSET as RUNSET
from repro.options import ColorOptions as RColorOptions

import repro_torch
import repro_torch.core.coloring as core_coloring
from repro_torch.core import is_valid_coloring
from repro_torch.core.batch import _EMPTY, GraphBatch, color_batch_fused
from repro_torch.core.csr import CSRGraph, csr_from_edges
from repro_torch.errors import Overloaded, ReproError, SessionEvicted
from repro_torch.launch import coloring_service as tsvc_mod
from repro_torch.launch.coloring_service import ColoringService
from repro_torch.options import UNSET, ColorOptions
from test_torch_package import _service_requests

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("iterations", "work_items", "padded_work", "class_cells", "converged")


def _graph(n=60, m=240, seed=0):
    rng = np.random.default_rng(seed)
    return csr_from_edges(n, rng.integers(0, n, m), rng.integers(0, n, m))


def _rgraph(n=60, m=240, seed=0):
    rng = np.random.default_rng(seed)
    return r_csr_from_edges(n, rng.integers(0, n, m), rng.integers(0, n, m))


def _tg(g) -> CSRGraph:
    return CSRGraph.from_numpy(g.row_offsets, g.col_indices)


def _direct(g, *args, **kw):
    return repro_torch.color(g, *args, device="cpu", **kw)


@pytest.fixture()
def svc():
    s = ColoringService(pool_size=4, queue_limit=16, max_batch=8, device="cpu")
    yield s
    s.shutdown()
    assert not s._worker.is_alive()


# --------------------------------------------------------------------------
# one-shot coloring through the micro-batcher
# --------------------------------------------------------------------------

def test_color_bit_identical_to_direct(svc):
    g = _graph()
    served = svc.color(g)
    direct = _direct(g, "fused")
    np.testing.assert_array_equal(served.colors, direct.colors)
    assert served.num_colors == direct.num_colors


def test_color_async_burst_all_valid_and_identical(svc):
    graphs = [_graph(seed=s) for s in range(6)]
    tickets = [svc.color(g, wait=False) for g in graphs]
    results = [t.wait(60) for t in tickets]
    for g, r in zip(graphs, results):
        assert is_valid_coloring(g, r.colors)
        np.testing.assert_array_equal(r.colors, _direct(g, "fused").colors)
    m = svc.metrics()
    assert m["completed"] == len(graphs)
    assert m["batched_requests"] == len(graphs)


def test_bucket_jit_key_is_stable_across_repeats(svc):
    g = _graph()
    svc.color(g)                       # first presentation of the key
    before = svc.metrics()["bucket_jit_misses"]
    for _ in range(4):                 # same (bucket, B=1) key every time
        svc.color(g)
    after = svc.metrics()["bucket_jit_misses"]
    assert after == before
    assert svc.metrics()["bucket_jit_hits"] >= 4


def test_incompatible_options_take_slow_path(svc):
    g = _graph()
    r = svc.color(g, ensure_valid=True)   # the ladder is per-request only
    assert is_valid_coloring(g, r.colors)
    assert svc.metrics()["slow_requests"] == 1


def test_distinct_options_get_distinct_buckets(svc):
    g = _graph()
    svc.color(g)
    svc.color(g, heuristic="id")
    assert len(svc.metrics()["buckets"]) == 2


def test_request_errors_cross_the_thread_boundary(svc):
    with pytest.raises(KeyError):
        svc.recolor("never-opened")
    with pytest.raises(TypeError):
        svc.open_session("bad", object())
    assert svc.metrics()["failed"] == 2


def test_engine_error_in_the_worker_reaches_the_caller(svc, monkeypatch):
    """An error raised inside the engine (as a kernel's launch error is)
    fails that ticket only; it is not retried and the worker serves on."""
    g = _graph()

    def broken(*args, **kwargs):
        raise RuntimeError("superstep launch failed: CUDA error 700")

    monkeypatch.setattr(core_coloring, "ragged_superstep", broken)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        svc.color(g)
    monkeypatch.undo()
    np.testing.assert_array_equal(svc.color(g).colors, _direct(g, "fused").colors)
    m = svc.metrics()
    assert m["failed"] == 1 and m["completed"] == 1 and m["slow_requests"] == 0


# --------------------------------------------------------------------------
# backpressure: bounded queue, structured Overloaded
# --------------------------------------------------------------------------

def test_overload_rejects_structured_and_bounded():
    g = _graph()
    with ColoringService(pool_size=2, queue_limit=4, max_batch=2,
                         device="cpu") as svc:
        tickets, errors = [], []
        for _ in range(40):
            try:
                tickets.append(svc.color(g, wait=False))
            except Overloaded as e:
                errors.append(e)
        for t in tickets:
            assert is_valid_coloring(g, t.wait(60).colors)
        assert errors, "flooding a queue_limit=4 service must shed load"
        e = errors[0]
        assert isinstance(e, ReproError)
        assert e.limit == 4 and e.queue_depth >= e.limit
        assert e.retry_after >= 0.0
        p = e.payload()
        assert p["error"] == "Overloaded" and p["limit"] == 4
        m = svc.metrics()
        assert m["rejected"] == len(errors)
        assert m["completed"] + m["rejected"] == 40


def test_shutdown_refuses_new_work(svc):
    svc.shutdown()
    with pytest.raises(RuntimeError):
        svc.color(_graph())


# --------------------------------------------------------------------------
# session pool: LRU admission, eviction, spill/restore
# --------------------------------------------------------------------------

def test_eviction_without_spill_is_structured():
    g = _graph()
    with ColoringService(pool_size=1, queue_limit=16, device="cpu") as svc:
        svc.open_session("a", g)
        out = svc.open_session("b", g)
        assert out["evicted"] == "a"
        with pytest.raises(SessionEvicted) as ei:
            svc.colors("a")
        assert ei.value.session_id == "a"
        assert isinstance(ei.value, LookupError)
        assert ei.value.payload()["error"] == "SessionEvicted"
        assert svc.metrics()["evictions"] == 1


def test_eviction_spills_and_restores(tmp_path):
    g = _graph()
    with ColoringService(pool_size=1, queue_limit=16, spill_dir=str(tmp_path),
                         device="cpu") as svc:
        svc.open_session("a", g)
        svc.apply_delta("a", add_edges=(np.array([0, 1]), np.array([2, 3])))
        svc.recolor("a")
        want = svc.colors("a")
        svc.open_session("b", g)              # evicts "a" to disk
        assert svc.metrics()["spills"] == 1
        got = svc.colors("a")                 # transparent restore (LRU bump)
        np.testing.assert_array_equal(got, want)
        m = svc.metrics()
        assert m["restores"] == 1 and m["pool_occupancy"] == 1


def test_session_ops_match_direct_session(svc):
    g = _graph()
    svc.open_session("s", g, heuristic="id")
    direct = repro_torch.open_session(g, heuristic="id", device="cpu")
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        add = (rng_a.integers(0, g.n, 8), rng_a.integers(0, g.n, 8))
        svc.apply_delta("s", add_edges=add)
        svc.recolor("s")
        direct.apply_delta(add_edges=(rng_b.integers(0, g.n, 8),
                                      rng_b.integers(0, g.n, 8)))
        direct.recolor()
    np.testing.assert_array_equal(svc.colors("s"), direct.colors)
    assert (svc.session_metrics("s")["recolors"]
            == direct.metrics()["recolors"])


def test_reopen_replaces_and_close_forgets(svc):
    g = _graph()
    svc.open_session("s", g)
    svc.apply_delta("s", add_edges=(np.array([0]), np.array([5])))
    svc.open_session("s", g)                  # replace: pending delta gone
    np.testing.assert_array_equal(
        svc.colors("s"), repro_torch.open_session(g, device="cpu").colors)
    assert svc.close_session("s") is True
    assert svc.close_session("s") is False
    with pytest.raises(KeyError):
        svc.colors("s")


def test_maintain_compacts_deferred_overlays(svc):
    g = _graph()
    svc.open_session("s", g)
    rng = np.random.default_rng(3)
    for _ in range(12):                       # grow overlays past the due
        svc.apply_delta("s", add_edges=(rng.integers(0, g.n, 30),
                                        rng.integers(0, g.n, 30)))
        svc.recolor("s")
    done = svc.maintain("s")
    assert "compact" in done["s"]
    assert svc.maintain() == {"s": []}        # sweep: nothing left due
    assert is_valid_coloring(svc._touch("s").graph, svc.colors("s"))


# --------------------------------------------------------------------------
# durability: checkpoint -> kill -> restore
# --------------------------------------------------------------------------

def test_spilled_session_survives_service_kill(tmp_path):
    from repro_torch.dynamic.session import ColoringSession

    g = _graph(n=120, m=600, seed=4)
    ref = repro_torch.open_session(g, device="cpu")
    rng = np.random.default_rng(11)

    svc = ColoringService(pool_size=1, queue_limit=16, spill_dir=str(tmp_path),
                          device="cpu")
    svc.open_session("live", g)
    for _ in range(5):
        k = 10
        a, b = rng.integers(0, g.n, k), rng.integers(0, g.n, k)
        svc.apply_delta("live", add_edges=(a, b))
        svc.recolor("live")
        ref.apply_delta(add_edges=(a, b))
        ref.recolor()
    svc.open_session("other", g)              # spill "live" durably
    svc.shutdown()                            # the "kill"
    assert not svc._worker.is_alive()
    del svc

    rest = ColoringSession.restore(str(tmp_path / "live"), device="cpu")
    assert rest.recovery is not None and not rest.recovery["truncated"]
    np.testing.assert_array_equal(rest.colors, ref.colors)
    # post-restore lockstep: the restored session behaves like the original
    a, b = rng.integers(0, g.n, 10), rng.integers(0, g.n, 10)
    rest.apply_delta(add_edges=(a, b))
    rest.recolor()
    ref.apply_delta(add_edges=(a, b))
    ref.recolor()
    np.testing.assert_array_equal(rest.colors, ref.colors)


def test_spill_journal_corruption_is_detected(tmp_path):
    from repro_torch import faultlab
    from repro_torch.dynamic.session import ColoringSession

    g = _graph(seed=5)
    svc = ColoringService(pool_size=1, queue_limit=16, spill_dir=str(tmp_path),
                          device="cpu")
    svc.open_session("live", g)
    svc.open_session("other", g)              # spill "live": snapshot on disk
    svc.colors("live")                        # restore; journal reattached
    rng = np.random.default_rng(2)
    for _ in range(4):                        # journaled through the service
        svc.apply_delta("live", add_edges=(rng.integers(0, g.n, 8),
                                           rng.integers(0, g.n, 8)))
        svc.recolor("live")
    svc.shutdown()

    faultlab.truncate_journal(str(tmp_path / "live"), mode="tear")
    rest = ColoringSession.restore(str(tmp_path / "live"), device="cpu")
    assert rest.recovery["truncated"]         # the detector fires
    # the torn tail may have cut a recolor record, leaving its delta's
    # frontier legitimately pending: one repair restores validity
    rest.recolor()
    assert rest.validate()


# --------------------------------------------------------------------------
# telemetry
# --------------------------------------------------------------------------

def test_trace_spans_cover_requests_and_microbatches():
    g = _graph()
    with ColoringService(pool_size=2, queue_limit=16, trace=True,
                         device="cpu") as svc:
        svc.open_session("s", g)
        svc.recolor("s")
        svc.color(g)
        names = {e.name for e in svc.take_spans()}
    assert "serve_request" in names and "serve_microbatch" in names
    assert svc.take_spans() == []             # drained


def test_metrics_shape():
    g = _graph()
    with ColoringService(pool_size=2, queue_limit=16, device="cpu") as svc:
        svc.open_session("s", g)
        svc.color(g)
        m = svc.metrics()
    for key in ("admitted", "completed", "rejected", "queue_depth",
                "queue_limit", "pool_occupancy", "pool_size",
                "bucket_jit_hits", "bucket_jit_misses",
                "session_engine_cache_hits", "session_engine_cache_misses",
                "ewma_request_seconds", "buckets"):
        assert key in m, key
    assert m["pool_occupancy"] == 1 and m["queue_depth"] == 0


# --------------------------------------------------------------------------
# the port's own: device, imports, padding, concurrency
# --------------------------------------------------------------------------

def test_service_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ColoringService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.ColoringService(device="cuda")


@pytest.mark.parametrize("call", ["color", "open_session", "service"])
def test_per_request_device_is_refused(svc, call):
    g = _graph()
    with pytest.raises(ValueError, match="device"):
        if call == "color":
            svc.color(g, device="cpu")
        elif call == "open_session":
            svc.open_session("s", g, options=ColorOptions(extra={"device": "cpu"}))
        else:
            ColoringService(options=ColorOptions(extra={"device": "cpu"}),
                            device="cpu")
    assert svc.metrics()["admitted"] == 0


@pytest.mark.parametrize("module", [
    "repro_torch.launch.coloring_service", "benchmarks.port_serve",
    "examples.port_batch_serve", "examples.port_stream_serve"])
def test_import_loads_neither_jax_nor_repro(module):
    code = (f"import sys; sys.path[:0] = ['src', '.']; import {module}; "
            "from repro_torch import ColoringService, Overloaded, SessionEvicted; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("distance2", [False, True], ids=["d1", "d2"])
def test_from_graphs_packs_empty_members_and_shape_pad(distance2):
    """The service's padded micro-batch: zero-vertex graphs and an edge-free
    shape graph pack into flat ids with ``width=`` widening W; results equal
    ``repro``'s batch of the same padded list."""
    import repro.core.batch as rbatch
    from repro.core.csr import CSRGraph as RCSRGraph

    reals = [_rgraph(seed=s) for s in range(3)]
    n2, w2 = 128, 512
    pad = [RCSRGraph(np.zeros(n2 + 1, np.int64), np.zeros(0, np.int32))]
    rlist = reals + pad + [rbatch._EMPTY] * 4
    tlist = [_tg(g) for g in reals + pad] + [_EMPTY] * 4
    batch = GraphBatch.from_graphs(tlist, width=w2, distance2=distance2,
                                   device="cpu")
    assert batch.B == 8 and batch.n_max == n2 and batch.width == w2
    assert batch.sizes == (60, 60, 60, n2, 0, 0, 0, 0)
    assert batch.sentinel == 8 * (n2 + 1) - 1
    assert int(batch.deg[3 * (n2 + 1):].sum()) == 0   # pad rows hold no edge
    want = rbatch.color_batch_fused(
        rbatch.GraphBatch.from_graphs(rlist, width=w2, distance2=distance2),
        distance2=distance2)
    got = color_batch_fused(batch, distance2=distance2)
    assert len(got) == len(want) == 8
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.colors, b.colors)
        for f in FIELDS + ("algorithm",):
            assert getattr(a, f) == getattr(b, f), f


def test_concurrent_submitters_lose_no_update():
    """Six threads submit at once with a short switch interval: every
    request is either admitted and finished or rejected, and the counters
    add up."""
    g = _graph()
    want = _direct(g, "fused").colors
    lock = threading.Lock()
    outcomes = {"ok": 0, "rejected": 0, "bad": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ColoringService(pool_size=2, queue_limit=6, max_batch=4,
                             device="cpu") as svc:
            def client():
                for _ in range(10):
                    try:
                        r = svc.color(g, wait=False).wait(60)
                        key = "ok" if np.array_equal(r.colors, want) else "bad"
                    except Overloaded:
                        key = "rejected"
                    with lock:
                        outcomes[key] += 1

            threads = [threading.Thread(target=client) for _ in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
            m = svc.metrics()
    finally:
        sys.setswitchinterval(old)
    assert outcomes["bad"] == 0
    assert outcomes["ok"] + outcomes["rejected"] == 60
    assert m["admitted"] == m["completed"] == outcomes["ok"]
    assert m["rejected"] == outcomes["rejected"] and m["failed"] == 0
    assert m["batched_requests"] == outcomes["ok"]


# --------------------------------------------------------------------------
# parity with repro's service
# --------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    RColorOptions(), RColorOptions(heuristic="id"),
    RColorOptions(algorithm="distance2", tail_serial=None, max_iters=7),
    RColorOptions(ensure_valid=True, trace=True),
    RColorOptions(extra={"mode": "fused", "tiling": (8, 32)}),
])
def test_describe_matches_repro(opts):
    fields = {f: getattr(opts, f) for f in ColorOptions._FIELDS
              if getattr(opts, f) is not RUNSET}
    port = ColorOptions(**fields, extra=dict(opts.extra))
    assert (port.tail_serial is UNSET) == (opts.tail_serial is RUNSET)
    assert port.describe() == opts.describe()


@pytest.mark.parametrize("name,kwargs", [
    ("Overloaded", {"queue_depth": 7, "limit": 4, "retry_after": 0.25}),
    ("Overloaded", {"queue_depth": 4, "limit": 4}),
    ("SessionEvicted", {"session_id": "user-7"}),
    ("SessionEvicted", {}),
])
def test_service_errors_match_repro(name, kwargs):
    import repro.errors as rerrors

    import repro_torch.errors as terrors

    want = getattr(rerrors, name)("full", **kwargs)
    got = getattr(terrors, name)("full", **kwargs)
    assert got.payload() == want.payload()
    assert isinstance(got, terrors.ReproError)
    assert isinstance(got, LookupError) == isinstance(want, LookupError)
    assert getattr(repro_torch, name) is type(got)


@pytest.mark.parametrize("sid", ["a", "user-7", "tenant:7/a b", "ü.x_y", "../up"])
def test_safe_name_matches_repro(sid):
    assert tsvc_mod._safe_name(sid) == rsvc_mod._safe_name(sid)


def _same(a, b):
    if hasattr(a, "colors") and hasattr(a, "iterations"):
        np.testing.assert_array_equal(a.colors, b.colors)
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), f
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_service_matches_repro(tmp_path):
    """The same synchronous requests through both services: every result
    field, ``metrics()`` apart from its timing field, and the span names."""
    rgraphs = [_rgraph(seed=s) for s in range(2)]
    rsess = _rgraph(n=90, m=300, seed=3)
    r = rsvc_mod.ColoringService(pool_size=1, queue_limit=16, max_batch=8,
                                 spill_dir=str(tmp_path / "repro"), trace=True)
    try:
        want = _service_requests(r, rgraphs, rsess, np.random.default_rng(5))
        want_m = r.metrics()
        want_spans = [e.name for e in r.take_spans()]
    finally:
        r.shutdown()
    with ColoringService(pool_size=1, queue_limit=16, max_batch=8,
                         spill_dir=str(tmp_path / "port"), trace=True,
                         device="cpu") as t:
        got = _service_requests(t, [_tg(g) for g in rgraphs], _tg(rsess),
                        np.random.default_rng(5))
        got_m = t.metrics()
        got_spans = [e.name for e in t.take_spans()]
    assert len(want) == len(got)
    for a, b in zip(want, got):
        _same(a, b)
    for m in (want_m, got_m):
        m.pop("ewma_request_seconds")
    assert got_m == want_m
    assert got_m["spills"] == 4 and got_m["restores"] == 3
    assert got_spans == want_spans


def test_repro_spill_directory_restores_in_the_port(tmp_path):
    """A session spilled by ``repro``'s service (under ``_safe_name`` of an
    id with unsafe characters) restores in the port's with the same
    colours, and serves on in lockstep with a direct port session."""
    sid = "tenant:7/a b"
    g = _rgraph(n=120, m=600, seed=4)
    rng = np.random.default_rng(11)
    deltas = [(rng.integers(0, g.n, 10), rng.integers(0, g.n, 10))
              for _ in range(4)]
    r = rsvc_mod.ColoringService(pool_size=1, queue_limit=16,
                                 spill_dir=str(tmp_path))
    try:
        r.open_session(sid, g)
        for a, b in deltas[:3]:
            r.apply_delta(sid, add_edges=(a, b))
            r.recolor(sid)
        want = r.colors(sid)
        r.open_session("other", g)            # spills sid
    finally:
        r.shutdown()
    assert (tmp_path / tsvc_mod._safe_name(sid)).is_dir()

    ref = repro_torch.open_session(_tg(g), device="cpu")
    for a, b in deltas[:3]:
        ref.apply_delta(add_edges=(a, b))
        ref.recolor()
    with ColoringService(pool_size=1, queue_limit=16, spill_dir=str(tmp_path),
                         device="cpu") as t:
        t._spilled.add(sid)                   # the id the caller still holds
        np.testing.assert_array_equal(t.colors(sid), want)
        assert t.metrics()["restores"] == 1
        a, b = deltas[3]
        t.apply_delta(sid, add_edges=(a, b))
        t.recolor(sid)
        ref.apply_delta(add_edges=(a, b))
        ref.recolor()
        np.testing.assert_array_equal(t.colors(sid), ref.colors)
