"""Fault injection in the port (``repro_torch.faultlab``) against
``repro.faultlab``.

Mirrors ``tests/test_faultlab.py``: every detector fires and every
recovery path heals, with the port's results equal to ``repro``'s (colours,
fields, ladder ``degradations``, journal replay after ``truncate_journal``).
The two halo-word tests run the injector against the port's detector
``check_halo_words``; the injector itself is held against ``repro``'s
here.  Durable directories cross between the packages in both directions.
"""
import json
import shutil

import numpy as np
import pytest

import repro
from repro import faultlab as rfaultlab
from repro.core import csr_from_edges as r_csr_from_edges
from repro.dynamic.journal import SessionJournal as RJournal
from repro.dynamic.session import ColoringSession as RSession
from repro.ingest import pack_halo_words

from repro_torch import faultlab
from repro_torch.api import color, open_session
from repro_torch.core import CSRGraph, is_valid_coloring
from repro_torch.core.guarantee import residual_vertices, serial_repair
from repro_torch.dynamic.journal import JOURNAL_NAME, SessionJournal
from repro_torch.dynamic.session import ColoringSession
from repro_torch.ingest import check_halo_words
from repro_torch.ingest import pack_halo_words as tpack_halo_words

FIELDS = ("iterations", "work_items", "padded_work", "class_cells", "converged",
          "algorithm", "degradations")


def _tg(g) -> CSRGraph:
    return CSRGraph.from_numpy(g.row_offsets, g.col_indices)


def _assert_same(want, got):
    np.testing.assert_array_equal(want.colors, got.colors)
    for f in FIELDS:
        assert getattr(want, f) == getattr(got, f), f


@pytest.fixture(scope="module")
def rgraph():
    rng = np.random.default_rng(11)
    n = 300
    return r_csr_from_edges(n, rng.integers(0, n, 2200), rng.integers(0, n, 2200))


@pytest.fixture(scope="module")
def graph(rgraph):
    return _tg(rgraph)


# --------------------------------------------------------------------------
# fault 1: colors corrupted between engine and commit
# --------------------------------------------------------------------------

def test_corrupt_colors_is_detected(graph, rgraph):
    with faultlab.corrupt_colors(fraction=0.05, seed=3):
        r = color(graph, "data_driven", device="cpu")
    assert not is_valid_coloring(graph, r.colors)
    with rfaultlab.corrupt_colors(fraction=0.05, seed=3):
        want = repro.color(rgraph, "data_driven")
    _assert_same(want, r)


def test_corrupt_colors_recovered_by_ladder(graph, rgraph):
    with faultlab.corrupt_colors(fraction=0.05, seed=3):
        r = color(graph, "data_driven", ensure_valid=True, device="cpu")
    assert r.converged and is_valid_coloring(graph, r.colors)
    assert [d["rung"] for d in r.degradations if d["stage"] == "ladder"]
    with rfaultlab.corrupt_colors(fraction=0.05, seed=3):
        want = repro.color(rgraph, "data_driven", ensure_valid=True)
    _assert_same(want, r)


def test_corrupt_colors_restores_registry(graph):
    from repro_torch import api

    api._ensure_registered()
    before = dict(api._REGISTRY)
    with pytest.raises(ZeroDivisionError):
        with faultlab.corrupt_colors():
            assert api._REGISTRY != before
            1 / 0
    assert api._REGISTRY == before
    assert is_valid_coloring(graph, color(graph, "data_driven", device="cpu").colors)


def test_corrupt_session_colors_full_recolor_heals(graph, rgraph):
    s = open_session(graph, device="cpu")
    assert s.validate()
    s.colors = faultlab._corrupt(s.graph, s.colors, 0.05, seed=1)
    np.testing.assert_array_equal(
        s.colors, rfaultlab._corrupt(rgraph, repro.open_session(rgraph).colors,
                                     0.05, seed=1))
    assert not s.validate()
    s.recolor(full=True)
    assert s.validate()


def test_serial_repair_survives_garbage_colors(graph):
    rng = np.random.default_rng(0)
    colors = rng.integers(-5, 10**6, graph.n).astype(np.int32)
    colors[:10] = 0
    colors[10:20] = -3
    residual = residual_vertices(graph, colors)
    out = serial_repair(graph, colors, np.arange(graph.n), order="oracle")
    assert is_valid_coloring(graph, out) and residual.size >= 20


# --------------------------------------------------------------------------
# fault 2: poisoned packed halo words
# --------------------------------------------------------------------------

def test_poisoned_halo_words_detected():
    n = 200
    rng = np.random.default_rng(4)
    words = tpack_halo_words(rng.integers(0, n, 64), rng.integers(1, 12, 64))
    assert check_halo_words(words, n).size == 0      # clean words pass
    poisoned = faultlab.poison_halo_words(words, n, fraction=0.25, seed=9)
    bad = check_halo_words(poisoned, n)
    changed = np.nonzero(poisoned != words)[0]
    assert changed.size > 0
    assert set(changed) <= set(bad.tolist())         # every poison detected


def test_poison_covers_all_flavors():
    words = tpack_halo_words(np.zeros(30, np.int64), np.ones(30, np.int64))
    poisoned = faultlab.poison_halo_words(words, 30, fraction=1.0, seed=0)
    assert (poisoned < 0).any()                      # negative word
    ids = (poisoned.astype(np.int64) >> 16)
    assert (ids > 30).any()                          # out-of-range id
    cols = poisoned & 0xFFFF
    assert ((poisoned >= 0) & (cols > 30)).any()     # impossible color
    assert set(check_halo_words(poisoned, 30).tolist()) == set(range(30))


@pytest.mark.parametrize("fraction,seed", [(0.25, 9), (1.0, 0)])
def test_poison_halo_words_matches_repro(fraction, seed):
    rng = np.random.default_rng(4)
    words = pack_halo_words(rng.integers(0, 200, 64), rng.integers(1, 12, 64))
    got = faultlab.poison_halo_words(words, 200, fraction=fraction, seed=seed)
    want = rfaultlab.poison_halo_words(words, 200, fraction=fraction, seed=seed)
    np.testing.assert_array_equal(want, got)
    assert got.dtype == np.int32 and (got != words).any()
    assert faultlab.poison_halo_words(np.zeros(0, np.int32), 5).size == 0


# --------------------------------------------------------------------------
# fault 3: torn / corrupted write-ahead journal
# --------------------------------------------------------------------------

def _churn(s, n, seed, rounds=6):
    rng = np.random.default_rng(seed)
    for i in range(rounds):
        k = max(1, n // 100)
        s.apply_delta(add_edges=(rng.integers(0, n, k), rng.integers(0, n, k)))
        if i % 2:
            s.apply_delta(remove_edges=(rng.integers(0, n, k // 2 + 1),
                                        rng.integers(0, n, k // 2 + 1)))
        s.recolor()


def test_checkpoint_kill_restore_bit_identical(graph, tmp_path):
    ref = open_session(graph, device="cpu")
    dur = open_session(graph, durable_dir=str(tmp_path), snapshot_every=5,
                       device="cpu")
    _churn(ref, graph.n, 21)
    _churn(dur, graph.n, 21)
    del dur
    rest = ColoringSession.restore(str(tmp_path), device="cpu")
    assert rest.recovery is not None and not rest.recovery["truncated"]
    np.testing.assert_array_equal(ref.colors, rest.colors)
    assert rest.validate()
    _churn(ref, graph.n, 33)
    _churn(rest, graph.n, 33)
    np.testing.assert_array_equal(ref.colors, rest.colors)
    assert rest.metrics()["recolors"] == ref.metrics()["recolors"]


def _restored_pair(tmp_path, write_with_repro: bool, graph, rgraph, mode=None):
    """A durable session under churn written by one package, torn with
    ``mode`` (by that package's ``truncate_journal``), then restored by
    each package from its own copy of the directory."""
    d = str(tmp_path / "w")
    if write_with_repro:
        s = repro.open_session(rgraph, durable_dir=d, snapshot_every=4)
    else:
        s = open_session(graph, durable_dir=d, snapshot_every=4, device="cpu")
    _churn(s, graph.n, 5, rounds=5)
    del s
    if mode is not None:
        lab = rfaultlab if write_with_repro else faultlab
        lab.truncate_journal(d, mode=mode)
    for sub in ("r", "t"):
        shutil.copytree(d, str(tmp_path / sub))
    return (RSession.restore(str(tmp_path / "r")),
            ColoringSession.restore(str(tmp_path / "t"), device="cpu"))


@pytest.mark.parametrize("mode", [None, "tear", "garbage", "drop"])
@pytest.mark.parametrize("writer", ["repro", "port"])
def test_durable_dirs_cross_between_packages(graph, rgraph, tmp_path, writer, mode):
    """A directory written by either package restores in both to the same
    state (colours, frontier, counters, recovery report), and the records
    and snapshot each writes next are the same bytes."""
    want, got = _restored_pair(tmp_path, writer == "repro", graph, rgraph, mode)
    assert want.recovery == got.recovery
    assert got.recovery["truncated"] == (mode in ("tear", "garbage"))
    np.testing.assert_array_equal(want.colors, got.colors)
    np.testing.assert_array_equal(want.frontier(), got.frontier())
    assert want.metrics() == got.metrics()
    assert got.validate()
    for s in (want, got):
        s.apply_delta(add_edges=(np.array([0, 2]), np.array([1, 3])))
    _assert_same(want.recolor(), got.recolor())
    want.checkpoint()
    got.checkpoint()
    logs = []
    for sub in ("r", "t"):
        with open(tmp_path / sub / JOURNAL_NAME, "rb") as f:
            logs.append(f.read().splitlines()[-2:])
        with open(tmp_path / sub / "snapshot.json") as f:
            logs.append(json.load(f))
        with np.load(tmp_path / sub / "snapshot.npz") as z:
            logs.append({k: z[k] for k in z.files})
    assert logs[0] == logs[3] and logs[1] == logs[4]
    if mode != "tear":  # after a tear the next record shares the torn line
        assert [json.loads(x)["kind"] for x in logs[0]] == ["delta", "recolor"]
    assert set(logs[2]) == set(logs[5])
    for k in logs[2]:
        np.testing.assert_array_equal(logs[2][k], logs[5][k])
        assert logs[2][k].dtype == logs[5][k].dtype
    # each package's reader takes the same records from either directory
    for sub in ("r", "t"):
        want_recs = list(RJournal(str(tmp_path / sub)).records())
        assert list(SessionJournal(str(tmp_path / sub)).records()) == want_recs


@pytest.mark.parametrize("mode", ["tear", "garbage"])
def test_truncated_journal_detected_and_recovered(graph, tmp_path, mode):
    s = open_session(graph, durable_dir=str(tmp_path), snapshot_every=1000,
                     device="cpu")
    _churn(s, graph.n, 5, rounds=4)
    del s
    faultlab.truncate_journal(str(tmp_path), mode=mode)
    rest = ColoringSession.restore(str(tmp_path), device="cpu")
    assert rest.recovery["truncated"] and rest.validate()
    rest.apply_delta(add_edges=(np.array([0]), np.array([1])))
    rest.recolor()
    assert rest.validate()


def test_dropped_tail_replays_clean_prefix(graph, tmp_path):
    s = open_session(graph, durable_dir=str(tmp_path), snapshot_every=1000,
                     device="cpu")
    _churn(s, graph.n, 5, rounds=4)
    total = s.metrics()["journal_seq"]
    del s
    removed = faultlab.truncate_journal(str(tmp_path), mode="drop", records=2)
    assert removed > 0
    rest = ColoringSession.restore(str(tmp_path), device="cpu")
    assert not rest.recovery["truncated"]
    assert rest.metrics()["journal_seq"] == total - 2
    assert rest.validate()
    with pytest.raises(ValueError, match="unknown mode"):
        faultlab.truncate_journal(str(tmp_path), mode="shred")


def test_restore_without_snapshot_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no snapshot"):
        ColoringSession.restore(str(tmp_path), device="cpu")


# --------------------------------------------------------------------------
# fault 4: forced non-convergence
# --------------------------------------------------------------------------

def test_starved_run_detected(graph, rgraph):
    assert faultlab.starved_opts() == rfaultlab.starved_opts()
    r = color(graph, "data_driven", engine="classic", device="cpu",
              **faultlab.starved_opts())
    assert not r.converged
    _assert_same(repro.color(rgraph, "data_driven", engine="classic",
                             **rfaultlab.starved_opts()), r)


def test_starved_run_recovered_by_ladder(graph, rgraph):
    r = color(graph, "data_driven", engine="classic", ensure_valid=True,
              device="cpu", **faultlab.starved_opts())
    assert r.converged and is_valid_coloring(graph, r.colors)
    outcomes = {d["rung"]: d["outcome"] for d in r.degradations
                if d["stage"] == "ladder"}
    assert outcomes and any(v == "resolved" for v in outcomes.values())
    _assert_same(repro.color(rgraph, "data_driven", engine="classic",
                             ensure_valid=True, **rfaultlab.starved_opts()), r)


def test_starved_session_raise_vs_ladder(graph, rgraph):
    k = np.arange(40)
    src, dst = np.meshgrid(k, k)
    with pytest.raises(RuntimeError, match="ladder"):
        s = open_session(graph, device="cpu", **faultlab.starved_opts())
        s.apply_delta(add_edges=(src.ravel(), dst.ravel()))
        s.recolor()
    s = open_session(graph, on_fail="ladder", device="cpu",
                     **faultlab.starved_opts())
    ref = repro.open_session(rgraph, on_fail="ladder", **rfaultlab.starved_opts())
    _assert_same(ref.result, s.result)
    assert s.result.converged and s.validate()
    for x in (s, ref):
        x.apply_delta(add_edges=(src.ravel(), dst.ravel()))
    r = s.recolor()
    _assert_same(ref.recolor(), r)
    assert r.converged and s.validate()
    assert any(d["stage"] == "ladder" for d in r.degradations)


def test_ladder_trace_spans_surface(graph):
    r = color(graph, "data_driven", engine="classic", ensure_valid=True,
              trace=True, device="cpu", **faultlab.starved_opts())
    assert "guarantee_ladder" in [s.name for s in r.trace.spans]


def test_adversarial_corpus_matches_repro():
    assert set(faultlab.ADVERSARIAL_GRAPHS) == set(rfaultlab.ADVERSARIAL_GRAPHS)
    for name, (ro, ci) in rfaultlab.ADVERSARIAL_GRAPHS.items():
        got = faultlab.ADVERSARIAL_GRAPHS[name]
        np.testing.assert_array_equal(ro, got[0])
        np.testing.assert_array_equal(ci, got[1])
        assert (ro.dtype, ci.dtype) == (got[0].dtype, got[1].dtype)
