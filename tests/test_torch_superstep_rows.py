"""K3 of the PyTorch port reading its rows where they lie, against repro.

``superstep_rows`` reads each worklist id's row from a row source — the
dense table (``TableRows``), CSR rows (``CsrRows``) or composed two-hop rows
(``TwoHopLanes``) — with colours and degrees in place; K1
(``superstep_csr``) runs the same body over packed CSR words.  On CPU tensors
they take their plain versions, which gather the source's tile and run the
superstep over it.  These tests hold those against ``repro``'s oracle
(``superstep_ref``) and its Pallas kernel in interpret mode
(``superstep_tpu``), run on the tile that ``repro``'s own provider gathers
(``DenseRows``, ``DeviceCSR``, ``TwoHopRows``) from the same numpy arrays.

The card reads a row only up to its degree (each hop's, for two-hop rows);
``card_tile`` below models that read and must give the full tile on the
engines' own tables.  The engine's card branch is run on the CPU with
``_on_card`` made true, so it calls the wrapper (and its plain version)
with the providers' sources and never their ``rows``.  Inputs are made
with numpy from a seed; everything is integer arithmetic, so the tolerance
is 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.coloring as RC
import repro.d2.coloring as RD2
from repro.core.csr import DeviceCSR as RDeviceCSR
from repro.graphs import erdos_renyi, jacobian_band, jacobian_tall_skinny, power_law
from repro.kernels.superstep.ops import superstep_tpu
from repro.kernels.superstep.ref import superstep_ref

import repro_torch
import repro_torch.core.coloring as TC
import repro_torch.d2.bipartite as TB
import repro_torch.d2.coloring as TD2
from repro_torch.core.csr import CSRGraph as TGraph
from repro_torch.core.csr import DeviceCSR as TDeviceCSR
from repro_torch.kernels.cuda import CsrRows, TableRows, TwoHopLanes
from repro_torch.kernels.superstep.csr_kernel import superstep_csr, superstep_csr_ref
from repro_torch.kernels.superstep.kernel import (
    source_tile,
    superstep_rows,
    superstep_rows_ref,
    superstep_tile,
)

HEURISTICS = ["id", "degree"]
SOURCES = ["table", "csr", "csr-class", "csr-g2", "packed", "two-hop-d2",
           "two-hop-bipartite", "two-hop-start"]


def _t(x) -> torch.Tensor:
    """A CPU tensor with the same contents as a numpy or JAX array."""
    return torch.from_numpy(np.array(x))


def _tg(g) -> TGraph:
    return TGraph.from_numpy(g.row_offsets, g.col_indices)


def _tb(bg) -> TB.BipartiteGraph:
    return TB.BipartiteGraph(bg.row_offsets, bg.row_to_col, bg.col_offsets, bg.col_to_row)


def _ext(degrees) -> np.ndarray:
    return np.concatenate([degrees, [0]]).astype(np.int32)


def _colors(rng, n: int, hi: int) -> np.ndarray:
    """``(n + 1,)`` colours in ``[0, hi]`` with 0 in the sentinel slot."""
    c = rng.integers(0, hi + 1, n + 1).astype(np.int32)
    c[n] = 0
    return c


def _ids(rng, n: int, w: int, low: int = 0) -> np.ndarray:
    """``w`` distinct ids of ``[low, n)`` and three sentinel entries."""
    ids = rng.choice(np.arange(low, n), min(w, n - low), replace=False)
    return np.concatenate([ids, [n, n, n]]).astype(np.int32)


def _case(source: str, mode: str, seed: int):
    """``(repro_tile, port_source, W, deg_ext, colors, ids, wide_row)`` for
    one case: repro's provider's tile of ``ids`` (numpy), the port's row
    source for the same arrays, the row width, the loser rule's degrees and
    the colours (numpy).  ``mode`` picks the colours: ``low`` in [0, 5]
    (many clashes), ``wide`` in [0, min(W + 1, 40)], and where a row holds
    33 or more distinct neighbours (``wide_row``) those hold 1, 2, ... one
    each and the row's vertex 0, so FirstFit takes the shared-bitset
    path."""
    rng = np.random.default_rng(seed)
    if source == "table":
        g = power_law(400, 4.0, seed=5)
        adj = g.padded_adjacency()
        deg, W = _ext(g.degrees), adj.shape[1]
        ids = _ids(rng, g.n, 150)
        tile = RC.DenseRows(jnp.asarray(adj)).rows(jnp.asarray(ids))
        port, W = TC.DenseRows(_t(adj), TDeviceCSR.from_csr(_tg(g), "cpu")).lane_source()
    elif source in ("csr", "csr-class", "packed"):
        g = power_law(400, 4.0, seed=5)
        deg = _ext(g.degrees)
        if source == "csr-class":  # a degree class cut to its width
            W = 16
            ids = _ids(rng, g.n, 150)
            ids = ids[deg[ids] <= W]
        else:
            W, ids = g.max_degree, _ids(rng, g.n, 150)
        tile = RDeviceCSR.from_csr(g).rows(jnp.asarray(ids), W)
        port, W = TDeviceCSR.from_csr(_tg(g), "cpu").lane_source(W)
    elif source == "csr-g2":  # G² rows, the loser rule on G's degrees
        g = erdos_renyi(300, 4.0, seed=1)
        g2 = g.square()
        deg, W = _ext(g.degrees), g2.max_degree
        ids = _ids(rng, g.n, 150)
        tile = RDeviceCSR.from_csr(g2).rows(jnp.asarray(ids))
        port, W = TDeviceCSR.from_csr(_tg(g2), "cpu").lane_source()
    elif source in ("two-hop-d2", "two-hop-start"):
        g = erdos_renyi(200, 3.0, seed=0)
        adj = g.padded_adjacency()
        deg = _ext(g.degrees)
        if source == "two-hop-d2":
            a, start, ids = adj, 0, _ids(rng, g.n, 120)
        else:  # a shard's slice of the first hop: rows [60, 140)
            a, start = adj[60:140], 60
            ids = np.concatenate([_ids(rng, g.n, 120)[:-3], [5, 59, 140, 199, g.n]])
            ids = ids.astype(np.int32)
        tile = RD2.TwoHopRows(jnp.asarray(a), jnp.asarray(adj), True, start,
                              g.n).rows(jnp.asarray(ids))
        port, W = TD2.TwoHopRows(_t(a), _t(adj), True, start, g.n).lane_source()
    else:  # bipartite: cols → rows → cols, no hop-1 lanes
        bg = jacobian_band(300, band=3)
        c2r, r2c = bg.padded_halves()
        deg = _ext(bg.col_degrees)
        ids = _ids(rng, bg.n_cols, 150)
        tile = RD2.TwoHopRows(jnp.asarray(c2r), jnp.asarray(r2c), False).rows(
            jnp.asarray(ids))
        port, W = TD2.TwoHopRows(_t(c2r), _t(r2c), False).lane_source()
    n = deg.shape[0] - 1
    tile = np.asarray(tile)
    colors = _colors(rng, n, 5 if mode == "low" else min(W + 1, 40))
    wide_row = False
    if mode == "wide":
        real = [np.setdiff1d(r[r < n], [v]) for r, v in zip(tile, ids)]
        i = max(range(len(real)), key=lambda k: real[k].size)
        if real[i].size >= 33:
            colors[real[i]] = rng.permutation(real[i].size) + 1
            colors[ids[i]] = 0
            wide_row = True
    return tile, port, W, deg, colors, ids, wide_row


@pytest.mark.parametrize("mode", ["low", "wide"])
@pytest.mark.parametrize("heuristic", HEURISTICS)
@pytest.mark.parametrize("source", SOURCES)
def test_superstep_rows_plain_matches_repro(source, heuristic, mode):
    tile, port, W, deg, colors, ids, wide_row = _case(source, mode,
                                                      seed=len(source) + len(mode))
    args = tuple(map(jnp.asarray, (ids, tile, colors[ids], colors[tile], deg[ids],
                                   deg[tile])))
    want = tuple(map(np.asarray, superstep_ref(*args, heuristic)))
    if mode == "wide":  # interpret-mode Pallas, one colouring a source
        tpu = superstep_tpu(*args, heuristic, interpret=True)
        for a, b in zip(want, tpu, strict=True):
            np.testing.assert_array_equal(a, np.asarray(b))
    n = deg.shape[0] - 1
    if source == "packed":
        packed = _t(colors) + (_t(deg) << 16)
        runs = [superstep_csr_ref(port.row_starts, port.col, packed, _t(ids), W, heuristic),
                superstep_csr(port.row_starts, port.col, packed, _t(ids), W, heuristic)]
    else:
        np.testing.assert_array_equal(tile, source_tile(port, _t(ids), n, W).numpy())
        kw = dict(source=port, W=W)
        runs = [superstep_rows_ref(_t(colors), _t(deg), _t(ids), heuristic, **kw),
                superstep_rows(_t(colors), _t(deg), _t(ids), heuristic, **kw)]
    for new_c, need in runs:
        assert new_c.dtype == torch.int32 and need.dtype == torch.bool
        np.testing.assert_array_equal(want[0], new_c.numpy())
        np.testing.assert_array_equal(want[1], need.numpy())
    assert want[1].any() and not want[1][:-3].all()
    if wide_row:
        assert (want[0] > 32).any()  # a row took the shared-bitset path
    assert wide_row or mode == "low" or source.startswith("two-hop") or W < 32


# --------------------------------------------------------------------------
# the card's read: each row up to its degree, each hop up to its own
# --------------------------------------------------------------------------

def card_tile(source, deg_ext, ids, n: int, W: int) -> torch.Tensor:
    """The composed id tile as the card reads it: every lane the kernel
    does not read stands as the sentinel ``n`` (colour 0).  A table row
    ``v < n`` is read up to ``min(deg_ext[v], W)`` lanes, a CSR row up to
    ``min(R[v+1] - R[v], W)``; a two-hop row (valid as ``two_hop_tile``
    masks) reads its hop-1 lanes up to ``min(deg_a[l], W1)`` and, for each
    of those mid ids below ``n_mid``, that mid row up to ``min(deg_b[mid],
    W2)``."""
    full = source_tile(source, ids, n, W)
    if isinstance(source, TableRows):
        length = torch.where(ids < n, deg_ext[ids.clamp(max=n).long()].clamp(max=W), 0)
        read = torch.arange(W)[None, :] < length[:, None]
        return torch.where(read, full, n)
    if isinstance(source, CsrRows):
        return full
    a, b = source.adj_a, source.adj_b
    n_rows, n_mid, W1, W2 = a.shape[0], b.shape[0], a.shape[1], b.shape[1]
    lidx = (ids - source.start).long()
    valid = (ids < n) & (lidx < n_rows)
    row = lidx.clamp(0, n_rows - 1)
    hop1 = torch.arange(W1)[None, :] < torch.where(valid, source.deg_a[row].clamp(max=W1),
                                                   0)[:, None]
    mids = torch.where(hop1, a[row], n_mid)
    safe = mids.clamp(max=n_mid - 1).long()
    len2 = torch.where(mids < n_mid, source.deg_b[safe].clamp(max=W2), 0)
    hop2 = torch.arange(W2)[None, None, :] < len2[:, :, None]
    lanes2 = torch.where(hop2, b[safe], n).reshape(ids.shape[0], -1)
    if source.include_first_hop:
        return torch.cat([torch.where(hop1, mids, n), lanes2], dim=1)
    return lanes2


def _engine_provider(monkeypatch, module, call):
    """The row provider (and degrees) ``call()`` hands the ragged engine."""
    seen = {}

    class Seen(Exception):
        pass

    def record(**kw):
        seen.update(kw)
        raise Seen

    monkeypatch.setattr(module, "run_ragged_engine", record)
    with pytest.raises(Seen):
        call()
    monkeypatch.undo()
    return seen["provider"], seen["deg_ext"]


ENGINE_CALLS = {
    "padded": (TC, lambda g, bg: repro_torch.color(g, device="cpu", engine="padded")),
    "ragged": (TC, lambda g, bg: repro_torch.color(g, device="cpu")),
    "distance2": (TD2, lambda g, bg: repro_torch.color(g, "distance2", device="cpu",
                                                       strategy="onthefly")),
    "distance2-precomputed": (TD2, lambda g, bg: repro_torch.color(
        g, "distance2", device="cpu", strategy="precomputed")),
    "bipartite": (TD2, lambda g, bg: repro_torch.color(bg, "bipartite", device="cpu",
                                                       strategy="onthefly")),
}


@pytest.mark.parametrize("graph", ["erdos_renyi", "power_law"])
@pytest.mark.parametrize("engine", sorted(ENGINE_CALLS))
def test_card_read_gives_the_full_tile(monkeypatch, engine, graph):
    """On the tables each engine hands the superstep (the padded engine's
    dense table, a DeviceCSR, G², the composed two-hop tables with their
    degrees read off the tables), the rows the card reads up to each degree
    are the full tiles: so K3 answers as over the full rows, which the test
    above holds to repro."""
    src = erdos_renyi(300, 4.0, seed=2) if graph == "erdos_renyi" else power_law(
        300, 3.0, seed=6)
    g = _tg(src)
    bg = _tb(jacobian_band(200, band=2) if graph == "erdos_renyi"
             else jacobian_tall_skinny(300, 30, 3, seed=1))
    module, call = ENGINE_CALLS[engine]
    provider, deg_ext = _engine_provider(monkeypatch, module, lambda: call(g, bg))
    n = deg_ext.shape[0] - 1
    ids = torch.cat([torch.arange(n, dtype=torch.int32),
                     torch.full((3,), n, dtype=torch.int32)])
    source, W = provider.lane_source()
    full = source_tile(source, ids, n, W)
    assert torch.equal(provider.rows(ids), full)
    assert torch.equal(card_tile(source, deg_ext, ids, n, W), full)
    if isinstance(provider, TD2.TwoHopRows):  # read off the tables: the degrees
        assert torch.equal(source.deg_a, deg_ext[:n])


# --------------------------------------------------------------------------
# the engine's card branch, on the CPU
# --------------------------------------------------------------------------

def _mid_state(rows_fn, deg, n: int, steps: int):
    """repro's colours and worklist after ``steps`` rotated supersteps over
    every vertex from the bootstrap identity (every vertex colour 1)."""
    colors = jnp.concatenate([jnp.ones(n, jnp.int32), jnp.zeros(1, jnp.int32)])
    wl = jnp.arange(n, dtype=jnp.int32)
    for _ in range(steps):
        colors, wl, count = RC.ragged_superstep(rows_fn, jnp.asarray(deg), colors, wl)
        wl = wl[:max(int(count), 1)]
    return np.asarray(colors), np.asarray(wl)


MID_RUN = {
    "table": lambda: power_law(400, 4.0, seed=5),
    "csr": lambda: power_law(400, 4.0, seed=5),
    "two-hop-d2": lambda: erdos_renyi(200, 3.0, seed=0),
    "two-hop-bipartite": lambda: jacobian_band(300, band=3),
}


@pytest.mark.parametrize("coarsen", [1, 3])
@pytest.mark.parametrize("source", sorted(MID_RUN))
def test_card_branch_matches_repro_mid_run(monkeypatch, source, coarsen):
    """At a state one superstep into a run, the port's ``ragged_superstep``
    with its card branch taken (``_on_card`` made true, every provider's
    ``rows`` made to raise) gives repro's colours, worklist and count: K3's
    wrapper runs over each provider's lane source, chunks read earlier
    chunks' writes."""
    g = MID_RUN[source]()
    if source == "table":
        adj = g.padded_adjacency()
        rows_fn = RC.DenseRows(jnp.asarray(adj)).rows
        port = TC.DenseRows(_t(adj), TDeviceCSR.from_csr(_tg(g), "cpu"))
        deg = _ext(g.degrees)
    elif source == "csr":
        rows_fn = RDeviceCSR.from_csr(g).rows
        port = TDeviceCSR.from_csr(_tg(g), "cpu")
        deg = _ext(g.degrees)
    elif source == "two-hop-d2":
        adj = g.padded_adjacency()
        rows_fn = RD2.TwoHopRows(jnp.asarray(adj), jnp.asarray(adj)).rows
        deg = _ext(g.degrees)
        port = TD2.TwoHopRows(_t(adj), _t(adj))
    else:
        c2r, r2c = g.padded_halves()
        rows_fn = RD2.TwoHopRows(jnp.asarray(c2r), jnp.asarray(r2c), False).rows
        deg = _ext(g.col_degrees)
        port = TD2.TwoHopRows(_t(c2r), _t(r2c), False)
    n = deg.shape[0] - 1
    colors, wl = _mid_state(rows_fn, deg, n, steps=1)
    want_c, want_wl, want_count = RC.ragged_superstep(
        rows_fn, jnp.asarray(deg), jnp.asarray(colors), jnp.asarray(wl), coarsen=coarsen)

    def refuse(*args, **kwargs):
        raise AssertionError("the card branch gathered a tile")

    monkeypatch.setattr(TC, "_on_card", lambda t: True)
    monkeypatch.setattr(port, "rows", refuse)
    before = superstep_tile.launches
    got_c, got_wl, got_count = TC.ragged_superstep(
        port, _t(deg), _t(colors), _t(wl), coarsen=coarsen)
    assert superstep_tile.launches == before  # plain versions on the CPU
    np.testing.assert_array_equal(np.asarray(want_c), got_c.numpy())
    np.testing.assert_array_equal(np.asarray(want_wl), got_wl.numpy())
    assert int(want_count) == int(got_count)


@pytest.mark.parametrize("opts", [
    dict(engine="padded"), dict(coarsen_lanes=64), dict(mode="fused", engine="padded"),
    dict(algorithm="distance2", strategy="onthefly"),
    dict(algorithm="bipartite", strategy="onthefly"),
], ids=["padded", "chunked", "padded-fused", "distance2", "bipartite"])
def test_card_branch_runs_the_engines_without_rows(monkeypatch, opts):
    """Whole runs through the card branch on the CPU (``_on_card`` true,
    the superstep's ``provider.rows`` made to raise; the composed tail may
    still gather) give the CPU branch's result field for field."""
    opts = dict(opts)
    algorithm = opts.pop("algorithm", "data_driven")
    if algorithm == "bipartite":
        g = _tb(jacobian_band(400, band=2))
    else:
        g = _tg(power_law(3000, 4.0, seed=7) if algorithm == "data_driven"
                else erdos_renyi(300, 4.0, seed=2))
    want = repro_torch.color(g, algorithm, device="cpu", **opts)

    def refuse(*args, **kwargs):
        raise AssertionError("the superstep gathered a tile on the card branch")

    real = TC.ragged_superstep

    def guarded(provider, *args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(provider, "rows", refuse)
            m.setattr(TC, "gather_rows", refuse)
            return real(provider, *args, **kwargs)

    monkeypatch.setattr(TC, "_on_card", lambda t: True)
    monkeypatch.setattr(TC, "ragged_superstep", guarded)
    got = repro_torch.color(g, algorithm, device="cpu", **opts)
    np.testing.assert_array_equal(want.colors, got.colors)
    for f in ("iterations", "work_items", "padded_work", "class_cells", "converged"):
        assert getattr(want, f) == getattr(got, f), f


# --------------------------------------------------------------------------
# the wrappers' arguments
# --------------------------------------------------------------------------

def test_superstep_rows_checks_its_arguments():
    tile, port, W, deg, colors, ids, _ = _case("table", "low", seed=3)
    c, d, i = _t(colors), _t(deg), _t(ids)
    for lanes in (1, 4, 8, 16, 32):  # a forced layout is checked, then the plain path runs
        assert all(torch.equal(a, b) for a, b in zip(
            superstep_rows(c, d, i, source=port, W=W, lanes=lanes),
            superstep_rows(c, d, i, source=port, W=W)))
    with pytest.raises(ValueError, match="lanes must be one of"):
        superstep_rows(c, d, i, source=port, W=W, lanes=3)
    with pytest.raises(ValueError, match="unknown heuristic"):
        superstep_rows(c, d, i, "random", source=port, W=W)
    with pytest.raises(TypeError, match="unknown row source"):
        superstep_rows(c, d, i, source=port.table, W=W)
    with pytest.raises(ValueError, match="table has shape"):
        superstep_rows(c, d, i, source=port, W=W + 1)
    with pytest.raises(ValueError, match="ids must be 1-D"):
        superstep_rows(c, d, i[:, None], source=port, W=W)
    with pytest.raises(ValueError, match="deg_ext must be"):
        superstep_rows(c, d[:-1], i, source=port, W=W)
    with pytest.raises(ValueError, match="at least 1"):
        superstep_rows(c, d, i, source=port, W=0)
    with pytest.raises(ValueError, match="row_starts must be"):
        superstep_rows(c, d, i, source=CsrRows(d[:-1], d), W=W)
    _, hop, Wh, degh, colh, idh, _ = _case("two-hop-d2", "low", seed=3)
    with pytest.raises(ValueError, match="two-hop rows colour"):
        superstep_rows(_t(colh), _t(degh), _t(idh), source=hop, W=Wh - 1)
    mixed = TwoHopLanes(hop.adj_a, hop.adj_b[:50], hop.deg_a, hop.deg_b, True, 0,
                        hop.n_colored)
    with pytest.raises(ValueError, match="mid side"):
        superstep_rows(_t(colh), _t(degh), _t(idh), source=mixed, W=mixed.width)
    with pytest.raises(ValueError, match="shared memory"):
        superstep_rows(c, d, i[:0], source=CsrRows(d, d), W=240_000)
    new_c, need = superstep_rows(c, d, i[:0], source=port, W=W)
    assert new_c.shape == (0,) and need.dtype == torch.bool
