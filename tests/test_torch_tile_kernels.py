"""K3, K4 and K5 of the PyTorch port, and the engine pieces around them,
against repro.

On CPU tensors the port's tile-kernel wrappers take their plain PyTorch
versions; these tests hold those against ``repro``'s oracles
(``superstep_ref``, ``firstfit_ref``, ``conflict_ref``) and its Pallas
kernels run in interpret mode.  The engine pieces that feed them
(``gather_rows``, ``DenseRows``, ``padded_adjacency``, ``degree_buckets``,
``_chunk_bounds``, the classic ``sgr_step`` and the chunked rotated step)
are held against ``repro``'s JAX formulations.  Inputs are made with numpy
from a seed; everything is integer arithmetic, so the tolerance is 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.coloring as C
from repro.core import DeviceCSR
from repro.graphs import erdos_renyi, power_law
from repro.kernels.conflict.ops import conflict_tpu
from repro.kernels.conflict.ref import conflict_ref
from repro.kernels.firstfit.ops import firstfit_bitset_tpu
from repro.kernels.firstfit.ref import firstfit_ref
from repro.kernels.superstep.ops import superstep_tpu
from repro.kernels.superstep.ref import superstep_ref

import repro_torch.core.coloring as TC
from repro_torch.core import csr as tcsr
from repro_torch.core.csr import CSRGraph as TGraph
from repro_torch.kernels.conflict.kernel import conflict_tile, conflict_tile_ref
from repro_torch.kernels.firstfit.kernel import firstfit_tile, firstfit_tile_ref
from repro_torch.kernels.superstep.kernel import superstep_tile, superstep_tile_ref

WIDTHS = [1, 31, 32, 33, 63, 64, 100]
HEURISTICS = ["id", "degree"]


def _t(x) -> torch.Tensor:
    """A CPU tensor with the same contents as a numpy or JAX array."""
    return torch.from_numpy(np.array(x))


def _tiles(W: int, seed: int, w: int = 64, n: int = 500):
    """``(ids, nid, my_c, nc, my_d, nd)`` for a ``(w, W)`` tile.

    Rows are ragged (pad lanes hold the sentinel ``n``, colour 0 and degree
    0), the last four rows are sentinel rows, colours are small so rows
    clash with their neighbours, and for ``W >= 32`` eight rows hold every
    colour in 1..W (the answer W + 1, through the shared-bitset path); half
    of those rows are uncoloured, half hold a colour they may beat.
    """
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, w).astype(np.int32)
    ids[-4:] = n
    nid = rng.integers(0, n, (w, W)).astype(np.int32)
    nc = rng.integers(0, min(W + 3, 6), (w, W)).astype(np.int32)
    nd = rng.integers(0, 6, (w, W)).astype(np.int32)
    deg = rng.integers(0, W + 1, w)
    my_c = rng.integers(0, 6, w).astype(np.int32)
    my_d = rng.integers(0, 6, w).astype(np.int32)
    if W >= 32:
        for i in range(8):
            nc[i] = rng.permutation(W) + 1
            deg[i] = W
            my_c[i] = 0 if i % 2 else rng.integers(1, W + 1)
    pad = np.arange(W)[None, :] >= deg[:, None]
    pad[-4:] = True
    nid[pad], nc[pad], nd[pad] = n, 0, 0
    my_c[-4:] = my_d[-4:] = 0
    return ids, nid, my_c, nc, my_d, nd


@pytest.mark.parametrize("W", WIDTHS)
def test_k4_plain_matches_repro(W):
    nc = _tiles(W, seed=W)[3]
    want = np.asarray(firstfit_ref(jnp.asarray(nc)))
    np.testing.assert_array_equal(
        want, np.asarray(firstfit_bitset_tpu(jnp.asarray(nc), interpret=True)))
    got = firstfit_tile(_t(nc))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(want, firstfit_tile_ref(_t(nc)).numpy())
    if W >= 32:
        assert (got[:8] == W + 1).all()


@pytest.mark.parametrize("heuristic", HEURISTICS)
@pytest.mark.parametrize("W", WIDTHS)
def test_k5_plain_matches_repro(W, heuristic):
    args = _tiles(W, seed=100 + W)
    want = np.asarray(conflict_ref(*map(jnp.asarray, args), heuristic))
    np.testing.assert_array_equal(want, np.asarray(conflict_tpu(
        *map(jnp.asarray, args), heuristic, interpret=True)))
    got = conflict_tile(*map(_t, args), heuristic)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(
        want, conflict_tile_ref(*map(_t, args), heuristic).numpy())
    assert want.any() and not want.all()


@pytest.mark.parametrize("heuristic", HEURISTICS)
@pytest.mark.parametrize("W", WIDTHS)
def test_k3_plain_matches_repro(W, heuristic):
    args = _tiles(W, seed=200 + W)
    want = superstep_ref(*map(jnp.asarray, args), heuristic)
    pallas = superstep_tpu(*map(jnp.asarray, args), heuristic, interpret=True)
    got = superstep_tile(*map(_t, args), heuristic)
    plain = superstep_tile_ref(*map(_t, args), heuristic)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    for k in range(2):
        np.testing.assert_array_equal(np.asarray(want[k]), np.asarray(pallas[k]))
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())
        np.testing.assert_array_equal(np.asarray(want[k]), plain[k].numpy())
    assert bool(got[1][-4:].all())  # sentinel rows have colour 0: need


def test_tile_wrappers_take_empty_tiles_and_check_shapes():
    args = [_t(a)[:0] for a in _tiles(8, seed=1)]
    assert firstfit_tile(args[3]).shape == (0,)
    assert conflict_tile(*args).dtype == torch.bool
    new_c, need = superstep_tile(*args)
    assert new_c.shape == need.shape == (0,)
    args = [_t(a) for a in _tiles(8, seed=1)]
    with pytest.raises(ValueError, match="nc has shape"):
        superstep_tile(*args[:3], args[3][:, :4], *args[4:])
    with pytest.raises(ValueError, match="my_d has shape"):
        conflict_tile(*args[:4], args[4][:5], args[5])
    with pytest.raises(ValueError, match="unknown heuristic"):
        conflict_tile(*args, "random")
    with pytest.raises(ValueError, match="unknown heuristic"):
        superstep_tile(*args, "random")
    with pytest.raises(ValueError, match=r"\(w, W\) tile"):
        firstfit_tile(args[0])


# --------------------------------------------------------------------------
# the engine pieces that feed the tile kernels
# --------------------------------------------------------------------------

def _graph_pair(g):
    return g, TGraph.from_numpy(g.row_offsets, g.col_indices)


@pytest.mark.parametrize("width", [None, 200])
def test_padded_adjacency_and_degree_buckets_match_repro(width):
    g, tg = _graph_pair(power_law(600, 6.0, seed=3))
    np.testing.assert_array_equal(g.padded_adjacency(width),
                                  tg.padded_adjacency(width))
    for thresholds in [(), (4,), (2, 8, 16)]:
        for a, b in zip(g.degree_buckets(thresholds), tg.degree_buckets(thresholds),
                        strict=True):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="allow_truncate"):
        tg.padded_adjacency(2)
    np.testing.assert_array_equal(g.padded_adjacency(2, allow_truncate=True),
                                  tg.padded_adjacency(2, allow_truncate=True))


def test_gather_rows_and_dense_rows_match_repro():
    g, tg = _graph_pair(erdos_renyi(300, 5.0, seed=2))
    adj = g.padded_adjacency()
    ids = np.array([0, 7, g.n, 299, g.n + 3, 5], np.int32)
    want = C.gather_rows(jnp.asarray(adj), jnp.asarray(ids))
    np.testing.assert_array_equal(np.asarray(want),
                                  TC.gather_rows(_t(adj), _t(ids)).numpy())
    np.testing.assert_array_equal(
        np.asarray(C.gather_rows(jnp.asarray(adj), jnp.asarray(ids), 7)),
        TC.gather_rows(_t(adj), _t(ids), 7).numpy())
    ref = C.DenseRows(jnp.asarray(adj))
    port = TC.DenseRows(_t(adj), tcsr.DeviceCSR.from_csr(tg, "cpu"))
    np.testing.assert_array_equal(np.asarray(ref.rows(jnp.asarray(ids))),
                                  port.rows(_t(ids)).numpy())
    for v in (0, 17, g.n - 1, g.n):
        np.testing.assert_array_equal(np.asarray(ref.row1(jnp.int32(v))),
                                      port.row1(v).numpy())


@pytest.mark.parametrize("cap,nchunks", [(1, 1), (1, 4), (7, 3), (64, 4), (100, 7)])
def test_chunk_bounds_match_repro(cap, nchunks):
    assert TC._chunk_bounds(cap, nchunks) == C._chunk_bounds(cap, nchunks)


def _step_inputs(seed=5):
    g, tg = _graph_pair(erdos_renyi(400, 6.0, seed=seed))
    rng = np.random.default_rng(seed)
    adj = g.padded_adjacency()
    deg_ext = np.concatenate([g.degrees, [0]]).astype(np.int32)
    colors = np.concatenate([rng.integers(0, 4, g.n), [0]]).astype(np.int32)
    wl = np.concatenate([rng.permutation(g.n)[:255], [g.n]]).astype(np.int32)
    return g, tg, adj, deg_ext, colors, wl


@pytest.mark.parametrize("opts", [
    dict(), dict(reuse_rows=True), dict(coarsen_ff=3), dict(coarsen_cr=4),
    dict(coarsen_ff=2, coarsen_cr=5, kind="scan"), dict(heuristic="id"),
], ids=["plain", "reuse-rows", "coarsen-ff", "coarsen-cr", "both-scan", "id"])
def test_sgr_step_matches_repro(opts):
    """The classic super-step with ``ff_apply`` and ``cr_flags`` (whose CPU
    branches take repro's formulations), chunked or not."""
    _, _, adj, deg_ext, colors, wl = _step_inputs()
    want = C.sgr_step(jnp.asarray(adj), jnp.asarray(deg_ext), jnp.asarray(colors),
                      jnp.asarray(wl), **opts)
    got = TC.sgr_step(_t(adj), _t(deg_ext), _t(colors), _t(wl), **opts)
    for a, b in zip(want, got, strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("provider", ["csr", "dense"])
@pytest.mark.parametrize("coarsen", [1, 3])
def test_ragged_superstep_chunked_matches_repro(provider, coarsen):
    """Chunks after the first read earlier chunks' writes; the first reads
    the snapshot it is given."""
    g, tg, adj, deg_ext, colors, wl = _step_inputs(seed=6)
    W = max(g.max_degree, 1)
    snapshot = np.where(colors > 2, 0, colors).astype(np.int32)
    if provider == "csr":
        dev = DeviceCSR.from_csr(g)
        rows_fn = lambda ids: dev.gather_rows(ids, W)  # noqa: E731
        port = tcsr.DeviceCSR.from_csr(tg, "cpu")
    else:
        rows_fn = C.DenseRows(jnp.asarray(adj)).rows
        port = TC.DenseRows(_t(adj), tcsr.DeviceCSR.from_csr(tg, "cpu"))
    want = C.ragged_superstep(
        rows_fn, jnp.asarray(deg_ext), jnp.asarray(colors), jnp.asarray(wl),
        coarsen=coarsen, colors_read=jnp.asarray(snapshot), pack_degrees=True)
    got = TC.ragged_superstep(port, _t(deg_ext), _t(colors), _t(wl),
                              coarsen=coarsen, colors_read=_t(snapshot),
                              pack_degrees=True, width=W)
    for a, b in zip(want, got, strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_generic_loops_match_repro():
    """``run_workefficient_loop`` and ``run_fused_loop`` over the classic
    step: the same colors, iterations and work counts."""
    from functools import partial

    g, _, adj, deg_ext, _, _ = _step_inputs(seed=8)
    zeros = np.zeros(g.n + 1, np.int32)
    wl = np.arange(g.n, dtype=np.int32)
    ref_step = partial(C.sgr_step, jnp.asarray(adj), jnp.asarray(deg_ext))
    port_step = partial(TC.sgr_step, _t(adj), _t(deg_ext))
    want = C.run_workefficient_loop(ref_step, jnp.asarray(zeros), jnp.asarray(wl),
                                    g.n, 50)
    got = TC.run_workefficient_loop(port_step, _t(zeros), _t(wl), g.n, 50)
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    assert tuple(want[1:]) == tuple(got[1:])
    want = C.run_fused_loop(ref_step, jnp.asarray(zeros), jnp.asarray(wl), g.n, 50)
    got = TC.run_fused_loop(port_step, _t(zeros), _t(wl), g.n, 50)
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    assert [int(x) for x in want[2:]] == [int(x) for x in got[2:]]
    a = C.fused_result(want[0], g.n, *want[2:], width=adj.shape[1])
    b = TC.fused_result(got[0], g.n, *got[2:], width=adj.shape[1])
    np.testing.assert_array_equal(a.colors, b.colors)
    assert (a.iterations, a.work_items, a.padded_work, a.converged) == (
        b.iterations, b.work_items, b.padded_work, b.converged)
