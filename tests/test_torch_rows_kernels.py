"""K4 and K5 of the PyTorch port reading their rows in place, against repro.

``firstfit_rows`` and ``conflict_rows`` read each worklist row from a table
(row ``ids[i]``, up to the vertex's degree; source (a)) or from a tile of
id rows the caller gathered (row ``i``; source (b)), with colours and
degrees from ``colors_ext`` and ``deg_ext``.  On CPU tensors they take
their plain versions; these tests hold those against ``repro``'s oracles
(``firstfit_ref``, ``conflict_ref``) and its Pallas kernels in interpret
mode, run on the tile that ``repro.core.coloring.gather_rows`` builds from
the same numpy table and ids.  The card reads a row of source (a) only up
to ``min(deg, W)`` lanes; ``degree_bounded_tile`` below models that read
and must give the full-width answer on the classic engine's tables.
Inputs are made with numpy from a seed; everything is integer arithmetic,
so the tolerance is 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.coloring as C
from repro.graphs import erdos_renyi, power_law
from repro.kernels.conflict.ops import conflict_tpu
from repro.kernels.conflict.ref import conflict_ref
from repro.kernels.firstfit.ops import firstfit_bitset_tpu
from repro.kernels.firstfit.ref import firstfit_ref

import repro_torch.core.coloring as TC
from repro_torch.core.csr import CSRGraph as TGraph
from repro_torch.kernels.conflict.kernel import conflict_rows, conflict_rows_ref
from repro_torch.kernels.cuda import ROW_LANES
from repro_torch.kernels.firstfit.kernel import firstfit_rows, firstfit_rows_ref

WIDTHS = [1, 31, 32, 33, 63, 64, 100]
HEURISTICS = ["id", "degree"]
SOURCES = ["table", "rows"]


def _t(x) -> torch.Tensor:
    """A CPU tensor with the same contents as a numpy or JAX array."""
    return torch.from_numpy(np.array(x))


def _rows_case(W: int, seed: int, w: int = 64):
    """``(table, deg_ext, colors_ext, ids, rows)`` numpy int32 arrays.

    ``table`` is ``(n, W + 3)``; its first W columns are the table the
    kernels read (stride W + 3 != W): row v holds ``deg_ext[v]`` random
    neighbour ids and the sentinel ``n`` in the rest, and junk past the
    slice.  ``rows`` is a ``(w, W)`` id tile with self, duplicate and
    sentinel lanes.  ``ids`` ends in four sentinel entries.  Colours are
    small so rows clash; for ``W >= 32`` eight rows of each source hold a
    pool of W vertices coloured 1..W, one each (FirstFit answers W + 1
    through the shared-bitset path), half of those rows' vertices
    uncoloured.
    """
    rng = np.random.default_rng(seed)
    n = max(300, 2 * W + 8)
    colors = rng.integers(0, min(W + 3, 6), n + 1).astype(np.int32)
    deg = rng.integers(0, W + 1, n + 1).astype(np.int32)
    table = rng.integers(0, n, (n, W + 3)).astype(np.int32)
    ids = rng.choice(n, w, replace=False).astype(np.int32)
    ids[-4:] = n
    rows = rng.integers(0, n + 1, (w, W)).astype(np.int32)
    lanes = rng.random((w, W))
    self_lane, dup_lane = lanes < 0.1, (lanes >= 0.1) & (lanes < 0.2)
    rows[self_lane] = np.broadcast_to(ids[:, None], (w, W))[self_lane]
    rows[dup_lane] = np.broadcast_to(rows[:, :1], (w, W))[dup_lane]
    rows[(lanes >= 0.2) & (lanes < 0.25)] = n
    if W >= 32:
        pool = rng.choice(np.setdiff1d(np.arange(n), ids), W, replace=False)
        colors[pool] = np.arange(1, W + 1)
        for i in range(8):
            deg[ids[i]] = W
            table[ids[i], :W] = rng.permutation(pool)
            rows[i] = rng.permutation(pool)
            colors[ids[i]] = 0 if i % 2 else rng.integers(1, W + 1)
    table[:, :W][np.arange(W)[None, :] >= deg[:n, None]] = n
    colors[n] = deg[n] = 0
    return table, deg, colors, ids, rows


def _repro_tile(source, table, ids, rows, W):
    """The id tile repro's engine reads: ``gather_rows`` of the sliced
    table, or the gathered rows themselves."""
    if source == "table":
        return np.asarray(C.gather_rows(jnp.asarray(table[:, :W]), jnp.asarray(ids)))
    return rows


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("W", WIDTHS)
def test_k4_rows_plain_matches_repro(W, source):
    table, deg, colors, ids, rows = _rows_case(W, seed=W)
    nc = jnp.asarray(colors[_repro_tile(source, table, ids, rows, W)])
    want = np.asarray(firstfit_ref(nc))
    np.testing.assert_array_equal(want, np.asarray(firstfit_bitset_tpu(nc, interpret=True)))
    src = (dict(table=_t(table)[:, :W], deg_ext=_t(deg)) if source == "table"
           else dict(rows=_t(rows)))
    got = firstfit_rows(_t(colors), _t(ids), **src)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    src.pop("deg_ext", None)
    np.testing.assert_array_equal(want, firstfit_rows_ref(_t(colors), _t(ids), **src).numpy())
    if W >= 32:
        assert (got[:8] == W + 1).all()


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("heuristic", HEURISTICS)
@pytest.mark.parametrize("W", WIDTHS)
def test_k5_rows_plain_matches_repro(W, heuristic, source):
    table, deg, colors, ids, rows = _rows_case(W, seed=100 + W)
    tile = _repro_tile(source, table, ids, rows, W)
    args = tuple(map(jnp.asarray, (ids, tile, colors[ids], colors[tile], deg[ids],
                                   deg[tile])))
    want = np.asarray(conflict_ref(*args, heuristic))
    np.testing.assert_array_equal(
        want, np.asarray(conflict_tpu(*args, heuristic, interpret=True)))
    src = dict(table=_t(table)[:, :W]) if source == "table" else dict(rows=_t(rows))
    got = conflict_rows(_t(colors), _t(deg), _t(ids), heuristic, **src)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(
        want, conflict_rows_ref(_t(colors), _t(deg), _t(ids), heuristic, **src).numpy())
    assert want.any() and not want.all()
    assert not want[-4:].any()  # sentinel rows hold colour 0


# --------------------------------------------------------------------------
# the degree-bounded read of source (a)
# --------------------------------------------------------------------------

def degree_bounded_tile(table, deg_ext, ids):
    """The ids the card reads for rows ``ids`` of ``table``: lane j of row
    ``v < n`` only while ``j < min(deg_ext[v], W)``, no lane of a sentinel
    row; every lane not read stands as the sentinel ``n`` (colour 0,
    degree 0)."""
    n, W = table.shape
    length = torch.where(ids < n, deg_ext[ids.clamp(max=n).long()].clamp(max=W), 0)
    read = torch.arange(W)[None, :] < length[:, None]
    return torch.where(read, table[ids.clamp(0, max(n - 1, 0)).long()], n)


GRAPHS = {
    "erdos_renyi": lambda: erdos_renyi(400, 6.0, seed=3),
    "power_law": lambda: power_law(600, 6.0, seed=4),
    "star": lambda: TGraph.from_numpy(*_star(200)),
}


def _star(n):
    """A star's CSR: hub 0 joined to every other vertex."""
    col = np.concatenate([np.arange(1, n), np.zeros(n - 1)]).astype(np.int32)
    return np.concatenate([[0, n - 1], np.arange(n, 2 * n - 1)]).astype(np.int32), col


@pytest.mark.parametrize("buckets", [(), (4,), (2, 8)], ids=["one-class", "4", "2-8"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_degree_bounded_read_gives_the_full_width_answer(graph, buckets):
    """On every class table ``_prepare`` gives the classic engine (column
    slices of the ``(n, Δmax)`` table), reading each row up to its degree
    yields the same tile, hence the same FirstFit and loser flags, as
    reading it at full width; both equal repro's oracles."""
    g = GRAPHS[graph]()
    g = TGraph.from_numpy(g.row_offsets, g.col_indices)
    rng = np.random.default_rng(len(buckets))
    tables, deg_ext, classes = TC._prepare(g, buckets, "cpu")
    colors = _t(np.concatenate([rng.integers(0, 5, g.n), [0]]).astype(np.int32))
    for table, cls in zip(tables, classes, strict=True):
        assert table.stride(0) == tables[-1].stride(0)  # one table, sliced
        ids = torch.cat([_t(cls), torch.tensor([g.n, g.n], dtype=torch.int32)])
        full = TC.gather_rows(table, ids)
        bounded = degree_bounded_tile(table, deg_ext, ids)
        assert torch.equal(full, bounded)
        nc = colors[bounded.long()]
        want = np.asarray(firstfit_ref(jnp.asarray(colors[full.long()].numpy())))
        np.testing.assert_array_equal(want, firstfit_rows(colors, ids, table=table,
                                                          deg_ext=deg_ext).numpy())
        np.testing.assert_array_equal(want, np.asarray(firstfit_ref(jnp.asarray(nc.numpy()))))
        for heuristic in HEURISTICS:
            args = (ids, bounded, colors[ids.long()], nc, deg_ext[ids.long()],
                    deg_ext[bounded.long()])
            want = np.asarray(conflict_ref(*(jnp.asarray(a.numpy()) for a in args),
                                           heuristic))
            np.testing.assert_array_equal(want, conflict_rows(
                colors, deg_ext, ids, heuristic, table=table).numpy())


# --------------------------------------------------------------------------
# the wrappers' arguments
# --------------------------------------------------------------------------

def test_rows_wrappers_check_their_arguments():
    table, deg, colors, ids, rows = (_t(a) for a in _rows_case(40, seed=7))
    W = 40
    for lanes in ROW_LANES:  # a forced layout is checked, then the plain path runs
        assert torch.equal(firstfit_rows(colors, ids, table=table[:, :W], lanes=lanes),
                           firstfit_rows(colors, ids, table=table[:, :W]))
    with pytest.raises(ValueError, match="lanes must be one of"):
        firstfit_rows(colors, ids, rows=rows, lanes=3)
    with pytest.raises(ValueError, match="lanes must be one of"):
        conflict_rows(colors, deg, ids, rows=rows, lanes=64)
    with pytest.raises(ValueError, match="shared memory"):
        firstfit_rows(colors[:9], ids[:0], table=torch.full((8, 9000), 8, dtype=torch.int32),
                      lanes=1)
    for fn, extra in ((firstfit_rows, ()), (conflict_rows, (deg,))):
        with pytest.raises(ValueError, match="exactly one"):
            fn(colors, *extra, ids)
        with pytest.raises(ValueError, match="exactly one"):
            fn(colors, *extra, ids, table=table, rows=rows)
        with pytest.raises(ValueError, match="table has"):
            fn(colors[:-1], *(e[:-1] for e in extra), ids, table=table)
        with pytest.raises(ValueError, match="rows has"):
            fn(colors, *extra, ids, rows=rows[:-1])
        with pytest.raises(ValueError, match="ids must be 1-D"):
            fn(colors, *extra, ids[:, None], rows=rows)
        with pytest.raises(ValueError, match="must be 2-D"):
            fn(colors, *extra, ids, rows=rows[0])
    with pytest.raises(ValueError, match="deg_ext has shape"):
        conflict_rows(colors, deg[:-1], ids, rows=rows)
    with pytest.raises(ValueError, match="unknown heuristic"):
        conflict_rows(colors, deg, ids, "random", rows=rows)
    empty = ids[:0]
    assert firstfit_rows(colors, empty, rows=rows[:0]).shape == (0,)
    assert conflict_rows(colors, deg, empty, rows=rows[:0]).dtype == torch.bool
