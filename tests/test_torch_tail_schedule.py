"""The schedule of K2, the serial tail, held on the CPU against the walk.

K2 (``repro_torch/csrc/superstep_csr.cu``) computes the sequential greedy
tail as Jones-Plassmann with the worklist position (the rank) as priority:
every entry runs at once, waits for its earlier-ranked tail neighbours and
then takes FirstFit under the read rule of the kernel's header.  No card is
needed to check that rule: ``schedule_model`` below runs it in rounds with
plain torch ops (in each round every unfinished entry whose earlier-ranked
tail neighbours are all done takes its colour), building ``rank`` with the
port's ``tail_ranks``.  It must return bit for bit what the sequential walk
returns (``serial_tail_rows_ref`` and ``repro``'s ``serial_tail_step``),
and its round count must be the depth of the dependency DAG, computed here
independently.  Inputs are made with numpy from a seed; everything is
integer, so the tolerance is 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.coloring as C
from repro.core import DeviceCSR
from repro.graphs import build_graph, grid2d

from repro_torch.kernels.superstep.csr_kernel import (
    serial_tail_rows,
    serial_tail_rows_ref,
    tail_ranks,
)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def schedule_model(starts, degs, col, colors_ext, wl, W: int):
    """K2's schedule in rounds: ``(colors_ext after the tail, rounds)``.

    Entry i reads ``col[starts[i] : starts[i] + min(degs[i], W)]``.  Each
    lane's neighbour u is read by the rule: ``rank[u] < 0`` its fixed
    colour; ``rank[u] < i`` its final colour, so entry i is ready only once
    all of those are done; ``rank[u] >= i`` (itself, a later entry) 0.
    Sentinel entries wait on nothing and write nothing but the clear of
    slot n.
    """
    n = colors_ext.shape[0] - 1
    T = wl.shape[0]
    rank = tail_ranks(wl, n)
    colors = colors_ext.clone()
    colors[wl.long()] = 0
    lane = torch.arange(W)
    valid = lane[None, :] < degs.clamp(max=W)[:, None]
    idx = (starts[:, None] + lane[None, :]).clamp(0, max(col.shape[0] - 1, 0))
    nbr = torch.where(valid, col[idx.long()], n).long()
    pos = torch.arange(T)[:, None]
    rn = rank[nbr]
    earlier = (rn >= 0) & (rn < pos)
    later = rn >= pos
    done = wl >= n
    rounds = 0
    while not bool(done.all()):
        waiting = earlier & ~done[rn.clamp(min=0)]
        ready = ~done & ~waiting.any(dim=1)
        assert bool(ready.any()), "no entry can proceed: the schedule is stuck"
        seen = torch.where(later, 0, colors[nbr])[ready]
        taken = torch.zeros((seen.shape[0], W + 3), dtype=torch.bool)
        taken.scatter_(1, seen.clamp(0, W + 2), True)  # W+2: past every candidate
        free = ~taken[:, 1:W + 2]
        colors[wl[ready].long()] = (free.int().argmax(dim=1) + 1).to(torch.int32)
        done |= ready
        rounds += 1
    return colors, rounds


def dag_depth(starts, degs, col, wl, W: int, n: int) -> int:
    """Longest chain of "waits for" over the tail, by dynamic programming
    in worklist order (independent of ``schedule_model``'s rounds)."""
    V = wl.tolist()
    pos = {v: i for i, v in enumerate(V) if v < n}
    S, D, Cl = starts.tolist(), degs.tolist(), col.tolist()
    depth = []
    for i, v in enumerate(V):
        waits = [depth[pos[u]] for u in Cl[S[i]: S[i] + min(D[i], W)]
                 if u in pos and pos[u] < i]
        depth.append(0 if v >= n else 1 + max(waits, default=0))
    return max(depth, default=0)


def csr_rows(g, wl):
    """K2's row form of a CSR tail: ``(starts, degs, col)``."""
    dev = DeviceCSR.from_csr(g)
    rs, cp, de = (_t(dev.row_starts), _t(dev.col_padded), _t(dev.deg_ext))
    wl = torch.tensor(np.asarray(wl), dtype=torch.int32)
    return rs[wl.clamp(0, max(g.n - 1, 0)).long()], de[wl.clamp(0, g.n).long()], cp


def repro_tail(g, colors, wl):
    """``repro``'s sequential tail over a CSR graph, through ``jnp``."""
    dev = DeviceCSR.from_csr(g)
    return np.asarray(C.serial_tail_step(dev.row1, jnp.asarray(colors), jnp.asarray(wl)))


def _check(starts, degs, col, colors, wl, W, want_repro=None):
    """The model equals the walk (and ``repro``'s tail when given); returns
    the model's round count."""
    got, rounds = schedule_model(starts, degs, col, colors, wl, W)
    want = serial_tail_rows_ref(starts, degs, col, colors.clone(), wl, W)
    assert torch.equal(got, want)
    assert torch.equal(serial_tail_rows(starts, degs, col, colors.clone(), wl, W), want)
    if want_repro is not None:
        np.testing.assert_array_equal(want_repro, got.numpy())
    return rounds


@pytest.mark.parametrize("name", ["rmat-er", "rmat-g", "thermal2", "kkt_power",
                                  "europe.osm", "hugebubbles"])
def test_schedule_matches_walk_on_suite(name):
    g = build_graph(name, 0.02)
    rng = np.random.default_rng(3)
    W = g.max_degree
    colors = np.concatenate([rng.integers(0, W + 2, g.n), [0]]).astype(np.int32)
    dev = DeviceCSR.from_csr(g)
    wl = np.asarray(C.order_tail(jnp.arange(g.n, dtype=jnp.int32), dev.deg_ext))
    starts, degs, col = csr_rows(g, wl)
    rounds = _check(starts, degs, col, _t(colors), _t(wl), W,
                    repro_tail(g, colors, wl))
    assert rounds == dag_depth(starts, degs, col, _t(wl), W, g.n)


@pytest.mark.parametrize("n", [1, 2, 50, 300])
def test_path_in_id_order_is_as_deep_as_the_tail(n):
    from repro.core import csr_from_edges

    g = csr_from_edges(n, np.arange(n - 1), np.arange(1, n))
    wl = np.arange(n, dtype=np.int32)
    colors = np.zeros(n + 1, np.int32)
    starts, degs, col = csr_rows(g, wl)
    rounds = _check(starts, degs, col, _t(colors), _t(wl), 2, repro_tail(g, colors, wl))
    assert rounds == n  # entry i waits on entry i - 1
    got, _ = schedule_model(starts, degs, col, _t(colors), _t(wl), 2)
    assert got[:n].tolist() == [1 + i % 2 for i in range(n)]


@pytest.mark.parametrize("rows,cols,diagonals", [(7, 9, False), (12, 5, True), (1, 20, True)])
def test_grid_in_id_order_depth(rows, cols, diagonals):
    g = grid2d(rows, cols, diagonals=diagonals)
    wl = np.arange(g.n, dtype=np.int32)
    colors = np.zeros(g.n + 1, np.int32)
    starts, degs, col = csr_rows(g, wl)
    rounds = _check(starts, degs, col, _t(colors), _t(wl), g.max_degree,
                    repro_tail(g, colors, wl))
    # (i, j) waits on (i, j-1) and the row above: level i + j without
    # diagonals; with them (i-1, j+1) too, so level 2i + j
    want = rows + cols - 1 if not diagonals else 2 * (rows - 1) + cols
    assert rounds == want == dag_depth(starts, degs, col, _t(wl), g.max_degree, g.n)


def test_subset_tail_reads_fixed_outside_colours_past_32():
    g = build_graph("rmat-g", 0.02)
    rng = np.random.default_rng(5)
    W = g.max_degree
    hub = int(np.argmax(g.degrees))
    nbrs = g.col_indices[g.row_offsets[hub]: g.row_offsets[hub + 1]]
    rest = np.setdiff1d(np.arange(g.n), np.concatenate([nbrs, [hub]]))
    ids = np.concatenate([[hub], rng.choice(rest, g.n // 3, replace=False)]).astype(np.int32)
    dev = DeviceCSR.from_csr(g)
    wl = np.asarray(C.order_tail(jnp.asarray(ids), dev.deg_ext))
    # outside vertices hold colours up to 60, the hub's neighbours (all
    # outside) 1..deg(hub) one each: the hub's colour lies past 32
    colors = np.concatenate([rng.integers(1, 61, g.n), [0]]).astype(np.int32)
    colors[nbrs] = rng.permutation(nbrs.size) + 1
    starts, degs, col = csr_rows(g, wl)
    want_repro = repro_tail(g, colors, wl)
    _check(starts, degs, col, _t(colors), _t(wl), W, want_repro)
    assert want_repro[hub] == nbrs.size + 1 > 32
    outside = np.setdiff1d(np.arange(g.n), ids)
    np.testing.assert_array_equal(want_repro[outside], colors[outside])


def hand_rows(rng, n, T, W, sentinels):
    """Rows laid out by hand: random ids of the whole graph (earlier and
    later entries, so rows are not symmetric, and outside vertices), with
    self, duplicate and sentinel lanes, and ``sentinels`` sentinel entries
    spread among the T."""
    ids = rng.choice(n, T - sentinels, replace=False).astype(np.int32)
    wl = np.insert(ids, rng.integers(0, T - sentinels + 1, sentinels), n).astype(np.int32)
    degs = rng.integers(0, W + 1, T).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(degs[:-1] + 2)]).astype(np.int32)
    col = rng.integers(0, n + 1, int(starts[-1]) + W + 2).astype(np.int32)
    for i in range(T):
        row = col[starts[i]: starts[i] + degs[i]]
        lanes = rng.random(row.shape[0])
        row[lanes < 0.1] = wl[i]
        if row.shape[0]:
            row[(lanes >= 0.1) & (lanes < 0.2)] = row[0]
        row[(lanes >= 0.2) & (lanes < 0.25)] = n
    colors = rng.integers(0, 50, n + 1).astype(np.int32)
    colors[n] = 0
    return [_t(a) for a in (starts, degs, col, colors, wl)]


@pytest.mark.parametrize("W", [3, 16, 40])
@pytest.mark.parametrize("sentinels", [0, 5])
def test_asymmetric_self_and_duplicate_lanes(W, sentinels):
    rng = np.random.default_rng(W * 10 + sentinels)
    n, T = 400, 150
    starts, degs, col, colors, wl = hand_rows(rng, n, T, W, sentinels)
    # repro's tail through a row provider: entry ids are distinct, so a
    # table by vertex id holds each entry's row (sentinel-padded to W)
    table = np.full((n + 1, W), n, np.int32)
    for i, v in enumerate(wl.tolist()):
        if v < n:
            d = min(int(degs[i]), W)
            table[v, :d] = col[int(starts[i]): int(starts[i]) + d].numpy()
    tab = jnp.asarray(table)
    want_repro = np.asarray(C.serial_tail_step(lambda v: tab[v], jnp.asarray(colors.numpy()),
                                               jnp.asarray(wl.numpy())))
    rounds = _check(starts, degs, col, colors, wl, W, want_repro)
    assert rounds == dag_depth(starts, degs, col, wl, W, n)


def test_sentinel_padded_worklist_clears_slot_n():
    g = grid2d(9, 11, diagonals=True)
    rng = np.random.default_rng(8)
    ids = rng.choice(g.n, 40, replace=False).astype(np.int32)
    dev = DeviceCSR.from_csr(g)
    wl = np.asarray(C.order_tail(jnp.asarray(np.concatenate([ids, np.full(9, g.n)])
                                             .astype(np.int32)), dev.deg_ext))
    assert (wl[-9:] == g.n).all()
    colors = np.concatenate([rng.integers(0, 10, g.n), [0]]).astype(np.int32)
    starts, degs, col = csr_rows(g, wl)
    _check(starts, degs, col, _t(colors), _t(wl), g.max_degree, repro_tail(g, colors, wl))


def test_only_sentinels_take_no_round():
    starts, degs = torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
    col = torch.zeros(4, dtype=torch.int32)
    colors = torch.tensor([3, 1, 0], dtype=torch.int32)
    wl = torch.full((4,), 2, dtype=torch.int32)
    got, rounds = schedule_model(starts, degs, col, colors, wl, 4)
    assert rounds == 0 and got.tolist() == [3, 1, 0]


@pytest.mark.parametrize("wl,n,want", [
    ([5, 2, 0, 6, 6], 6, [2, -1, 1, -1, -1, 0, -1]),
    ([], 3, [-1, -1, -1, -1]),
    ([3, 3, 1], 3, [-1, 2, -1, -1]),
])
def test_tail_ranks(wl, n, want):
    got = tail_ranks(torch.tensor(wl, dtype=torch.int32), n)
    assert got.dtype == torch.int32 and got.tolist() == want
