"""The paper's baselines in the port against repro: ``serial``,
``topology``, ``jp``, ``multihash`` and ``threestep`` with
``device="cpu"`` equal ``repro``'s, field for field; and the scheduling
and quality helpers built on them.

Graphs come from ``repro.graphs`` at small scale and reach the port
through ``CSRGraph.from_numpy``.  Every algorithm here is integer-only and
deterministic, so the bar is equality.  ``repro`` jit-compiles its
topology step and MIS round once per table shape, so the graphs are few.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import repro
import repro.core.jp as rjp
from repro.core import CSRGraph
from repro.core.scheduling import all_to_all_rounds as r_all_to_all_rounds
from repro.core.scheduling import phases as r_phases
from repro.core.scheduling import schedule_quality as r_schedule_quality
from repro.core.validate import quality_report as r_quality_report
from repro.graphs import build_graph, erdos_renyi, grid2d

import repro_torch
import repro_torch.core.jp as tjp
from repro_torch.core import (
    DeviceGraph,
    color_data_driven,
    color_jp,
    color_multihash,
    color_serial,
    color_threestep,
    color_topology,
    greedy_serial,
    is_valid_coloring,
    num_colors,
    quality_report,
)
from repro_torch.core.csr import CSRGraph as TGraph
from repro_torch.core.scheduling import all_to_all_rounds, phases, schedule_quality

FIELDS = ("iterations", "work_items", "padded_work", "class_cells", "converged",
          "algorithm", "degradations")
GRAPHS = {
    "er": lambda: erdos_renyi(400, 6.0, seed=1),
    "rmat-g": lambda: build_graph("rmat-g", 0.01),
    "grid": lambda: grid2d(20, 20),
}


def _tg(g) -> TGraph:
    return TGraph.from_numpy(g.row_offsets, g.col_indices)


_CACHE: dict = {}


def _graph(name):
    if name not in _CACHE:
        g = GRAPHS[name]()
        _CACHE[name] = (g, _tg(g))
    return _CACHE[name]


def _assert_same(want, got):
    np.testing.assert_array_equal(want.colors, got.colors)
    assert got.colors.dtype == np.int32
    for f in FIELDS:
        assert getattr(want, f) == getattr(got, f), (f, getattr(want, f),
                                                     getattr(got, f))
    assert got.trace is None and want.trace is None


def _both(name, algorithm, **opts):
    g, t = _graph(name)
    want = repro.color(g, algorithm, **opts)
    got = repro_torch.color(t, algorithm, device="cpu", **opts)
    _assert_same(want, got)
    assert is_valid_coloring(t, got.colors) == bool(got.converged)
    return want, got


# --------------------------------------------------------------------------
# the algorithms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("firstfit", ["scan", "sort", "bitset"])
@pytest.mark.parametrize("heuristic", ["id", "degree"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_topology_matches_repro(name, heuristic, firstfit):
    _, got = _both(name, "topology", heuristic=heuristic, firstfit=firstfit)
    assert got.algorithm == "topology_sgr"
    assert got.work_items == got.iterations * got.colors.shape[0]


def test_topology_starved_budget_matches_repro():
    _, got = _both("er", "topology", max_iters=2)
    assert not got.converged and got.iterations == 2


@pytest.mark.parametrize("name", list(GRAPHS))
def test_jp_matches_repro(name):
    _, got = _both(name, "jp")
    assert got.algorithm == "jp_mis"
    # one independent set a round: every colour is used by some vertex
    assert got.num_colors == got.iterations


@pytest.mark.parametrize("nhash", [1, 2, 3])
@pytest.mark.parametrize("name", ["er", "rmat-g"])
def test_multihash_matches_repro(name, nhash):
    _, got = _both(name, "multihash", nhash=nhash)
    assert got.algorithm == f"multihash_mis_{nhash}"


def test_multihash_positional_nhash():
    g, t = _graph("er")
    _assert_same(repro.core.color_multihash(g, 2),
                 color_multihash(t, 2, device="cpu"))
    _assert_same(repro.core.color_jp(g), color_jp(t, device="cpu"))


@pytest.mark.parametrize("device_rounds", [0, 1, 2])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_threestep_matches_repro(name, device_rounds):
    want, got = _both(name, "threestep", device_rounds=device_rounds)
    assert got.serial_tail == want.serial_tail
    assert got.work_items == got.iterations * got.colors.shape[0] + got.serial_tail
    if device_rounds == 0:
        assert got.serial_tail == got.colors.shape[0]


@pytest.mark.parametrize("firstfit", ["scan", "bitset"])
def test_threestep_firstfit_kinds_match_repro(firstfit):
    want, got = _both("rmat-g", "threestep", firstfit=firstfit)
    assert got.serial_tail == want.serial_tail


@pytest.mark.parametrize("order", ["natural", "largest_degree_first", "explicit"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_serial_matches_repro(name, order):
    g, t = _graph(name)
    if order == "explicit":
        order = np.random.default_rng(7).permutation(g.n)
    want = repro.core.color_serial(g, order=order)
    got = color_serial(t, order=order, device="cpu")
    _assert_same(want, got)
    assert got.algorithm == "serial_greedy" and got.iterations == 1
    np.testing.assert_array_equal(got.colors, greedy_serial(t, order))
    assert is_valid_coloring(t, got.colors)


def test_serial_through_color_matches_repro():
    _both("grid", "serial")
    _both("er", "serial", order="largest_degree_first")


def test_unknown_serial_order_raises():
    with pytest.raises(ValueError, match="unknown order"):
        repro_torch.color(_graph("er")[1], "serial", order="random",
                          device="cpu")


# the empty graph and the edgeless one, every baseline
EDGE_CASES = {
    "empty": (CSRGraph(np.zeros(1, np.int64), np.zeros(0, np.int32)),
              TGraph(np.zeros(1, np.int64), np.zeros(0, np.int32))),
    "edgeless": (CSRGraph(np.zeros(9, np.int64), np.zeros(0, np.int32)),
                 TGraph(np.zeros(9, np.int64), np.zeros(0, np.int32))),
}


@pytest.mark.parametrize("algorithm,opts", [
    ("serial", {}), ("topology", {}), ("jp", {}), ("multihash", {}),
    ("multihash", dict(nhash=3)), ("threestep", {}),
    ("threestep", dict(device_rounds=0)),
])
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_edge_case_graphs_match_repro(case, algorithm, opts):
    g, t = EDGE_CASES[case]
    want = repro.color(g, algorithm, **opts)
    got = repro_torch.color(t, algorithm, device="cpu", **opts)
    _assert_same(want, got)
    if case == "edgeless":
        assert set(got.colors.tolist()) == {1} or algorithm == "multihash"
        assert is_valid_coloring(t, got.colors)
    if algorithm == "threestep":
        assert getattr(got, "serial_tail", 0) == getattr(want, "serial_tail", 0)


def test_baselines_resolve_the_device():
    t = _graph("er")[1]
    for fn in (color_topology, color_jp, color_multihash, color_threestep,
               color_serial):
        with pytest.raises(ValueError, match="neither a CUDA device nor the CPU"):
            fn(t, device="meta")


def test_device_graph_shares_the_classic_upload():
    t = _graph("er")[1]
    color_data_driven(t, engine="classic", device="cpu")
    dg = DeviceGraph.from_csr(t, "cpu")
    assert dg.adj is t._device_cache["dense", dg.adj.device]
    assert dg.n == t.n and dg.D == t.max_degree
    np.testing.assert_array_equal(dg.degrees.numpy(),
                                  np.concatenate([t.degrees, [0]]))
    wide = DeviceGraph.from_csr(t, "cpu", width=t.max_degree + 3)
    assert wide.D == t.max_degree + 3
    np.testing.assert_array_equal(wide.adj[:, :dg.D].numpy(), dg.adj.numpy())
    assert (wide.adj[:, dg.D:] == t.n).all()


# --------------------------------------------------------------------------
# JP's hash: uint32 arithmetic in int64
# --------------------------------------------------------------------------

WRAP_POINTS = [0, 1, 2, 7919, 2**16 - 1, 2**16, 2**31 - 2, 2**31 - 1,
               2**31, 2**31 + 1, 2**32 - 7919, 2**32 - 2, 2**32 - 1]


@pytest.mark.parametrize("j", [0, 1, 2])
def test_hash32_matches_repro_at_the_wrap_points(j):
    import torch

    ids = np.array([v + d for v in WRAP_POINTS for d in (-1, 0, 1)
                    if 0 <= v + d < 2**32], dtype=np.int64)
    salt = 0x9E3779B9 + 131 * j
    want = np.asarray(rjp._hash32(jnp.asarray(ids.astype(np.uint32).view(np.int32)),
                                  salt=salt)).astype(np.int64)
    got = tjp._hash32(torch.from_numpy(ids), salt).numpy()
    np.testing.assert_array_equal(want, got)
    assert (got >= 0).all() and (got < 2**32).all()


@pytest.mark.parametrize("round_idx", [0, 5, 271_000, 300_000, 600_000])
def test_mis_round_matches_repro_past_the_int32_wrap(round_idx):
    """``ids + round * 7919`` passes 2^31 from round 271,183 on: the port
    reduces it mod 2^32, which is repro's int32 wrap."""
    import torch

    g, t = _graph("er")
    adj = g.padded_adjacency()
    colors = np.zeros(g.n + 1, np.int32)
    colors[: g.n: 3] = 5  # a third already coloured
    want = rjp._mis_round(jnp.asarray(adj), jnp.asarray(colors), jnp.int32(6),
                          jnp.int32(round_idx), nhash=2, modes=("max", "min"))
    got = tjp._mis_round(torch.from_numpy(adj).reshape(-1), adj.shape[1],
                         torch.from_numpy(colors.copy()), 6, round_idx,
                         nhash=2, modes=("max", "min"))
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    assert int(want[1]) == int(got[1]) and int(want[2]) == got[2] == 10


def test_local_extreme_ties_break_by_id():
    """Equal priorities: the larger id wins for max, the smaller for min;
    colored and sentinel lanes never block."""
    import torch

    # path 0 - 1 - 2; sentinel lanes read id 3
    adj = torch.tensor([[1, 3], [0, 2], [1, 3]], dtype=torch.int32).reshape(-1)
    uncol = torch.tensor([True, True, True])
    key = (torch.zeros(3, dtype=torch.int64) << 31) | torch.arange(3)
    assert tjp._local_extreme(adj, 2, uncol, key, "max").tolist() == [False, False, True]
    assert tjp._local_extreme(adj, 2, uncol, key, "min").tolist() == [True, False, False]
    # vertex 1 coloured: it blocks neither end (its own flag is masked by
    # the round's ``uncol``)
    uncol[1] = False
    assert tjp._local_extreme(adj, 2, uncol, key, "max").tolist() == [True, False, True]
    assert tjp._local_extreme(adj, 2, uncol, key, "min").tolist() == [True, False, True]


# --------------------------------------------------------------------------
# quality and scheduling helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(GRAPHS))
def test_quality_report_matches_repro(name):
    g, t = _graph(name)
    colors = repro.color(g).colors
    assert quality_report(t, colors) == r_quality_report(g, colors)
    bad = colors.copy()
    bad[0] = 0
    assert quality_report(t, bad) == r_quality_report(g, bad)
    assert quality_report(t, bad)["valid"] is False
    assert num_colors(colors) == repro.core.num_colors(colors)


def test_phases_and_schedule_quality_match_repro():
    g, t = _graph("rmat-g")
    colors = repro_torch.color(t, device="cpu").colors
    want, got = r_phases(colors), phases(colors)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
        assert b.dtype == np.int32
    assert schedule_quality(colors) == r_schedule_quality(colors)
    assert schedule_quality(np.zeros(0, np.int32)) == r_schedule_quality(
        np.zeros(0, np.int32))


@pytest.mark.parametrize("n_devices", [4, 5, 6, 7, 8])
def test_all_to_all_rounds_match_repro(n_devices):
    want = r_all_to_all_rounds(n_devices)
    got = all_to_all_rounds(n_devices, device="cpu")
    assert got == want
    seen = set()
    for rnd in got:
        assert len({s for s, _ in rnd}) == len(rnd)
        assert len({r for _, r in rnd}) == len(rnd)
        seen.update(rnd)
    assert seen == {(i, j) for i in range(n_devices) for j in range(n_devices)
                    if i != j}
    assert len(got) <= 2 * (n_devices - 1) + 1


def test_all_to_all_rounds_ignores_other_color_kwargs():
    assert (all_to_all_rounds(4, device="cpu", heuristic="id", engine="padded")
            == r_all_to_all_rounds(4, heuristic="id", engine="padded"))


# --------------------------------------------------------------------------
# mirrors of tests/test_scheduling.py and the coloring part of
# tests/test_system.py, on the port
# --------------------------------------------------------------------------

def test_phases_are_independent_sets():
    t = _tg(erdos_renyi(800, 8.0, seed=1))
    colors = color_data_driven(t, device="cpu").colors
    adj = {v: set(t.neighbors(v).tolist()) for v in range(t.n)}
    for phase in phases(colors):
        s = set(phase.tolist())
        for v in s:
            assert not (adj[v] & s), "phase contains adjacent vertices"


def test_phases_cover_all_vertices():
    t = _tg(erdos_renyi(500, 6.0, seed=2))
    assert sum(p.size for p in phases(greedy_serial(t))) == t.n


def test_schedule_quality_parallelism():
    t = _tg(erdos_renyi(1000, 6.0, seed=3))
    sq = schedule_quality(color_data_driven(t, device="cpu").colors)
    assert sq["mean_parallelism"] >= t.n / (t.max_degree + 1)


def test_end_to_end_color_pipeline():
    """Generate -> color (SGR, serial, multi-hash) -> validate -> schedule,
    on the port, and the same counts as repro."""
    from repro_torch.graphs import build_graph as t_build_graph

    t = t_build_graph("rmat-g", scale=0.05)
    serial = greedy_serial(t)
    opt = color_data_driven(t, coarsen_lanes=16384, device="cpu")
    mis = color_multihash(t, 2, device="cpu")
    assert is_valid_coloring(t, opt.colors) and is_valid_coloring(t, mis.colors)
    assert num_colors(opt.colors) <= num_colors(serial) + 2
    assert num_colors(mis.colors) > num_colors(opt.colors)
    assert sum(p.size for p in phases(opt.colors)) == t.n
    g = build_graph("rmat-g", scale=0.05)
    _assert_same(repro.core.color_multihash(g, 2), mis)
    np.testing.assert_array_equal(repro.core.greedy_serial(g), serial)


def test_core_reexports_the_ported_names():
    import repro.core
    import repro_torch.core

    assert repro_torch.core.__all__ == repro.core.__all__  # in its order
    for name in repro_torch.core.__all__:
        assert getattr(repro_torch.core, name) is not None
    assert repro_torch.core.color_jp is color_jp


def test_algorithms_equal_repro_but_dynamic():
    # "dynamic" was the one missing until ROADMAP A9 was ported
    assert repro_torch.algorithms() == repro.algorithms()
    for name in ("serial", "topology", "jp", "multihash", "threestep"):
        assert repro_torch.get_algorithm(name).__module__.startswith(
            "repro_torch.core.")
