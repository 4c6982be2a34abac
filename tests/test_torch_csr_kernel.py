"""K1 and K2 of the PyTorch port, and the pieces around them, against repro.

On CPU tensors the port's kernel wrappers take their plain PyTorch versions;
these tests hold those against ``repro``'s Pallas kernels run in interpret
mode and against ``repro``'s JAX formulations.  Inputs are made with numpy
from a seed and handed to both packages.  Everything is integer arithmetic,
so the tolerance is 0: arrays must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.coloring as C
from repro.core import DeviceCSR, auto_tile_thresholds, csr_from_edges, next_pow2
from repro.core.firstfit import FF_FUNCS
from repro.graphs import SUITE, build_graph, erdos_renyi, grid2d, power_law
from repro.kernels.superstep.csr_kernel import (
    serial_tail_csr_tpu,
    superstep_csr_tpu,
)

import repro_torch.core.coloring as TC
from repro_torch.core import csr as tcsr
from repro_torch.core.csr import CSRGraph as TGraph
from repro_torch.core.firstfit import FF_FUNCS as T_FF_FUNCS
from repro_torch.kernels.superstep.csr_kernel import (
    serial_tail_csr,
    superstep_csr,
)

GRAPHS = {
    "er": lambda: erdos_renyi(900, 7.0, seed=11),
    "grid": lambda: grid2d(25, 30),
    "powerlaw": lambda: power_law(900, 6.0, seed=13),
}


def _t(x) -> torch.Tensor:
    """A CPU tensor with the same contents as a numpy or JAX array."""
    return torch.from_numpy(np.array(x))


def _port_graph(g):
    return TGraph.from_numpy(g.row_offsets, g.col_indices)


def _inputs(g, seed, extra_sentinels=0):
    """Both packages' device CSR, colors, packed table and worklist for ``g``."""
    rng = np.random.default_rng(seed)
    dev = DeviceCSR.from_csr(g)
    tdev = tcsr.DeviceCSR.from_csr(_port_graph(g), "cpu")
    W = dev.max_width
    colors = np.concatenate([rng.integers(0, W + 2, g.n), [0]]).astype(np.int32)
    wl = np.arange(g.n, dtype=np.int32)
    if extra_sentinels:
        wl = np.concatenate([wl, np.full(extra_sentinels, g.n, np.int32)])
    deg_ext = np.asarray(dev.deg_ext)
    packed = colors + (deg_ext << 16)
    return dev, tdev, colors, packed, wl


def _check_k1(g, seed, W, heuristic, extra_sentinels=0):
    dev, tdev, _, packed, wl = _inputs(g, seed, extra_sentinels)
    want_c, want_n = superstep_csr_tpu(dev.row_starts, dev.col_padded,
                                       jnp.asarray(packed), jnp.asarray(wl), W,
                                       heuristic, interpret=True)
    got_c, got_n = superstep_csr(tdev.row_starts, tdev.col_padded, _t(packed),
                                 _t(wl), W, heuristic)
    assert got_c.dtype == torch.int32 and got_n.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(want_c), got_c.numpy())
    np.testing.assert_array_equal(np.asarray(want_n), got_n.numpy())
    return got_c, got_n


@pytest.mark.parametrize("W", [31, 32, 63, 64])
@pytest.mark.parametrize("heuristic", ["id", "degree"])
def test_k1_plain_word_boundary_widths(W, heuristic):
    """A (W+1)-clique puts every row at degree exactly W, at or one past a
    32-bit bitset word boundary."""
    src, dst = np.triu_indices(W + 1, 1)
    _check_k1(csr_from_edges(W + 1, src, dst), W, W, heuristic)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("heuristic", ["id", "degree"])
def test_k1_plain_ragged_rows(gname, heuristic):
    """Lanes past a row's degree alias the next row's ids in raw C storage
    and must read as the inert sentinel."""
    g = GRAPHS[gname]()
    _check_k1(g, 17, max(g.max_degree, 1), heuristic)


def test_k1_plain_sentinel_padded_worklist():
    g = GRAPHS["er"]()
    got_c, got_n = _check_k1(g, 23, g.max_degree, "degree", extra_sentinels=37)
    assert got_n[: g.n].any()
    assert bool(got_n[g.n:].all())  # a sentinel has color 0: needs a refit


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_k2_plain_matches_pallas_tail_and_serial_tail_step(gname):
    g = GRAPHS[gname]()
    dev, tdev, colors, _, _ = _inputs(g, 31)
    W = dev.max_width
    rng = np.random.default_rng(37)
    wl = rng.choice(g.n, min(64, g.n), replace=False).astype(np.int32)
    wl = np.concatenate([wl, np.full(7, g.n, np.int32)])  # sentinel padding
    wl = np.asarray(C.order_tail(jnp.asarray(wl), dev.deg_ext))
    want_kernel = serial_tail_csr_tpu(dev.row_starts, dev.col_padded, dev.deg_ext,
                                      jnp.asarray(colors), jnp.asarray(wl), W,
                                      interpret=True)
    want_step = C.serial_tail_step(dev.row1, jnp.asarray(colors), jnp.asarray(wl))
    colors_ext = _t(colors)
    got = serial_tail_csr(tdev.row_starts, tdev.col_padded, tdev.deg_ext,
                          colors_ext, _t(wl), W)
    assert got is colors_ext  # updated in place, as the Pallas kernel aliases
    np.testing.assert_array_equal(np.asarray(want_kernel), got.numpy())
    np.testing.assert_array_equal(np.asarray(want_step), got.numpy())


@pytest.mark.parametrize("kind", ["bitset", "scan"])
def test_serial_tail_step_matches_repro(kind):
    g = GRAPHS["grid"]()
    dev, tdev, colors, _, _ = _inputs(g, 41)
    wl = np.concatenate([np.arange(0, g.n, 7, dtype=np.int32), [g.n, g.n]])
    wl = np.asarray(C.order_tail(jnp.asarray(wl), dev.deg_ext))
    want = C.serial_tail_step(dev.row1, jnp.asarray(colors), jnp.asarray(wl), kind)
    got = TC.serial_tail_step(tdev.row1, _t(colors), _t(wl), kind)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("provider", ["csr", "dense"])
def test_provider_tail_matches_repro(provider):
    """``provider_tail`` over a ``DeviceCSR`` and a ``DenseRows`` provider."""
    g = GRAPHS["powerlaw"]()
    dev, tdev, colors, _, _ = _inputs(g, 43)
    wl = np.concatenate([np.arange(3, g.n, 5, dtype=np.int32), [g.n]])
    wl = np.asarray(C.order_tail(jnp.asarray(wl), dev.deg_ext))
    if provider == "dense":
        adj = np.asarray(dev.gather_rows(jnp.arange(g.n, dtype=jnp.int32), dev.max_width))
        dev, tdev = C.DenseRows(jnp.asarray(adj)), TC.DenseRows(_t(adj), tdev)
    want = C.provider_tail(dev, jnp.asarray(colors), jnp.asarray(wl))
    colors_ext = _t(colors)
    got = TC.provider_tail(tdev, colors_ext, _t(wl))
    assert got is colors_ext
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_ffs_u32_matches_repro():
    """Every bit alone, zero, all ones, and random words (bit 31 set in
    about half): ``repro`` on uint32, the port on the same bits in int32."""
    from repro.core.firstfit import ffs_u32
    from repro_torch.core.firstfit import ffs_u32 as t_ffs_u32

    rng = np.random.default_rng(47)
    words = np.concatenate([np.uint32(1) << np.arange(32, dtype=np.uint32),
                            np.array([0, 0xFFFFFFFF, 0x80000000], np.uint32),
                            rng.integers(0, 2 ** 32, 500, dtype=np.uint64).astype(np.uint32),
                            rng.integers(0, 2 ** 32, 200, dtype=np.uint64).astype(np.uint32)
                            & ~np.uint32(0xFFFF)]).reshape(-1, 5)
    want = np.asarray(ffs_u32(jnp.asarray(words)))
    got = t_ffs_u32(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == tuple(words.shape)
    np.testing.assert_array_equal(want, got.numpy())
    assert t_ffs_u32(torch.zeros((0,), dtype=torch.int32)).shape == (0,)


def test_device_csr_matches_repro():
    g = GRAPHS["powerlaw"]()
    dev = DeviceCSR.from_csr(g)
    tdev = tcsr.DeviceCSR.from_csr(_port_graph(g), "cpu")
    for name in ("row_starts", "col_padded", "deg_ext"):
        assert getattr(tdev, name).dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(getattr(dev, name)),
                                      getattr(tdev, name).numpy())
    assert (tdev.n, tdev.max_width) == (dev.n, dev.max_width)
    ids = np.array([0, 5, g.n, 17, g.n - 1], np.int32)
    for width in (1, 4, dev.max_width):
        np.testing.assert_array_equal(
            np.asarray(dev.gather_rows(jnp.asarray(ids), width)),
            tdev.gather_rows(_t(ids), width).numpy())
    for v in (0, 3, g.n - 1, g.n):
        np.testing.assert_array_equal(np.asarray(dev.gather_row1(jnp.int32(v))),
                                      tdev.gather_row1(v).numpy())


@pytest.mark.parametrize("heuristic", ["id", "degree"])
def test_ragged_superstep_packed_and_unpacked_match_repro(heuristic):
    """The K1 path and the unpacked CPU formulation (the packed-overflow
    fallback) both equal repro's rotated super-step."""
    g = GRAPHS["er"]()
    dev, tdev, colors, _, wl = _inputs(g, 43, extra_sentinels=5)
    W = dev.max_width
    want_c, want_wl, want_n = C.ragged_superstep(
        lambda ids: dev.gather_rows(ids, W), dev.deg_ext, jnp.asarray(colors),
        jnp.asarray(wl), heuristic=heuristic, pack_degrees=True)
    for pack in (True, False):
        got_c, got_wl, got_n = TC.ragged_superstep(
            tdev, tdev.deg_ext, _t(colors), _t(wl), heuristic=heuristic,
            pack_degrees=pack, width=W)
        np.testing.assert_array_equal(np.asarray(want_c), got_c.numpy())
        np.testing.assert_array_equal(np.asarray(want_wl), got_wl.numpy())
        assert int(want_n) == int(got_n)


@pytest.mark.parametrize("x", [0, 1, 2, 3, 5, 64, 65, 1000, 2**20 + 1])
def test_next_pow2_matches_repro(x):
    assert tcsr.next_pow2(x) == next_pow2(x)


@pytest.mark.parametrize("name", sorted(SUITE))
def test_auto_tile_thresholds_match_repro(name):
    deg = build_graph(name, 0.05).degrees
    assert tcsr.auto_tile_thresholds(deg) == auto_tile_thresholds(deg)


@pytest.mark.parametrize("cap", [1, 7, 64, 1000])
def test_compact_matches_repro(cap):
    rng = np.random.default_rng(cap)
    ids = rng.integers(0, 500, cap).astype(np.int32)
    flags = rng.random(cap) < 0.4
    want_wl, want_n = C.compact(jnp.asarray(ids), jnp.asarray(flags), 500)
    got_wl, got_n = TC.compact(_t(ids), _t(flags), 500)
    np.testing.assert_array_equal(np.asarray(want_wl), got_wl.numpy())
    assert int(want_n) == int(got_n) and got_wl.dtype == torch.int32


def test_order_tail_matches_repro():
    g = GRAPHS["powerlaw"]()
    deg_ext = np.concatenate([g.degrees, [0]]).astype(np.int32)
    rng = np.random.default_rng(3)
    wl = np.concatenate([rng.choice(g.n, 300, replace=False),
                         np.full(20, g.n)]).astype(np.int32)
    rng.shuffle(wl)
    want = C.order_tail(jnp.asarray(wl), jnp.asarray(deg_ext))
    got = TC.order_tail(_t(wl), _t(deg_ext))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("tail_serial", ["auto", None, 0, False, 1, 100, 5000])
@pytest.mark.parametrize("n", [1, 100, 5000, 200000])
def test_resolve_tail_threshold_matches_repro(tail_serial, n):
    assert (TC.resolve_tail_threshold(tail_serial, n)
            == C.resolve_tail_threshold(tail_serial, n))


@pytest.mark.parametrize("kind", ["scan", "sort", "bitset"])
@pytest.mark.parametrize("W", [1, 8, 31, 32, 33, 100])
def test_firstfit_matches_repro(kind, W):
    rng = np.random.default_rng(W)
    tile = rng.integers(0, W + 3, (257, W)).astype(np.int32)
    tile[:8] = np.arange(1, W + 1)[None, :]  # full rows: answer W + 1
    want = FF_FUNCS[kind](jnp.asarray(tile))
    got = T_FF_FUNCS[kind](_t(tile))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("heuristic", ["id", "degree"])
def test_conflict_rules_match_repro(heuristic):
    from repro.core.heuristics import conflict_lose_flags, conflict_lose_lanes

    from repro_torch.core import heuristics as th

    rng = np.random.default_rng(7)
    w, W, n = 300, 12, 400
    ids = np.concatenate([rng.integers(0, n, w - 4), np.full(4, n)]).astype(np.int32)
    nid = rng.integers(0, n + 1, (w, W)).astype(np.int32)
    my_c = np.where(ids < n, rng.integers(0, 4, w), 0).astype(np.int32)
    nc = rng.integers(0, 4, (w, W)).astype(np.int32)
    my_d = rng.integers(0, 5, w).astype(np.int32)
    nd = rng.integers(0, 5, (w, W)).astype(np.int32)
    args = (ids, nid, my_c, nc, my_d, nd)
    want = conflict_lose_lanes(*map(jnp.asarray, args), heuristic)
    got = th.conflict_lose_lanes(*map(_t, args), heuristic)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(
        np.asarray(conflict_lose_flags(*map(jnp.asarray, args), heuristic)),
        th.conflict_lose_flags(*map(_t, args), heuristic).numpy())
