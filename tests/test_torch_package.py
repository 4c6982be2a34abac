"""Guards, option surface and device behaviour of the PyTorch port.

This file imports no JAX, so its card tests (marked ``cuda``) also run on a
machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_package.py

Without a card they skip; the decision is made inside the ``cuda_device``
fixture, never while the module is imported.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
import repro_torch.core.coloring as core_coloring
from repro_torch.core.coloring import order_tail, run_ragged_engine
from repro_torch.core.csr import (
    CSRGraph,
    DeviceCSR,
    PartitionedCSR,
    csr_from_edges,
)
from repro_torch.core.distributed import ShardRows
from repro_torch.core.validate import is_valid_coloring
from repro_torch.d2 import (
    compress_jacobian_pattern,
    d2_sgr_step,
    validate_bipartite,
    validate_d2,
)
from repro_torch.d2.coloring import TwoHopRows
from repro_torch.errors import CapacityError
from repro_torch.graphs import (
    build_graph,
    erdos_renyi,
    grid2d,
    jacobian_band,
    jacobian_tall_skinny,
    power_law,
    road,
)
from repro_torch.kernels.conflict.kernel import (
    conflict_rows,
    conflict_rows_ref,
    conflict_tile,
    conflict_tile_ref,
)
from repro_torch.kernels.cuda import ROW_LANES, TableRows
from repro_torch.kernels.d2.kernel import d2_firstfit, d2_firstfit_ref
from repro_torch.kernels.firstfit.kernel import (
    firstfit_rows,
    firstfit_rows_ref,
    firstfit_tile,
    firstfit_tile_ref,
)
from repro_torch.kernels.superstep.csr_kernel import (
    _launch_tail,
    serial_tail_csr,
    serial_tail_csr_ref,
    serial_tail_rows,
    serial_tail_rows_ref,
    superstep_csr,
    superstep_csr_ref,
)
from repro_torch.kernels.superstep.kernel import (
    source_tile,
    superstep_rows,
    superstep_rows_ref,
    superstep_tile,
    superstep_tile_ref,
)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "benchmarks" / "port_serve.py",
    *sorted((ROOT / "examples").glob("port_*.py"))]
FIELDS = ("iterations", "work_items", "padded_work", "class_cells", "converged")
KERNELS = (superstep_csr, serial_tail_csr, superstep_tile, firstfit_tile,
           conflict_tile, firstfit_rows, conflict_rows, d2_firstfit)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.fixture
def zero_counts():
    for k in KERNELS:
        k.launches = 0
    yield
    for k in KERNELS:
        k.launches = 0


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    tops = {name.split(".")[0] for name in _imported_modules(path)}
    assert not tops & {"jax", "jaxlib", "repro"}, path


def _k1_inputs(seed=5):
    g = power_law(1500, 6.0, seed=seed)
    dev = DeviceCSR.from_csr(g, "cpu")
    rng = np.random.default_rng(seed)
    colors = np.concatenate([rng.integers(0, dev.max_width + 2, g.n), [0]])
    packed = torch.from_numpy(colors.astype(np.int32)) + (dev.deg_ext << 16)
    wl = torch.from_numpy(np.concatenate(
        [rng.permutation(g.n)[:999], np.full(5, g.n)]).astype(np.int32))
    return g, dev, packed, wl


def _tile_inputs(W, seed=6, w=300, n=1000):
    """Random ``(ids, nid, my_c, nc, my_d, nd)`` for K3 and K5 (K4 takes
    ``nc``): small colours that clash, sentinel rows, and rows holding every
    colour in 1..W (answer W + 1, through the shared-bitset path)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, w).astype(np.int32)
    ids[-5:] = n
    nid = rng.integers(0, n + 1, (w, W)).astype(np.int32)
    nc = rng.integers(0, 6, (w, W)).astype(np.int32)
    nc[:6] = rng.permutation(W)[None, :] + 1
    nd = rng.integers(0, 7, (w, W)).astype(np.int32)
    my_c = rng.integers(0, 6, w).astype(np.int32)
    my_c[:6:2] = 0
    my_d = rng.integers(0, 7, w).astype(np.int32)
    my_c[-5:] = my_d[-5:] = 0
    return tuple(torch.from_numpy(a) for a in (ids, nid, my_c, nc, my_d, nd))


def _rows_inputs(W, seed=8, w=300, n=1000):
    """``(table, deg_ext, colors_ext, ids, rows)`` for the row-resident K4
    and K5: ``table`` is ``(n, W + 3)``, read as its first W columns (row v
    holds ``deg_ext[v]`` ids, then the sentinel n); ``rows`` is a ``(w, W)``
    id tile with self, duplicate and sentinel lanes; five sentinel ids; six
    rows of each source hold a pool of W vertices coloured 1..W (answer
    W + 1, through the shared-bitset path for W >= 32)."""
    rng = np.random.default_rng(seed)
    n = max(n, 2 * W + 8)
    colors = rng.integers(0, 6, n + 1).astype(np.int32)
    deg = rng.integers(0, W + 1, n + 1).astype(np.int32)
    table = rng.integers(0, n, (n, W + 3)).astype(np.int32)
    ids = rng.choice(n, w, replace=False).astype(np.int32)
    ids[-5:] = n
    rows = rng.integers(0, n + 1, (w, W)).astype(np.int32)
    rows[:, 0] = np.where(rng.random(w) < 0.3, ids, rows[:, 0])  # self lanes
    rows[:, -1] = np.where(rng.random(w) < 0.3, rows[:, 0], n)  # duplicate, sentinel
    pool = rng.choice(np.setdiff1d(np.arange(n), ids), W, replace=False)
    colors[pool] = np.arange(1, W + 1)
    for i in range(6):
        deg[ids[i]] = W
        table[ids[i], :W] = rng.permutation(pool)
        rows[i] = rng.permutation(pool)
    table[:, :W][np.arange(W)[None, :] >= deg[:n, None]] = n
    colors[n] = deg[n] = 0
    return tuple(torch.from_numpy(a) for a in (table, deg, colors, ids, rows))


def _d2_tiles(w, W1, W2, seed=7, full_rows=4):
    """Random hop-1 ``(w, W1)`` and hop-2 ``(w, W2)`` colour tiles for K6:
    zeros, colours past the bound, and ``full_rows`` rows holding every
    colour in 1..W1+W2 (answer W1 + W2 + 1; for W1 + W2 >= 32 through the
    shared-bitset path)."""
    rng = np.random.default_rng(seed)
    hi = W1 + W2 + 3
    nc1 = rng.integers(0, hi, (w, W1)).astype(np.int32)
    nc2 = rng.integers(0, hi, (w, W2)).astype(np.int32)
    nc1[: w // 3] %= 9  # low colours: rows where 1..32 may all be taken
    for i in range(min(w, full_rows)):
        perm = rng.permutation(W1 + W2) + 1
        nc1[i], nc2[i] = perm[:W1], perm[W1:]
    return torch.from_numpy(nc1), torch.from_numpy(nc2)


def _d2_steps(g, device, include_first_hop=True, steps=4):
    """``d2_sgr_step`` from the all-zero start on ``device``: the list of
    ``(colors_ext, wl, count)`` after each step, on the host."""
    adj = torch.from_numpy(g.padded_adjacency()).to(device)
    deg = torch.from_numpy(np.concatenate([g.degrees, [0]]).astype(np.int32)).to(device)
    colors = torch.zeros(g.n + 1, dtype=torch.int32, device=device)
    wl = torch.arange(g.n, dtype=torch.int32, device=device)
    out = []
    for _ in range(steps):
        colors, wl, count = d2_sgr_step(adj, adj, deg, colors, wl,
                                        include_first_hop=include_first_hop)
        out.append((colors.cpu().clone(), wl.cpu(), int(count)))
    return out


def test_wrappers_take_plain_versions_on_cpu_and_count_no_launch(zero_counts):
    g, dev, packed, wl = _k1_inputs()
    W = dev.max_width
    got = superstep_csr(dev.row_starts, dev.col_padded, packed, wl, W, "degree")
    want = superstep_csr_ref(dev.row_starts, dev.col_padded, packed, wl, W, "degree")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    tail = order_tail(wl, dev.deg_ext)
    colors = torch.ones(g.n + 1, dtype=torch.int32)
    got = serial_tail_csr(dev.row_starts, dev.col_padded, dev.deg_ext,
                          colors.clone(), tail, W)
    want = serial_tail_csr_ref(dev.row_starts, dev.col_padded, dev.deg_ext,
                               colors.clone(), tail, W)
    assert torch.equal(got, want)
    args = _tile_inputs(40)
    got = superstep_tile(*args, "degree")
    want = superstep_tile_ref(*args, "degree")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(conflict_tile(*args, "id"), conflict_tile_ref(*args, "id"))
    assert torch.equal(firstfit_tile(args[3]), firstfit_tile_ref(args[3]))
    table, deg, colors, ids, rows = _rows_inputs(40)
    for src in (dict(table=table[:, :40]), dict(rows=rows)):
        assert torch.equal(firstfit_rows(colors, ids, **src),
                           firstfit_rows_ref(colors, ids, **src))
        assert torch.equal(conflict_rows(colors, deg, ids, "degree", **src),
                           conflict_rows_ref(colors, deg, ids, "degree", **src))
    nc1, nc2 = _d2_tiles(40, 26, 64)
    assert torch.equal(d2_firstfit(nc1, nc2), d2_firstfit_ref(nc1, nc2))
    g = build_graph("rmat-g", 0.05)
    r = repro_torch.color(g, device="cpu")
    assert r.iterations > 2 and r.class_cells[-1][0] == r.class_cells[0][0]
    for opts in (dict(engine="classic"), dict(engine="padded"),
                 dict(coarsen_lanes=512, mode="fused")):
        assert repro_torch.color(g, device="cpu", **opts).converged
    g = erdos_renyi(300, 5.0, seed=1)
    for strategy in ("precomputed", "onthefly"):
        assert validate_d2(g, repro_torch.color(g, "distance2", device="cpu",
                                                strategy=strategy).colors)
    _d2_steps(g, "cpu")
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def test_color_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.color(grid2d(4, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.color(grid2d(4, 4), device="cuda")


# options that raised NotImplementedError naming their ROADMAP item; A5
# (the baselines), A6 (trace=), A10 (ingest, the ladder), A9 (the dynamic
# algorithm) and A11 (the sharded engine) are ported, so none raises now
NOT_PORTED = [
    ("engine-sharded", (), dict(engine="sharded"), "A11"),
    ("trace", (), dict(trace=True), "A6"),
    ("validate-input", (), dict(validate_input="strict"), "A10"),
    ("ensure-valid", (), dict(ensure_valid=True), "A10"),
    ("algorithm-serial", ("serial",), {}, "A5"),
    ("algorithm-jp", ("jp",), {}, "A5"),
    ("algorithm-multihash", ("multihash",), {}, "A5"),
    ("algorithm-threestep", ("threestep",), {}, "A5"),
    ("distance2-trace", ("distance2",), dict(trace=True), "A6"),
    ("distance2-sharded", ("distance2",), dict(engine="sharded"), "A11"),
    ("algorithm-dynamic", ("dynamic",), {}, "A9"),
]
PORTED_ITEMS = ("A5", "A6", "A9", "A10", "A11")


@pytest.mark.parametrize("args,opts,item", [c[1:] for c in NOT_PORTED],
                         ids=[c[0] for c in NOT_PORTED])
def test_options_outside_the_slice_raise_naming_their_item(args, opts, item):
    """The options of the items ported since (A5, A6, A9, A10, A11) run: a
    valid, converged coloring whose fields equal the same call without the
    option where the option adds only telemetry or checks, and, for
    ``engine="sharded"`` on one device, the fused call (their parity with
    repro is held in ``tests/test_torch_baselines.py``,
    ``test_torch_obs.py``, ``test_torch_dynamic.py``,
    ``test_torch_guarantee.py`` and ``test_torch_sharded.py``)."""
    g = erdos_renyi(300, 5.0, seed=1)
    if item not in PORTED_ITEMS:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            repro_torch.color(g, *args, device="cpu", **opts)
        return
    r = repro_torch.color(g, *args, device="cpu", **opts)
    valid = validate_d2 if args == ("distance2",) else is_valid_coloring
    assert r.converged and valid(g, r.colors)
    assert r.degradations == ()
    if args in ((), ("distance2",)):
        # one device: the sharded engine is the ragged fused call
        plain = repro_torch.color(g, *args, device="cpu",
                                  **(dict(mode="fused") if item == "A11" else {}))
        np.testing.assert_array_equal(plain.colors, r.colors)
        assert all(getattr(plain, f) == getattr(r, f) for f in FIELDS)
    if opts.get("trace"):
        assert r.trace.check(r) == [] and r.trace.iterations == r.iterations
    else:
        assert r.trace is None


def test_unchunked_coarsen_lanes_is_in_the_slice():
    g = erdos_renyi(300, 5.0, seed=1)
    a = repro_torch.color(g, device="cpu")
    b = repro_torch.color(g, device="cpu", coarsen_lanes=g.n)
    np.testing.assert_array_equal(a.colors, b.colors)
    assert all(getattr(a, f) == getattr(b, f) for f in FIELDS)


def test_warm_start_raises_naming_its_item():
    """``colors_init=`` raised naming A9 until A9 was ported; it now runs.
    From all-zero colours its first step is the bootstrap the cold run
    skips (every vertex takes colour 1), so colours, iterations and work
    items equal the cold run's and ``padded_work`` adds that step's cells
    (its parity with repro is held in ``tests/test_torch_dynamic.py``)."""
    g = grid2d(6, 6)
    dev = DeviceCSR.from_csr(g, "cpu")
    kw = dict(n=g.n, provider=dev, deg_ext=dev.deg_ext,
              classes=[np.arange(g.n, dtype=np.int32)], tile_widths=[4],
              acc_widths=[4], tail_width=4, max_iters=10)
    cold = run_ragged_engine(**kw)
    warm = run_ragged_engine(**kw, colors_init=np.zeros(g.n + 1, np.int32))
    np.testing.assert_array_equal(cold.colors, warm.colors)
    assert (warm.iterations, warm.work_items) == (cold.iterations, cold.work_items)
    assert warm.padded_work == cold.padded_work + g.n * 4


def test_packed_capacity_guard():
    g = grid2d(6, 6)
    dev = DeviceCSR.from_csr(g, "cpu")
    with pytest.raises(CapacityError, match="packed gather"):
        run_ragged_engine(n=g.n, provider=dev, deg_ext=dev.deg_ext,
                          classes=[np.arange(g.n, dtype=np.int32)],
                          tile_widths=[4], acc_widths=[4], tail_width=40000,
                          max_iters=10, pack_degrees=True)


@pytest.mark.parametrize("opts,match", [
    (dict(backend="cuda"), "needs a CUDA device"),
    (dict(backend="pallas-csr"), "unknown backend"),
    (dict(backend="torch"), "unknown backend"),
    (dict(engine="dense"), "unknown engine"),
    (dict(mode="eager"), "unknown mode"),
    (dict(engine="classic", mode="eager"), "unknown mode"),
    (dict(heuristic="random"), "unknown heuristic"),
    (dict(firstfit="popcount"), "unknown firstfit"),
])
def test_bad_options_raise_value_error(opts, match):
    with pytest.raises(ValueError, match=match):
        repro_torch.color(grid2d(5, 5), device="cpu", **opts)


def test_unknown_device_and_algorithm_raise():
    with pytest.raises(ValueError, match="neither"):
        repro_torch.color(grid2d(5, 5), device="meta")
    with pytest.raises(ValueError, match="unknown algorithm"):
        repro_torch.color(grid2d(5, 5), "nonesuch", device="cpu")


@pytest.mark.parametrize("backend", [None, "auto"])
def test_auto_backends_run_on_cpu(backend):
    r = repro_torch.color(grid2d(5, 5), device="cpu", backend=backend)
    assert r.converged and r.num_colors >= 2


def test_public_surface():
    assert repro_torch.algorithms() == (
        "bipartite", "data_driven", "distance2", "dynamic", "fused", "jp",
        "multihash", "serial", "threestep", "topology")
    assert repro_torch.get_algorithm("data_driven").__name__ == "color_data_driven"
    assert issubclass(repro_torch.CapacityError, repro_torch.ReproError)
    assert issubclass(repro_torch.IngestError, (repro_torch.ReproError, ValueError))
    o = repro_torch.ColorOptions.normalize(heuristic="id", tiling=(8, 16))
    assert o.engine_kwargs() == {"heuristic": "id", "tiling": (8, 16)}
    assert hash(o) == hash(repro_torch.ColorOptions(
        heuristic="id", extra={"tiling": [8, 16]}))
    with pytest.raises(AttributeError):
        repro_torch.nonesuch  # noqa: B018


def test_csr_graph_from_numpy_checks_its_arrays():
    with pytest.raises(ValueError):
        CSRGraph.from_numpy(np.array([1, 2]), np.array([0, 1]))
    with pytest.raises(ValueError):
        CSRGraph.from_numpy(np.array([0, 3]), np.array([0, 1]))
    g = CSRGraph.from_numpy([0, 1, 2], [1, 0])
    assert (g.n, g.m, g.max_degree) == (2, 2, 1)


def test_kernel_wrappers_validate_their_arguments():
    g, dev, packed, wl = _k1_inputs()
    with pytest.raises(ValueError, match="class width"):
        superstep_csr(dev.row_starts, dev.col_padded, packed, wl, 0)
    with pytest.raises(ValueError, match="unknown heuristic"):
        superstep_csr(dev.row_starts, dev.col_padded, packed, wl, 4, "random")


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("heuristic", ["id", "degree"])
def test_cuda_k1_matches_plain(cuda_device, zero_counts, heuristic):
    g, dev, packed, wl = _k1_inputs(seed=9)
    gpu = DeviceCSR.from_csr(g, cuda_device)
    W = dev.max_width
    want = superstep_csr_ref(dev.row_starts, dev.col_padded, packed, wl, W,
                             heuristic)
    got = superstep_csr(gpu.row_starts, gpu.col_padded, packed.to(cuda_device),
                        wl.to(cuda_device), W, heuristic)
    assert superstep_csr.launches == 1
    assert all(torch.equal(a, b.cpu()) for a, b in zip(want, got))


@pytest.mark.cuda
def test_cuda_k2_matches_plain(cuda_device, zero_counts):
    g, dev, _, wl = _k1_inputs(seed=10)
    gpu = DeviceCSR.from_csr(g, cuda_device)
    tail = order_tail(wl, dev.deg_ext)
    colors = torch.from_numpy(np.random.default_rng(1).integers(
        0, 9, g.n + 1).astype(np.int32))
    colors[g.n] = 0
    want = serial_tail_csr_ref(dev.row_starts, dev.col_padded, dev.deg_ext,
                               colors.clone(), tail, dev.max_width)
    got = serial_tail_csr(gpu.row_starts, gpu.col_padded, gpu.deg_ext,
                          colors.to(cuda_device), tail.to(cuda_device),
                          dev.max_width)
    assert serial_tail_csr.launches == 1
    assert torch.equal(want, got.cpu())


def _tail_rows(W, seed=12, n=3000, T=1200):
    """Rows laid out by hand for K2: random ids (earlier and later entries,
    outside vertices, so rows are not symmetric), self, duplicate and
    sentinel lanes, sentinel entries, outside colours up to 60."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(n, T - 6, replace=False)
    wl = np.insert(ids, rng.integers(0, T - 6, 6), n).astype(np.int32)
    degs = rng.integers(0, W + 1, T).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(degs[:-1])]).astype(np.int32)
    col = rng.integers(0, n + 1, int(degs.sum()) + W).astype(np.int32)
    for i in range(T):
        row = col[starts[i]: starts[i] + degs[i]]
        lanes = rng.random(row.shape[0])
        row[lanes < 0.1] = wl[i]
        if row.shape[0]:
            row[(lanes >= 0.1) & (lanes < 0.2)] = row[0]
    colors = rng.integers(0, 61, n + 1).astype(np.int32)
    colors[n] = 0
    return tuple(torch.from_numpy(a) for a in (starts, degs, col, colors, wl))


def test_serial_tail_rows_takes_its_plain_version_on_cpu(zero_counts):
    starts, degs, col, colors, wl = _tail_rows(20)
    want = serial_tail_rows_ref(starts, degs, col, colors.clone(), wl, 20)
    got = colors.clone()
    assert serial_tail_rows(starts, degs, col, got, wl, 20) is got
    assert torch.equal(got, want)
    assert serial_tail_csr.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 20, 32, 33, 100])
@pytest.mark.parametrize("per_thread", [True, False], ids=["thread", "warp"])
def test_cuda_k2_layouts_match_plain(cuda_device, zero_counts, W, per_thread):
    args = _tail_rows(W)
    want = serial_tail_rows_ref(*args[:3], args[3].clone(), args[4], W)
    gpu = [a.to(cuda_device) for a in args]
    got = _launch_tail(*gpu, W, per_thread)
    assert serial_tail_csr.launches == 1
    assert torch.equal(want, got.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rmat-g", "thermal2", "europe.osm"])
def test_cuda_color_matches_cpu(cuda_device, zero_counts, name):
    g = build_graph(name, 0.05)
    a = repro_torch.color(g, device=cuda_device)
    assert superstep_csr.launches > 0 and serial_tail_csr.launches > 0
    b = repro_torch.color(g, device="cpu")
    np.testing.assert_array_equal(a.colors, b.colors)
    assert all(getattr(a, f) == getattr(b, f) for f in FIELDS)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [{}, dict(mode="fused")],
                         ids=["workefficient", "fused"])
def test_cuda_packed_overflow_star_matches_cpu(cuda_device, zero_counts, opts):
    n = 32769  # a star whose hub has degree 2^15 > PACKED_GATHER_MAX_DEG
    g = csr_from_edges(n, np.zeros(n - 1, np.int64), np.arange(1, n))
    a = repro_torch.color(g, device=cuda_device, **opts)
    assert superstep_tile.launches > 0 and superstep_csr.launches == 0
    b = repro_torch.color(g, device="cpu", **opts)
    np.testing.assert_array_equal(a.colors, b.colors)
    assert all(getattr(a, f) == getattr(b, f) for f in FIELDS)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 8, 31, 32, 33, 64, 376, 4096])
@pytest.mark.parametrize("heuristic", ["id", "degree"])
def test_cuda_tile_kernels_match_plain(cuda_device, zero_counts, W, heuristic):
    args = _tile_inputs(W, seed=W)
    gpu = [a.to(cuda_device) for a in args]
    want = superstep_tile_ref(*args, heuristic)
    got = superstep_tile(*gpu, heuristic)
    assert all(torch.equal(a, b.cpu()) for a, b in zip(want, got))
    assert torch.equal(conflict_tile_ref(*args, heuristic),
                       conflict_tile(*gpu, heuristic).cpu())
    assert torch.equal(firstfit_tile_ref(args[3]), firstfit_tile(gpu[3]).cpu())
    assert [k.launches for k in KERNELS] == [0, 0, 1, 1, 1, 0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", ROW_LANES)
@pytest.mark.parametrize("source", ["table", "rows"])
@pytest.mark.parametrize("W", [1, 8, 26, 33, 376])
def test_cuda_rows_kernels_match_plain(cuda_device, zero_counts, W, source, lanes):
    """K4 and K5 reading rows in place, in a forced layout, equal their plain
    versions: source (a) a column-sliced table read up to each degree,
    source (b) a gathered id tile."""
    table, deg, colors, ids, rows = _rows_inputs(W, seed=W)
    if source == "table":  # sliced on the card: rows W + 3 words apart
        cpu, gpu = dict(table=table[:, :W]), dict(table=table.to(cuda_device)[:, :W])
    else:
        cpu, gpu = dict(rows=rows), dict(rows=rows.to(cuda_device))
    colors_g, deg_g, ids_g = (a.to(cuda_device) for a in (colors, deg, ids))
    extra = dict(deg_ext=deg_g) if source == "table" else {}
    got = firstfit_rows(colors_g, ids_g, **gpu, **extra, lanes=lanes)
    assert torch.equal(firstfit_rows_ref(colors, ids, **cpu), got.cpu())
    for heuristic in ("id", "degree"):
        got = conflict_rows(colors_g, deg_g, ids_g, heuristic, **gpu, lanes=lanes)
        assert torch.equal(conflict_rows_ref(colors, deg, ids, heuristic, **cpu), got.cpu())
    assert [k.launches for k in KERNELS] == [0, 0, 0, 0, 0, 1, 2, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", ROW_LANES)
@pytest.mark.parametrize("W", [8, 33, 376])
def test_cuda_tile_entry_points_take_each_layout(cuda_device, zero_counts, W, lanes):
    args = _tile_inputs(W, seed=W)
    gpu = [a.to(cuda_device) for a in args]
    assert torch.equal(firstfit_tile_ref(args[3]), firstfit_tile(gpu[3], lanes=lanes).cpu())
    for heuristic in ("id", "degree"):
        assert torch.equal(conflict_tile_ref(*args, heuristic),
                           conflict_tile(*gpu, heuristic, lanes=lanes).cpu())
        got = superstep_tile(*gpu, heuristic, lanes=lanes)
        assert all(torch.equal(a, b.cpu())
                   for a, b in zip(superstep_tile_ref(*args, heuristic), got))


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [
    dict(), dict(buckets=(4, 16)), dict(coarsen_ff=3, coarsen_cr=2),
    dict(mode="fused", reuse_rows=True)],
    ids=["one-class", "buckets", "chunked", "fused-reuse-rows"])
def test_cuda_classic_gathers_no_tile(cuda_device, zero_counts, monkeypatch, opts):
    """The classic engine on the card reads its rows in place: with
    ``gather_rows`` made to raise for that call only, it still equals the
    CPU run in every field."""
    g = build_graph("rmat-g", 0.05)

    def refuse(*args, **kwargs):
        raise AssertionError("the classic step gathered a tile on the card")

    with monkeypatch.context() as m:
        m.setattr(core_coloring, "gather_rows", refuse)
        a = repro_torch.color(g, device=cuda_device, engine="classic", **opts)
    assert firstfit_rows.launches > 0 and conflict_rows.launches > 0
    assert firstfit_tile.launches == conflict_tile.launches == 0
    b = repro_torch.color(g, device="cpu", engine="classic", **opts)
    np.testing.assert_array_equal(a.colors, b.colors)
    assert all(getattr(a, f) == getattr(b, f) for f in FIELDS)


@pytest.mark.cuda
@pytest.mark.parametrize("opts,kernels", [
    (dict(engine="classic"), (firstfit_rows, conflict_rows)),
    (dict(engine="classic", mode="fused", reuse_rows=True),
     (firstfit_rows, conflict_rows)),
    (dict(engine="padded"), (superstep_tile, serial_tail_csr)),
    (dict(engine="padded", mode="fused"), (superstep_tile, serial_tail_csr)),
    (dict(coarsen_lanes=1024), (superstep_tile, serial_tail_csr)),
    (dict(mode="fused"), (superstep_csr, serial_tail_csr)),
], ids=["classic", "classic-fused", "padded", "padded-fused", "chunked",
        "ragged-fused"])
def test_cuda_engines_match_cpu(cuda_device, zero_counts, opts, kernels):
    g = build_graph("rmat-g", 0.05)
    a = repro_torch.color(g, device=cuda_device, **opts)
    assert all(k.launches > 0 for k in kernels)
    b = repro_torch.color(g, device="cpu", **opts)
    np.testing.assert_array_equal(a.colors, b.colors)
    assert all(getattr(a, f) == getattr(b, f) for f in FIELDS)


@pytest.mark.cuda
def test_cuda_wrappers_reject_other_dtypes_and_mixed_devices(cuda_device):
    g, dev, packed, wl = _k1_inputs()
    gpu = DeviceCSR.from_csr(g, cuda_device)
    with pytest.raises(ValueError, match="int32"):
        superstep_csr(gpu.row_starts, gpu.col_padded, packed.to(cuda_device),
                      wl.to(cuda_device).long(), dev.max_width)
    with pytest.raises(ValueError, match="all lie"):
        superstep_csr(gpu.row_starts, gpu.col_padded, packed, wl, dev.max_width)
    args = _tile_inputs(16)
    gpu_args = [a.to(cuda_device) for a in args]
    with pytest.raises(ValueError, match="int32"):
        firstfit_tile(gpu_args[3].long())
    with pytest.raises(ValueError, match="all lie"):
        conflict_tile(*gpu_args[:3], args[3], *gpu_args[4:])
    with pytest.raises(ValueError, match="int32"):
        superstep_tile(*gpu_args[:5], gpu_args[5].long())
    table, deg, colors, ids, rows = (a.to(cuda_device) for a in _rows_inputs(16))
    with pytest.raises(ValueError, match="int32 table"):
        firstfit_rows(colors, ids, table=table.long()[:, :16], deg_ext=deg)
    with pytest.raises(ValueError, match="all lie"):
        conflict_rows(colors, deg, ids, table=table.cpu()[:, :16])
    with pytest.raises(ValueError, match="int32"):
        conflict_rows(colors, deg, ids, rows=rows.long())


def _k3_case(source, seed=14):
    """``(source, W, deg_ext, colors_ext, ids)`` on the CPU for K3 over a
    row source: a column-sliced random table (rows W + 3 words apart), the
    padded engine's dense table, CSR rows at full and at a class width, G²
    rows with G's degrees, two-hop rows for distance-2, for bipartite and
    for a shard's slice of the first hop.  Small colours that clash, three
    sentinel ids, and the row with the most distinct neighbours holding
    1, 2, ... one each while its vertex is uncoloured (for rows of 33 or
    more, FirstFit's shared-bitset path)."""
    rng = np.random.default_rng(seed)
    if source == "table":
        table, deg, _, ids, _ = _rows_inputs(40, seed=seed)
        src, W = TableRows(table[:, :40]), 40
    elif source in ("dense", "csr", "csr-class"):
        g = power_law(1500, 6.0, seed=seed)
        dev = DeviceCSR.from_csr(g, "cpu")
        deg = dev.deg_ext
        if source == "dense":
            src, W = core_coloring.DenseRows(
                torch.from_numpy(g.padded_adjacency()), dev).lane_source()
        else:
            src, W = dev.lane_source(16 if source == "csr-class" else None)
        ids = rng.permutation(g.n)
        ids = ids[deg[ids].numpy() <= W][:999]
    elif source == "csr-g2":
        g = erdos_renyi(1000, 4.0, seed=seed)
        src, W = DeviceCSR.from_csr(g.square(), "cpu").lane_source()
        deg = DeviceCSR.from_csr(g, "cpu").deg_ext
        ids = rng.permutation(g.n)
    elif source == "csr-shard":  # shard 1 of 3; ids outside it read no row
        g = power_law(1500, 6.0, seed=seed)
        plan = PartitionedCSR.from_graph(g, 3)
        shard = [torch.from_numpy(a[1]) for a in plan.stack_shards(g)]
        src, W = ShardRows(*shard, int(plan.starts[1]), g.n, plan.n_loc,
                           g.max_degree).lane_source()
        deg = DeviceCSR.from_csr(g, "cpu").deg_ext
        ids = np.concatenate([np.arange(plan.starts[1], plan.starts[2])[:900],
                              rng.permutation(g.n)[:99]])
    elif source == "two-hop-bipartite":
        bg = jacobian_tall_skinny(2000, 64, 4, seed=seed)
        c2r, r2c = (torch.from_numpy(a) for a in bg.padded_halves())
        src, W = TwoHopRows(c2r, r2c, False).lane_source()
        deg = torch.from_numpy(np.concatenate([bg.col_degrees, [0]]).astype(np.int32))
        ids = rng.permutation(bg.n_cols)
    else:
        g = erdos_renyi(2000, 6.0, seed=seed)
        adj = torch.from_numpy(g.padded_adjacency())
        deg = torch.from_numpy(np.concatenate([g.degrees, [0]]).astype(np.int32))
        if source == "two-hop-d2":
            src, W = TwoHopRows(adj, adj).lane_source()
            ids = rng.permutation(g.n)[:999]
        else:  # rows [500, 1500) of the first hop; ids outside it too
            src, W = TwoHopRows(adj[500:1500].clone(), adj, True, 500, g.n).lane_source()
            ids = rng.permutation(g.n)[:999]
    n = deg.shape[0] - 1
    ids = torch.from_numpy(np.concatenate([ids, [n, n, n]]).astype(np.int32))
    colors = torch.from_numpy(rng.integers(0, 6, n + 1).astype(np.int32))
    colors[n] = 0
    tile = source_tile(src, ids, n, W)
    real = [torch.unique(r[(r < n) & (r != v)]) for r, v in zip(tile, ids)]
    i = max(range(len(real)), key=lambda k: real[k].numel())
    colors[real[i].long()] = torch.randperm(real[i].numel(), dtype=torch.int32) + 1
    colors[ids[i]] = 0
    return src, W, deg, colors, ids


def _to(source, device):
    """``source`` with its tensors on ``device`` (a sliced table sliced there)."""
    if isinstance(source, TableRows):
        table = source.table
        full = table.as_strided((table.shape[0], table.stride(0)), table.stride())
        return TableRows(full.to(device)[:, :table.shape[1]])
    return dataclasses.replace(source, **{
        f.name: getattr(source, f.name).to(device) for f in dataclasses.fields(source)
        if isinstance(getattr(source, f.name), torch.Tensor)})


K3_SOURCES = ["table", "dense", "csr", "csr-class", "csr-g2", "csr-shard",
              "two-hop-d2", "two-hop-bipartite", "two-hop-start"]


def test_shard_rows_read_in_place_are_its_gathered_rows():
    """A shard's ``CsrRows`` over its rebased row starts gives each of its
    ids the row ``ShardRows.rows`` gathers, and every other id no lane."""
    g = power_law(1500, 6.0, seed=3)
    plan = PartitionedCSR.from_graph(g, 3)
    stacked = plan.stack_shards(g)
    for d in range(plan.ndev):
        s, e = int(plan.starts[d]), int(plan.starts[d + 1])
        shard = ShardRows(*(torch.from_numpy(a[d]) for a in stacked), s, g.n,
                          plan.n_loc, g.max_degree)
        for width in (None, 4):
            src, W = shard.lane_source(width)
            own = torch.arange(s, e, dtype=torch.int32)
            ids = torch.cat([own, torch.tensor([g.n], dtype=torch.int32)])
            assert torch.equal(source_tile(src, ids, g.n, W), shard.rows(ids, width))
            other = torch.cat([torch.arange(0, s), torch.arange(e, g.n)]).int()
            assert (source_tile(src, other, g.n, W) == g.n).all()
        assert int(src.row_starts[-1]) == int(g.row_offsets[e] - g.row_offsets[s])


def test_k3_cases_take_the_plain_version_on_cpu(zero_counts):
    """The card tests' K3 inputs are well formed: on CPU tensors the wrapper
    equals its plain version in every forced layout, and counts nothing."""
    for source in K3_SOURCES:
        src, W, deg, colors, ids = _k3_case(source)
        want = superstep_rows_ref(colors, deg, ids, "degree", source=src, W=W)
        for lanes in ROW_LANES:
            got = superstep_rows(colors, deg, ids, "degree", source=src, W=W, lanes=lanes)
            assert all(torch.equal(a, b) for a, b in zip(want, got))
        assert want[1].any() and not want[1].all()
    assert superstep_tile.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("heuristic", ["id", "degree"])
@pytest.mark.parametrize("lanes", ROW_LANES)
@pytest.mark.parametrize("source", K3_SOURCES)
def test_cuda_k3_rows_match_plain(cuda_device, zero_counts, source, lanes, heuristic):
    """K3 reading rows by id from each source, in each layout forced, equals
    its plain version (the source's tile gathered on the CPU)."""
    src, W, deg, colors, ids = _k3_case(source)
    want = superstep_rows_ref(colors, deg, ids, heuristic, source=src, W=W)
    got = superstep_rows(colors.to(cuda_device), deg.to(cuda_device), ids.to(cuda_device),
                         heuristic, source=_to(src, cuda_device), W=W, lanes=lanes)
    assert all(torch.equal(a, b.cpu()) for a, b in zip(want, got))
    assert superstep_tile.launches == 1 and superstep_csr.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", ROW_LANES)
def test_cuda_k1_layouts_match_plain(cuda_device, zero_counts, lanes):
    g, dev, packed, wl = _k1_inputs(seed=11)
    gpu = DeviceCSR.from_csr(g, cuda_device)
    for heuristic in ("id", "degree"):
        want = superstep_csr_ref(dev.row_starts, dev.col_padded, packed, wl,
                                 dev.max_width, heuristic)
        got = superstep_csr(gpu.row_starts, gpu.col_padded, packed.to(cuda_device),
                            wl.to(cuda_device), dev.max_width, heuristic, lanes=lanes)
        assert all(torch.equal(a, b.cpu()) for a, b in zip(want, got))
    assert superstep_csr.launches == 2 and superstep_tile.launches == 0


def _superstep_gathers_nothing(monkeypatch):
    """Make ``provider.rows`` and ``gather_rows`` raise inside every
    ``ragged_superstep`` call (the composed tail's segments may still
    gather)."""
    real = core_coloring.ragged_superstep

    def refuse(*args, **kwargs):
        raise AssertionError("the superstep gathered a tile on the card")

    def guarded(provider, *args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(provider, "rows", refuse)
            m.setattr(core_coloring, "gather_rows", refuse)
            return real(provider, *args, **kwargs)

    monkeypatch.setattr(core_coloring, "ragged_superstep", guarded)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("data_driven", "rmat-g", dict(engine="padded")),
    ("data_driven", "rmat-g", dict(engine="padded", mode="fused")),
    ("data_driven", "rmat-g", dict(coarsen_lanes=1024)),
    ("data_driven", "star", {}),
    ("distance2", "rmat-g", dict(strategy="onthefly")),
    ("distance2", "thermal2", dict(strategy="onthefly", mode="fused")),
    ("bipartite", "tall-skinny", dict(strategy="onthefly")),
    ("bipartite", "band", dict(strategy="onthefly")),
], ids=["padded", "padded-fused", "chunked", "overflow", "d2-onthefly",
        "d2-onthefly-fused", "bipartite-tall-skinny", "bipartite-band"])
def test_cuda_superstep_gathers_no_rows(cuda_device, zero_counts, monkeypatch, case):
    """The superstep on the card reads every row in place: with the
    providers' ``rows`` made to raise inside it, each engine that runs K3
    still equals the CPU run in every field."""
    algorithm, graph, opts = case
    g = {"band": lambda: jacobian_band(4096, band=3),
         "tall-skinny": lambda: jacobian_tall_skinny(2000, 64, 4, seed=1),
         "star": lambda: csr_from_edges(32769, np.zeros(32768, np.int64),
                                        np.arange(1, 32769))}.get(
        graph, lambda: build_graph(graph, 0.02))()
    _superstep_gathers_nothing(monkeypatch)
    a = repro_torch.color(g, algorithm, device=cuda_device, **opts)
    monkeypatch.undo()
    assert superstep_tile.launches > 0
    b = repro_torch.color(g, algorithm, device="cpu", **opts)
    np.testing.assert_array_equal(a.colors, b.colors)
    assert all(getattr(a, f) == getattr(b, f) for f in FIELDS)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("data_driven", "rmat-g", {}),
    ("data_driven", "road", dict(heuristic="id", trace=True)),
    ("distance2", "rmat-g", dict(strategy="onthefly")),
    ("bipartite", "band", dict(strategy="onthefly")),
], ids=["rmat-g", "road-unpacked-halo", "d2-onthefly", "bipartite-band"])
def test_cuda_sharded_matches_cpu(cuda_device, zero_counts, monkeypatch, case):
    """The sharded engine on three shards of the card equals three shards
    of the CPU in every field (the halo bytes and trace rows too), with K3
    launched by every shard and no tile gathered in a superstep."""
    algorithm, graph, opts = case
    g = {"band": lambda: jacobian_band(4096, band=3),
         "road": lambda: road(40000, seed=9)}.get(
        graph, lambda: build_graph(graph, 0.02))()
    _superstep_gathers_nothing(monkeypatch)
    a = repro_torch.color(g, algorithm, engine="sharded", devices=[cuda_device] * 3,
                          **opts)
    monkeypatch.undo()
    assert superstep_tile.launches >= 3 * (a.iterations - 2)
    assert superstep_csr.launches == 0
    b = repro_torch.color(g, algorithm, engine="sharded", devices=["cpu"] * 3, **opts)
    np.testing.assert_array_equal(a.colors, b.colors)
    assert all(getattr(a, f) == getattr(b, f)
               for f in FIELDS + ("algorithm", "halo_bytes_per_step"))
    if opts.get("trace"):
        np.testing.assert_array_equal(a.trace.steps, b.trace.steps)
    one = repro_torch.color(g, algorithm, device="cpu", **opts)
    np.testing.assert_array_equal(a.colors, one.colors)


@pytest.mark.cuda
@pytest.mark.parametrize("W1,W2", [(1, 1), (1, 31), (8, 64), (26, 676), (32, 31),
                                   (33, 4096)])
def test_cuda_k6_matches_plain(cuda_device, zero_counts, W1, W2):
    for w in (1, 37, 1000):
        nc1, nc2 = _d2_tiles(w, W1, W2, seed=W1 * W2 + w)
        got = d2_firstfit(nc1.to(cuda_device), nc2.to(cuda_device))
        assert torch.equal(d2_firstfit_ref(nc1, nc2), got.cpu())
    assert d2_firstfit.launches == 3
    assert [k.launches for k in KERNELS[:-1]] == [0] * (len(KERNELS) - 1)


@pytest.mark.cuda
def test_cuda_k6_rejects_other_dtypes_and_mixed_devices(cuda_device):
    nc1, nc2 = _d2_tiles(16, 4, 12)
    with pytest.raises(ValueError, match="int32"):
        d2_firstfit(nc1.to(cuda_device).long(), nc2.to(cuda_device))
    with pytest.raises(ValueError, match="all lie"):
        d2_firstfit(nc1.to(cuda_device), nc2)


@pytest.mark.cuda
@pytest.mark.parametrize("include_first_hop", [True, False], ids=["K6", "K4"])
def test_cuda_d2_sgr_step_matches_cpu(cuda_device, zero_counts, include_first_hop):
    g = erdos_renyi(2000, 6.0, seed=4)
    want = _d2_steps(g, "cpu", include_first_hop)
    got = _d2_steps(g, cuda_device, include_first_hop)
    for (wc, wwl, wn), (gc, gwl, gn) in zip(want, got):
        assert torch.equal(wc, gc) and torch.equal(wwl, gwl) and wn == gn
    step_kernel = d2_firstfit if include_first_hop else firstfit_rows
    assert step_kernel.launches == 4 and conflict_rows.launches == 4


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm,graph,opts,kernels", [
    ("distance2", "rmat-g", dict(strategy="precomputed"),
     (superstep_csr, serial_tail_csr)),
    ("distance2", "rmat-g", dict(strategy="onthefly"), (superstep_tile,)),
    ("distance2", "thermal2", dict(strategy="onthefly", mode="fused"),
     (superstep_tile, serial_tail_csr)),
    ("distance2", "rmat-er", dict(strategy="onthefly", tail_serial=10**6),
     (serial_tail_csr,)),
    ("bipartite", "band", dict(strategy="precomputed"), (superstep_csr,)),
    ("bipartite", "tall-skinny", dict(strategy="onthefly"), (superstep_tile,)),
], ids=["d2-precomputed", "d2-onthefly", "d2-onthefly-fused", "d2-composed-tail",
        "bipartite-precomputed", "bipartite-onthefly"])
def test_cuda_d2_engines_match_cpu(cuda_device, zero_counts, algorithm, graph,
                                   opts, kernels):
    g = {"band": lambda: jacobian_band(4096, band=3),
         "tall-skinny": lambda: jacobian_tall_skinny(2000, 64, 4, seed=1)}.get(
        graph, lambda: build_graph(graph, 0.02))()
    a = repro_torch.color(g, algorithm, device=cuda_device, **opts)
    assert all(k.launches > 0 for k in kernels)
    b = repro_torch.color(g, algorithm, device="cpu", **opts)
    np.testing.assert_array_equal(a.colors, b.colors)
    assert all(getattr(a, f) == getattr(b, f) for f in FIELDS)
    valid = validate_d2 if algorithm == "distance2" else validate_bipartite
    assert valid(g, a.colors)


@pytest.mark.cuda
def test_cuda_compress_jacobian_pattern_matches_cpu(cuda_device, zero_counts):
    bg = jacobian_band(4096, band=3)
    got = compress_jacobian_pattern(bg, device=cuda_device)
    assert superstep_csr.launches + superstep_tile.launches > 0
    want = compress_jacobian_pattern(bg, device="cpu")
    assert got.num_groups == want.num_groups == 7
    np.testing.assert_array_equal(want.seed_matrix(), got.seed_matrix())


# --------------------------------------------------------------------------
# the paper's baselines, traced runs and the ladder (ROADMAP A5, A6, A10)
# --------------------------------------------------------------------------

BASELINES = [
    ("topology", dict(heuristic="id")),
    ("topology", dict(heuristic="degree", firstfit="scan")),
    ("jp", {}),
    ("multihash", dict(nhash=1)),
    ("multihash", dict(nhash=2)),
    ("threestep", {}),
    ("threestep", dict(device_rounds=0)),
    ("serial", {}),
]
BASELINE_IDS = [f"{a}-{i}" for i, (a, _) in enumerate(BASELINES)]


def test_baselines_on_the_cpu_launch_nothing(zero_counts):
    g = build_graph("rmat-g", 0.05)
    for algorithm, opts in BASELINES:
        r = repro_torch.color(g, algorithm, device="cpu", **opts)
        assert r.converged and is_valid_coloring(g, r.colors)
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def test_baselines_without_device_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so device=None runs there")
    for algorithm, _ in BASELINES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            repro_torch.color(grid2d(4, 4), algorithm)


def _refuse_gathers(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a dense-table step gathered a tile on the card")
    monkeypatch.setattr(core_coloring, "gather_rows", refuse)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm,opts", BASELINES, ids=BASELINE_IDS)
def test_cuda_baselines_match_cpu(cuda_device, zero_counts, monkeypatch,
                                  algorithm, opts):
    """Topology and three-step run K4 and K5 over the dense table, one
    launch each a step and no tile gathered; JP, multi-hash and serial
    launch no kernel.  Every field equals the CPU port's."""
    g = build_graph("rmat-g", 0.05)
    with monkeypatch.context() as m:
        _refuse_gathers(m)
        a = repro_torch.color(g, algorithm, device=cuda_device, **opts)
    steps = a.iterations if algorithm in ("topology", "threestep") else 0
    assert firstfit_rows.launches == conflict_rows.launches == steps
    assert sum(k.launches for k in KERNELS) == 2 * steps
    b = repro_torch.color(g, algorithm, device="cpu", **opts)
    np.testing.assert_array_equal(a.colors, b.colors)
    assert all(getattr(a, f) == getattr(b, f) for f in FIELDS)
    assert a.algorithm == b.algorithm
    assert getattr(a, "serial_tail", None) == getattr(b, "serial_tail", None)
    assert is_valid_coloring(g, a.colors)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm,opts", [
    ("data_driven", {}), ("data_driven", dict(engine="classic")),
    ("data_driven", dict(engine="padded", mode="fused")),
    ("distance2", dict(strategy="onthefly")), ("data_driven", dict(trace=3)),
], ids=["ragged", "classic", "padded-fused", "distance2", "ring-3"])
def test_cuda_traced_runs_match_cpu(cuda_device, zero_counts, algorithm, opts):
    g = build_graph("rmat-g", 0.05)
    opts = {"trace": True, **opts}
    a = repro_torch.color(g, algorithm, device=cuda_device, **opts)
    b = repro_torch.color(g, algorithm, device="cpu", **opts)
    np.testing.assert_array_equal(a.colors, b.colors)
    assert all(getattr(a, f) == getattr(b, f) for f in FIELDS)
    assert torch.equal(torch.from_numpy(a.trace.steps),
                       torch.from_numpy(b.trace.steps))
    assert a.trace.iterations == b.trace.iterations and a.trace.check(a) == []
    assert [e.name for e in a.trace.spans] == [e.name for e in b.trace.spans]
    untraced = repro_torch.color(g, algorithm, device=cuda_device,
                                 **{k: v for k, v in opts.items() if k != "trace"})
    np.testing.assert_array_equal(untraced.colors, a.colors)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm,opts", [
    ("data_driven", dict(max_iters=1, tail_serial=False)),
    ("data_driven", dict(engine="classic", max_iters=1, tail_serial=False)),
    ("topology", dict(max_iters=1)),
    ("distance2", dict(max_iters=1, tail_serial=False)),
], ids=["ragged", "classic", "topology", "distance2"])
def test_cuda_ladder_matches_cpu(cuda_device, zero_counts, algorithm, opts):
    g = erdos_renyi(3000, 8.0, seed=11)
    a = repro_torch.color(g, algorithm, device=cuda_device, ensure_valid=True,
                          **opts)
    b = repro_torch.color(g, algorithm, device="cpu", ensure_valid=True, **opts)
    assert a.degradations == b.degradations != ()
    np.testing.assert_array_equal(a.colors, b.colors)
    assert a.converged and a.iterations == b.iterations


@pytest.mark.cuda
def test_cuda_all_to_all_rounds_match_cpu(cuda_device, zero_counts):
    from repro_torch.core.scheduling import all_to_all_rounds

    assert all_to_all_rounds(8, device=cuda_device) == all_to_all_rounds(
        8, device="cpu")
    assert superstep_csr.launches > 0


def _same_results(a_list, b_list):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        np.testing.assert_array_equal(a.colors, b.colors)
        assert all(getattr(a, f) == getattr(b, f) for f in FIELDS)
        assert a.degradations == b.degradations
        if b.trace is not None:
            assert torch.equal(torch.from_numpy(a.trace.steps),
                               torch.from_numpy(b.trace.steps))


def _counting_steps(monkeypatch):
    """Count ``ragged_superstep`` calls (the batch's global steps) and make
    every provider's ``rows`` and ``gather_rows`` raise inside them."""
    real = core_coloring.ragged_superstep
    calls = []

    def refuse(*args, **kwargs):
        raise AssertionError("the superstep gathered a tile on the card")

    def guarded(provider, *args, **kwargs):
        calls.append(1)
        with monkeypatch.context() as m:
            m.setattr(provider, "rows", refuse)
            m.setattr(core_coloring, "gather_rows", refuse)
            return real(provider, *args, **kwargs)

    monkeypatch.setattr(core_coloring, "ragged_superstep", guarded)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["fused", "distance2"])
@pytest.mark.parametrize("heuristic", ["degree", "id"])
def test_cuda_batch_matches_cpu_one_k3_launch_a_step(cuda_device, zero_counts,
                                                      monkeypatch, algorithm,
                                                      heuristic):
    """The batched engine on the card equals the CPU run, traced, in every
    field; one pre-packed batch takes one K3 launch a global step, at most
    one K2 launch, and gathers no tile."""
    from repro_torch.core.batch import GraphBatch, color_batch_fused
    from repro_torch.graphs import serving_mix

    graphs = serving_mix(6, 0.2) + [grid2d(4, 5)]  # the grid freezes at once
    opts = dict(heuristic=heuristic, trace=True)
    a = repro_torch.color_batch(graphs, algorithm, device=cuda_device, **opts)
    b = repro_torch.color_batch(graphs, algorithm, device="cpu", **opts)
    _same_results(a, b)
    d2 = algorithm == "distance2"
    packed = GraphBatch.from_graphs(graphs, distance2=d2, device=cuda_device)
    for k in KERNELS:
        k.launches = 0
    steps = _counting_steps(monkeypatch)
    got = color_batch_fused(packed, distance2=d2, heuristic=heuristic)
    monkeypatch.undo()
    assert superstep_tile.launches == len(steps) > 0
    assert serial_tail_csr.launches <= 1 and superstep_csr.launches == 0
    want = color_batch_fused(GraphBatch.from_graphs(graphs, distance2=d2,
                                                    device="cpu"),
                             distance2=d2, heuristic=heuristic)
    _same_results(got, want)
    valid = validate_d2 if d2 else is_valid_coloring
    assert all(valid(g, r.colors) for g, r in zip(graphs, got))


@pytest.mark.cuda
def test_cuda_batched_steps_match_cpu(cuda_device, zero_counts):
    from repro_torch.core.batch import (
        GraphBatch,
        batched_ragged_step,
        batched_sgr_step,
    )

    graphs = [erdos_renyi(300, 6.0, seed=3), grid2d(9, 20), power_law(200, 5.0, seed=2)]
    batch = GraphBatch.from_graphs(graphs, device="cpu")
    B, L = batch.B, batch.n_max
    rng = np.random.default_rng(5)
    colors = torch.from_numpy(rng.integers(0, 4, (B, L + 1)).astype(np.int32))
    colors[:, L] = 0
    lane = torch.arange(L)[None, :]
    sizes = torch.tensor(batch.sizes)[:, None]
    colors[:, :L][lane >= sizes] = 0
    wl = torch.where(lane < sizes, lane, L).to(torch.int32)
    args = (batch.adj.contiguous(), batch.deg_ext.contiguous(), colors, wl)
    for step, kw, kernels in (
            (batched_sgr_step, dict(coarsen_ff=1), (firstfit_rows, conflict_rows)),
            (batched_sgr_step, dict(coarsen_ff=2, coarsen_cr=3),
             (firstfit_rows, conflict_rows)),
            (batched_ragged_step, {}, (superstep_tile,))):
        for k in KERNELS:
            k.launches = 0
        a = step(*(t.to(cuda_device) for t in args), heuristic="id", **kw)
        assert all(k.launches > 0 for k in kernels)
        b = step(*args, heuristic="id", **kw)
        assert all(torch.equal(x.cpu(), y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "workefficient"])
def test_cuda_session_matches_cpu(cuda_device, zero_counts, monkeypatch, mode,
                                  tmp_path):
    """Three churn rounds of a session on the card equal the CPU session's:
    results, frontier, metrics and the journal's records; the recolors run
    K1 (or K3) and gather no tile."""
    from repro_torch.dynamic import churn_delta, open_session
    from repro_torch.dynamic.journal import SessionJournal

    g = build_graph("rmat-g", 0.1)
    a = open_session(g, device=cuda_device, mode=mode, trace=True,
                     durable_dir=str(tmp_path / "card"), snapshot_every=3)
    b = open_session(g, device="cpu", mode=mode, trace=True,
                     durable_dir=str(tmp_path / "cpu"), snapshot_every=3)
    _same_results([a.result], [b.result])
    rng_a, rng_b = np.random.default_rng(14), np.random.default_rng(14)
    for _ in range(3):
        for s, rng in ((a, rng_a), (b, rng_b)):
            rem, add = churn_delta(s.graph, 0.01, rng)
            s.apply_delta(remove_edges=rem, add_edges=add)
        np.testing.assert_array_equal(a.frontier(), b.frontier())
        for k in KERNELS:
            k.launches = 0
        _counting_steps(monkeypatch)
        ra = a.recolor()
        monkeypatch.undo()
        assert superstep_csr.launches + superstep_tile.launches > 0
        _same_results([ra], [b.recolor()])
        assert a.metrics() == b.metrics() and a.validate()
    assert (list(SessionJournal(str(tmp_path / "card")).records())
            == list(SessionJournal(str(tmp_path / "cpu")).records()))


def _service_requests(svc, graphs, sess_graph, rng):
    """A fixed synchronous sequence: colours under both heuristics, a
    distance-2 bucket, a slow-path request, and open / delta / recolor /
    colours / metrics on two sessions (the pool holds one, so the second
    open evicts the first to the spill directory). Shared with
    ``test_torch_service.py``, which runs it through ``repro``'s service."""
    out = []
    for g in graphs:
        out.append(svc.color(g))
        out.append(svc.color(g, heuristic="id"))
    out.append(svc.color(graphs[0], algorithm="distance2"))
    out.append(svc.color(graphs[1], ensure_valid=True, max_iters=2))
    out.append(svc.open_session("s1", sess_graph))
    out.append(svc.open_session("s2", sess_graph, heuristic="id"))
    for sid in ("s1", "s2", "s1"):
        a, b = rng.integers(0, sess_graph.n, 12), rng.integers(0, sess_graph.n, 12)
        out.append(svc.apply_delta(sid, add_edges=(a, b)))
        out.append(svc.recolor(sid))
        out.append(svc.colors(sid))
        out.append(svc.session_metrics(sid))
    out.append(svc.maintain())
    return out


@pytest.mark.cuda
def test_cuda_service_matches_cpu(cuda_device, zero_counts, monkeypatch, tmp_path):
    """The service on the card equals the service on the CPU for a small
    mix: every result field, array, summary and ``metrics()`` apart from
    its timing field; the card's micro-batches launch K3 a global step."""
    from repro_torch.core.coloring import ColoringResult
    from repro_torch.graphs import serving_mix
    from repro_torch.launch.coloring_service import ColoringService

    graphs = serving_mix(6, 0.2)
    outs = {}
    for dev in (cuda_device, "cpu"):
        svc = ColoringService(pool_size=1, queue_limit=16, spill_dir=str(
            tmp_path / torch.device(dev).type), device=dev)
        try:
            if dev != "cpu":
                steps = _counting_steps(monkeypatch)
            out = _service_requests(svc, graphs, graphs[2],
                                    np.random.default_rng(5))
            m = svc.metrics()
            m.pop("ewma_request_seconds")
            outs[dev] = out, m
            monkeypatch.undo()
        finally:
            svc.shutdown()
        assert not svc._worker.is_alive()
    (a, ma), (b, mb) = outs[cuda_device], outs["cpu"]
    assert ma == mb and ma["failed"] == 0 and ma["restores"] > 0
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, ColoringResult):
            _same_results([x], [y])
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y
    # a global step of a micro-batch is one K3 launch, a session's class
    # sub-step a K1 (or K3) launch
    assert superstep_tile.launches > 0 and superstep_csr.launches > 0
    assert superstep_tile.launches + superstep_csr.launches >= len(steps) > 0


@pytest.mark.cuda
def test_cuda_service_worker_error_reaches_the_caller(cuda_device, zero_counts,
                                                     monkeypatch):
    """An error raised in the worker on the card (a kernel wrapper's launch
    check failing) reaches the caller through its ticket, is not retried,
    and the worker serves the next request on the card."""
    from repro_torch.launch.coloring_service import ColoringService

    g = erdos_renyi(2000, 6.0, seed=1)
    want = repro_torch.color(g, "fused", device=cuda_device).colors
    with ColoringService(pool_size=1, queue_limit=8, device=cuda_device) as svc:
        def failed_launch(*args, **kwargs):
            raise RuntimeError("superstep_rows launch failed: CUDA error 700 "
                               "(an illegal memory access was encountered)")

        monkeypatch.setattr(core_coloring, "superstep_rows", failed_launch)
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            svc.color(g)
        monkeypatch.undo()
        np.testing.assert_array_equal(svc.color(g).colors, want)
        m = svc.metrics()
    assert not svc._worker.is_alive()
    assert m["failed"] == 1 and m["completed"] == 1 and m["slow_requests"] == 0


# ---------------------------------------------------------------------------
# the LM stack's serving path on the card (no kernel of its own)
# ---------------------------------------------------------------------------

LM_F32_TOL = 1e-4   # float32 logits, card against CPU (TF32 off)


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "mixtral-8x22b", "deepseek-v2-236b",
                                  "recurrentgemma-2b", "rwkv6-1.6b", "internvl2-26b",
                                  "hubert-xlarge"])
def test_cuda_lm_forward_matches_cpu(cuda_device, no_tf32, arch):
    """A reduced config's forward logits and loss, and prefill + 4 decode
    steps, on the card against the CPU with the same weights."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    cpu = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(3))
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(3)
    if cfg.family == "encoder":
        batch = {"frames": rng.standard_normal((2, 64, cfg.d_frontend), np.float32),
                 "labels": rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)}
    else:
        s_text = 64 - cfg.n_patches
        batch = {"tokens": rng.integers(0, cfg.vocab, (2, s_text)).astype(np.int32)}
        batch["labels"] = batch["tokens"]
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (2, cfg.n_patches, cfg.d_frontend), np.float32)
    got, want = card.forward(batch), cpu.forward(batch)
    assert got.device.type == "cuda" and torch.isfinite(got).all()
    assert (got.cpu() - want)[..., :cfg.vocab].abs().max() <= LM_F32_TOL
    with torch.no_grad():
        assert card.loss(batch)[0].item() == pytest.approx(
            cpu.loss(batch)[0].item(), rel=1e-5, abs=1e-5)
    if cfg.family == "encoder":
        return
    off = cfg.n_patches if cfg.family == "vlm" else 0
    pre = {n: v for n, v in batch.items() if n != "labels"}
    pre["tokens"] = batch["tokens"][:, :12]
    (ca, la), (cb, lb) = card.prefill(pre, 16 + off), cpu.prefill(pre, 16 + off)
    for t in range(12, 16):
        tok = batch["tokens"][:, t:t + 1]
        assert (la.cpu() - lb)[:, :cfg.vocab].abs().max() <= LM_F32_TOL
        (ca, la), (cb, lb) = card.decode_step(ca, tok, t + off), cpu.decode_step(cb, tok, t + off)
    assert (la.cpu() - lb)[:, :cfg.vocab].abs().max() <= LM_F32_TOL


@pytest.mark.cuda
def test_cuda_lm_build_model_defaults_to_the_card(cuda_device):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    model = build_model(get_config("qwen3-4b").reduced())
    assert model.device.type == "cuda"
    assert all(p.device.type == "cuda" for p in model.parameters())
    assert model.init_cache(2, 8)[0]["k"].device.type == "cuda"


@pytest.mark.cuda
def test_cuda_serve_batch(cuda_device, no_tf32):
    """``serve_batch`` with no ``device=`` runs on the card; ``generate`` on
    the card's copy of CPU weights picks the CPU's greedy tokens."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.launch.serve_lm import generate, serve_batch
    from repro_torch.models import build_model

    cfg = get_config("qwen3-4b").reduced()
    out = serve_batch(cfg, batch=2, prompt_len=8, gen=6)
    assert out["generated"].shape == (2, 6)
    assert ((out["generated"] >= 0) & (out["generated"] < cfg.vocab)).all()
    cpu = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(5))
    card = copy.deepcopy(cpu).to(cuda_device)
    prompts = {"tokens": np.random.default_rng(5).integers(0, cfg.vocab, (2, 8)).astype(np.int32)}
    a = generate(card, prompts, prompt_len=8, gen=6)["generated"]
    b = generate(cpu, prompts, prompt_len=8, gen=6)["generated"]
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the LM stack's training path on the card (no kernel of its own)
# ---------------------------------------------------------------------------

TRAIN_TOL = 1e-4   # float32 loss and grad_norm, card against CPU (TF32 off)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "mixtral-8x22b"])
def test_cuda_train_step_matches_cpu(cuda_device, no_tf32, arch):
    """A reduced config's AdamW train step on the card against the CPU
    from the same weights: loss and grad_norm within 1e-4 relative, the
    parameters within AdamW's allowance (a sign flip moves one by 2 lr)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, SyntheticData, init_train_state,
                                      make_train_step)

    cfg = get_config(arch).reduced()
    cpu = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(6))
    card = copy.deepcopy(cpu).to(cuda_device)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0, total_steps=2)
    batches = [SyntheticData.for_model(cfg, 2, 64, seed=6).batch(i) for i in range(2)]
    states = [init_train_state(m) for m in (cpu, card)]
    steps = [make_train_step(m, opt) for m in (cpu, card)]
    for b in batches:
        _, want = steps[0](states[0], b)
        _, got = steps[1](states[1], b)
        assert got["loss"].device.type == "cuda"
        for key in ("loss", "grad_norm"):
            assert got[key].item() == pytest.approx(want[key].item(), rel=TRAIN_TOL)
    assert states[1].opt["m"]["embed"].device.type == "cuda"
    assert all(p.grad is None for p in card.parameters())
    for a, b in zip(card.parameters(), cpu.parameters()):
        assert (a.detach().cpu() - b.detach()).abs().max() <= 2 * 1e-3 * len(batches)


@pytest.mark.cuda
def test_cuda_train_crash_and_resume(cuda_device, tmp_path):
    """``train_loop`` with no ``device=`` runs on the card; a run that dies
    at step 8 and is resumed by ``run_with_restarts`` ends within 1e-3 of
    the uninterrupted run's loss."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.fault_tolerance import run_with_restarts
    from repro_torch.launch.train import train_loop

    cfg = get_config("qwen3-4b").reduced()
    kw = dict(steps=12, batch_size=4, seq_len=16, lr=1e-3, log_every=4, seed=3)
    ref = train_loop(cfg, ckpt_dir=str(tmp_path / "ref"), ckpt_every=100, **kw)
    ck, starts = str(tmp_path / "ck"), []

    def run(start):
        starts.append(start)
        return train_loop(cfg, ckpt_dir=ck, ckpt_every=4, resume=start > 0,
                          fail_at_step=8 if len(starts) == 1 else None, **kw)

    out = run_with_restarts(run, ckpt_dir=ck, max_restarts=1)
    assert starts == [0, 8] and out["steps"] == 4
    assert abs(out["final_loss"] - ref["final_loss"]) < 1e-3


# ---------------------------------------------------------------------------
# the LM stack's mesh half on the card (an NCCL group of one, in a subprocess:
# a process group is global to a process)
# ---------------------------------------------------------------------------

MESH_MODULES = ("distributed/sharding.py", "launch/dryrun.py", "launch/op_analysis.py",
                "launch/mesh.py")

MESH_PROBE = """
import socket, sys, tempfile
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.distributed.fault_tolerance import reshard_state
from repro_torch.distributed.sharding import (batch_shardings, distribute, place_state,
                                              state_shardings)
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, SyntheticData, init_train_state, make_train_step
from repro_torch.training.checkpoint import save_checkpoint

dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                        device_id=dev)
mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
cfg = get_config("qwen3-4b").reduced()
opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0, total_steps=2)
batches = [SyntheticData.for_model(cfg, 2, 64, seed=6).batch(i) for i in range(2)]
plain = build_model(cfg, dev, generator=torch.Generator(device=dev).manual_seed(6))
placed = build_model(cfg, dev, generator=torch.Generator(device=dev).manual_seed(6))
states = [init_train_state(m) for m in (plain, placed)]
place_state(states[1], state_shardings(states[1], mesh))
steps = [make_train_step(m, opt) for m in (plain, placed)]
for b in batches:
    _, want = steps[0](states[0], b)
    db = distribute({k: torch.as_tensor(v, device=dev) for k, v in b.items()},
                    batch_shardings(b, mesh))
    _, got = steps[1](states[1], db)
    for key in ("loss", "grad_norm"):
        g, w = float(got[key].full_tensor()), float(want[key])
        assert abs(g - w) <= 1e-4 * abs(w), (key, g, w)
for (n, a), b in zip(placed.named_parameters(), plain.parameters()):
    assert isinstance(a, DTensor) and a.device.type == "cuda", n
    assert float((a.full_tensor() - b).abs().max()) <= 2 * 1e-3 * len(batches), n
with tempfile.TemporaryDirectory() as tmp:
    save_checkpoint(tmp, 2, states[1])
    fresh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    back = reshard_state(tmp, 2, init_train_state(build_model(cfg, "meta")), fresh)
want = state_shardings(back, fresh)
assert back.step == 2
for n, p in back.params.items():
    assert p.device_mesh == fresh and tuple(p.placements) == want["params"][n].placements
    assert torch.equal(p.full_tensor(), states[1].params[n].full_tensor()), n
for k in ("m", "v"):
    for n, t in back.opt[k].items():
        assert torch.equal(t.full_tensor(), states[1].opt[k][n].full_tensor()), (k, n)
dist.destroy_process_group()
print("MESH_OK")
"""


def test_mesh_modules_are_port_files():
    """The mesh half's modules are among the files held to import no JAX and
    nothing of ``repro``."""
    for rel in MESH_MODULES:
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES, rel


@pytest.mark.cuda
def test_cuda_mesh_train_step_and_reshard(cuda_device):
    """On a (1, 1) NCCL mesh, reduced qwen3-4b's AdamW steps on placed
    ``DTensor``s equal the steps without a mesh (loss and ``grad_norm``
    within 1e-4, parameters within AdamW's 2 lr a step, TF32 off); its
    checkpoint restores through ``reshard_state`` onto a fresh mesh, every
    leaf placed as the resolver says and equal to the saved one."""
    import os
    import subprocess
    import sys

    r = subprocess.run([sys.executable, "-c", MESH_PROBE], capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0 and "MESH_OK" in r.stdout, r.stderr[-3000:]
