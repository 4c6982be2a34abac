"""Synthetic graph generators standing in for the UF Sparse Matrix Collection.

A copy of ``repro.graphs.generators``: the real-world graphs of the paper's
Table 1 are replaced by generators matched on the published (n, m, d̄, σ)
statistics; see ``suite.py`` for the mapping.  All generators return clean
(undirected, deduped, self-loop-free, sorted) ``CSRGraph`` objects.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import CSRGraph, csr_from_edges

__all__ = [
    "erdos_renyi",
    "grid2d",
    "grid3d",
    "stencil27",
    "honeycomb",
    "road",
    "small_world",
    "power_law",
    "jacobian_band",
    "jacobian_tall_skinny",
]


def erdos_renyi(n: int, avg_degree: float = 10.0, seed: int = 0) -> CSRGraph:
    m = int(n * avg_degree / 2)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return csr_from_edges(n, src, dst)


def grid2d(rows: int, cols: int, diagonals: bool = False) -> CSRGraph:
    """2D grid; 4-point (d̄≈4) or 8-point (d̄≈8) stencil."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    pairs = [
        (idx[:, :-1].ravel(), idx[:, 1:].ravel()),
        (idx[:-1, :].ravel(), idx[1:, :].ravel()),
    ]
    if diagonals:
        pairs += [
            (idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()),
            (idx[:-1, 1:].ravel(), idx[1:, :-1].ravel()),
        ]
    src = np.concatenate([p[0] for p in pairs])
    dst = np.concatenate([p[1] for p in pairs])
    return csr_from_edges(rows * cols, src, dst)


def grid3d(nx: int, ny: int, nz: int) -> CSRGraph:
    """3D 7-point stencil (d̄≈6, tiny variance) — atmosphere/FEM-like."""
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    pairs = [
        (idx[:-1].ravel(), idx[1:].ravel()),
        (idx[:, :-1].ravel(), idx[:, 1:].ravel()),
        (idx[:, :, :-1].ravel(), idx[:, :, 1:].ravel()),
    ]
    src = np.concatenate([p[0] for p in pairs])
    dst = np.concatenate([p[1] for p in pairs])
    return csr_from_edges(nx * ny * nz, src, dst)


def stencil27(nx: int, ny: int, nz: int) -> CSRGraph:
    """3D 27-point stencil (d̄≈26) — nlpkkt-like high-degree regular graph."""
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    srcs, dsts = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if (dx, dy, dz) <= (0, 0, 0):
                    continue  # half the shifts; symmetrize adds the rest
                sx = slice(max(0, -dx), min(nx, nx - dx))
                sy = slice(max(0, -dy), min(ny, ny - dy))
                sz = slice(max(0, -dz), min(nz, nz - dz))
                tx = slice(max(0, dx), min(nx, nx + dx))
                ty = slice(max(0, dy), min(ny, ny + dy))
                tz = slice(max(0, dz), min(nz, nz + dz))
                srcs.append(idx[sx, sy, sz].ravel())
                dsts.append(idx[tx, ty, tz].ravel())
    return csr_from_edges(nx * ny * nz, np.concatenate(srcs), np.concatenate(dsts))


def honeycomb(rows: int, cols: int) -> CSRGraph:
    """Honeycomb lattice: every interior vertex has degree exactly 3 (σ≈0)."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    # brick-wall representation of a hex lattice on a grid
    src = [idx[:, :-1].ravel()]
    dst = [idx[:, 1:].ravel()]
    r, c = np.meshgrid(np.arange(rows - 1), np.arange(cols), indexing="ij")
    keep = (r + c) % 2 == 0
    src.append(idx[:-1, :][keep].ravel())
    dst.append(idx[1:, :][keep].ravel())
    return csr_from_edges(rows * cols, np.concatenate(src), np.concatenate(dst))


def road(n: int, shortcut_frac: float = 0.05, seed: int = 0) -> CSRGraph:
    """Road-network-like: long path + a few shortcuts (d̄≈2.1, σ small)."""
    rng = np.random.default_rng(seed)
    src = [np.arange(n - 1)]
    dst = [np.arange(1, n)]
    k = int(n * shortcut_frac)
    src.append(rng.integers(0, n, size=k))
    dst.append(rng.integers(0, n, size=k))
    return csr_from_edges(n, np.concatenate(src), np.concatenate(dst))


def small_world(n: int, k: int = 6, rewire: float = 0.1, seed: int = 0) -> CSRGraph:
    """Watts–Strogatz ring lattice with rewiring — circuit-sim-like."""
    rng = np.random.default_rng(seed)
    base = np.arange(n)
    srcs, dsts = [], []
    for off in range(1, k // 2 + 1):
        dst = (base + off) % n
        flip = rng.random(n) < rewire
        dst = np.where(flip, rng.integers(0, n, size=n), dst)
        srcs.append(base)
        dsts.append(dst)
    return csr_from_edges(n, np.concatenate(srcs), np.concatenate(dsts))


def power_law(n: int, avg_degree: float = 7.0, exponent: float = 2.2, seed: int = 0) -> CSRGraph:
    """Chung–Lu power-law graph — kkt_power/ASIC-like skewed degrees."""
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n + 1) ** (-1.0 / (exponent - 1.0)))
    w *= (n * avg_degree / 2) / w.sum()
    p = w / w.sum()
    m = int(n * avg_degree / 2)
    src = rng.choice(n, size=m, p=p)
    dst = rng.choice(n, size=m, p=p)
    return csr_from_edges(n, src, dst)


def jacobian_band(n_rows: int, band: int = 2, n_cols: int | None = None):
    """Banded Jacobian pattern: row i is nonzero in columns [i-band, i+band].

    Any interior row holds ``2·band+1`` pairwise-conflicting columns, and
    columns with equal index mod ``2·band+1`` never share a row, so the
    optimal column count is exactly ``min(2·band+1, n_cols)``.
    """
    from repro_torch.d2.bipartite import BipartiteGraph

    n_cols = n_rows if n_cols is None else n_cols
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), 2 * band + 1)
    cols = rows + np.tile(np.arange(-band, band + 1), n_rows)
    keep = (cols >= 0) & (cols < n_cols)
    return BipartiteGraph.from_coo(n_rows, n_cols, rows[keep], cols[keep])


def jacobian_tall_skinny(
    n_rows: int, n_cols: int, nnz_per_row: int = 4, seed: int = 0
):
    """Random tall-skinny Jacobian pattern (n_rows >> n_cols): many
    observations over few parameters, each row touching a handful of
    columns."""
    from repro_torch.d2.bipartite import BipartiteGraph

    rng = np.random.default_rng(seed)
    nnz = min(nnz_per_row, n_cols)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), nnz)
    # vectorized sample-without-replacement per row (n_cols is small)
    cols = np.argsort(rng.random((n_rows, n_cols)), axis=1)[:, :nnz].ravel()
    return BipartiteGraph.from_coo(n_rows, n_cols, rows, cols)
