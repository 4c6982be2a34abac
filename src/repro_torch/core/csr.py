"""Compressed Sparse Row graph container (the paper's R / C arrays).

The host graph ``CSRGraph`` is numpy, as in ``repro.core.csr``; the device
form ``DeviceCSR`` holds int32 torch tensors on an explicit device:

* ``row_starts`` (n+1,) — CSR offsets (R);
* ``col_padded`` (m + dmax,) — CSR column ids (C) with ``dmax`` trailing
  sentinel slots holding ``n``, so a full-width row read starting at the
  last row never leaves the array;
* ``deg_ext`` (n+1,) — degrees with a trailing 0 for the sentinel id ``n``.

Gathers through an extended color array ``colors_ext`` of length ``n + 1``
(slot ``n`` pinned to color 0) make sentinel lanes inert: color 0 is
"uncolored", never forbidden and never conflicting.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.cuda import CsrRows

__all__ = [
    "CSRGraph",
    "DeviceCSR",
    "DeviceGraph",
    "PartitionedCSR",
    "auto_tile_thresholds",
    "balanced_starts",
    "compose_pairs",
    "csr_from_edges",
    "csr_tile",
    "gather_rows",
    "next_pow2",
    "padded_ragged",
]


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    x = max(int(x), 1)
    return 1 << (x - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Undirected sparse graph in CSR form (host-side, numpy)."""

    row_offsets: np.ndarray  # (n+1,) int32/int64
    col_indices: np.ndarray  # (m,) int32

    def __post_init__(self):
        if self.row_offsets.ndim != 1 or self.col_indices.ndim != 1:
            raise ValueError("row_offsets and col_indices must be 1-D")
        if self.row_offsets.shape[0] < 1 or self.row_offsets[0] != 0:
            raise ValueError("row_offsets must start at 0")
        if self.row_offsets[-1] != self.col_indices.shape[0]:
            raise ValueError("row_offsets[-1] must equal len(col_indices)")

    @classmethod
    def from_numpy(cls, row_offsets, col_indices) -> "CSRGraph":
        """Wrap CSR arrays, e.g. those of a ``repro.CSRGraph``, unchanged."""
        return cls(np.asarray(row_offsets), np.asarray(col_indices))

    @property
    def n(self) -> int:
        return int(self.row_offsets.shape[0] - 1)

    @property
    def m(self) -> int:
        """Number of directed edges (2x undirected edge count)."""
        return int(self.col_indices.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_offsets).astype(np.int32)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max(initial=0))

    @property
    def avg_degree(self) -> float:
        return self.m / max(self.n, 1)

    def neighbors(self, v: int) -> np.ndarray:
        return self.col_indices[self.row_offsets[v] : self.row_offsets[v + 1]]

    def padded_adjacency(
        self, width: int | None = None, *, allow_truncate: bool = False
    ) -> np.ndarray:
        """Dense ``(n, width)`` adjacency; padding slots hold the sentinel ``n``.

        ``width < max_degree`` would silently drop neighbors and corrupt any
        coloring built on the view, so it raises unless the caller opts in
        with ``allow_truncate=True``.
        """
        width = max(self.max_degree, 1) if width is None else int(width)
        if width < self.max_degree and not allow_truncate:
            raise ValueError(
                f"width={width} < max_degree={self.max_degree} would silently "
                f"drop neighbors; pass allow_truncate=True if that is intended"
            )
        return padded_ragged(self.row_offsets, self.col_indices, width, self.n)

    # -- distance-2 views ----------------------------------------------------
    def two_hop_degree_bound(self) -> int:
        """Cheap upper bound on the square graph's max degree (no dedup):
        ``max_v [deg(v) + Σ_{u∈N(v)} deg(u)]``, in O(m)."""
        if self.m == 0:
            return 0
        deg = self.degrees.astype(np.int64)
        rows = np.repeat(np.arange(self.n, dtype=np.int64), deg)
        nbr_deg_sum = np.bincount(
            rows, weights=deg[self.col_indices], minlength=self.n
        ).astype(np.int64)
        return int((deg + nbr_deg_sum).max())

    def square(self) -> "CSRGraph":
        """The square graph G²: u ~ v iff 0 < dist(u, v) <= 2.

        Distance-2 coloring of G is distance-1 coloring of G².  Costs
        O(Σ_u deg(u)²) host time and memory.
        """
        src1, dst1 = self.edges()
        src2, dst2 = compose_pairs(
            self.row_offsets, self.col_indices, self.row_offsets, self.col_indices
        )
        return csr_from_edges(
            self.n,
            np.concatenate([src1, src2]),
            np.concatenate([dst1, dst2]),
            symmetrize=False,  # dist<=2 is already a symmetric relation
            dedup=True,
        )

    def degree_buckets(self, thresholds) -> list[np.ndarray]:
        """Vertex-id arrays per degree class: (0, t0], (t0, t1], ..., (tk-1, inf)."""
        deg = self.degrees
        out, lo = [], 0
        bounds = list(thresholds) + [max(self.max_degree, 1)]
        for hi in bounds:
            out.append(np.where((deg > lo) & (deg <= hi))[0].astype(np.int32))
            lo = hi
        # degree-0 vertices go to the first bucket (they take color 1 trivially)
        zero = np.where(deg == 0)[0].astype(np.int32)
        if zero.size:
            out[0] = np.concatenate([zero, out[0]])
        return out

    def edges(self) -> tuple[np.ndarray, np.ndarray]:
        src = np.repeat(np.arange(self.n, dtype=np.int32), self.degrees)
        return src, self.col_indices.astype(np.int32)


def padded_ragged(row_offsets: np.ndarray, col_indices: np.ndarray, width: int,
                  sentinel: int) -> np.ndarray:
    """Dense ``(n_rows, width)`` fill of a ragged CSR; pads hold ``sentinel``."""
    n_rows = row_offsets.shape[0] - 1
    m = col_indices.shape[0]
    out = np.full((n_rows, width), sentinel, dtype=np.int32)
    if m == 0:
        return out
    deg = np.diff(row_offsets)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), deg)
    within = np.arange(m, dtype=np.int64) - row_offsets[rows]
    keep = within < width
    out[rows[keep], within[keep]] = col_indices[keep]
    return out


def gather_rows(adj: torch.Tensor, ids: torch.Tensor, sentinel: int | None = None):
    """Gather padded adjacency rows; sentinel ids yield all-sentinel rows.

    Ids are clipped to ``n - 1`` before the gather, as JAX clamps it in
    ``repro``, and rows of ids ``>= n`` read ``sentinel`` (default ``n``).
    """
    n = adj.shape[0]
    fill = n if sentinel is None else sentinel
    rows = adj[ids.clamp(0, max(n - 1, 0)).long()]
    return torch.where((ids < n)[:, None], rows, fill)


def csr_tile(row_starts: torch.Tensor, col: torch.Tensor, ids: torch.Tensor,
             width: int) -> torch.Tensor:
    """The ``(w, width)`` id tile of CSR rows: row ``v``'s first
    ``min(R[v+1] - R[v], width)`` ids of ``col``, the sentinel ``n`` past
    them and in the rows of ids ``>= n``.  Reads are clamped into ``col``,
    as JAX clamps gathers."""
    n = row_starts.shape[0] - 1
    safe = ids.clamp(0, max(n - 1, 0)).long()
    starts = row_starts[safe]
    length = torch.where(ids < n, row_starts[safe + 1] - starts, 0)
    lane = torch.arange(width, dtype=torch.int32, device=ids.device)[None, :]
    idx = (starts[:, None] + lane).clamp(max=col.shape[0] - 1)
    return torch.where(lane < length[:, None], col[idx.long()], n)


def compose_pairs(
    row_offsets_a: np.ndarray,
    col_indices_a: np.ndarray,
    row_offsets_b: np.ndarray,
    col_indices_b: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """All length-2 paths ``v -A-> u -B-> w`` as raw ``(v, w)`` pairs.

    Behind both the square graph (``A = B = G``) and the bipartite
    column-conflict relation (``A`` = cols→rows, ``B`` = rows→cols).  Pairs
    are not deduplicated and include ``v == w`` round trips; callers clean
    up via ``csr_from_edges``.  O(Σ_u deg_A·deg_B) time and memory.
    """
    n_a = row_offsets_a.shape[0] - 1
    deg_a = np.diff(row_offsets_a).astype(np.int64)
    deg_b = np.diff(row_offsets_b).astype(np.int64)
    src_a = np.repeat(np.arange(n_a, dtype=np.int64), deg_a)  # v per A-edge
    mid = col_indices_a.astype(np.int64)                      # u per A-edge
    lens = deg_b[mid]                                         # fan-out per A-edge
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    v = np.repeat(src_a, lens)
    starts = np.repeat(row_offsets_b[:-1].astype(np.int64)[mid], lens)
    ends = np.cumsum(lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens)
    w = col_indices_b[starts + within].astype(np.int64)
    return v, w


def _gather_ragged(offsets: np.ndarray, values: np.ndarray, ids) -> np.ndarray:
    """Concatenated ``values[offsets[v]:offsets[v+1]]`` slices for ``ids``."""
    ids = np.asarray(ids, dtype=np.int64)
    starts = offsets[ids].astype(np.int64)
    lens = (offsets[ids + 1] - offsets[ids]).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, values.dtype)
    pos = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )
    return values[np.repeat(starts, lens) + pos]


def csr_from_edges(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    *,
    symmetrize: bool = True,
    dedup: bool = True,
) -> CSRGraph:
    """Build a clean CSR graph from an edge list.

    Drops self loops; optionally symmetrizes (undirected) and deduplicates.
    Adjacency lists come out sorted, matching the UF-collection convention.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    if dedup and src.size:
        key = np.unique(src * n + dst)
        src, dst = key // n, key % n
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.add.at(row_offsets, src + 1, 1)
    row_offsets = np.cumsum(row_offsets)
    return CSRGraph(row_offsets.astype(np.int64), dst.astype(np.int32))


def auto_tile_thresholds(
    degrees: np.ndarray,
    *,
    min_width: int = 8,
    min_class_frac: float = 0.05,
    max_classes: int = 6,
) -> tuple[int, ...]:
    """Log-spaced degree-class thresholds derived from the degree histogram.

    Candidate bounds double from ``min_width`` up to the max degree; a bound
    survives only if the class it closes holds at least ``min_class_frac``
    of the vertices (smaller classes merge into the next wider tile).
    Returns ``()`` — one full-width class — for graphs under 2048 vertices
    or with ``dmax <= 2 * min_width``.
    """
    degrees = np.asarray(degrees)
    n = int(degrees.size)
    dmax = int(degrees.max(initial=0))
    if n < 2048 or dmax <= 2 * min_width:
        return ()
    out: list[int] = []
    lo = 0
    t = min_width
    while t < dmax and len(out) < max_classes:
        if int(((degrees > lo) & (degrees <= t)).sum()) >= min_class_frac * n:
            out.append(t)
            lo = t
        t *= 2
    return tuple(out)


def balanced_starts(weights: np.ndarray, ndev: int) -> np.ndarray:
    """Contiguous range boundaries balancing ``weights`` over ``ndev`` parts.

    Returns ``starts`` of shape ``(ndev + 1,)`` with ``starts[0] == 0`` and
    ``starts[-1] == len(weights)``: part ``d`` owns ``[starts[d],
    starts[d+1])``.  Cuts sit at the weight-prefix-sum quantiles, so parts
    carry (near-)equal total weight while staying contiguous in id — the
    classic 1-D block partition of distributed coloring (Boman–Bozdağ).
    """
    weights = np.asarray(weights, dtype=np.int64)
    n = int(weights.size)
    ndev = max(int(ndev), 1)
    cum = np.concatenate([[0], np.cumsum(weights)])
    targets = cum[-1] * np.arange(1, ndev, dtype=np.float64) / ndev
    cuts = np.searchsorted(cum, targets, side="left")
    starts = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    return np.maximum.accumulate(np.clip(starts, 0, n))


@dataclasses.dataclass(frozen=True)
class PartitionedCSR:
    """Degree-balanced contiguous partition plan + halo index sets.

    Device ``d`` owns the contiguous vertex range ``[starts[d],
    starts[d+1])``.  ``interior[d]`` / ``boundary[d]`` split that range by
    whether the vertex's color is ever read off-device under the conflict
    relation the plan was built for — 1-hop edges for distance-1
    (``from_graph``), two-hop reach for distance-2
    (``from_graph(boundary_mode="two_hop")``), shared-row column conflicts
    for bipartite partial coloring (``from_bipartite``).  Interior vertices
    never communicate; ``boundary[d]`` doubles as device ``d``'s halo SEND
    list and ``recv[d]`` is the remote vertex set whose colors it reads.
    The engine (``core/distributed.py``) consumes ``starts`` + ``boundary``
    (its all-gather broadcast makes per-pair recv routing unnecessary), so
    those are built eagerly at partition time (O(m) host work); ``recv``
    documents the communication pattern for validation and introspection
    and is computed lazily on first access (O(ndev·m)) — the property
    tests assert it against the edge list.
    """

    n: int
    starts: np.ndarray            # (ndev+1,) int64 range boundaries
    interior: tuple               # per-device global ids, colors stay local
    boundary: tuple               # per-device global ids == halo send lists
    # zero-arg closure building the recv sets on demand (engine never needs
    # them); excluded from equality/repr like any derived cache
    _make_recv: object = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def recv(self) -> tuple:
        """Per-device remote ids whose colors the device reads (lazy)."""
        cache = getattr(self, "_recv_cache", None)
        if cache is None:
            cache = (self._make_recv() if self._make_recv is not None
                     else tuple(np.zeros(0, np.int32)
                                for _ in self.interior))
            object.__setattr__(self, "_recv_cache", cache)
        return cache

    @property
    def ndev(self) -> int:
        return len(self.interior)

    @property
    def lens(self) -> np.ndarray:
        return np.diff(self.starts).astype(np.int64)

    @property
    def n_loc(self) -> int:
        """Uniform per-shard slot count (max range length, >= 1)."""
        return max(int(self.lens.max(initial=0)), 1)

    @property
    def halo_words(self) -> int:
        """Total boundary vertices — one halo round's worst-case payload."""
        return int(sum(b.size for b in self.boundary))

    def owners(self) -> np.ndarray:
        """(n,) owning-device id per vertex (computed once, read-only)."""
        cache = getattr(self, "_owners_cache", None)
        if cache is None:
            cache = (np.searchsorted(self.starts, np.arange(self.n), side="right")
                     - 1).astype(np.int32)
            cache.flags.writeable = False
            object.__setattr__(self, "_owners_cache", cache)
        return cache

    def boundary_masks(self) -> np.ndarray:
        """(ndev, n_loc) bool: is local slot ``i`` of device ``d`` boundary."""
        out = np.zeros((self.ndev, self.n_loc), dtype=bool)
        for d, b in enumerate(self.boundary):
            out[d, b - self.starts[d]] = True
        return out

    @classmethod
    def from_graph(
        cls, g: "CSRGraph", ndev: int, *, boundary_mode: str = "edge",
        validate_input: str | None = None,
    ) -> "PartitionedCSR":
        """Partition ``g`` balancing ``degree + 1`` per contiguous range.

        ``boundary_mode="edge"`` marks a vertex boundary when it has a
        cross-partition edge (its color is read one hop away);
        ``"two_hop"`` when its *two-hop* neighborhood crosses (the reader
        set of distance-2 coloring) — a vertex or any of its neighbors has
        a cross-partition edge.

        ``validate_input="strict"|"repair"`` runs ``g`` through the
        ingest front door first: an asymmetric CSR silently breaks the
        halo-exchange invariant (a boundary vertex the other side doesn't
        know to send), so sanitize before partitioning.
        """
        if validate_input is not None:
            from repro_torch.ingest import sanitize_csr

            g, _ = sanitize_csr(g, policy=validate_input)
        n = g.n
        starts = balanced_starts(g.degrees.astype(np.int64) + 1, ndev)
        owner = (
            np.searchsorted(starts, np.arange(n), side="right") - 1
        ).astype(np.int32)
        src, dst = g.edges()
        cross = owner[src] != owner[dst]
        has_cross = np.zeros(n, dtype=bool)
        has_cross[src[cross]] = True
        if boundary_mode == "edge":
            is_boundary = has_cross
        elif boundary_mode == "two_hop":
            nbr_cross = np.zeros(n, dtype=np.int64)
            np.add.at(nbr_cross, src, has_cross[dst].astype(np.int64))
            is_boundary = has_cross | (nbr_cross > 0)
        else:
            raise ValueError(
                f"unknown boundary_mode {boundary_mode!r}; options: edge, two_hop"
            )
        interior, boundary = [], []
        for d in range(len(starts) - 1):
            ids = np.arange(starts[d], starts[d + 1], dtype=np.int32)
            boundary.append(ids[is_boundary[ids]])
            interior.append(ids[~is_boundary[ids]])

        def build_recv() -> tuple:
            recv = []
            for d in range(len(starts) - 1):
                mine = owner[src] == d
                out_edges = dst[mine & cross]
                if boundary_mode == "two_hop":
                    # readers two hops away: neighbors of my one-hop reach
                    lo = g.row_offsets[starts[d]]
                    hi = g.row_offsets[starts[d + 1]]
                    reach = np.unique(g.col_indices[lo:hi])
                    two = np.unique(
                        _gather_ragged(g.row_offsets, g.col_indices, reach))
                    out_edges = np.concatenate([out_edges, reach, two])
                uniq = np.unique(out_edges).astype(np.int32)
                in_range = (uniq >= starts[d]) & (uniq < starts[d + 1])
                recv.append(uniq[~in_range])
            return tuple(recv)

        return cls(n, starts, tuple(interior), tuple(boundary), build_recv)

    @classmethod
    def from_bipartite(cls, bg, ndev: int) -> "PartitionedCSR":
        """Partition a ``BipartiteGraph``'s COLUMN side (the colored side).

        Columns conflict when they share a row, so a column is boundary iff
        one of its rows also holds a column owned by another device.
        """
        n = bg.n_cols
        starts = balanced_starts(bg.col_degrees.astype(np.int64) + 1, ndev)
        owner = (
            np.searchsorted(starts, np.arange(n), side="right") - 1
        ).astype(np.int32)
        # a row "spans" when its columns touch more than one partition
        row_src = np.repeat(
            np.arange(bg.n_rows, dtype=np.int64), bg.row_degrees
        )
        col_owner = owner[bg.row_to_col]
        row_min = np.full(bg.n_rows, np.iinfo(np.int32).max, np.int64)
        row_max = np.full(bg.n_rows, -1, np.int64)
        np.minimum.at(row_min, row_src, col_owner)
        np.maximum.at(row_max, row_src, col_owner)
        row_spans = (row_max >= 0) & (row_min != row_max)
        col_src = np.repeat(np.arange(n, dtype=np.int64), bg.col_degrees)
        bad = np.zeros(n, dtype=np.int64)
        np.add.at(bad, col_src, row_spans[bg.col_to_row].astype(np.int64))
        is_boundary = bad > 0
        interior, boundary = [], []
        for d in range(len(starts) - 1):
            ids = np.arange(starts[d], starts[d + 1], dtype=np.int32)
            boundary.append(ids[is_boundary[ids]])
            interior.append(ids[~is_boundary[ids]])

        def build_recv() -> tuple:
            recv = []
            for d in range(len(starts) - 1):
                lo = bg.col_offsets[starts[d]]
                hi = bg.col_offsets[starts[d + 1]]
                my_rows = np.unique(bg.col_to_row[lo:hi])
                reach = np.unique(
                    _gather_ragged(bg.row_offsets, bg.row_to_col, my_rows)
                )
                in_range = (reach >= starts[d]) & (reach < starts[d + 1])
                recv.append(reach[~in_range].astype(np.int32))
            return tuple(recv)

        return cls(n, starts, tuple(interior), tuple(boundary), build_recv)

    # -- stacked per-shard device layouts (consumed by core/distributed) -----
    def stack_shards(self, g: "CSRGraph") -> tuple[np.ndarray, ...]:
        """Per-shard CSR arrays stacked on a leading device axis.

        Returns ``(row_starts (ndev, L+1), col_padded (ndev, Mcap), deg
        (ndev, L+1))`` — the ``DeviceCSR`` layout of each shard's row range,
        with GLOBAL column ids (gathers read the globally-indexed color
        view) and the global sentinel ``n`` in every padding slot.  ``Mcap``
        includes ``max_degree`` slack so a full-width dynamic slice starting
        at the last local row never reads out of bounds.
        """
        assert g.n == self.n, "plan was built for a different graph"
        L = self.n_loc
        wmax = max(g.max_degree, 1)
        m_loc = [
            int(g.row_offsets[self.starts[d + 1]] - g.row_offsets[self.starts[d]])
            for d in range(self.ndev)
        ]
        m_cap = max(max(m_loc), 1) + wmax
        row_starts = np.zeros((self.ndev, L + 1), np.int32)
        col = np.full((self.ndev, m_cap), self.n, np.int32)
        deg = np.zeros((self.ndev, L + 1), np.int32)
        for d in range(self.ndev):
            s, e = int(self.starts[d]), int(self.starts[d + 1])
            ln = e - s
            ro = (g.row_offsets[s : e + 1] - g.row_offsets[s]).astype(np.int32)
            row_starts[d, : ln + 1] = ro
            row_starts[d, ln + 1 :] = ro[-1] if ln else 0
            col[d, : m_loc[d]] = g.col_indices[
                g.row_offsets[s] : g.row_offsets[e]
            ]
            deg[d, :ln] = g.degrees[s:e]
        return row_starts, col, deg

    def stack_rows(self, rows: np.ndarray, fill: int) -> np.ndarray:
        """Slice a dense per-vertex ``(n, W)`` table into ``(ndev, L, W)``.

        Shard ``d`` gets its own row range; slots past the range length are
        filled with ``fill`` (the hop target's sentinel) so padding lanes
        stay inert — used to shard the first hop of ``TwoHopRows``.
        """
        L = self.n_loc
        out = np.full((self.ndev, L, rows.shape[1]), fill, rows.dtype)
        for d in range(self.ndev):
            s, e = int(self.starts[d]), int(self.starts[d + 1])
            out[d, : e - s] = rows[s:e]
        return out


class DeviceCSR:
    """Device-resident CSR graph — the ragged engine's native storage.

    ``gather_rows(ids, width)`` materializes only the ``(w, width)`` tile a
    worklist class needs; lanes past each row's degree, and whole rows for
    sentinel ids, read as the sentinel ``n``.
    """

    def __init__(self, row_starts, col_padded, deg_ext, n: int, max_width: int):
        self.row_starts = row_starts
        self.col_padded = col_padded
        self.deg_ext = deg_ext
        self.n = int(n)
        self.max_width = int(max_width)  # widest legal gather (>= max degree)

    @property
    def device(self) -> torch.device:
        return self.row_starts.device

    @classmethod
    def from_csr(cls, g: CSRGraph, device) -> "DeviceCSR":
        """The device form of ``g``, built exactly as ``repro`` builds it."""
        n = g.n
        w = max(g.max_degree, 1)
        col = np.concatenate(
            [g.col_indices.astype(np.int32), np.full(w, n, np.int32)])
        deg = np.concatenate([g.degrees, np.zeros(1, np.int32)]).astype(np.int32)
        return cls(
            torch.from_numpy(g.row_offsets.astype(np.int32)).to(device),
            torch.from_numpy(col).to(device),
            torch.from_numpy(deg).to(device),
            n,
            w,
        )

    # row-provider protocol of the engine: rows / row1 / lane_source
    def lane_source(self, width: int | None = None):
        """``(source, W)``: where K3 reads a row on the card (``CsrRows``,
        each row cut to ``W`` lanes) and the row width."""
        return (CsrRows(self.row_starts, self.col_padded),
                self.max_width if width is None else int(width))

    def rows(self, ids, width: int | None = None):
        return self.gather_rows(ids, self.max_width if width is None else width)

    def row1(self, v):
        return self.gather_row1(v)

    def gather_rows(self, ids: torch.Tensor, width: int) -> torch.Tensor:
        """Ragged ``(w, width)`` neighbor-id tile for worklist ``ids``.

        ``width`` must cover every gathered vertex's degree; narrower widths
        would silently truncate adjacency.
        """
        return csr_tile(self.row_starts, self.col_padded, ids, width)

    def gather_row1(self, v: int, width: int | None = None) -> torch.Tensor:
        """One vertex's sentinel-padded ``(width,)`` neighbor row.

        The slice start is clamped so the row stays inside ``col_padded``,
        as ``lax.dynamic_slice`` clamps it in ``repro``.
        """
        width = self.max_width if width is None else int(width)
        n = self.n
        v = int(v)
        start = int(self.row_starts[min(max(v, 0), max(n - 1, 0))])
        start = min(start, self.col_padded.shape[0] - width)
        vals = self.col_padded[start: start + width]
        lane = torch.arange(width, dtype=torch.int32, device=vals.device)
        deg = int(self.deg_ext[min(max(v, 0), n)])
        if v >= n:
            return torch.full_like(vals, n)
        return torch.where(lane < deg, vals, n)


class DeviceGraph:
    """Device-side padded-adjacency graph (the dense-table algorithms'
    storage: topology, JP, multi-hash, three-step).

    ``adj``      (n, D) int32, sentinel ``n`` in padding lanes
    ``degrees``  (n+1,) int32, sentinel slot holds 0
    """

    def __init__(self, adj, degrees, n: int):
        self.adj = adj
        self.degrees = degrees
        self.n = int(n)
        self.D = int(adj.shape[1])

    @classmethod
    def from_csr(cls, g: CSRGraph, device, width: int | None = None) -> "DeviceGraph":
        """The table and degrees of ``g`` on ``device``.  At the natural
        width they come from the graph's device cache, so the classic
        engine and the dense-table algorithms share one upload."""
        from repro_torch.core.coloring import _dense_adjacency, _device_csr

        device = torch.device(device)
        deg = _device_csr(g, device).deg_ext
        if width is None or int(width) == max(g.max_degree, 1):
            adj = _dense_adjacency(g, device)
        else:
            adj = torch.from_numpy(g.padded_adjacency(width)).to(device)
        return cls(adj, deg, g.n)
