"""Bipartite partial coloring — the Jacobian-compression workload (port of
``repro.d2.bipartite``).

A sparse Jacobian pattern ``J`` (n_rows × n_cols) is a bipartite graph;
columns ``u, v`` conflict iff some row holds nonzeros in both.  A partial
coloring of the column side with that rule partitions the columns into
structurally-orthogonal groups, so ``J`` is recovered from ``num_groups``
products ``J @ seed`` instead of ``n_cols``.

The strategies of ``d2/coloring.py``: ``precomputed`` colors the
column-conflict graph's CSR with the distance-1 engine; ``onthefly``
composes the cols→rows and rows→cols gathers per super-step
(``TwoHopRows(include_first_hop=False)``: row-side ids carry no colors).
Both order losers by column degree (nnz per column, ties by id), so they
give the same colors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api import register
from repro_torch.core.coloring import (
    ColoringResult,
    _graph_device_cache,
    traced_run,
)
from repro_torch.core.csr import (
    CSRGraph,
    DeviceCSR,
    PartitionedCSR,
    compose_pairs,
    csr_from_edges,
    padded_ragged,
)
from repro_torch.d2.coloring import (
    DEFAULT_D2_BUDGET,
    TwoHopRows,
    _stacked_plan,
    degrees_ext,
    resolve_d2_engine,
    resolve_strategy,
    run_d2_engine,
    run_sharded_d2_engine,
)
from repro_torch.errors import NonConvergenceError
from repro_torch.obs.spans import span
from repro_torch.obs.trace import empty_trace

__all__ = [
    "BipartiteGraph",
    "CompressionResult",
    "color_bipartite",
    "compress_jacobian_pattern",
]


def _resolve_bipartite_strategy(bg: "BipartiteGraph", strategy: str,
                                budget: int) -> str:
    w2_bound = max(bg.conflict_degree_bound(), 1)
    pair_bound = int((bg.row_degrees.astype(np.int64) ** 2).sum())
    return resolve_strategy(
        strategy, 4 * bg.n_cols * w2_bound + 16 * pair_bound, budget)


@dataclasses.dataclass(frozen=True)
class BipartiteGraph:
    """A sparse bipartite pattern stored as both ragged halves.

    ``row_offsets``/``row_to_col`` — rows→cols CSR (the pattern's rows);
    ``col_offsets``/``col_to_row`` — cols→rows CSR (its transpose).  Only
    the column side is colored.  The four arrays of a
    ``repro.d2.BipartiteGraph`` build the same graph unchanged.
    """

    row_offsets: np.ndarray  # (n_rows+1,)
    row_to_col: np.ndarray   # (nnz,) int32
    col_offsets: np.ndarray  # (n_cols+1,)
    col_to_row: np.ndarray   # (nnz,) int32

    @property
    def n_rows(self) -> int:
        return int(self.row_offsets.shape[0] - 1)

    @property
    def n_cols(self) -> int:
        return int(self.col_offsets.shape[0] - 1)

    @property
    def nnz(self) -> int:
        return int(self.row_to_col.shape[0])

    @property
    def row_degrees(self) -> np.ndarray:
        return np.diff(self.row_offsets).astype(np.int32)

    @property
    def col_degrees(self) -> np.ndarray:
        return np.diff(self.col_offsets).astype(np.int32)

    @classmethod
    def from_coo(
        cls, n_rows: int, n_cols: int, rows: np.ndarray, cols: np.ndarray
    ) -> "BipartiteGraph":
        """Build (deduplicated, sorted) from nonzero coordinates."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if rows.size:
            key = np.unique(rows * n_cols + cols)
            rows, cols = key // n_cols, key % n_cols
        r_off = np.zeros(n_rows + 1, dtype=np.int64)
        np.add.at(r_off, rows + 1, 1)
        c_off = np.zeros(n_cols + 1, dtype=np.int64)
        np.add.at(c_off, cols + 1, 1)
        order_c = np.lexsort((rows, cols))  # transpose ordering
        return cls(
            np.cumsum(r_off),
            cols.astype(np.int32),
            np.cumsum(c_off),
            rows[order_c].astype(np.int32),
        )

    @classmethod
    def from_dense(cls, pattern: np.ndarray) -> "BipartiteGraph":
        """Build from a dense (n_rows, n_cols) boolean/nonzero mask."""
        pattern = np.asarray(pattern)
        rows, cols = np.nonzero(pattern)
        return cls.from_coo(pattern.shape[0], pattern.shape[1], rows, cols)

    # -- derived views -------------------------------------------------------
    def column_conflict_graph(self) -> CSRGraph:
        """The column-side conflict relation as a plain ``CSRGraph``:
        ``u ~ v`` iff a length-2 path ``u → row → v`` exists."""
        src, dst = compose_pairs(
            self.col_offsets, self.col_to_row, self.row_offsets, self.row_to_col
        )
        return csr_from_edges(self.n_cols, src, dst, symmetrize=False, dedup=True)

    def conflict_degree_bound(self) -> int:
        """Upper bound on the conflict graph's max degree (no dedup)."""
        if self.nnz == 0:
            return 0
        rdeg = self.row_degrees.astype(np.int64)
        per_col = np.bincount(
            np.repeat(np.arange(self.n_cols, dtype=np.int64), self.col_degrees),
            weights=rdeg[self.col_to_row],
            minlength=self.n_cols,
        )
        return int(per_col.max())

    def padded_halves(self) -> tuple[np.ndarray, np.ndarray]:
        """Padded cols→rows and rows→cols views with cross-side sentinels."""
        wc = max(int(self.col_degrees.max(initial=0)), 1)
        wr = max(int(self.row_degrees.max(initial=0)), 1)
        cols2rows = padded_ragged(self.col_offsets, self.col_to_row, wc, self.n_rows)
        rows2cols = padded_ragged(self.row_offsets, self.row_to_col, wr, self.n_cols)
        return cols2rows, rows2cols


@register("bipartite")
def color_bipartite(
    bg: BipartiteGraph,
    *,
    heuristic: str = "degree",
    firstfit: str = "bitset",
    mode: str = "workefficient",
    strategy: str = "auto",
    memory_budget: int = DEFAULT_D2_BUDGET,
    coarsen: int = 1,
    max_iters: int | None = None,
    tiling="auto",
    tail_serial="auto",
    engine: str = "ragged",
    devices=None,
    backend: str | None = None,
    trace=False,
    device=None,
) -> ColoringResult:
    """Partial coloring of ``bg``'s column side with the SGR super-step.

    ``result.colors[c]`` is the group of column ``c``; validity means no two
    columns sharing a row share a color (``d2.validate_bipartite``).  The
    precomputed strategy colors the column-conflict graph's CSR (K1, K2 on
    the card), the on-the-fly strategy composes the cols→rows→cols gathers
    (K3, K2).  ``trace`` attaches a ``RunTrace`` with the phase spans.
    Results equal ``repro.d2.color_bipartite``'s field for field.
    ``engine="sharded"`` distributes the column side over one shard per
    entry of ``devices`` along a ``PartitionedCSR.from_bipartite`` plan;
    with one device it runs ``ragged`` with ``mode="fused"``.
    """
    device, devs = resolve_d2_engine(engine, coarsen, devices, device, backend)
    nc = bg.n_cols
    if devs is not None:
        if len(devs) > 1 and nc > 0:
            return _color_bipartite_sharded(
                bg, devs, heuristic=heuristic, firstfit=firstfit,
                strategy=strategy, memory_budget=memory_budget,
                tiling=tiling, tail_serial=tail_serial, max_iters=max_iters,
                trace=trace)
        # one device: the ragged fused realization, so colours and
        # accounting do not depend on the device count
        mode = "fused"
    if nc == 0:
        result = ColoringResult(np.zeros(0, np.int32), 0, 0, 0, True,
                                algorithm="bipartite_partial_sgr")
        if trace:
            result.trace = empty_trace("bipartite_partial_sgr")
        return result
    max_iters = max_iters or nc + 1
    strategy = _resolve_bipartite_strategy(bg, strategy, memory_budget)

    def run():
        deg_ext = degrees_ext(bg.col_degrees, device)
        if strategy == "precomputed":
            with span("csr_build", engine="bipartite_precomputed"):
                cg = bg.column_conflict_graph()
                provider = DeviceCSR.from_csr(cg, device)
            degrees_for_tiling = cg.degrees
        else:
            with span("csr_build", engine="bipartite_onthefly"):
                cols2rows, rows2cols = bg.padded_halves()
                provider = TwoHopRows(torch.from_numpy(cols2rows).to(device),
                                      torch.from_numpy(rows2cols).to(device),
                                      include_first_hop=False)
            degrees_for_tiling = None
        return run_d2_engine(
            n=nc, provider=provider, deg_ext=deg_ext, tiling=tiling,
            degrees_for_tiling=degrees_for_tiling, mode=mode,
            heuristic=heuristic, kind=firstfit, coarsen=coarsen,
            tail_serial=tail_serial, max_iters=max_iters,
            algorithm="bipartite_partial_sgr",
            deg_bound=int(bg.col_degrees.max(initial=0)), trace=trace,
        )

    return traced_run(run, trace)


def _color_bipartite_sharded(
    bg: BipartiteGraph, devices, *, heuristic, firstfit, strategy,
    memory_budget, tiling, tail_serial, max_iters, trace=False,
) -> ColoringResult:
    """The multi-shard realization of ``color_bipartite``."""
    nc = bg.n_cols
    ndev = len(devices)
    max_iters = max_iters or nc + 1
    strategy = _resolve_bipartite_strategy(bg, strategy, memory_budget)
    deg_bound = int(bg.col_degrees.max(initial=0))

    def run():
        deg_ext_np = np.concatenate(
            [bg.col_degrees, np.zeros(1, np.int32)]).astype(np.int32)
        if strategy == "precomputed":
            with span("csr_build", engine="bipartite_precomputed"):
                cg = bg.column_conflict_graph()
            with span("partition_plan", ndev=ndev):
                plan = PartitionedCSR.from_graph(cg, ndev)
                prov_np = plan.stack_shards(cg)
            return run_sharded_d2_engine(
                n=nc, devices=devices, plan=plan, provider_kind="csr",
                prov_np=prov_np, deg_ext_np=deg_ext_np,
                degrees_for_tiling=cg.degrees, tiling=tiling,
                heuristic=heuristic, kind=firstfit, tail_serial=tail_serial,
                max_iters=max_iters,
                algorithm=f"bipartite_partial_sgr_sharded_{ndev}dev",
                tail_provider=DeviceCSR.from_csr(cg, devices[0]),
                deg_bound=deg_bound, trace=trace,
            )
        with span("csr_build", engine="bipartite_onthefly"):
            cols2rows, rows2cols = _graph_device_cache(bg, "halves", None,
                                                       bg.padded_halves)
        with span("partition_plan", ndev=ndev):
            # built once per shard count, where repro rebuilds it every call
            plan, rows_np = _graph_device_cache(
                bg, f"plan{ndev}", None,
                lambda: _stacked_plan(PartitionedCSR.from_bipartite(bg, ndev),
                                      cols2rows, bg.n_rows))
        full_width = cols2rows.shape[1] * rows2cols.shape[1]
        tail_provider = TwoHopRows(torch.from_numpy(cols2rows).to(devices[0]),
                                   torch.from_numpy(rows2cols).to(devices[0]),
                                   include_first_hop=False)
        return run_sharded_d2_engine(
            n=nc, devices=devices, plan=plan, provider_kind="twohop",
            prov_np=(rows_np, rows2cols),
            deg_ext_np=deg_ext_np, degrees_for_tiling=None, tiling=tiling,
            heuristic=heuristic, kind=firstfit, tail_serial=tail_serial,
            max_iters=max_iters,
            algorithm=f"bipartite_partial_sgr_sharded_{ndev}dev",
            tail_provider=tail_provider, include_first_hop=False,
            deg_bound=deg_bound, full_width=full_width, trace=trace,
        )

    return traced_run(run, trace)


# --------------------------------------------------------------------------
# Jacobian compression
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CompressionResult:
    """Column groups for compressed Jacobian recovery."""

    coloring: ColoringResult
    groups: list[np.ndarray]  # column ids per group, 0-indexed groups

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def seed_matrix(self, dtype=np.float32) -> np.ndarray:
        """(n_cols, num_groups) 0/1 seed: column c contributes to its group.

        ``J @ seed`` evaluates the whole Jacobian in ``num_groups``
        directional derivatives.
        """
        n_cols = self.coloring.colors.shape[0]
        seed = np.zeros((n_cols, self.num_groups), dtype=dtype)
        for k, cols in enumerate(self.groups):
            seed[cols, k] = 1
        return seed


def compress_jacobian_pattern(pattern, *, on_fail: str = "ladder",
                              **opts) -> CompressionResult:
    """Color a Jacobian sparsity pattern into structurally-orthogonal groups.

    ``pattern`` may be a ``BipartiteGraph``, a dense (n_rows, n_cols)
    boolean/nonzero mask, or a ``(n_rows, n_cols, rows, cols)`` COO tuple.
    Extra ``opts`` (``device=`` among them) pass through to
    ``color_bipartite``.

    A run that exhausts ``max_iters`` before converging would leave
    uncolored columns out of every group.  ``on_fail="ladder"`` (the
    default) escalates it through the guarantee ladder on the
    column-conflict graph (``core.guarantee``; every rung recorded in
    ``result.coloring.degradations``, reruns on the caller's device), so
    the partition is always total; ``on_fail="raise"`` refuses it with
    ``NonConvergenceError``.
    """
    if on_fail not in ("ladder", "raise"):
        raise ValueError(
            f"unknown on_fail {on_fail!r}; options: ladder, raise")
    if isinstance(pattern, BipartiteGraph):
        bg = pattern
    elif isinstance(pattern, tuple) and len(pattern) == 4:
        bg = BipartiteGraph.from_coo(*pattern)
    else:
        bg = BipartiteGraph.from_dense(pattern)
    result = color_bipartite(bg, **opts)
    if not result.converged and on_fail == "raise":
        raise NonConvergenceError(
            f"bipartite coloring did not converge after {result.iterations} "
            f"super-steps (raise max_iters); refusing to build a partial "
            f"column partition"
        )
    if not result.converged:
        from repro_torch.core.guarantee import ensure_valid_result, rung_options

        result = ensure_valid_result(
            bg.column_conflict_graph(), result,
            lambda rung: color_bipartite(bg, **rung_options(opts, rung)))
    groups = [
        np.where(result.colors == c)[0].astype(np.int32)
        for c in range(1, result.num_colors + 1)
    ]
    return CompressionResult(result, groups)
