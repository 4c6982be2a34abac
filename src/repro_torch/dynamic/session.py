"""``ColoringSession`` — streaming incremental recolouring (port of
``repro.dynamic.session``).

A mutating graph is recoloured by the same engine with the worklist cut to
the **dirty frontier** (the vertices whose neighbourhoods changed since the
last recolor), every other colour fixed.  A frontier vertex FirstFits a
colour distinct from every colour in its row, fixed neighbours included,
so fresh conflicts only arise between frontier vertices and stay inside
the worklist; edges between fixed vertices were valid before the delta, so
convergence of the frontier loop makes the whole colouring valid.

    session = open_session(rows, cols)          # cold ragged colouring
    session.apply_delta(add_edges=(src, dst))   # overlay mutation
    result = session.recolor()                  # frontier-sized super-steps

On the card a frontier recolor runs ``run_ragged_engine`` warm
(``colors_init=``) over the session's padded ``DeviceCSR``: K1 where the
packed word fits, K3 over CSR rows otherwise, then K2 for a tail.  Results,
``frontier()``, ``pending_dirty``, ``metrics()`` and the journal's records
equal ``repro``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import register
from repro_torch.core.coloring import (
    ColoringResult,
    _graph_device_cache,
    _resolve_classes,
    color_data_driven,
    resolve_tail_threshold,
    run_ragged_engine,
)
from repro_torch.core.csr import CSRGraph, DeviceCSR, csr_from_edges, next_pow2
from repro_torch.ingest import packed_gather_ok
from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.obs.spans import SpanRecorder, span
from repro_torch.obs.trace import empty_trace

__all__ = ["ColoringSession", "color_dynamic", "open_session"]

# Frontiers at or below this size recolor as one full-width class padded to
# this many lanes, so their engine key depends on the capacities alone.
_SMALL_FRONTIER = 64


def _padded_edge_cap(m: int, wcap: int) -> int:
    """Pow2 device-CSR column capacity with >= 25% edge-growth headroom."""
    return next_pow2(m + wcap + max(m // 4, 64))


def _device_csr_padded(g: CSRGraph, wcap: int, device,
                       cap: int | None = None) -> DeviceCSR:
    """A ``DeviceCSR`` whose array shapes are powers of two.

    The column array is padded to ``cap`` (default ``_padded_edge_cap``)
    with the inert sentinel ``n``, and the row width is ``wcap``: a slowly
    mutating graph keeps its shapes, and so its engine key, until it grows
    past the headroom.
    """
    n, m = g.n, g.m
    if cap is None:
        cap = _padded_edge_cap(m, wcap)
    col = np.full(cap, n, np.int32)
    col[:m] = g.col_indices
    deg = np.concatenate([g.degrees, np.zeros(1, np.int32)]).astype(np.int32)
    return DeviceCSR(
        torch.from_numpy(g.row_offsets.astype(np.int32)).to(device),
        torch.from_numpy(col).to(device), torch.from_numpy(deg).to(device),
        n, wcap)


def open_session(rows, cols=None, *, n: int | None = None, options=None,
                 **opts) -> "ColoringSession":
    """Open a streaming session from COO edge arrays (or a ready CSRGraph).

    ``rows``/``cols`` are undirected edge endpoints (symmetrized and
    deduplicated); ``n`` widens the vertex count past ``max(endpoint) + 1``
    for isolated vertices.  Options come as a ``ColorOptions``
    (``options=``) or loose kwargs (heuristic, firstfit, mode, tiling,
    tail_serial, max_iters, compact_frac, backend, device, ...).
    """
    if options is not None or opts:
        from repro_torch.options import ColorOptions

        opts = ColorOptions.normalize(options, **opts).session_kwargs()
    if cols is None:
        if not isinstance(rows, CSRGraph):
            raise TypeError(
                "open_session takes (rows, cols) edge arrays or a CSRGraph; "
                f"got {type(rows).__name__}")
        g = rows
    else:
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        hi = int(max(rows.max(initial=-1), cols.max(initial=-1))) + 1
        n = hi if n is None else int(n)
        if n < hi:
            raise ValueError(f"n={n} < max endpoint + 1 = {hi}")
        g = csr_from_edges(n, rows, cols)
    return ColoringSession(g, **opts)


def _edge_payload(pair):
    """COO edge-batch args as a JSON-safe journal payload (None passes)."""
    if pair is None:
        return None
    src, dst = pair
    return [np.asarray(src).astype(int).tolist(),
            np.asarray(dst).astype(int).tolist()]


def _payload_edges(payload):
    """Inverse of ``_edge_payload`` for journal replay."""
    if payload is None:
        return None
    return (np.asarray(payload[0], np.int64), np.asarray(payload[1], np.int64))


class ColoringSession:
    """Persistent colouring of one mutating graph (``DeltaCSR`` + the
    ragged engine).  ``device`` defaults to ``"cuda"``; it is not part of
    the durable state, so ``restore`` takes it again."""

    def __init__(self, graph, *, heuristic: str = "degree",
                 firstfit: str = "bitset", mode: str = "fused",
                 tiling="auto", tail_serial="auto",
                 max_iters: int | None = None, compact_frac: float = 0.25,
                 backend: str | None = None, trace=False,
                 validate_input: str | None = None, on_fail: str = "raise",
                 durable_dir: str | None = None, snapshot_every: int = 64,
                 defer_maintenance: bool = False, device=None):
        from repro_torch.dynamic.delta import DeltaCSR

        if validate_input is not None and isinstance(graph, CSRGraph):
            from repro_torch.ingest import sanitize_csr

            graph, self.ingest_report = sanitize_csr(graph, policy=validate_input)
        else:
            self.ingest_report = None
        self.delta = (graph if isinstance(graph, DeltaCSR)
                      else DeltaCSR(graph, compact_frac=compact_frac))
        self._configure(
            heuristic=heuristic, firstfit=firstfit, mode=mode, tiling=tiling,
            tail_serial=tail_serial, max_iters=max_iters,
            compact_frac=compact_frac, backend=backend, trace=trace,
            on_fail=on_fail, snapshot_every=snapshot_every,
            defer_maintenance=defer_maintenance, device=device)
        if self._defer_maintenance:
            # the owner schedules compaction: suppress the inline
            # auto-compact and let maintain() run it from an idle slot
            self.delta.compact_frac = float("inf")
        self.result = self._cold(self.delta.graph())
        if not self.result.converged and self._on_fail == "ladder":
            self.result = self._escalate(self.result, True)
        self.colors = self.result.colors
        if durable_dir is not None:
            from repro_torch.dynamic.journal import SessionJournal

            self._journal = SessionJournal(durable_dir, fresh=True)
            self.checkpoint()

    def _configure(self, *, heuristic, firstfit, mode, tiling, tail_serial,
                   max_iters, compact_frac, backend, trace, on_fail,
                   snapshot_every, defer_maintenance=False, device=None) -> None:
        if on_fail not in ("raise", "ladder"):
            raise ValueError(
                f"unknown on_fail {on_fail!r}; options: raise, ladder")
        self._device = resolve_backend(backend, device)
        self._heuristic = heuristic
        self._firstfit = firstfit
        self._mode = mode
        self._tiling = tuple(tiling) if isinstance(tiling, list) else tiling
        self._tail_serial = tail_serial
        self._max_iters = max_iters
        self._compact_frac = compact_frac
        self._backend = backend
        self._trace = trace
        # non-convergence policy and durability; an owner that defers
        # maintenance calls maintain() in an idle slot instead
        self._on_fail = on_fail
        self._defer_maintenance = bool(defer_maintenance)
        self._snapshot_every = int(snapshot_every)
        self._journal = None
        self._records_since_snapshot = 0
        self.recovery = None
        self._dirty: list[np.ndarray] = []
        # cumulative counters behind metrics(); the engine-key counts track
        # the (shape, static-argument) keys this session has presented
        self._counters = {
            "deltas": 0, "dirtied_total": 0, "recolors": 0,
            "full_recolors": 0, "noop_recolors": 0, "frontier_total": 0,
            "work_total": 0, "supersteps_total": 0,
            "engine_cache_hits": 0, "engine_cache_misses": 0,
        }
        self._engine_keys: set = set()

    # -- engine plumbing -----------------------------------------------------
    def _cold(self, g: CSRGraph) -> ColoringResult:
        return color_data_driven(
            g, engine="ragged", mode=self._mode, heuristic=self._heuristic,
            firstfit=self._firstfit, tiling=self._tiling,
            tail_serial=self._tail_serial, max_iters=self._max_iters,
            backend=self._backend, trace=self._trace, device=self._device,
        )

    # -- state views ---------------------------------------------------------
    @property
    def graph(self) -> CSRGraph:
        """The current (post-delta) graph snapshot."""
        return self.delta.graph()

    @property
    def n(self) -> int:
        return self.delta.n

    @property
    def num_colors(self) -> int:
        return int(self.colors.max(initial=0))

    def frontier(self) -> np.ndarray:
        """Dirty vertex ids pending the next ``recolor()`` (sorted, unique)."""
        if not self._dirty:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(self._dirty)).astype(np.int64)

    @property
    def pending_dirty(self) -> int:
        """Cheap upper bound on the dirty-frontier size (no dedup pass):
        0 means a recolor would be a no-op."""
        return sum(int(a.size) for a in self._dirty)

    def validate(self) -> bool:
        """True iff the committed colouring is proper on the current graph."""
        from repro_torch.core.validate import is_valid_coloring

        return is_valid_coloring(self.delta.graph(), self.colors)

    # -- mutation ------------------------------------------------------------
    def apply_delta(self, *, add_vertices: int = 0, add_edges=None,
                    remove_edges=None, remove_vertices=None) -> np.ndarray:
        """Apply one batched mutation; returns the vertex ids it dirtied.

        Applied in order vertex-adds, edge-adds, edge-removes,
        vertex-removes, so one delta can create vertices and wire them up.
        ``add_edges``/``remove_edges`` are ``(src, dst)`` array pairs;
        no-op entries (an existing edge added, a missing one removed) dirty
        nothing.
        """
        if self._journal is not None:
            # write-ahead: the journal records the intent before the
            # overlay mutates, so a crash mid-mutation replays the batch
            self._journal_append("delta", {
                "add_vertices": int(add_vertices),
                "add_edges": _edge_payload(add_edges),
                "remove_edges": _edge_payload(remove_edges),
                "remove_vertices": (
                    None if remove_vertices is None
                    else np.asarray(remove_vertices).astype(int).tolist()),
            })
        with span("delta_mutation"):
            touched: list[np.ndarray] = []
            if add_vertices:
                touched.append(self.delta.add_vertices(add_vertices))
            if add_edges is not None:
                touched.append(self.delta.add_edges(*add_edges))
            if remove_edges is not None:
                touched.append(self.delta.remove_edges(*remove_edges))
            if remove_vertices is not None:
                touched.append(self.delta.remove_vertices(remove_vertices))
            self._counters["deltas"] += 1
            if not touched:
                return np.zeros(0, np.int32)
            out = np.unique(np.concatenate(
                [np.asarray(t, dtype=np.int64) for t in touched]))
            if out.size:
                self._dirty.append(out)
            self._counters["dirtied_total"] += int(out.size)
            return out.astype(np.int32)

    # -- recolouring ---------------------------------------------------------
    def recolor(self, *, full: bool = False) -> ColoringResult:
        """Repair the colouring after pending deltas; commits on convergence.

        Default: frontier-restricted super-steps (work follows the
        frontier).  ``full=True`` compacts the overlay and reruns the cold
        ragged engine on the whole graph, the result a fresh
        ``color(g, "fused")`` gives.
        """
        if full:
            with span("compaction", overlay=self.delta.overlay_size):
                g = self.delta.compact()
            self._counters["full_recolors"] += 1
            result = self._cold(g)
        else:
            frontier = self.frontier()
            if frontier.size == 0:
                self._counters["noop_recolors"] += 1
                result = ColoringResult(
                    self.colors.copy(), 0, 0, 0, True, "dynamic_sgr")
                if self._trace:
                    result.trace = empty_trace("dynamic_sgr")
                return result
            self._counters["frontier_total"] += int(frontier.size)
            if self._trace:
                with SpanRecorder() as rec:
                    result = self._recolor_frontier(frontier)
                if result.trace is not None:
                    result.trace.spans = rec.events
            else:
                result = self._recolor_frontier(frontier)
        if not result.converged:
            if self._on_fail == "ladder":
                result = self._escalate(result, full)
            else:
                from repro_torch.errors import NonConvergenceError

                raise NonConvergenceError(
                    "recolor() hit max_iters before converging; the session "
                    "coloring was NOT updated — retry with a larger "
                    "max_iters, tail_serial enabled, recolor(full=True), or "
                    "open the session with on_fail='ladder' to escalate "
                    "through the guarantee ladder instead")
        self._counters["recolors"] += 1
        self._counters["work_total"] += int(result.work_items)
        self._counters["supersteps_total"] += int(result.iterations)
        self.colors = result.colors
        self.result = result
        self._dirty.clear()
        if self._journal is not None:
            # post-commit record: a crash before this line replays as "the
            # recolor never happened", which is exactly true of the state
            self._journal_append("recolor", {"full": bool(full)})
        return result

    def _escalate(self, result, full: bool):
        """The guarantee ladder for a recolor that hit ``max_iters``."""
        from repro_torch.core.guarantee import ensure_valid_result

        g = self.delta.graph()

        def rerun(rung):
            if rung != "budget_extension":
                # reseeding would flip the session's pinned heuristic and
                # desynchronize later frontier recolors: not applicable
                return None
            saved = self._max_iters
            self._max_iters = None
            try:
                if full:
                    return self._cold(g)
                return self._recolor_frontier(self.frontier())
            finally:
                self._max_iters = saved

        return ensure_valid_result(g, result, rerun)

    def _recolor_frontier(self, frontier: np.ndarray) -> ColoringResult:
        g = self.delta.graph()
        n = g.n
        prev = self.colors
        colors0 = np.zeros(n + 1, np.int32)
        colors0[: prev.shape[0]] = prev  # n only grows; new slots stay 0
        colors0[frontier] = 0            # the frontier recolours from scratch
        deg = g.degrees
        dmax = max(g.max_degree, 1)
        # High-water capacities: balanced churn makes max-degree and m flap
        # around pow2 boundaries; never shrinking a capacity keeps the key
        # set monotone.
        self._wcap_hw = wcap = max(next_pow2(dmax), getattr(self, "_wcap_hw", 0))
        self._ecap_hw = ecap = max(_padded_edge_cap(g.m, wcap),
                                   getattr(self, "_ecap_hw", 0))
        small = frontier.size <= _SMALL_FRONTIER
        if small:
            # one class at the full width, padded to the fixed floor: the
            # key is one constant per capacity state
            classes_idx, widths = [np.arange(frontier.size)], [wcap]
        else:
            classes_idx, widths = _resolve_classes(deg[frontier], (), self._tiling)
            widths = [min(next_pow2(w), wcap) for w in widths]
        # pow2-pad worklists with the inert sentinel n, as repro does to
        # keep its jit keys repeating
        classes, counts = [], []
        for ci in classes_idx:
            ids = frontier[ci].astype(np.int32)
            pad_to = _SMALL_FRONTIER if small else next_pow2(ids.size)
            classes.append(np.concatenate(
                [ids, np.full(pad_to - ids.size, n, np.int32)]))
            counts.append(int(ids.size))
        dev = self._device
        deg_ext = _graph_device_cache(g, "deg_ext", dev, lambda: torch.from_numpy(
            np.concatenate([deg, np.zeros(1, np.int32)]).astype(np.int32)).to(dev))
        provider = _graph_device_cache(
            g, f"dcsr_dyn:{wcap}:{ecap}", dev,
            lambda: _device_csr_padded(g, wcap, dev, cap=ecap))
        tail_enabled, thr = resolve_tail_threshold(
            self._tail_serial, int(frontier.size))
        # the packed word needs colours < 2^15, fixed colours included
        # (deletions can leave them past the current dmax + 1)
        pack = packed_gather_ok(wcap, int(colors0.max(initial=0)))
        # engine-key accounting: everything that is a jit static argument
        # or an array shape in repro.  The port compiles nothing per key, so
        # these count keys presented, not compiles.
        key = (n, ecap, wcap,
               tuple(c.shape[0] for c in classes), tuple(widths),
               tail_enabled, thr, pack, self._max_iters or n + 1)
        hit = key in self._engine_keys
        self._engine_keys.add(key)
        self._counters["engine_cache_hits" if hit else
                       "engine_cache_misses"] += 1
        return run_ragged_engine(
            n=n, provider=provider, deg_ext=deg_ext, classes=classes,
            tile_widths=widths, acc_widths=widths, tail_width=wcap,
            mode=self._mode, heuristic=self._heuristic, kind=self._firstfit,
            coarsen=1, coarsen_lanes=None,
            tail_enabled=tail_enabled, tail_threshold=thr,
            max_iters=self._max_iters or n + 1, algorithm="dynamic_sgr",
            pack_degrees=pack, colors_init=colors0,
            stall_serializes_all=False, class_counts=counts,
            trace=self._trace,
        )

    # -- durability ------------------------------------------------------------
    def _journal_append(self, kind: str, payload: dict) -> None:
        self._journal.append(kind, payload)
        self._records_since_snapshot += 1
        if (self._records_since_snapshot >= self._snapshot_every
                and not self._defer_maintenance):
            self.checkpoint()

    def checkpoint(self) -> None:
        """Write a full-state snapshot (DeltaCSR base + overlay, colours,
        dirty frontier, counters, engine options) into ``durable_dir``.

        Atomic (tmp + rename) and automatic every ``snapshot_every``
        journal records; ``restore()`` resumes from the latest snapshot
        plus the journal tail.  Raises unless the session is durable.
        """
        if self._journal is None:
            raise RuntimeError(
                "checkpoint() needs a durable session; open it with "
                "ColoringSession(..., durable_dir=path)")
        arrays = dict(self.delta.state_arrays())
        arrays["colors"] = np.asarray(self.colors, np.int32)
        arrays["dirty"] = self.frontier()
        meta = {
            "counters": {k: int(v) for k, v in self._counters.items()},
            "compactions": int(self.delta.compactions),
            "opts": {
                "heuristic": self._heuristic,
                "firstfit": self._firstfit,
                "mode": self._mode,
                "tiling": (list(self._tiling)
                           if isinstance(self._tiling, tuple)
                           else self._tiling),
                "tail_serial": self._tail_serial,
                "max_iters": self._max_iters,
                "compact_frac": self._compact_frac,
                "backend": self._backend,
                "trace": self._trace,
                "on_fail": self._on_fail,
                "snapshot_every": self._snapshot_every,
                "defer_maintenance": self._defer_maintenance,
            },
        }
        self._journal.write_snapshot(arrays, meta)
        self._records_since_snapshot = 0

    # -- owner hooks: deferred maintenance and spill ---------------------------
    def maintenance_due(self) -> dict:
        """Which deferred maintenance steps are owed (a cheap poll):
        ``compact`` by the configured ``compact_frac``, ``snapshot`` by the
        ``snapshot_every`` cadence the defer flag suppressed."""
        return {
            "compact": self.delta.compaction_due(self._compact_frac),
            "snapshot": (self._journal is not None
                         and self._records_since_snapshot
                         >= self._snapshot_every),
        }

    def maintain(self) -> list[str]:
        """Run owed maintenance now (an idle slot); returns the actions."""
        due = self.maintenance_due()
        done = []
        if due["compact"]:
            with span("compaction", overlay=self.delta.overlay_size,
                      deferred=True):
                self.delta.compact()
            done.append("compact")
        if due["snapshot"]:
            self.checkpoint()
            done.append("snapshot")
        return done

    def attach_durable(self, durable_dir: str) -> None:
        """Late-enable durability on a live session (the spill hook): a
        fresh journal under ``durable_dir`` and a full snapshot.  A durable
        session just checkpoints."""
        if self._journal is not None:
            self.checkpoint()
            return
        from repro_torch.dynamic.journal import SessionJournal

        self._journal = SessionJournal(durable_dir, fresh=True)
        self._records_since_snapshot = 0
        self.checkpoint()

    @classmethod
    def restore(cls, durable_dir: str, *, device=None) -> "ColoringSession":
        """Resume a durable session on ``device`` (default ``"cuda"``).

        Loads the latest snapshot under ``durable_dir`` and replays every
        CRC-valid journal record after it through ``apply_delta`` and
        ``recolor``; the engines are deterministic, so the state equals the
        uninterrupted session's.  A torn tail stops the replay at the last
        good record; ``session.recovery`` reports the snapshot seq, the
        records replayed and whether a torn tail was dropped.
        """
        from repro_torch.dynamic.delta import DeltaCSR
        from repro_torch.dynamic.journal import SessionJournal

        journal = SessionJournal(durable_dir)
        snap = journal.load_snapshot()
        if snap is None:
            raise FileNotFoundError(
                f"no snapshot under {durable_dir!r}; restore() needs a "
                "session that was opened with durable_dir= (the opening "
                "checkpoint is written automatically)")
        arrays, meta = snap
        self = cls.__new__(cls)
        self.ingest_report = None
        opts = dict(meta["opts"])
        self._configure(**opts, device=device)
        self.delta = DeltaCSR.from_state(
            arrays, compact_frac=opts["compact_frac"],
            compactions=meta.get("compactions", 0))
        if self._defer_maintenance:
            self.delta.compact_frac = float("inf")
        self._counters = dict(meta["counters"])
        self.colors = np.asarray(arrays["colors"], np.int32)
        self.result = ColoringResult(
            self.colors.copy(), 0, 0, 0, True, "dynamic_sgr_restored")
        dirty = np.asarray(arrays["dirty"], np.int64)
        self._dirty = [dirty] if dirty.size else []
        # replay with journaling off (_configure left _journal=None): the
        # records being replayed are already on disk
        replayed = 0
        for rec in journal.records(after_seq=int(meta["seq"])):
            p = rec["payload"]
            if rec["kind"] == "delta":
                self.apply_delta(
                    add_vertices=p.get("add_vertices") or 0,
                    add_edges=_payload_edges(p.get("add_edges")),
                    remove_edges=_payload_edges(p.get("remove_edges")),
                    remove_vertices=p.get("remove_vertices"),
                )
            elif rec["kind"] == "recolor":
                self.recolor(full=bool(p.get("full")))
            replayed += 1
        self._journal = journal
        self._records_since_snapshot = replayed
        self.recovery = {
            "snapshot_seq": int(meta["seq"]),
            "replayed": replayed,
            "truncated": bool(getattr(journal, "truncated", False)),
        }
        return self

    # -- observability -------------------------------------------------------
    def metrics(self) -> dict:
        """Cumulative session counters since the cold colouring.

        Mutation batches (``deltas``) and the vertices they dirtied,
        committed, no-op and full recolors, summed frontier sizes, engine
        work items and super-steps, and the engine keys: ``repro`` counts a
        frontier recolor whose (shape, static-argument) key repeats an
        earlier one as a jit cache hit and a fresh key as a compile.  The
        port keeps the same key set, so ``engine_cache_hits`` and
        ``engine_cache_misses`` equal ``repro``'s; here they count keys
        presented, not compiles (the kernels take any shape).  Overlay
        state comes from the live ``DeltaCSR``.
        """
        out = dict(self._counters)
        out["overlay_size"] = int(self.delta.overlay_size)
        out["compactions"] = int(self.delta.compactions)
        out["n"] = int(self.n)
        out["num_colors"] = self.num_colors
        out["pending_frontier"] = int(self.frontier().size)
        if self._journal is not None:
            out["journal_seq"] = int(self._journal.seq)
            out["records_since_snapshot"] = int(self._records_since_snapshot)
        return out


@register("dynamic")
def color_dynamic(g: CSRGraph, **opts) -> ColoringResult:
    """Cold-start a ``ColoringSession`` on ``g`` and return its colouring:
    the colours of ``color(g, "fused", engine="ragged")``; keep the session
    itself (``open_session``) for streaming."""
    return ColoringSession(g, **opts).result
