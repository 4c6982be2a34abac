"""``DeltaCSR`` — a batched mutation overlay over the host CSR graph
(port of ``repro.dynamic.delta``; host numpy, the same arrays).

CSR is the wrong structure to mutate in place (a row's length change shifts
every later offset), so mutations accumulate in an *overlay* against an
immutable compacted base:

* the base is a ``CSRGraph`` plus its sorted directed-edge key array
  ``(u << 32) | v`` (int64) — row-sorted CSR makes the keys sorted for free;
* ``_add`` holds keys present now but absent from the base,
  ``_del`` keys present in the base but deleted since — both sorted, both
  disjoint from each other, with ``_add ∩ base = ∅`` and ``_del ⊆ base``
  as maintained invariants, so the current edge set is always
  ``(base ∖ _del) ∪ _add`` and every membership question is a vectorized
  ``O(Δ log m)`` sorted-array operation;
* ``compact()`` folds the overlay back into a fresh base and fires
  automatically once the overlay outgrows ``compact_frac`` of the base.

The set operations are ``repro``'s, computed by binary search over the
sorted base instead of ``np.isin``/``setdiff1d``/``union1d``, which sort
the whole base on every call: the snapshot a recolor reads is a delete and
an insert at searched positions, O(m) with no sort (on the card machine's
host ``repro``'s form took 10.6 s a churn round on rmat-g at 2^20, PERF.md
§5).  The arrays are the same: the base is sorted and unique, ``_del`` a
sorted subset of it, ``_add`` sorted and disjoint from it.

Mutations are **batched and vectorized**: each call takes edge *arrays*
(symmetrized, self-loops dropped, duplicates ignored) and returns the vertex
ids whose neighborhoods actually changed — the dirty frontier the
``ColoringSession`` recolors.  Adding an edge that already exists, or
removing one that doesn't, is a no-op and dirties nobody.

Vertex semantics keep ids stable (colors are indexed by vertex id, so
renumbering would invalidate every frozen color): ``add_vertices`` appends
isolated vertices at the end of the id space, ``remove_vertices`` deletes
all incident edges and leaves the slot behind as an isolated (degree-0)
vertex.  The id space therefore only grows; compaction never renumbers.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import CSRGraph, _gather_ragged

__all__ = ["DeltaCSR"]

_LO32 = np.int64(0xFFFFFFFF)
_EMPTY_KEYS = np.zeros(0, np.int64)
_EMPTY_IDS = np.zeros(0, np.int32)


def _graph_keys(g: CSRGraph) -> np.ndarray:
    """Sorted directed-edge keys of a CSR graph (sorted rows => sorted keys)."""
    src, dst = g.edges()
    return (src.astype(np.int64) << 32) | dst.astype(np.int64)


def _ends(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return (keys >> 32), (keys & _LO32)


def _member(sorted_keys: np.ndarray, k: np.ndarray) -> np.ndarray:
    """``np.isin(k, sorted_keys)`` for a sorted unique ``sorted_keys``, by
    binary search: O(len(k) log m), where ``np.isin`` sorts both arrays."""
    if sorted_keys.size == 0:
        return np.zeros(k.shape, bool)
    idx = np.minimum(np.searchsorted(sorted_keys, k), sorted_keys.size - 1)
    return sorted_keys[idx] == k


def _clean_pairs(src, dst, n: int) -> np.ndarray:
    """Unique symmetrized directed keys of an edge batch (self-loops dropped)."""
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    if src.shape != dst.shape:
        raise ValueError(
            f"edge batch endpoint arrays differ in length: "
            f"{src.shape[0]} vs {dst.shape[0]}")
    if src.size == 0:
        return _EMPTY_KEYS
    lo = min(int(src.min()), int(dst.min()))
    hi = max(int(src.max()), int(dst.max()))
    if lo < 0 or hi >= n:
        raise ValueError(
            f"edge endpoint out of range [0, {n}): saw {lo if lo < 0 else hi}")
    keep = src != dst
    src, dst = src[keep], dst[keep]
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    return np.unique((u << 32) | v)


class DeltaCSR:
    """Mutable graph = immutable CSR base + sorted add/delete key overlay."""

    def __init__(self, base: CSRGraph, *, compact_frac: float = 0.25,
                 validate_input: str | None = None):
        self.ingest_report = None
        if validate_input is not None:
            # the ingest front door: overlay invariants (sorted keys, symmetry,
            # no dups/loops) inherit from the base — a dirty base corrupts
            # every later membership query, so sanitize it on the way in
            from repro_torch.ingest import sanitize_csr

            base, self.ingest_report = sanitize_csr(
                base, policy=validate_input)
        self._base = base
        self._base_keys = _graph_keys(base)
        self._n = base.n
        self._add = _EMPTY_KEYS
        self._del = _EMPTY_KEYS
        self._cache: CSRGraph | None = base
        self.compact_frac = float(compact_frac)
        self.compactions = 0

    @classmethod
    def from_edges(cls, n: int, src, dst, **kw) -> "DeltaCSR":
        from repro_torch.core.csr import csr_from_edges

        return cls(csr_from_edges(n, src, dst), **kw)

    # -- durable state (session checkpoints) ---------------------------------
    def state_arrays(self) -> dict:
        """The full mutable state as named numpy arrays (snapshot format)."""
        return {
            "base_row_offsets": self._base.row_offsets.astype(np.int64),
            "base_col_indices": self._base.col_indices.astype(np.int32),
            "add_keys": self._add,
            "del_keys": self._del,
            "delta_n": np.asarray(self._n, np.int64),
        }

    @classmethod
    def from_state(cls, arrays: dict, *, compact_frac: float = 0.25,
                   compactions: int = 0) -> "DeltaCSR":
        """Rebuild a ``DeltaCSR`` from ``state_arrays()`` output."""
        base = CSRGraph(
            np.asarray(arrays["base_row_offsets"], np.int64),
            np.asarray(arrays["base_col_indices"], np.int32))
        d = cls(base, compact_frac=compact_frac)
        d._add = np.asarray(arrays["add_keys"], np.int64)
        d._del = np.asarray(arrays["del_keys"], np.int64)
        d._n = int(arrays["delta_n"])
        d.compactions = int(compactions)
        if d._add.size or d._del.size or d._n != base.n:
            d._cache = None
        return d

    # -- current-state views -------------------------------------------------
    @property
    def n(self) -> int:
        return self._n

    @property
    def m(self) -> int:
        """Current directed edge count (2x undirected)."""
        return self._base_keys.size - self._del.size + self._add.size

    @property
    def overlay_size(self) -> int:
        return self._add.size + self._del.size

    def _current_keys(self) -> np.ndarray:
        kept = self._base_keys
        if self._del.size:  # _del is a sorted subset of the base
            kept = np.delete(kept, np.searchsorted(kept, self._del))
        if self._add.size == 0:
            return kept
        # disjoint sorted sets: insert each added key at its sorted place
        return np.insert(kept, np.searchsorted(kept, self._add), self._add)

    def graph(self) -> CSRGraph:
        """The current graph as a (cached) host CSRGraph snapshot.

        The snapshot object is reused until the next mutation, so device
        views memoized on it (``_graph_device_cache``) survive across
        recolor calls on a quiet graph.
        """
        if self._cache is None:
            cur = self._current_keys()
            src, dst = _ends(cur)
            counts = np.bincount(src, minlength=self._n)
            row_offsets = np.zeros(self._n + 1, np.int64)
            np.cumsum(counts, out=row_offsets[1:])
            self._cache = CSRGraph(row_offsets, dst.astype(np.int32))
        return self._cache

    def compact(self) -> CSRGraph:
        """Fold the overlay into a fresh base; returns the compacted graph."""
        g = self.graph()
        if self.overlay_size or g is not self._base:
            self._base = g
            self._base_keys = _graph_keys(g)
            self._add = _EMPTY_KEYS
            self._del = _EMPTY_KEYS
            self.compactions += 1
        return self._base

    def compaction_due(self, frac: float | None = None) -> bool:
        """True once the overlay outgrows ``frac`` of the base (cheap poll).

        ``frac`` defaults to the live ``compact_frac``; a pooled session
        sets ``compact_frac=inf`` to suppress the inline compaction
        and polls this with its CONFIGURED fraction from an idle slot.
        """
        frac = self.compact_frac if frac is None else frac
        return self.overlay_size > frac * max(self._base_keys.size, 64)

    def _touched(self) -> None:
        self._cache = None
        if self.compaction_due():
            self.compact()

    # -- batched mutations (each returns the dirtied vertex ids) -------------
    def add_vertices(self, count: int) -> np.ndarray:
        """Append ``count`` isolated vertices; returns their (new) ids."""
        count = int(count)
        if count < 0:
            raise ValueError(f"cannot add {count} vertices")
        from repro_torch.ingest import INDEX_MAX

        if self._n + count > INDEX_MAX:
            raise ValueError(
                f"adding {count} vertices would push n past the int32 "
                f"index capacity ({INDEX_MAX}); colors and worklists are "
                "int32 device arrays")
        ids = np.arange(self._n, self._n + count, dtype=np.int32)
        if count:
            self._n += count
            self._cache = None  # id space grew; edge overlay unchanged
        return ids

    def add_edges(self, src, dst) -> np.ndarray:
        """Insert an undirected edge batch; returns ids that gained neighbors."""
        k = _clean_pairs(src, dst, self._n)
        if k.size == 0:
            return _EMPTY_IDS
        in_base = _member(self._base_keys, k)
        in_del = _member(self._del, k)
        in_add = _member(self._add, k)
        new = ~((in_base & ~in_del) | in_add)
        if not new.any():
            return _EMPTY_IDS
        self._del = np.setdiff1d(self._del, k[new & in_del], assume_unique=True)
        self._add = np.union1d(self._add, k[new & ~in_base])
        self._touched()
        return np.unique(k[new] >> 32).astype(np.int32)

    def remove_edges(self, src, dst) -> np.ndarray:
        """Delete an undirected edge batch; returns ids that lost neighbors."""
        k = _clean_pairs(src, dst, self._n)
        if k.size == 0:
            return _EMPTY_IDS
        in_base = _member(self._base_keys, k)
        in_del = _member(self._del, k)
        in_add = _member(self._add, k)
        gone = (in_base & ~in_del) | in_add
        if not gone.any():
            return _EMPTY_IDS
        self._del = np.union1d(self._del, k[gone & in_base])
        self._add = np.setdiff1d(self._add, k[gone & in_add], assume_unique=True)
        self._touched()
        return np.unique(k[gone] >> 32).astype(np.int32)

    def remove_vertices(self, ids) -> np.ndarray:
        """Drop every edge incident to ``ids`` (slots stay, as isolated ids).

        Returns the dirtied ids: the removed vertices AND their ex-neighbors
        (whose neighborhoods shrank).
        """
        ids = np.unique(np.asarray(ids, dtype=np.int64).ravel())
        if ids.size == 0:
            return _EMPTY_IDS
        if ids[0] < 0 or ids[-1] >= self._n:
            raise ValueError(
                f"vertex id out of range [0, {self._n}): saw "
                f"{ids[0] if ids[0] < 0 else ids[-1]}")
        # directed keys with src ∈ ids: base rows (minus deletions) + overlay
        old = ids[ids < self._base.n]
        lens = (self._base.row_offsets[old + 1]
                - self._base.row_offsets[old]).astype(np.int64)
        nbr = _gather_ragged(self._base.row_offsets, self._base.col_indices,
                             old).astype(np.int64)
        base_inc = (np.repeat(old, lens) << 32) | nbr
        base_inc = np.setdiff1d(base_inc, self._del, assume_unique=True)
        add_inc = self._add[np.isin(self._add >> 32, ids)]
        inc = np.union1d(base_inc, add_inc)
        if inc.size == 0:
            return _EMPTY_IDS
        u, v = _ends(inc)
        partners = (v << 32) | u  # the symmetric halves stored under v's row
        all_inc = np.union1d(inc, partners)
        self._del = np.union1d(self._del,
                               all_inc[_member(self._base_keys, all_inc)])
        self._add = np.setdiff1d(self._add, all_inc, assume_unique=True)
        self._touched()
        # dirty = ids that actually lost edges + their ex-neighbors; edge-less
        # members of ``ids`` were no-ops and dirty nobody (u ⊆ ids by
        # construction — they are the incident keys' source endpoints)
        return np.union1d(np.unique(u), np.unique(v)).astype(np.int32)
