"""Validating CSR ingest and the packed-word capacity budgets (port of
``repro.ingest``).

Every engine trusts its CSR input: sorted rows, symmetry, and the bit
budget of the packed ``color | deg << 16`` gather word.  ``sanitize_csr``
checks all of it up front and either refuses with a structured report
(``policy="strict"``) or repairs (symmetrize, deduplicate, strip
self-loops, drop out-of-range columns, re-sort rows), recording every
action taken:

    g, report = sanitize_csr(rows, cols, policy="repair")
    color(g, device="cpu")              # engines now run on contract input

or, through the API:

    color(g, validate_input="strict")   # raise IngestError on any defect
    color(g, validate_input="repair")   # fix + record on result.degradations

Host numpy, a copy of ``repro.ingest``: the same input gives the same graph
and the same report.  ``pack_halo_words`` / ``unpack_halo_words`` are the
host mirror of the sharded engine's ``id << 16 | color`` halo word
(``core/distributed.py``), and ``check_halo_words`` finds the words that
cannot be legitimate (the detector of ``faultlab.poison_halo_words``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.errors import IngestError

__all__ = [
    "IngestError",
    "IngestReport",
    "sanitize_csr",
    "packed_halo_ok",
    "packed_gather_ok",
    "pack_halo_words",
    "unpack_halo_words",
    "check_halo_words",
    "PACKED_HALO_MAX_N",
    "PACKED_GATHER_MAX_DEG",
    "INDEX_MAX",
]

# The packed gather fuses colors and degrees into one int32 word
# ``color | deg << 16``: the degree must fit 15 bits and the color 16.
# Greedy colors are bounded by ``dmax + 1``, so the engine gates on
# ``dmax < 2^15 - 1`` (the -1 keeps ``dmax + 1`` colors inside the budget).
PACKED_GATHER_MAX_DEG = 2**15 - 1

# the sharded engine's halo word ``id << 16 | color`` needs ids in 15 bits
PACKED_HALO_MAX_N = 2**15

# vertex ids and edge counts live in int32 device arrays everywhere
INDEX_MAX = 2**31 - 1


def packed_halo_ok(n: int) -> bool:
    """True iff the packed halo word can represent every (id, color)."""
    return 0 <= int(n) < PACKED_HALO_MAX_N


def packed_gather_ok(dmax: int, color_bound: int | None = None) -> bool:
    """True iff the packed-gather word can hold (color, degree).

    ``color_bound`` (when known) must fit the 16-bit color field with the
    same margin the degree field gets; omitted means colors are
    degree-bounded (static coloring).
    """
    if not 0 <= int(dmax) < PACKED_GATHER_MAX_DEG:
        return False
    if color_bound is not None and not 0 <= int(color_bound) < PACKED_GATHER_MAX_DEG:
        return False
    return True


def pack_halo_words(ids: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """Host mirror of the halo packing: ``id << 16 | color`` (int32)."""
    ids = np.asarray(ids, dtype=np.int64)
    colors = np.asarray(colors, dtype=np.int64)
    return ((ids << 16) | colors).astype(np.int32)


def unpack_halo_words(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of ``pack_halo_words``: ``(ids, colors)`` int32 arrays."""
    words = np.asarray(words, dtype=np.int32)
    return (words >> 16).astype(np.int32), (words & 0xFFFF).astype(np.int32)


def check_halo_words(words: np.ndarray, n: int) -> np.ndarray:
    """Indices of halo words that cannot be legitimate ``(id, color)`` pairs.

    A well-formed word unpacks to ``0 <= id <= n`` (``n`` is the inert
    sentinel the exchange pads with) and ``0 <= color <= n`` (greedy colors
    never exceed the vertex count), and the sentinel carries color 0.
    Anything else (a negative word, whose sign bit an id >= 2^15 set, an
    out-of-range id, an impossible color) is poison.
    """
    ids, colors = unpack_halo_words(words)
    words = np.asarray(words, dtype=np.int32)
    bad = (words < 0) | (ids > n) | (colors > n) | ((ids == n) & (colors != 0))
    return np.nonzero(bad)[0].astype(np.int64)


# --------------------------------------------------------------------------
# structured report
# --------------------------------------------------------------------------

@dataclasses.dataclass
class IngestReport:
    """What ``sanitize_csr`` found (and, under ``repair``, what it did).

    ``issues`` maps defect kind to occurrence count; ``repairs`` is the
    ordered ``(action, count)`` log of fixes applied (empty under
    ``strict`` or on clean input); ``hazards`` records capacity facts that
    are not defects but disable packed fast paths (the engines consult the
    same predicates and fall back to unpacked arithmetic).
    """

    n: int
    m: int
    policy: str
    issues: dict = dataclasses.field(default_factory=dict)
    repairs: tuple = ()
    hazards: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.issues

    def summary(self) -> str:
        if self.ok:
            return f"clean CSR (n={self.n}, m={self.m})"
        parts = ", ".join(f"{k}={v}" for k, v in sorted(self.issues.items()))
        fixed = (" — repaired: "
                 + ", ".join(f"{a}({c})" for a, c in self.repairs)
                 if self.repairs else "")
        return f"CSR defects (n={self.n}, m={self.m}): {parts}{fixed}"

    def degradations(self) -> tuple:
        """The repair log as ``ColoringResult.degradations`` entries."""
        return tuple(
            {"stage": "ingest_repair", "action": action, "count": int(count)}
            for action, count in self.repairs
        )


# --------------------------------------------------------------------------
# sanitize_csr
# --------------------------------------------------------------------------

def _row_ids(row_offsets: np.ndarray, m: int) -> np.ndarray:
    """Source vertex per CSR slot, from (already monotone) offsets."""
    counts = np.diff(row_offsets)
    return np.repeat(np.arange(counts.shape[0], dtype=np.int64), counts)


def sanitize_csr(graph_or_offsets, col_indices=None, *,
                 policy: str = "strict",
                 require_symmetric: bool = True) -> tuple["CSRGraph", IngestReport]:
    """Validate (and optionally repair) a CSR graph for the engines.

    Accepts a ``CSRGraph`` or raw ``(row_offsets, col_indices)`` arrays.
    Detects: non-monotone / mis-anchored indptr, negative and out-of-range
    column indices, self-loops, duplicate edges, unsorted rows, asymmetry
    (unless ``require_symmetric=False`` — bipartite halves are directed),
    and int32 index-capacity overflow (never repairable).

    ``policy="strict"``  — raise ``IngestError`` carrying an
    ``IngestReport`` when any defect is present.
    ``policy="repair"``  — rebuild a clean graph (drop bad columns, strip
    self-loops, symmetrize, deduplicate, sort rows), recording every action
    in ``report.repairs``.  Repairing a clean graph returns it unchanged.

    Packed-word capacity *hazards* are recorded on ``report.hazards`` in
    both policies; they are legal inputs (the engines fall back to unpacked
    arithmetic), not defects.  ``packed_halo_ok`` is the halo-word budget,
    ``n < 2^15``: past it the sharded engine ships ``(id, colour)`` pairs.
    """
    from repro_torch.core.csr import CSRGraph, csr_from_edges

    if policy not in ("strict", "repair"):
        raise ValueError(f"unknown policy {policy!r}; options: strict, repair")
    if isinstance(graph_or_offsets, CSRGraph):
        if col_indices is not None:
            raise TypeError("pass either a CSRGraph or raw arrays, not both")
        row_offsets = np.asarray(graph_or_offsets.row_offsets)
        cols = np.asarray(graph_or_offsets.col_indices)
        original = graph_or_offsets
    else:
        row_offsets = np.asarray(graph_or_offsets)
        cols = np.asarray(col_indices)
        original = None
    if row_offsets.ndim != 1 or cols.ndim != 1 or row_offsets.shape[0] < 1:
        raise IngestError(IngestReport(
            n=0, m=int(cols.size), policy=policy,
            issues={"indptr_shape": 1}))
    if not (np.issubdtype(row_offsets.dtype, np.integer)
            and np.issubdtype(cols.dtype, np.integer)):
        raise IngestError(IngestReport(
            n=max(int(row_offsets.shape[0]) - 1, 0), m=int(cols.size),
            policy=policy, issues={"non_integer_dtype": 1}))

    n = int(row_offsets.shape[0]) - 1
    m = int(cols.shape[0])
    report = IngestReport(n=n, m=m, policy=policy)
    issues = report.issues

    # -- capacity: int32 index space (unrepairable — refuse in BOTH policies)
    if n > INDEX_MAX or m > INDEX_MAX:
        issues["index_overflow"] = 1
        raise IngestError(report)

    offsets = row_offsets.astype(np.int64)
    # -- indptr structure
    diffs = np.diff(offsets)
    nonmono = int((diffs < 0).sum())
    if nonmono:
        issues["indptr_nonmonotone"] = nonmono
    if offsets[0] != 0:
        issues["indptr_first_nonzero"] = 1
    if offsets[-1] != m:
        issues["indptr_last_mismatch"] = 1
    if (offsets.clip(0, m) != offsets).any():
        issues.setdefault("indptr_out_of_range",
                          int(((offsets < 0) | (offsets > m)).sum()))

    # a usable monotone offset view for per-row analysis (repair view; also
    # used to *localise* defects when the raw indptr is broken)
    fixed_offsets = np.maximum.accumulate(offsets.clip(0, m))
    fixed_offsets[0] = 0
    if fixed_offsets[-1] != m:
        # rows cannot account for every column slot; the trailing slots are
        # treated as belonging to the last row for repair purposes
        fixed_offsets[-1] = m
        fixed_offsets = np.maximum.accumulate(fixed_offsets)

    cols64 = cols.astype(np.int64)
    neg = int((cols64 < 0).sum())
    oob = int((cols64 >= n).sum())
    if neg:
        issues["col_negative"] = neg
    if oob:
        issues["col_out_of_range"] = oob

    src = _row_ids(fixed_offsets, m)
    in_range = (cols64 >= 0) & (cols64 < n)
    vsrc, vdst = src[in_range], cols64[in_range]
    loops = int((vsrc == vdst).sum())
    if loops:
        issues["self_loop"] = loops
    keep = vsrc != vdst
    esrc, edst = vsrc[keep], vdst[keep]
    keys = (esrc << 32) | edst
    sorted_keys = np.sort(keys)
    dups = int((sorted_keys[1:] == sorted_keys[:-1]).sum())
    if dups:
        issues["duplicate_edge"] = dups
    # unsorted rows: a decreasing adjacent pair *within* a row (use the raw
    # columns so the defect is observed exactly as the engines would)
    if m > 1:
        same_row = src[1:] == src[:-1]
        unsorted = int((same_row & (cols64[1:] < cols64[:-1])).sum())
        if unsorted:
            issues["row_unsorted"] = unsorted
    if require_symmetric and keys.size:
        uniq = np.unique(keys)
        rev = ((uniq & 0xFFFFFFFF) << 32) | (uniq >> 32)
        asym = int((~np.isin(rev, uniq)).sum())
        if asym:
            issues["asymmetric"] = asym

    # -- packed-word capacity hazards (facts, not defects)
    deg = np.diff(fixed_offsets)
    dmax = int(deg.max(initial=0))
    report.hazards = {
        "packed_halo_ok": packed_halo_ok(n),
        "packed_gather_ok": packed_gather_ok(dmax),
        "max_degree": dmax,
    }

    if not issues:
        clean = original if original is not None else CSRGraph(
            offsets, cols.astype(np.int32))
        return clean, report

    if policy == "strict":
        raise IngestError(report)

    # -- repair: rebuild from the surviving edge list
    repairs = []
    if ("indptr_nonmonotone" in issues or "indptr_first_nonzero" in issues
            or "indptr_last_mismatch" in issues
            or "indptr_out_of_range" in issues):
        repairs.append(("rebuilt_indptr", nonmono
                        + issues.get("indptr_first_nonzero", 0)
                        + issues.get("indptr_last_mismatch", 0)))
    if neg or oob:
        repairs.append(("dropped_out_of_range", neg + oob))
    if loops:
        repairs.append(("stripped_self_loops", loops))
    if dups:
        repairs.append(("deduplicated", dups))
    if issues.get("row_unsorted"):
        repairs.append(("sorted_rows", issues["row_unsorted"]))
    if issues.get("asymmetric"):
        repairs.append(("symmetrized", issues["asymmetric"]))
    clean = csr_from_edges(n, esrc, edst,
                           symmetrize=require_symmetric, dedup=True)
    report.repairs = tuple(repairs)
    report.hazards["max_degree"] = clean.max_degree
    report.hazards["packed_gather_ok"] = packed_gather_ok(clean.max_degree)
    return clean, report
