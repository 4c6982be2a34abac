"""Capacity budgets of the packed gather word (from ``repro.ingest``).

The validating front door (``sanitize_csr``) arrives with ROADMAP item A10;
this slice needs only the packed-gather budget.
"""
from __future__ import annotations

__all__ = ["PACKED_GATHER_MAX_DEG", "packed_gather_ok"]

# The packed gather fuses colors and degrees into one int32 word
# ``color | deg << 16``: the degree must fit 15 bits and the color 16.
# Greedy colors are bounded by ``dmax + 1``, so the engine gates on
# ``dmax < 2^15 - 1`` (the -1 keeps ``dmax + 1`` colors inside the budget).
PACKED_GATHER_MAX_DEG = 2**15 - 1


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
