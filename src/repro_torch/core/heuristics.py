"""Conflict-resolve policies (paper Alg. 5 and §3.2 heuristic).

A conflict is an edge whose endpoints share a color; exactly one endpoint
loses (is cleared and re-queued):

* ``id``     — the *smaller id* loses;
* ``degree`` — the *smaller degree* loses; on equal degrees the smaller id
               keeps its color (the larger loses).

Both rules are strict total orders, so every conflicting pair has exactly
one loser.
"""
from __future__ import annotations

import torch

__all__ = ["conflict_lose_flags", "conflict_lose_lanes", "HEURISTICS"]

HEURISTICS = ("id", "degree")


def conflict_lose_lanes(
    ids: torch.Tensor,           # (w,)   worklist vertex ids (sentinel n allowed)
    neigh_ids: torch.Tensor,     # (w, W) padded neighbor ids (sentinel n in pads)
    my_colors: torch.Tensor,     # (w,)   colors of ids (0 for sentinel)
    neigh_colors: torch.Tensor,  # (w, W) colors of neighbors (0 in pads)
    my_deg: torch.Tensor,        # (w,)
    neigh_deg: torch.Tensor,     # (w, W)
    heuristic: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-lane conflict masks ``(same, lose_lane)``.

    ``same`` marks lanes whose neighbor shares my nonzero color;
    ``lose_lane`` the subset whose neighbor beats me.  ``same & ~lose_lane``
    lanes are neighbors I beat, which the rotated super-step refits as if
    already cleared.
    """
    same = (neigh_colors == my_colors[:, None]) & (my_colors[:, None] > 0)
    if heuristic == "id":
        lose_lane = same & (ids[:, None] < neigh_ids)
    elif heuristic == "degree":
        dv = my_deg[:, None]
        lose_lane = same & (
            (neigh_deg > dv) | ((neigh_deg == dv) & (neigh_ids < ids[:, None]))
        )
    else:
        raise ValueError(f"unknown heuristic {heuristic!r}; options: {HEURISTICS}")
    return same, lose_lane


def conflict_lose_flags(ids, neigh_ids, my_colors, neigh_colors, my_deg,
                        neigh_deg, heuristic: str) -> torch.Tensor:
    """True where the worklist vertex loses a conflict and must recolor."""
    _, lose_lane = conflict_lose_lanes(
        ids, neigh_ids, my_colors, neigh_colors, my_deg, neigh_deg, heuristic)
    return lose_lane.any(dim=1)
