"""Chromatic scheduling: turn a coloring into conflict-free parallel phases
(port of ``repro.core.scheduling``).

This is the paper's motivating use case ("coloring is used to identify
subtasks that can be carried out simultaneously", §1) made into a framework
feature:

* ``phases``            — vertex groups per color: tasks in one phase touch no
                          shared edge and may run concurrently.
* ``schedule_quality``  — average parallelism the schedule exposes (the reason
                          fewer colors matter: parallelism = n / #colors).
* ``all_to_all_rounds`` — edge-color the all-to-all device communication graph
                          with the coloring engine: each round is a set of
                          disjoint (src, dst) transfers, the classical
                          collective-scheduling application.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.coloring import color_data_driven
from repro_torch.core.csr import csr_from_edges
from repro_torch.core.validate import num_colors

__all__ = ["phases", "schedule_quality", "all_to_all_rounds"]


def phases(colors: np.ndarray) -> list[np.ndarray]:
    colors = np.asarray(colors)
    return [
        np.nonzero(colors == c)[0].astype(np.int32)
        for c in range(1, num_colors(colors) + 1)
    ]


def schedule_quality(colors: np.ndarray) -> dict:
    ph = phases(colors)
    sizes = np.array([p.size for p in ph]) if ph else np.zeros(1)
    return {
        "phases": len(ph),
        "mean_parallelism": float(sizes.mean()),
        "min_parallelism": int(sizes.min(initial=0)),
        "critical_path": len(ph),
    }


def all_to_all_rounds(n_devices: int, **color_kwargs) -> list[list[tuple[int, int]]]:
    """Schedule a full all-to-all among ``n_devices`` into conflict-free rounds.

    Transfers (i, j), i != j, conflict iff they share an endpoint (each link
    endpoint sends/receives once per round).  We build the line graph of the
    complete directed communication graph and color it with the paper's
    engine; color classes are the rounds.  Optimal is n_devices - 1 rounds
    (round-robin); greedy coloring typically lands within ~2x.

    ``repro`` ignores ``color_kwargs``; the port takes ``device=`` from them
    (where the engine runs: ``None`` means the card) and ignores the rest.
    """
    pairs = [(i, j) for i in range(n_devices) for j in range(n_devices) if i != j]
    index = {p: k for k, p in enumerate(pairs)}
    src_list, dst_list = [], []
    for (i, j), k in index.items():
        for (a, b), l in index.items():
            if l <= k:
                continue
            # conflict: same sender or same receiver in one round
            if a == i or b == j:
                src_list.append(k)
                dst_list.append(l)
    line_graph = csr_from_edges(len(pairs), np.array(src_list), np.array(dst_list))
    res = color_data_driven(line_graph, heuristic="degree",
                            device=color_kwargs.get("device"))
    rounds: list[list[tuple[int, int]]] = [[] for _ in range(res.num_colors)]
    for p, c in zip(pairs, res.colors):
        rounds[c - 1].append(p)
    return rounds
