"""Fault-injection harness for the robustness layer (port of
``repro.faultlab``).

Every guarantee is only as good as the test that breaks it on purpose.
This module holds the breakage: small, deterministic injectors that
corrupt exactly one invariant each, so ``tests/test_torch_faultlab.py``
can assert that (a) the matching detector fires and (b) the matching
recovery path restores a valid coloring.

Injectors
---------

``corrupt_colors``
    Context manager that patches the ``repro_torch.api`` algorithm registry so
    every run's returned colors are corrupted *after* the engine finishes
    (a deterministic subset of vertices copies a neighbor's color —
    guaranteed monochromatic edges).  Models a device-memory fault or a
    bad kernel landing between the super-step and the commit.  Detector:
    ``is_valid_coloring`` / the ``ensure_valid=True`` ladder.

``poison_halo_words``
    Pure function that flips a deterministic subset of packed
    ``id << 16 | color`` halo words into garbage (negative words,
    out-of-range ids, corrupt colors).  Models a torn halo exchange.
    Detector: ``repro_torch.ingest.check_halo_words``.

``truncate_journal``
    Tears the tail of a durable session's write-ahead journal — either
    mid-record (a crash half-way through a ``write``) or by appending a
    record whose CRC cannot match.  Detector: ``SessionJournal.records``
    stops at the tear and ``ColoringSession.restore`` reports
    ``recovery["truncated"] = True`` while still restoring the last
    consistent state.

``starved_opts``
    The forced-non-convergence scenario: engine options (one iteration,
    no serial tail) under which the speculative engines cannot converge
    on any graph with conflicts.  Recovery: the guarantee ladder
    (``ensure_valid=True`` / ``on_fail="ladder"``).

``ADVERSARIAL_GRAPHS``
    The shared corpus of malformed CSR inputs (asymmetric, self-loops,
    duplicates, unsorted rows, negative / out-of-range indices, broken
    indptr, empty) used by both the ingest tests and the differential
    engine × backend matrix.  Each entry maps a name to raw
    ``(row_offsets, col_indices)`` arrays — *raw*, because building a
    ``CSRGraph`` through the normal constructors would fix them.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np

__all__ = [
    "corrupt_colors",
    "poison_halo_words",
    "truncate_journal",
    "starved_opts",
    "ADVERSARIAL_GRAPHS",
]


# --------------------------------------------------------------------------
# scenario 1: colors corrupted between engine and commit
# --------------------------------------------------------------------------

def _corrupt(g, colors: np.ndarray, fraction: float, seed: int) -> np.ndarray:
    """Copy a neighbor's color onto a deterministic vertex subset.

    Touched vertices with at least one neighbor are guaranteed to sit on a
    monochromatic edge afterwards, so the corruption is always *detectable*
    (never a silently-still-valid perturbation).
    """
    out = np.asarray(colors, dtype=np.int32).copy()
    n = g.n
    if n == 0:
        return out
    rng = np.random.default_rng(seed)
    k = max(1, int(fraction * n))
    victims = rng.choice(n, size=min(k, n), replace=False)
    R, C = g.row_offsets, g.col_indices
    for v in victims:
        lo, hi = R[v], R[v + 1]
        if hi > lo:
            out[v] = out[C[lo]]  # first neighbor's color: conflict by design
    return out


@contextmanager
def corrupt_colors(fraction: float = 0.05, seed: int = 0):
    """Patch the algorithm registry: every result's colors come back corrupt.

    The engine runs untouched; corruption lands on the *result*, modeling a
    fault between the device computation and the host commit.  Restores the
    registry on exit, even on error.
    """
    from repro_torch import api

    api._ensure_registered()
    saved = dict(api._REGISTRY)

    def wrap(fn):
        def corrupted(g, **opts):
            result = fn(g, **opts)
            result.colors = _corrupt(g, result.colors, fraction, seed)
            return result

        return corrupted

    try:
        for name, fn in saved.items():
            api._REGISTRY[name] = wrap(fn)
        yield
    finally:
        api._REGISTRY.clear()
        api._REGISTRY.update(saved)


# --------------------------------------------------------------------------
# scenario 2: poisoned packed halo words
# --------------------------------------------------------------------------

def poison_halo_words(words: np.ndarray, n: int, *, fraction: float = 0.1,
                      seed: int = 0) -> np.ndarray:
    """Flip a deterministic subset of packed halo words into garbage.

    Three poison flavors, round-robin over the victims: a negative word
    (bit-flipped sign), an out-of-range vertex id (``>= n``), and a color
    field larger than any proper coloring of ``n`` vertices can produce.
    All three are exactly what ``repro``'s ``check_halo_words`` rejects.
    """
    words = np.asarray(words, dtype=np.int32).copy()
    if words.size == 0:
        return words
    rng = np.random.default_rng(seed)
    k = max(1, int(fraction * words.size))
    victims = rng.choice(words.size, size=min(k, words.size), replace=False)
    for i, v in enumerate(victims):
        flavor = i % 3
        if flavor == 0:
            words[v] = np.int32(-1)
        elif flavor == 1:
            words[v] = np.int32(((n + 1 + i) << 16) | 1)
        else:
            words[v] = np.int32((0 << 16) | min(n + 1 + i, 0xFFFF))
    return words


# --------------------------------------------------------------------------
# scenario 3: torn write-ahead journal
# --------------------------------------------------------------------------

def truncate_journal(durable_dir: str, *, mode: str = "tear",
                     records: int = 1) -> int:
    """Damage the tail of a durable session's journal; returns bytes removed.

    ``mode="tear"`` cuts the file mid-way through the final record — the
    classic crash-during-write artifact (the last line fails to parse).
    ``mode="drop"`` removes the last ``records`` complete records — a crash
    after the engine ran but before the journal flush reached the disk.
    ``mode="garbage"`` appends a record-shaped line whose CRC is wrong — a
    bit-rotted tail.  All three must stop replay at the last good record.
    """
    import os

    from repro_torch.dynamic.journal import JOURNAL_NAME

    path = os.path.join(str(durable_dir), JOURNAL_NAME)
    with open(path, "rb") as f:
        data = f.read()
    lines = data.splitlines(keepends=True)
    if mode == "tear":
        if not lines:
            return 0
        cut = max(1, len(lines[-1]) // 2)
        with open(path, "wb") as f:
            f.write(data[: len(data) - cut])
        return cut
    if mode == "drop":
        keep = lines[: max(0, len(lines) - records)]
        with open(path, "wb") as f:
            f.writelines(keep)
        return len(data) - sum(len(line) for line in keep)
    if mode == "garbage":
        junk = (b'{"seq": 999999, "kind": "delta", "payload": {}, '
                b'"crc": 12345}\n')
        with open(path, "ab") as f:
            f.write(junk)
        return -len(junk)
    raise ValueError(f"unknown mode {mode!r}; options: tear, drop, garbage")


# --------------------------------------------------------------------------
# scenario 4: forced non-convergence
# --------------------------------------------------------------------------

def starved_opts() -> dict:
    """Engine options under which speculation cannot finish: one super-step,
    no serial tail.  Any graph with at least one conflict after the first
    speculative round leaves the run unconverged — the deterministic
    trigger for the guarantee ladder."""
    return {"max_iters": 1, "tail_serial": False}


# --------------------------------------------------------------------------
# shared adversarial-input corpus (raw CSR arrays — deliberately malformed)
# --------------------------------------------------------------------------

def _adversarial_graphs() -> dict:
    i64 = np.int64
    i32 = np.int32
    return {
        # vertex 0 lists 1, but 1 does not list 0
        "asymmetric": (np.array([0, 1, 1, 1], i64), np.array([1], i32)),
        # 0-1 edge plus a 0-0 self loop
        "self_loop": (np.array([0, 2, 3], i64), np.array([0, 1, 0], i32)),
        # 0 lists 1 twice
        "dup_edge": (np.array([0, 2, 3], i64), np.array([1, 1, 0], i32)),
        # negative column index
        "negative_index": (np.array([0, 2, 3], i64), np.array([-1, 1, 0], i32)),
        # column index >= n
        "out_of_range": (np.array([0, 2, 3], i64), np.array([1, 5, 0], i32)),
        # row 1's neighbor list is unsorted (valid edges, wrong order)
        "unsorted_row": (np.array([0, 2, 4, 6], i64),
                         np.array([1, 2, 2, 0, 0, 1], i32)),
        # indptr decreases mid-way
        "nonmonotone_indptr": (np.array([0, 2, 1, 3], i64),
                               np.array([1, 2, 0], i32)),
        # empty graph: n = 0, m = 0 — must sail through untouched
        "empty": (np.array([0], i64), np.array([], i32)),
    }


ADVERSARIAL_GRAPHS = _adversarial_graphs()
