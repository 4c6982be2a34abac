"""Trace rings and the host-side ``RunTrace`` record (port of
``repro.obs.trace``).

Engines called with ``trace=True`` record one row per super-step and
attach a ``RunTrace`` as ``ColoringResult.trace``.  The rows are
``repro``'s, field for field; only where they are kept differs:

* **Trace ring** - ``repro``'s fused drivers thread a ``(cap, NF)`` int32
  buffer through their ``lax.while_loop`` and write one row per step at
  ``step % cap``, keeping the last ``cap`` rows.  The port's loops are host
  loops; they keep their rows in a ring of the same capacity (``HostRing``
  semantics: the last ``cap`` rows, every row counted), and ``ring_init``
  makes the device buffer for a caller that wants one.  ``trace=False``
  runs exactly the untraced code: no row, no extra host sync.
* **``RunTrace``** - the record attached as ``ColoringResult.trace``: the
  retained rows in step order, the total step count, the engine label and
  the phase spans captured while the engine ran.  ``check()`` verifies the
  structural invariants below.

Row schema (``TRACE_FIELDS``, one int64 per field after assembly):

``live``        worklist entries entering the step (the bootstrap row
                carries the initial worklist; a tail row the surviving
                live worklist it drains, not the full-graph charge a
                stall-serialization pays).
``retired``     entries that left the worklist this step (``live -
                conflicts``).
``conflicts``   entries detected as needing recolor (the next worklist).
``max_color``   maximum color in use after the step.
``cells``       gather cells dispatched this step (``lanes x tile width``).
``tail``        1 on the serial-tail step, else 0.
``halo_bytes``  bytes of boundary colors a device received this step
                (sharded engine; 0 on single-device engines).
``imbalance``   max-minus-min per-shard live count (sharded; 0 otherwise).

Invariants (``RunTrace.check``):

* ``retired + conflicts == live`` on every row; tail rows retire their
  whole worklist (``conflicts == 0``).
* worklist continuity: ``conflicts[i] == live[i + 1]``.
* with no ring drops and a converged run, ``sum(retired) == live[0]``.
* ``sum(cells) == ColoringResult.padded_work`` on the single-graph engines.
"""
from __future__ import annotations

import dataclasses
import sys
from collections import deque

import numpy as np

__all__ = [
    "TRACE_FIELDS",
    "NF",
    "DEFAULT_TRACE_CAP",
    "HostRing",
    "RunTrace",
    "resolve_trace_cap",
    "ring_init",
    "ring_rows",
    "assemble_trace",
    "empty_trace",
]

TRACE_FIELDS = ("live", "retired", "conflicts", "max_color", "cells",
                "tail", "halo_bytes", "imbalance")
NF = len(TRACE_FIELDS)
DEFAULT_TRACE_CAP = 512

_LIVE, _RETIRED, _CONFLICTS, _MAXC, _CELLS, _TAIL = range(6)


def resolve_trace_cap(trace, max_iters: int | None = None) -> int:
    """Ring capacity from the ``trace`` knob: 0 = off.

    ``trace`` is ``False``/``True`` (default capacity) or a positive int
    (explicit capacity).  ``max_iters`` bounds the ring — no point holding
    more rows than the engine can ever take steps.
    """
    if trace is False or trace is None:
        return 0
    if trace is True:
        cap = DEFAULT_TRACE_CAP
    else:
        cap = int(trace)
        if cap <= 0:
            return 0
    if max_iters is not None:
        # +2 leaves room for the bootstrap and tail rows the host appends
        cap = min(cap, int(max_iters) + 2)
    return max(cap, 1)


def ring_init(cap: int, device="cpu"):
    """A fresh device-side trace ring: ``(cap, NF)`` int32 zeros on
    ``device``."""
    import torch

    return torch.zeros((cap, NF), dtype=torch.int32, device=device)


def ring_rows(buf, steps: int) -> np.ndarray:
    """Retained rows of a ring buffer in step order (a numpy array or a
    torch tensor, read once).

    ``steps`` rows were written at positions ``s % cap``; the retained
    window is the last ``min(steps, cap)`` of them.
    """
    if hasattr(buf, "cpu"):
        buf = buf.cpu().numpy()
    buf = np.asarray(buf)
    cap = buf.shape[0]
    steps = int(steps)
    if steps <= 0:
        return buf[:0]
    first = max(0, steps - cap)
    idx = [s % cap for s in range(first, steps)]
    return buf[idx]


class HostRing:
    """Drop-oldest row accumulator for host-loop drivers.

    Keeps the most recent ``cap`` rows and counts every row, the retention
    of ``repro``'s device ring, so every driver assembles the same
    ``RunTrace``.  A field may be a 0-d torch tensor still on the device
    (the port's engines pass ``colors_ext.max()`` enqueued at that step):
    ``rows()`` reads all of them at once, so a traced loop takes one host
    sync for its whole trace rather than one a step.
    """

    def __init__(self, cap: int):
        self.cap = int(cap)
        self._rows: deque = deque(maxlen=self.cap)
        self.recorded = 0

    def append(self, live, retired, conflicts, max_color, cells, tail=0,
               halo_bytes=0, imbalance=0) -> None:
        self._rows.append((live, retired, conflicts, max_color, cells, tail,
                           halo_bytes, imbalance))
        self.recorded += 1

    def rows(self) -> np.ndarray:
        if not self._rows:
            return np.zeros((0, NF), dtype=np.int64)
        rows = list(self._rows)
        torch = sys.modules.get("torch")  # no tensor exists without it
        if torch is not None:
            pending = [v for r in rows for v in r if torch.is_tensor(v)]
            if pending:
                read = iter(torch.stack(pending).tolist())
                rows = [tuple(next(read) if torch.is_tensor(v) else v for v in r)
                        for r in rows]
        return np.asarray(rows, dtype=np.int64)


@dataclasses.dataclass
class RunTrace:
    """Per-super-step telemetry of one engine run (``ColoringResult.trace``)."""

    steps: np.ndarray                 # (S, NF) int64, step order
    iterations: int                   # rows recorded (>= S when ring wrapped)
    engine: str = ""
    cap: int = DEFAULT_TRACE_CAP
    spans: list = dataclasses.field(default_factory=list)  # SpanEvent list
    schema: int = 1

    @property
    def fields(self) -> tuple:
        return TRACE_FIELDS

    @property
    def dropped(self) -> int:
        """Rows the ring overwrote (0 unless the run outran the capacity)."""
        return self.iterations - int(self.steps.shape[0])

    def series(self, field: str) -> np.ndarray:
        return self.steps[:, TRACE_FIELDS.index(field)]

    @property
    def tail_step(self) -> int:
        """Absolute step index of the serial-tail row, or -1 when no tail ran."""
        tails = np.flatnonzero(self.steps[:, _TAIL])
        if tails.size == 0:
            return -1
        return int(tails[0]) + self.dropped

    def check(self, result=None) -> list:
        """Structural-invariant violations (empty list = trace is coherent)."""
        bad: list = []
        s = self.steps.astype(np.int64)
        if s.shape[0] == 0:
            if self.iterations != 0:
                bad.append(f"{self.iterations} steps recorded but no rows kept")
            return bad
        if np.any(s[:, (_LIVE, _RETIRED, _CONFLICTS, _CELLS)] < 0):
            bad.append("negative live/retired/conflicts/cells entry")
        tail = s[:, _TAIL]
        if np.any((tail != 0) & (tail != 1)):
            bad.append("tail flag not in {0, 1}")
        if np.any(s[tail == 1, _CONFLICTS] != 0):
            bad.append("tail row with conflicts != 0")
        if np.any(s[:, _RETIRED] + s[:, _CONFLICTS] != s[:, _LIVE]):
            bad.append("retired + conflicts != live on some row")
        if np.any(s[:-1, _CONFLICTS] != s[1:, _LIVE]):
            bad.append("worklist continuity broken: conflicts[i] != live[i+1]")
        if self.dropped == 0 and s[-1, _CONFLICTS] == 0:
            if int(s[:, _RETIRED].sum()) != int(s[0, _LIVE]):
                bad.append(
                    f"retired sum {int(s[:, _RETIRED].sum())} != initial "
                    f"worklist {int(s[0, _LIVE])}")
        if result is not None and self.dropped == 0:
            cells = int(s[:, _CELLS].sum())
            padded = int(getattr(result, "padded_work", cells))
            if cells > padded:
                bad.append(f"cells sum {cells} > padded_work {padded}")
        return bad

    def to_dict(self) -> dict:
        return {
            "schema": self.schema,
            "engine": self.engine,
            "fields": list(TRACE_FIELDS),
            "iterations": int(self.iterations),
            "dropped": int(self.dropped),
            "tail_step": self.tail_step,
            "steps": self.steps.astype(int).tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "RunTrace":
        steps = np.asarray(d.get("steps", []), dtype=np.int64)
        if steps.size == 0:
            steps = np.zeros((0, NF), dtype=np.int64)
        return cls(steps=steps, iterations=int(d.get("iterations", 0)),
                   engine=d.get("engine", ""), schema=int(d.get("schema", 1)))

    def summary(self, max_points: int = 64) -> dict:
        """The compact BENCH schema-6 record: headline counters + series.

        Series longer than ``max_points`` are truncated from the front
        (the interesting dynamics — tail trigger, convergence — live at
        the end); ``series_from`` records the first retained step.
        """
        s = self.steps
        start = max(0, s.shape[0] - max_points)
        out = {
            "supersteps": int(self.iterations),
            "tail_step": self.tail_step,
            "series_from": start + self.dropped,
            "live": s[start:, _LIVE].astype(int).tolist(),
            "retired": s[start:, _RETIRED].astype(int).tolist(),
            "conflicts": s[start:, _CONFLICTS].astype(int).tolist(),
            "max_color": s[start:, _MAXC].astype(int).tolist(),
            "cells": s[start:, _CELLS].astype(int).tolist(),
        }
        halo = self.series("halo_bytes")
        if s.shape[0] and halo.any():
            out["halo_bytes"] = halo[start:].astype(int).tolist()
            out["imbalance"] = (
                self.series("imbalance")[start:].astype(int).tolist())
        return out


def empty_trace(engine: str = "") -> RunTrace:
    """The trace of a zero-step run (empty graphs, no-op recolors)."""
    return RunTrace(steps=np.zeros((0, NF), dtype=np.int64), iterations=0,
                    engine=engine)


def assemble_trace(rows, recorded: int, cap: int, engine: str) -> RunTrace:
    """``RunTrace`` from in-order row tuples, keeping the last ``cap``.

    ``recorded`` counts every step the engine took (>= len(rows) when a
    device ring already wrapped); host-side retention then drops the oldest
    surplus so the kept window is contiguous and ends at the final step.
    """
    rows = [tuple(int(v) for v in r) for r in rows]
    kept = rows[-cap:] if cap else rows
    steps = (np.asarray(kept, dtype=np.int64) if kept
             else np.zeros((0, NF), dtype=np.int64))
    return RunTrace(steps=steps, iterations=int(recorded), engine=engine,
                    cap=int(cap))
