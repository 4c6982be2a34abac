"""Structured errors of the port (counterpart of ``repro.errors``).

Only the classes the ported slices raise are here; the rest of the error
surface (``IngestError``, ``Overloaded``, ``SessionEvicted``) arrives with
ROADMAP item A10.
"""
from __future__ import annotations

__all__ = ["ReproError", "CapacityError", "NonConvergenceError"]


class ReproError(Exception):
    """Base of every structured error the port raises.

    ``payload()`` renders the exception as a JSON-safe dict; subclasses add
    fields through ``_fields()``.
    """

    def _fields(self) -> dict:
        return {}

    def payload(self) -> dict:
        out = {"error": type(self).__name__, "message": str(self)}
        out.update(self._fields())
        return out


class CapacityError(ReproError, ValueError):
    """A packed fast path or a kernel cannot hold its operands.

    The packed ``color | deg << 16`` word has a hard bit budget
    (``repro_torch.ingest.PACKED_GATHER_MAX_DEG``); the engine refuses past
    it rather than silently corrupting colors.
    """


class NonConvergenceError(ReproError, RuntimeError, ValueError):
    """A speculative run exhausted its iteration budget without converging
    and the caller asked for a refusal (``on_fail="raise"``).  Inherits both
    legacy bases of ``repro``'s class: its dynamic engine raised
    ``RuntimeError`` here, its bipartite compressor ``ValueError``.
    """
