"""Structured errors of the port (counterpart of ``repro.errors``).

Every class of ``repro.errors``: the engines, the batched engine and the
streaming sessions raise the first four, the coloring service
(``repro_torch.launch.coloring_service``) ``Overloaded`` and
``SessionEvicted``.  ``IngestError`` lives here rather than beside
``IngestReport`` as in ``repro``: it only reads the report it is given.
"""
from __future__ import annotations

__all__ = ["ReproError", "IngestError", "CapacityError", "NonConvergenceError",
           "Overloaded", "SessionEvicted"]


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


class IngestError(ReproError, ValueError):
    """The ingest front door (``repro_torch.ingest.sanitize_csr``) refused a
    malformed CSR under its strict policy; ``.report`` carries the
    structured ``IngestReport``.  Still a ``ValueError``, as in ``repro``.
    """

    def __init__(self, report):
        self.report = report
        super().__init__(report.summary())

    def _fields(self) -> dict:
        return {"issues": dict(self.report.issues),
                "repairs": [[a, int(c)] for a, c in self.report.repairs]}


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


class Overloaded(ReproError):
    """Admission-control rejection: the bounded request queue is full.

    The service's backpressure contract: a queue at its limit rejects
    *immediately* with this structured error instead of growing without
    bound.  ``retry_after`` is a coarse hint (seconds) derived from the
    service's recent drain rate.
    """

    def __init__(self, message: str, *, queue_depth: int, limit: int,
                 retry_after: float = 0.0):
        super().__init__(message)
        self.queue_depth = int(queue_depth)
        self.limit = int(limit)
        self.retry_after = float(retry_after)

    def _fields(self) -> dict:
        return {"queue_depth": self.queue_depth, "limit": self.limit,
                "retry_after": self.retry_after}


class SessionEvicted(ReproError, LookupError):
    """The addressed pooled session was LRU-evicted without durable spill.

    Its in-memory state is gone and there is no journal to resurrect it
    from; the client must re-open the session (services opened with a
    ``spill_dir`` restore evicted sessions transparently instead of
    raising this).
    """

    def __init__(self, message: str, *, session_id=None):
        super().__init__(message)
        self.session_id = session_id

    def _fields(self) -> dict:
        return {"session_id": self.session_id}
