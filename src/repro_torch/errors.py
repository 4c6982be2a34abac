"""Structured errors of the port (counterpart of ``repro.errors``).

Only the classes the ported slices raise are here: the batched engine and
the streaming sessions raise these too.  ``Overloaded`` and
``SessionEvicted`` arrive with the service (ROADMAP A12).  ``IngestError``
lives here rather than beside ``IngestReport`` as in ``repro``: it only
reads the report it is given.
"""
from __future__ import annotations

__all__ = ["ReproError", "IngestError", "CapacityError", "NonConvergenceError"]


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
