"""Streaming dynamic-graph colouring (port of ``repro.dynamic``).

``DeltaCSR`` (batched edge and vertex inserts and deletes as an overlay
over the CSR base, with periodic compaction), ``ColoringSession``
(incremental recolouring of the dirty frontier, every other colour fixed)
and ``SessionJournal`` (write-ahead journal and snapshots).  Registered as
algorithm ``"dynamic"``.
"""
from repro_torch.dynamic.churn import churn_delta
from repro_torch.dynamic.delta import DeltaCSR
from repro_torch.dynamic.session import ColoringSession, color_dynamic, open_session

__all__ = ["ColoringSession", "DeltaCSR", "churn_delta", "color_dynamic",
           "open_session"]
