"""Observability (port of ``repro.obs``): trace rings, phase spans,
exporters.

* ``obs.trace``  - the ``RunTrace`` record every engine attaches as
  ``ColoringResult.trace`` when called with ``trace=True``
  (``trace=False`` runs the untraced code unchanged).
* ``obs.spans``  - host-side monotonic-clock phase spans, with the first
  dispatch of each engine key told apart from warm ones.
* ``obs.export`` / ``obs.report`` - Chrome-trace (Perfetto-loadable) JSON
  export and the text reporter (``python -m repro_torch.obs.report``).
"""
from .export import chrome_trace, export_chrome_trace
from .report import format_metrics, format_result, format_spans, format_trace
from .spans import SpanEvent, SpanRecorder, jit_span, recorder, span
from .trace import (
    DEFAULT_TRACE_CAP,
    NF,
    TRACE_FIELDS,
    HostRing,
    RunTrace,
    assemble_trace,
    empty_trace,
    resolve_trace_cap,
    ring_init,
    ring_rows,
)

__all__ = [
    "TRACE_FIELDS",
    "NF",
    "DEFAULT_TRACE_CAP",
    "HostRing",
    "RunTrace",
    "assemble_trace",
    "empty_trace",
    "resolve_trace_cap",
    "ring_init",
    "ring_rows",
    "SpanEvent",
    "SpanRecorder",
    "recorder",
    "span",
    "jit_span",
    "chrome_trace",
    "export_chrome_trace",
    "format_result",
    "format_trace",
    "format_spans",
    "format_metrics",
]
