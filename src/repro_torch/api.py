"""Public coloring API of the port (counterpart of ``repro.api``).

    import repro_torch
    result = repro_torch.color(g)                  # on the card
    result = repro_torch.color(g, device="cpu")    # plain versions, no card

Algorithms self-register with ``@register(name)``.  The port registers
every algorithm ``repro`` has but ``dynamic``, which raises
``NotImplementedError`` naming the ROADMAP item that ports it (A9).

Robustness knobs, as in ``repro``: ``validate_input=`` runs the ingest
front door (``repro_torch.ingest.sanitize_csr``) on a ``CSRGraph`` first,
and ``ensure_valid=True`` escalates an unconverged or invalid result
through the guarantee ladder (``repro_torch.core.guarantee``).  Both record
what they did on ``result.degradations``.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable

from repro_torch.options import ColorOptions

if TYPE_CHECKING:
    from repro_torch.core.coloring import ColoringResult
    from repro_torch.core.csr import CSRGraph

__all__ = ["register", "color", "algorithms", "get_algorithm", "ColorOptions"]

_REGISTRY: dict[str, Callable] = {}

# repro's algorithms that later slices port, with their ROADMAP items
_NOT_PORTED = {"dynamic": "A9"}


def register(name: str):
    """Registry decorator: ``@register("data_driven")`` on a ``(g, **opts)`` adapter."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY and _REGISTRY[name] is not fn:
            raise ValueError(f"algorithm {name!r} registered twice")
        _REGISTRY[name] = fn
        return fn

    return deco


def _ensure_registered() -> None:
    # importing the modules runs their @register decorators
    import repro_torch.core.coloring  # noqa: F401
    import repro_torch.core.jp  # noqa: F401
    import repro_torch.core.serial  # noqa: F401
    import repro_torch.core.threestep  # noqa: F401
    import repro_torch.core.topo  # noqa: F401
    import repro_torch.d2  # noqa: F401


def algorithms() -> tuple[str, ...]:
    """Sorted names of every registered coloring algorithm."""
    _ensure_registered()
    return tuple(sorted(_REGISTRY))


def get_algorithm(name: str) -> Callable:
    """The registered adapter for ``name``.

    Raises ``NotImplementedError`` for a ``repro`` algorithm not ported yet
    and ``ValueError`` for an unknown name.
    """
    _ensure_registered()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet (ROADMAP {_NOT_PORTED[name]})")
    raise ValueError(
        f"unknown algorithm {name!r}; registered: {', '.join(sorted(_REGISTRY))}")


def _normalize(algorithm, options, opts) -> ColorOptions:
    """One ``ColorOptions`` from (positional algorithm | options, kwargs)."""
    if isinstance(algorithm, ColorOptions):
        if options is not None:
            raise TypeError(
                "pass ColorOptions positionally OR as options=, not both")
        options, algorithm = algorithm, None
    return ColorOptions.normalize(options, algorithm=algorithm, **opts)


def color(graph: "CSRGraph", algorithm: "str | ColorOptions | None" = None,
          *, options: ColorOptions | None = None, **opts) -> "ColoringResult":
    """Color ``graph`` with the named algorithm (default ``"data_driven"``).

    Returns a ``ColoringResult`` whose ``colors`` is a host int32 array in
    ``[1, num_colors]``.  Options come as a ``ColorOptions`` or as loose
    kwargs.  ``device=`` defaults to ``"cuda"`` and raises without a card;
    ``device="cpu"`` runs the kernels' plain versions.

    ``validate_input="strict"`` raises ``IngestError`` with a structured
    report on a defective ``CSRGraph`` (asymmetry, self-loops, duplicates,
    unsorted rows, bad indices, broken indptr); ``"repair"`` fixes it and
    records every action on ``result.degradations``.  ``ensure_valid=True``
    guarantees a coloring valid under the algorithm's conflict relation:
    an unconverged or corrupt run is escalated through the ladder (reseed,
    full iteration budget, serialize the survivors, serial oracle), every
    rung taken recorded on ``result.degradations`` and as a
    ``guarantee_ladder`` span.  The ladder's reruns keep the caller's
    ``device``.
    """
    o = _normalize(algorithm, options, opts)
    algorithm = o.algorithm or "data_driven"
    fn = get_algorithm(algorithm)
    engine_opts = o.engine_kwargs()
    pre = ()
    if o.validate_input is not None:
        from repro_torch.core.csr import CSRGraph as _CSR
        from repro_torch.ingest import sanitize_csr

        if not isinstance(graph, _CSR):
            raise TypeError(
                "validate_input= applies to CSRGraph inputs; got "
                f"{type(graph).__name__} (sanitize bipartite halves with "
                "sanitize_csr(..., require_symmetric=False) directly)")
        graph, report = sanitize_csr(graph, policy=o.validate_input)
        pre = report.degradations()
    result = fn(graph, **engine_opts)
    if pre:
        result.degradations = pre + tuple(result.degradations)
    if o.ensure_valid:
        result = _apply_ladder(graph, algorithm, fn, engine_opts, result)
    return result


def _apply_ladder(graph, algorithm: str, fn: Callable, opts: dict, result):
    """Escalate ``result`` through the guarantee ladder (see ``color``)."""
    from repro_torch.core.guarantee import (
        ensure_valid_result,
        rung_options,
        square_graph,
    )
    from repro_torch.obs.spans import SpanRecorder

    if algorithm == "bipartite":
        cg = graph.column_conflict_graph()
    elif algorithm == "distance2":
        cg = square_graph(graph)
    else:
        cg = graph

    def rerun(rung):
        return fn(graph, **rung_options(opts, rung))

    if result.trace is not None:
        # ladder spans land on the run's own trace even without a user
        # recorder (an outer recorder still sees them)
        with SpanRecorder() as rec:
            out = ensure_valid_result(cg, result, rerun)
        if out.trace is not None and rec.events:
            out.trace.spans = list(out.trace.spans or []) + rec.events
        return out
    return ensure_valid_result(cg, result, rerun)
