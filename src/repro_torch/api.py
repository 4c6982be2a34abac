"""Public coloring API of the port (counterpart of ``repro.api``).

    import repro_torch
    result = repro_torch.color(g)                  # on the card
    result = repro_torch.color(g, device="cpu")    # plain versions, no card

Algorithms self-register with ``@register(name)``; the port registers
every algorithm ``repro`` has.  ``color_batch`` colours many graphs (the
batched engine for ``"fused"`` and ``"distance2"``), ``open_session``
opens a streaming session (``repro_torch.dynamic``).  ``engine="sharded",
devices=[...]`` colours one graph (or a batch) over several shards
(``repro_torch.core.distributed``).

Robustness knobs, as in ``repro``: ``validate_input=`` runs the ingest
front door (``repro_torch.ingest.sanitize_csr``) on a ``CSRGraph`` first,
and ``ensure_valid=True`` escalates an unconverged or invalid result
through the guarantee ladder (``repro_torch.core.guarantee``).  Both record
what they did on ``result.degradations``.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Iterable

from repro_torch.options import ColorOptions

if TYPE_CHECKING:
    from repro_torch.core.coloring import ColoringResult
    from repro_torch.core.csr import CSRGraph

__all__ = ["register", "color", "color_batch", "algorithms", "get_algorithm",
           "open_session", "ColorOptions"]

_REGISTRY: dict[str, Callable] = {}

# repro's algorithms that later slices port, with their ROADMAP items
_NOT_PORTED: dict[str, str] = {}


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
    import repro_torch.dynamic  # noqa: F401


def open_session(rows, cols=None, *, options: ColorOptions | None = None,
                 **opts):
    """Open a streaming ``ColoringSession`` (see ``repro_torch.dynamic``)."""
    from repro_torch.dynamic import open_session as _open_session

    return _open_session(rows, cols, options=options, **opts)


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


# the knobs the batched engine understands; everything else goes through
# the per-graph ``color`` path.  ``repro``'s set plus ``device``.
_BATCH_SUPPORTED = ("heuristic", "firstfit", "max_iters", "tail_serial",
                    "engine", "devices", "device", "backend", "trace",
                    "validate_input", "ensure_valid")


def color_batch(
    graphs: Iterable["CSRGraph"],
    algorithm: "str | ColorOptions | None" = None, *,
    options: ColorOptions | None = None, **opts
) -> "list[ColoringResult]":
    """Colour many graphs; the serving-path entry point.

    Options come as a ``ColorOptions`` or loose kwargs, as for ``color``;
    the default algorithm is ``"fused"``.  ``"fused"`` and ``"distance2"``
    run the batched engine (``repro_torch.core.batch``): the graphs are
    packed into one table and coloured in one loop of launches.  Any other
    name loops ``color`` over the graphs.  Knobs the batched engine cannot
    honor are refused by name.  ``device=`` defaults to ``"cuda"``;
    ``engine="sharded"`` places the batch over ``devices=``
    (``core.batch.color_batch_sharded``).  ``validate_input=`` and
    ``ensure_valid=`` act per graph, as in ``color``.
    """
    graphs = list(graphs)
    o = _normalize(algorithm, options, opts)
    algorithm = o.algorithm or "fused"
    if algorithm in ("fused", "distance2"):
        from repro_torch.core.batch import color_batch_fused, color_batch_sharded

        extra = o.extra_dict()
        devices = extra.pop("devices", None)
        extra.pop("device", None)
        if extra:
            raise ValueError(
                f"options {sorted(extra)} are not supported by the batched "
                f"fused engine (supported: {sorted(_BATCH_SUPPORTED)}); "
                f"use color(g, {algorithm!r}, ...) per graph instead"
            )
        pre = [()] * len(graphs)
        if o.validate_input is not None:
            from repro_torch.ingest import sanitize_csr

            sanitized = []
            for i, g in enumerate(graphs):
                g, report = sanitize_csr(g, policy=o.validate_input)
                sanitized.append(g)
                pre[i] = report.degradations()
            graphs = sanitized
        kw = o.engine_kwargs()
        kw.pop("engine", None)
        kw.pop("devices", None)
        engine = o.engine or "batch"
        if engine == "sharded":
            results = color_batch_sharded(
                graphs, distance2=(algorithm == "distance2"), devices=devices,
                **kw)
        elif engine != "batch":
            raise ValueError(
                f"unknown batch engine {engine!r}; options: batch, sharded"
            )
        elif devices is not None:
            raise ValueError(
                "devices= only applies to engine='sharded'; the default "
                "batched engine runs on one device (device=)"
            )
        else:
            results = color_batch_fused(
                graphs, distance2=(algorithm == "distance2"), **kw
            )
        for r, p in zip(results, pre):
            if p:
                r.degradations = tuple(p) + tuple(r.degradations)
        if o.ensure_valid:
            fn = get_algorithm(algorithm)
            results = [_apply_ladder(g, algorithm, fn, kw, r)
                       for g, r in zip(graphs, results)]
        return results
    per_graph = o.merged(algorithm=algorithm)
    return [color(g, options=per_graph) for g in graphs]
