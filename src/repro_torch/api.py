"""Public coloring API of the port (counterpart of ``repro.api``).

    import repro_torch
    result = repro_torch.color(g)                  # on the card
    result = repro_torch.color(g, device="cpu")    # plain versions, no card

Algorithms self-register with ``@register(name)``.  The port registers
``data_driven``, ``fused``, ``distance2`` and ``bipartite``; the names
``repro`` has beyond them raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
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
_NOT_PORTED = {
    "serial": "A5", "topology": "A5", "jp": "A5",
    "multihash": "A5", "threestep": "A5", "dynamic": "A9",
}


def register(name: str):
    """Registry decorator: ``@register("data_driven")`` on a ``(g, **opts)`` adapter."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY and _REGISTRY[name] is not fn:
            raise ValueError(f"algorithm {name!r} registered twice")
        _REGISTRY[name] = fn
        return fn

    return deco


def _ensure_registered() -> None:
    import repro_torch.core.coloring  # noqa: F401  (runs @register)
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
    """
    o = _normalize(algorithm, options, opts)
    if o.validate_input is not None or o.ensure_valid:
        raise NotImplementedError(
            "validate_input= and ensure_valid= (ingest and the guarantee "
            "ladder) are not ported yet (ROADMAP A10)")
    fn = get_algorithm(o.algorithm or "data_driven")
    return fn(graph, **o.engine_kwargs())
