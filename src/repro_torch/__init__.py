"""repro_torch: the PyTorch and CUDA port of ``repro`` (csrcolor-jax).

Public entry points: ``repro_torch.color``, ``color_batch`` and
``open_session`` (lazy re-exports of ``repro_torch.api``), the
``ColoringService`` of ``repro_torch.launch.coloring_service``, and the
fault injectors of ``repro_torch.faultlab``.  They run on the card by default
(``device="cuda"``), through hand-written CUDA kernels for Hopper
(``csrc/``); ``device="cpu"`` runs their plain PyTorch versions.  The LM
stack's serving path is ``repro_torch.configs``, ``repro_torch.models`` and
``repro_torch.launch.serve_lm`` (plain PyTorch ops, on the card by default).
The package imports no JAX and nothing of ``repro``.  See README.md for what this slice covers.
"""

__version__ = "0.1.0"

_API_NAMES = ("color", "color_batch", "algorithms", "get_algorithm",
              "register", "open_session")
_OPTIONS_NAMES = ("ColorOptions",)
_ERROR_NAMES = ("ReproError", "IngestError", "CapacityError",
                "NonConvergenceError", "Overloaded", "SessionEvicted")
_SERVICE_NAMES = ("ColoringService",)


def __getattr__(name):
    # keep `import repro_torch` light: torch loads on first use only
    if name in _API_NAMES:
        from repro_torch import api

        return getattr(api, name)
    if name in _OPTIONS_NAMES:
        from repro_torch import options

        return getattr(options, name)
    if name in _ERROR_NAMES:
        from repro_torch import errors

        return getattr(errors, name)
    if name in _SERVICE_NAMES:
        from repro_torch.launch import coloring_service

        return getattr(coloring_service, name)
    if name == "faultlab":
        import importlib

        return importlib.import_module("repro_torch.faultlab")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_API_NAMES) + list(_OPTIONS_NAMES)
                  + list(_ERROR_NAMES) + list(_SERVICE_NAMES) + ["faultlab"])
