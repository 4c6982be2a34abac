"""The port's coloring engine: CSR storage, FirstFit, conflict rules, the
data-driven engines (single-device, batched and sharded), the paper's
baselines (serial, topology-driven, JP, multi-hash, three-step), and the
host-side oracle and validators.

Re-exports ``repro.core.__all__``, in its order.  The names load on first
use (``from repro_torch.core import color_jp``), so importing one submodule
does not import them all.
"""
import importlib

_EXPORTS = {
    "CSRGraph": "csr",
    "DeviceCSR": "csr",
    "DeviceGraph": "csr",
    "GraphBatch": "batch",
    "PartitionedCSR": "csr",
    "auto_tile_thresholds": "csr",
    "csr_from_edges": "csr",
    "next_pow2": "csr",
    "ColoringResult": "coloring",
    "color_data_driven": "coloring",
    "color_distributed": "distributed",
    "color_fused": "coloring",
    "color_batch_fused": "batch",
    "color_batch_sharded": "batch",
    "SessionBatch": "batch",
    "open_session_batch": "batch",
    "batched_ragged_step": "batch",
    "batched_sgr_step": "batch",
    "color_topology": "topo",
    "color_jp": "jp",
    "color_multihash": "jp",
    "color_threestep": "threestep",
    "color_serial": "serial",
    "greedy_serial": "serial",
    "is_valid_coloring": "validate",
    "num_colors": "validate",
    "quality_report": "validate",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f"repro_torch.core.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + __all__)
