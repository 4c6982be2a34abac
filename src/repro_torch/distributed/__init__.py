"""Placement rules and fault tolerance for training runs (the port of
``repro.distributed``): the resolver in
``repro_torch.distributed.sharding`` (``param_spec``, ``act_spec``,
``state_shardings``, ``batch_shardings``, ``cache_shardings``; a mesh is a
``DeviceMesh``, a placed tensor a ``DTensor``) and ``run_with_restarts``,
``reshard_state`` and ``install_preemption_handler`` in
``repro_torch.distributed.fault_tolerance``."""
from repro_torch.distributed.sharding import (
    act_spec,
    batch_shardings,
    cache_shardings,
    param_spec,
    state_shardings,
)

__all__ = [
    "param_spec",
    "act_spec",
    "batch_shardings",
    "cache_shardings",
    "state_shardings",
]
