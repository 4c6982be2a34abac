"""Fault tolerance for training runs (the port of ``repro.distributed``):
``run_with_restarts`` and ``install_preemption_handler`` in
``repro_torch.distributed.fault_tolerance``.  ``repro``'s sharding rules
(``distributed/sharding.py``) and ``reshard_state`` are not ported yet."""
