"""Fault tolerance policy for training runs (the port of
``repro.distributed.fault_tolerance``).

* ``run_with_restarts`` — supervisor loop: run the training function, on any
  exception restore from the last checkpoint and continue, up to
  ``max_restarts``.  Combined with the stateless data pipeline (pure function
  of the step index) a restart reproduces the uninterrupted trajectory.
* ``install_preemption_handler`` — SIGTERM (a cloud preemption notice)
  triggers an immediate checkpoint.

``repro``'s ``reshard_state`` (restore a checkpoint onto a new mesh) needs
the sharding rules of ``repro.distributed.sharding``, which the port does
not have yet; it is left out until they are ported.
"""
from __future__ import annotations

import signal
from typing import Callable

from repro_torch.training.checkpoint import latest_step

__all__ = ["run_with_restarts", "install_preemption_handler"]


def run_with_restarts(
    run_fn: Callable[[int], dict],
    *,
    ckpt_dir: str,
    max_restarts: int = 3,
) -> dict:
    """Run ``run_fn(start_step)``; on failure, restart from the checkpoint.

    ``run_fn`` must checkpoint to ``ckpt_dir`` itself (see launch/train.py)
    and accept the step to resume from.
    """
    attempts = 0
    while True:
        start = latest_step(ckpt_dir) or 0
        try:
            return run_fn(start)
        except Exception:
            attempts += 1
            if attempts > max_restarts:
                raise
            print(f"[ft] failure (attempt {attempts}/{max_restarts}); "
                  f"restarting from step {latest_step(ckpt_dir) or 0}")


def install_preemption_handler(save_fn: Callable[[], None]):
    """SIGTERM -> checkpoint immediately (cloud preemption notice)."""
    def handler(signum, frame):
        print("[ft] preemption signal received; checkpointing")
        save_fn()
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, handler)
