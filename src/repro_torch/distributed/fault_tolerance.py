"""Fault tolerance and elasticity policy for training runs (the port of
``repro.distributed.fault_tolerance``).

* ``run_with_restarts`` — supervisor loop: run the training function, on any
  exception restore from the last checkpoint and continue, up to
  ``max_restarts``.  Combined with the stateless data pipeline (pure function
  of the step index) a restart reproduces the uninterrupted trajectory.
* ``reshard_state`` — elastic scaling: place a checkpointed state onto a NEW
  mesh (grow or shrink the fleet between restarts): ``state_shardings`` on
  that mesh, then ``restore_checkpoint(shardings=)``.
* ``install_preemption_handler`` — SIGTERM (a cloud preemption notice)
  triggers an immediate checkpoint.
"""
from __future__ import annotations

import signal
from typing import Callable

from repro_torch.distributed.sharding import state_shardings
from repro_torch.training.checkpoint import latest_step, restore_checkpoint

__all__ = ["run_with_restarts", "reshard_state", "install_preemption_handler"]


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


def reshard_state(ckpt_dir: str, step: int, state_like, new_mesh):
    """Elastic restore: place checkpoint ``step`` onto ``new_mesh``.
    ``state_like`` is a ``TrainState`` of the run's model (on any mesh or
    none); its leaves become ``DTensor``s placed by the resolver on
    ``new_mesh``, and it is returned."""
    return restore_checkpoint(ckpt_dir, step, state_like,
                              shardings=state_shardings(state_like, new_mesh))


def install_preemption_handler(save_fn: Callable[[], None]):
    """SIGTERM -> checkpoint immediately (cloud preemption notice)."""
    def handler(signum, frame):
        print("[ft] preemption signal received; checkpointing")
        save_fn()
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, handler)
