"""End-to-end training driver (the port of ``repro.launch.train``).

Synthetic data pipeline, AdamW, checkpoint/restart with ``--resume auto``,
periodic metrics, on one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --reduced --steps 20 --device cpu

``--device`` defaults to ``cuda``; a full configuration runs on the card.
``train_loop(mesh=)`` trains on a ``DeviceMesh`` (the process group up on
every rank): the state and each batch are placed by the resolver
(``repro_torch.distributed.sharding``) and every step runs on ``DTensor``s.
As in ``repro``, the CLI has no mesh flag.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.sharding import (
    batch_shardings,
    distribute,
    place_state,
    state_shardings,
)
from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.models import build_model
from repro_torch.models.layers import is_dtensor
from repro_torch.training import AdamWConfig, init_train_state, make_train_step
from repro_torch.training.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.training.data import SyntheticData

__all__ = ["train_loop", "main"]


def train_loop(
    cfg,
    *,
    steps: int,
    batch_size: int,
    seq_len: int,
    lr: float = 3e-4,
    ckpt_dir: str | None = None,
    ckpt_every: int = 100,
    resume: bool = False,
    log_every: int = 10,
    seed: int = 0,
    fail_at_step: int | None = None,
    device=None,
    mesh=None,
) -> dict:
    """Returns summary metrics. ``fail_at_step`` injects a crash (FT tests).

    ``device=None`` means ``"cuda"`` (and raises without a card); the
    weights come from a generator on that device seeded with ``seed``.
    ``mesh`` (a ``DeviceMesh`` of that device type, on every rank) places
    the state by ``state_shardings`` (a resume restores onto it) and each
    batch by ``batch_shardings``.  The model is built without the mesh, as
    ``repro``'s ``train_loop`` builds it, so the activation constraints are
    off in training."""
    dev = resolve_backend(None, device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for training on {dev}")
    model = build_model(cfg, dev, generator=torch.Generator(device=dev).manual_seed(seed))
    opt_cfg = AdamWConfig(peak_lr=lr, warmup_steps=min(50, steps // 10 + 1),
                          total_steps=steps)
    data = SyntheticData.for_model(cfg, batch_size, seq_len, seed=seed)

    state = init_train_state(model)
    start_step = 0
    if resume and ckpt_dir and (last := latest_step(ckpt_dir)) is not None:
        shardings = state_shardings(state, mesh) if mesh is not None else None
        state = restore_checkpoint(ckpt_dir, last, state, shardings=shardings)
        start_step = last
        print(f"[train] resumed from step {last}")

    step_fn = make_train_step(model, opt_cfg)
    batch_sh = None
    if mesh is not None:
        place_state(state, state_shardings(state, mesh))
        batch_sh = batch_shardings(data.batch(0), mesh)
    losses, grad_norms = [], []
    t0 = time.time()
    for step in range(start_step, steps):
        if fail_at_step is not None and step == fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        batch = data.batch(step)
        if batch_sh is not None:
            batch = distribute({k: torch.as_tensor(v, device=dev) for k, v in batch.items()},
                               batch_sh)
        state, metrics = step_fn(state, batch)
        if (step + 1) % log_every == 0 or step == steps - 1:
            loss = _scalar(metrics["loss"])
            losses.append(loss)
            grad_norms.append(_scalar(metrics["grad_norm"]))
            print(
                f"[train] step {step + 1}/{steps} loss={loss:.4f} "
                f"ce={_scalar(metrics['ce']):.4f} "
                f"gnorm={grad_norms[-1]:.3f} "
                f"lr={float(metrics['lr']):.2e}",
                flush=True,
            )
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, state)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    return {
        "final_loss": losses[-1] if losses else None,
        "first_loss": losses[0] if losses else None,
        "losses": losses,
        "grad_norms": grad_norms,
        "steps": steps - start_step,
        "wall_s": dt,
    }


def _scalar(t) -> float:
    """A 0-dim metric on the host (a ``DTensor`` one gathered first)."""
    return float(t.full_tensor() if is_dtensor(t) else t)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", choices=("auto", "never"), default="never")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    summary = train_loop(
        cfg,
        steps=args.steps,
        batch_size=args.batch,
        seq_len=args.seq,
        lr=args.lr,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        resume=args.resume == "auto",
        seed=args.seed,
        device=args.device,
    )
    print(json.dumps({k: v for k, v in summary.items() if k not in ("losses", "grad_norms")}))
    return summary


if __name__ == "__main__":
    main()
