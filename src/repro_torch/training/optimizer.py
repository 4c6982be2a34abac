"""AdamW + cosine schedule + global-norm clipping (the port of
``repro.training.optimizer``).

Moments are kept in float32 whatever the parameter's dtype; the step is
computed in float32 (the ``weight_decay * p`` term inside it) and cast back,
in ``repro``'s order of operations.  The update runs in place, one leaf at a
time under ``torch.no_grad``, so a 4.4 B-parameter state fits on one card:
that stands in for ``repro``'s donated buffers.  ``torch.optim.AdamW`` is not
used: it keeps its moments in the parameter's dtype, decays the weights in a
separate multiply and has no global-norm clip in the step.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(step, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), a float32 scalar
    on the CPU: linear warm-up, then a cosine down to ``min_lr_ratio``."""
    step = torch.as_tensor(step).to(torch.float32).cpu()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: dict) -> dict:
    """Zero float32 moments ``{"m": {name: t}, "v": {name: t}}`` on each
    parameter's device."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": {n: zeros32(p) for n, p in params.items()},
            "v": {n: zeros32(p) for n, p in params.items()}}


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of the float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict, step,
                 cfg: AdamWConfig):
    """One AdamW step over ``params`` (``{name: tensor}``), in place.

    ``grads`` maps the same names to gradients (``None`` counts as zeros,
    as a leaf the loss does not reach has a zero gradient in ``repro``);
    ``opt_state`` is ``adamw_init``'s, updated in place.  Returns
    ``(params, opt_state, {"grad_norm", "lr"})``, the first two the objects
    passed in, as ``repro`` returns new ones."""
    grads = {n: (g if g is not None else torch.zeros_like(params[n]))
             for n, g in grads.items()}
    gnorm = _global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = cosine_lr(step, cfg)
    t = torch.as_tensor(step).to(torch.float32).cpu() + 1.0
    # float32 scalars, as ``repro`` computes them; each is exact as a float
    bc1 = float(1.0 - cfg.b1 ** t)
    bc2 = float(1.0 - cfg.b2 ** t)
    lr_f = float(lr)

    for name, p in params.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        g = grads[name].float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        step_ = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        step_.add_(cfg.weight_decay * p.float())
        new = p.float() - lr_f * step_
        del step_
        p.copy_(new)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
