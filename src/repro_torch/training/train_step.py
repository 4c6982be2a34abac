"""Train state and train step (the port of ``repro.training.train_step``).

``repro``'s state is a pytree ``{"params", "opt": {"m", "v"}, "step"}`` and
its step a pure function jitted with donated buffers.  The port's state
holds the ``Model`` itself (its ``nn.Parameter``s are the params), the
float32 moments keyed by parameter name and an int step; the step updates
them in place, which stands in for the donation.
"""
from __future__ import annotations

import dataclasses

from torch import nn

from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainState", "init_train_state", "make_train_step"]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt: dict            # {"m": {name: float32 tensor}, "v": {...}}
    step: int = 0

    @property
    def params(self) -> dict:
        """``{name: nn.Parameter}`` of the model, in its order."""
        return dict(self.model.named_parameters())


def init_train_state(model) -> TrainState:
    """Zero moments on the model's device for an initialised ``model``
    (``build_model`` draws the weights from its generator)."""
    return TrainState(model=model, opt=adamw_init(dict(model.named_parameters())))


def make_train_step(model, opt_cfg: AdamWConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)`` for a state
    of ``model``: ``Model.loss``, its backward, then ``adamw_update`` in
    place; the gradients are freed after the update.  ``metrics`` holds
    ``repro``'s keys (``ce``, ``lb_loss``, ``z_loss``, ``tokens``,
    ``grad_norm``, ``lr``, ``loss``) as 0-dim tensors, read by nobody until
    the caller asks, so a step waits for the device only where it must."""

    def train_step(state: TrainState, batch):
        if state.model is not model:
            raise ValueError("train_step was made for another model than the state's")
        model.zero_grad(set_to_none=True)
        with model.sharding_context():   # the backward recomputes blocks
            loss, metrics = model.loss(batch)
            loss.backward()
        params = state.params
        _, _, stats = adamw_update(params, {n: p.grad for n, p in params.items()},
                                   state.opt, state.step, opt_cfg)
        model.zero_grad(set_to_none=True)
        state.step += 1
        metrics = {**{k: v.detach() for k, v in metrics.items()}, **stats,
                   "loss": loss.detach()}
        return state, metrics

    return train_step
