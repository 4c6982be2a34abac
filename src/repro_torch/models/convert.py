"""Carry a ``repro`` parameter tree into the port's ``Model``.

``repro`` keeps its weights as nested dicts whose scanned segments stack
their layers on a leading axis (``params["segments"][i]["sub{j}"]``).  The
port holds one ``Block`` per layer with the same leaf names and the same
``(in, out)`` layout, so carrying a tree is unstacking it in
``plan_segments`` order and copying each leaf, with no transpose.  A train
state (``{"params", "opt": {"m", "v"}, "step"}``) carries the same way, its
moments unstacked like the parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import plan_segments

__all__ = ["unstack_params", "load_repro_params", "load_repro_train_state"]


def _flatten(prefix: str, node, out: dict):
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(f"{prefix}.{k}" if prefix else k, v, out)
    else:
        out[prefix] = node


def _take(node, j: int):
    """Layer ``j`` of a scanned segment's stacked leaves."""
    if isinstance(node, dict):
        return {k: _take(v, j) for k, v in node.items()}
    return node[j]


def unstack_params(cfg, tree: dict) -> dict:
    """``{port parameter name: leaf}`` for a ``repro`` tree of ``cfg``: the
    top-level leaves by their dotted paths, then each segment's layers as
    ``layers.{i}.…`` in ``plan_segments`` order (the leading dense layers,
    the periods of the scanned segment, the trailing partial period).
    Leaves are indexed, never copied, so views and shape stand-ins pass."""
    out: dict = {}
    for k, v in tree.items():
        if k != "segments":
            _flatten(k, v, out)
    segs = plan_segments(cfg)
    if len(tree["segments"]) != len(segs):
        raise ValueError(f"{len(tree['segments'])} segments in the tree, "
                         f"{len(segs)} planned for {cfg.name}")
    i = 0
    for seg, node in zip(segs, tree["segments"]):
        for j in range(seg.count):
            period = _take(node, j) if seg.kind == "scan" else node
            for s in range(len(seg.specs)):
                _flatten(f"layers.{i}", period[f"sub{s}"], out)
                i += 1
    return out


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                  # a writable copy
    if a.dtype.name == "bfloat16":   # numpy has no bfloat16: carry its bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _matched(cfg, tree: dict, targets: dict, what: str) -> dict:
    """``tree`` unstacked, checked name for name and shape for shape
    against ``targets`` (``{port name: tensor}``)."""
    flat = unstack_params(cfg, tree)
    missing, extra = sorted(targets.keys() - flat.keys()), sorted(flat.keys() - targets.keys())
    if missing or extra:
        raise ValueError(f"{cfg.name}: {what} missing from the tree "
                         f"{missing}, not in the model {extra}")
    for name, w in targets.items():
        if tuple(flat[name].shape) != tuple(w.shape):
            raise ValueError(f"{cfg.name}: {what} {name} has shape "
                             f"{tuple(flat[name].shape)}, the model {tuple(w.shape)}")
    return flat


@torch.no_grad()
def load_repro_params(model, tree: dict):
    """Copy ``repro``'s parameters (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) into ``model`` in place.  Raises
    ``ValueError`` on any missing, extra or mis-shaped leaf."""
    params = dict(model.named_parameters())
    flat = _matched(model.cfg, tree, params, "leaves")
    for name, w in params.items():
        w.copy_(_tensor(flat[name]))
    return model


@torch.no_grad()
def load_repro_train_state(state, repro_state: dict):
    """Copy ``repro``'s train state ``{"params", "opt": {"m", "v"},
    "step"}`` (numpy leaves) into the port's ``TrainState`` in place: the
    parameters, both moments (unstacked like the parameters) and the step.
    Every tree is checked before anything is copied; any missing, extra or
    mis-shaped leaf raises ``ValueError``."""
    cfg = state.model.cfg
    params = state.params
    flat_p = _matched(cfg, repro_state["params"], params, "leaves")
    moments = {k: _matched(cfg, repro_state["opt"][k], state.opt[k], f"opt/{k} leaves")
               for k in ("m", "v")}
    for name, w in params.items():
        w.copy_(_tensor(flat_p[name]))
    for k, flat in moments.items():
        for name, t in state.opt[k].items():
            t.copy_(_tensor(flat[name]))
    state.step = int(repro_state["step"])
    return state
