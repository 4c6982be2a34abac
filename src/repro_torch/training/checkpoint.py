"""Fault-tolerant checkpointing: atomic, last-k retention (the port of
``repro.training.checkpoint``).

Format, as ``repro``'s: one ``.npz`` (all leaves, keyed by their
``/``-joined path) + ``meta.json`` per step directory, written to
``<dir>/tmp.step_N`` and renamed to ``<dir>/step_N``, so a half-written
checkpoint is never visible.  A ``TrainState`` is saved as the tree
``{"params": {name: ...}, "opt": {"m": ..., "v": ...}, "step": step}``:
keys ``params/<name>``, ``opt/m/<name>``, ``opt/v/<name>`` and ``step``,
where ``<name>`` is the port's parameter name.  numpy has no bfloat16, so a
bfloat16 leaf is stored as its uint16 bits, its dtype in ``meta.json``.

``repro``'s ``shardings=`` (restore onto another mesh) waits for the port's
sharding rules.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.training.train_step import TrainState

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "list_steps"]

_SEP = "/"


def _tree(state) -> dict:
    if isinstance(state, TrainState):
        return {"params": state.params, "opt": state.opt, "step": state.step}
    return state


def _flatten(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` over nested dicts."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    return out


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """``(array, dtype name)``; bfloat16 leaves as their uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep_last: int = 3) -> str:
    """Write ``tree`` (a ``TrainState`` or nested dicts of tensors, arrays
    and numbers) as ``<ckpt_dir>/step_<step>``; keep the last ``keep_last``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat, dtypes = {}, {}
    for key, leaf in _flatten(_tree(tree)).items():
        flat[key], dtypes[key] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = {"step": step, "keys": sorted(flat), "dtypes": dtypes}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic visibility
    # retention
    for s in list_steps(ckpt_dir)[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
    return final


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            steps.append(int(name.split("_", 1)[1]))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load(data, dtypes: dict, key: str) -> torch.Tensor:
    a = data[key]
    if dtypes.get(key) == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def restore_checkpoint(ckpt_dir: str, step: int, like: TrainState) -> TrainState:
    """Restore step ``step`` into the ``TrainState`` ``like``: its parameters,
    moments and step are filled in place, each tensor keeping its device and
    dtype, and the state is returned.  A leaf of ``like`` missing from the
    checkpoint raises ``KeyError``."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        dtypes = json.load(f)["dtypes"]
    with np.load(os.path.join(path, "arrays.npz")) as data, torch.no_grad():
        for key, t in _flatten(_tree(like)).items():
            if key != "step":
                t.copy_(_load(data, dtypes, key))
        like.step = int(data["step"])
    return like
