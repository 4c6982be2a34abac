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

A state on a mesh (``DTensor`` leaves) is saved whole: each leaf is
gathered (``full_tensor``, on every rank) and rank 0 writes.
``restore_checkpoint(..., shardings=)`` reads each leaf whole and places it
with ``distribute_tensor`` on the sharding's mesh, which need not be the
mesh that saved it (``distributed.fault_tolerance.reshard_state``).
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import zipfile

import numpy as np
import torch

from repro_torch.models.layers import is_dtensor
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
    """``(array, dtype name)``; bfloat16 leaves as their uint16 bits; a
    ``DTensor`` gathered whole first."""
    if isinstance(leaf, torch.Tensor):
        t = (leaf.full_tensor() if is_dtensor(leaf) else leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep_last: int = 3) -> str:
    """Write ``tree`` (a ``TrainState`` or nested dicts of tensors, arrays
    and numbers) as ``<ckpt_dir>/step_<step>``; keep the last ``keep_last``."""
    flat, dtypes = {}, {}
    for key, leaf in _flatten(_tree(tree)).items():   # every rank: the gathers
        flat[key], dtypes[key] = _to_numpy(leaf)
    final = os.path.join(ckpt_dir, f"step_{step}")
    if not _writer():
        _barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
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
    _barrier()
    return final


def _writer() -> bool:
    """Rank 0 of the process group that is up, or the only process."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _barrier():
    """Every rank past the write before any reads it back."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


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


class _Arrays:
    """The arrays of ``arrays.npz`` by key, each mapped copy-on-write straight
    from the file: a restore makes no host copy and no CRC pass (the two took
    most of a 44 GB restore).  ``np.savez``, which writes every checkpoint
    here and in ``repro``, stores its members uncompressed; a compressed
    member is refused."""

    def __init__(self, path: str):
        self.path = path
        with zipfile.ZipFile(path) as z:
            self.members = {i.filename.removesuffix(".npy"): i for i in z.infolist()}

    def __getitem__(self, key: str) -> np.memmap:
        info = self.members[key]
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"{self.path}: member {key!r} is compressed; "
                             "checkpoints are written uncompressed by np.savez")
        with open(self.path, "rb") as f:
            f.seek(info.header_offset)
            name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            offset = f.tell()
        return np.memmap(self.path, dtype=dtype, mode="c", offset=offset, shape=shape,
                         order="F" if fortran else "C")


def _load(data: _Arrays, dtypes: dict, key: str) -> torch.Tensor:
    """The leaf ``key`` on the host; it may alias the file (copy-on-write),
    so a caller that keeps it copies it."""
    a = data[key]
    if dtypes.get(key) == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def restore_checkpoint(ckpt_dir: str, step: int, like: TrainState, *,
                       shardings: dict | None = None) -> TrainState:
    """Restore step ``step`` into the ``TrainState`` ``like`` and return it.

    Without ``shardings`` its parameters, moments and step are filled in
    place, each tensor keeping its device and dtype.  With ``shardings``
    (``state_shardings``' tree, on any mesh) each leaf is read whole, cast
    to ``like``'s dtype and placed with ``distribute_tensor`` on its
    sharding's mesh: the model's parameters and the moments become
    ``DTensor``s of those placements.  A leaf of ``like`` missing from the
    checkpoint raises ``KeyError``."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        dtypes = json.load(f)["dtypes"]
    data = _Arrays(os.path.join(path, "arrays.npz"))
    with torch.no_grad():
        if shardings is None:
            for key, t in _flatten(_tree(like)).items():
                if key != "step":
                    t.copy_(_load(data, dtypes, key))
        else:
            from repro_torch.distributed.sharding import set_parameter

            def placed(key, sh, dtype):
                t = _load(data, dtypes, key).to(sh.mesh.device_type, dtype, copy=True)
                return sh.place(t)

            for name, p in like.params.items():
                set_parameter(like.model, name,
                              placed(f"params{_SEP}{name}", shardings["params"][name], p.dtype))
            for k in ("m", "v"):
                like.opt[k] = {name: placed(f"opt{_SEP}{k}{_SEP}{name}",
                                            shardings["opt"][k][name], t.dtype)
                               for name, t in like.opt[k].items()}
        like.step = int(data["step"])
    return like
