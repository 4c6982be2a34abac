"""Divisibility-aware placement resolution for every tree of the LM stack
(the port of ``repro.distributed.sharding``).

Policy, rule for rule ``repro``'s:

* params — TP: the trailing (output-feature) dim shards over "model" when
  divisible and large enough; FSDP: the largest remaining dim shards over
  "data".  Params are replicated across the "pod" axis (pure DP over the
  slow links between pods) so gradients all-reduce over pods only.
* batches — the batch dim shards over ("pod","data"); when batch is 1
  (long-context shapes) the *sequence* dim takes those axes instead
  (sequence parallelism).
* caches / activations — batch over ("pod","data"), then the largest
  remaining dim that divides takes "model".

The resolver reads only axis names and sizes from the mesh: a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``, or a
plain ``{name: size}`` mapping (no process group needed).  A spec is a
``PartitionSpec``: one entry per tensor dim, ``None``, an axis name or a
tuple of names.  ``NamedSharding(mesh, spec).placements`` turns it into
one ``Shard(dim)`` / ``Replicate()`` per mesh dim for ``distribute_tensor``.

**Stacked resolution.**  ``repro`` stacks the layers of a scanned segment
on a leading axis and resolves the stacked leaf; the port holds one tensor
a layer.  A leaf of a layer in a ``scan`` segment of ``plan_segments`` is
therefore resolved on ``(seg.count, *shape)`` and the leading entry
dropped, which gives ``repro``'s placement exactly wherever that entry is
``None``.  Where ``repro`` puts a mesh axis on the layer axis itself, a
tensor a layer cannot follow, and the port resolves the layer's own shape
instead.  That happens for two causes only: the name-based expert rule
(``expert_param_spec``) matches a dense FFN's stacked ``w_gate`` /
``w_up`` / ``w_down`` (``(L, d, ff)``) whenever L divides the model axis,
and ``cache_shardings`` takes dim 0 of a stacked cache for the batch, so a
layer count that divides the data axes takes them.  Leaves of ``plain``
segments and top-level leaves have no stack axis in ``repro`` either.
"""
from __future__ import annotations

import math
import os
from collections.abc import Mapping

import torch

from repro_torch.models.layers import contiguous_stride
from repro_torch.models.transformer import cache_layout, plan_segments

__all__ = [
    "PartitionSpec",
    "NamedSharding",
    "mesh_axes",
    "param_spec",
    "act_spec",
    "expert_param_spec",
    "layer_stacks",
    "state_shardings",
    "batch_shardings",
    "cache_shardings",
    "zero_caches",
    "replicated",
    "distribute",
    "set_parameter",
    "place_state",
]

_MIN_SHARD = 512  # don't bother sharding tiny param dims


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    names (that dim split over each, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of a mapping)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class NamedSharding:
    """A spec on a mesh; ``placements`` is what ``distribute_tensor`` and
    ``redistribute`` take."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __repr__(self):
        return f"NamedSharding({mesh_axes(self.mesh)}, {self.spec!r})"

    @property
    def placements(self) -> tuple:
        """``Shard(d)`` on each mesh dim that an entry of dim ``d`` names
        (a tuple entry on each of its axes, in mesh order, as JAX orders
        them), ``Replicate()`` on the rest.  A mesh dim of size 1 holds the
        whole tensor whatever the spec says: ``Replicate()`` there, which
        keeps ``DTensor`` from refusing a view of a dim "split" once."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name, size in mesh_axes(self.mesh).items():
            dims = [d for d, e in enumerate(self.spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
        return tuple(out)

    def place(self, t: torch.Tensor):
        """``t`` (whole) as a ``DTensor`` of this placement; a ``DTensor``
        already on this mesh is redistributed."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        if isinstance(t, DTensor):
            return t.redistribute(self.mesh, self.placements)
        return distribute_tensor(t, self.mesh, self.placements)

    def zeros(self, shape, dtype, device):
        """A zero ``DTensor`` of global ``shape`` in this placement, of which
        only this rank's shard is allocated, on ``device``.  The shard's
        shape is ``DTensor``'s: each ``Shard(d)``, in mesh order, cuts dim
        ``d`` into ``torch.chunk``'s pieces and keeps this rank's."""
        from torch.distributed.tensor import DTensor

        local = list(shape)
        coord = self.mesh.get_coordinate()
        for i, pl in enumerate(self.placements):
            if pl.is_shard():
                d, n = pl.dim, self.mesh.size(i)
                piece = -(-local[d] // n)
                local[d] = max(0, min(local[d], (coord[i] + 1) * piece) - coord[i] * piece)
        return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), self.mesh,
                                  self.placements, run_check=False,
                                  shape=torch.Size(shape), stride=contiguous_stride(shape))


def _axis_size(sizes: dict, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(sizes[a] for a in axes)


def _data_axes(sizes: dict):
    return tuple(a for a in ("pod", "data") if a in sizes)


def param_spec(shape, mesh) -> P:
    """TP on trailing dim (model), FSDP on the largest remaining dim (data)."""
    sizes = mesh_axes(mesh)
    ndim = len(shape)
    dims: list = [None] * ndim
    if ndim < 2:
        return P(*dims)
    msize = sizes.get("model", 1)
    dsize = sizes.get("data", 1)
    if shape[-1] % msize == 0 and shape[-1] >= max(_MIN_SHARD, msize):
        dims[-1] = "model"
    # FSDP: largest remaining dim, skipping tiny/scan-stacked leading dims
    order = sorted(range(ndim - 1), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % dsize == 0 and shape[i] >= max(_MIN_SHARD, dsize):
            dims[i] = "data"
            break
    if dims[-1] is None and shape[-1] % msize == 0 and shape[-1] >= msize:
        # second chance with a lower bar if nothing else sharded
        if all(d is None for d in dims):
            dims[-1] = "model"
    return P(*dims)


def act_spec(shape, mesh, batch_dim: int = 0) -> P:
    """Batch over (pod,data); largest remaining divisible dim over model."""
    sizes = mesh_axes(mesh)
    ndim = len(shape)
    dims: list = [None] * ndim
    daxes = _data_axes(sizes)
    dsize = _axis_size(sizes, daxes)
    used_data = False
    if ndim > batch_dim and shape[batch_dim] % dsize == 0 and shape[batch_dim] > 1:
        dims[batch_dim] = daxes
        used_data = True
    msize = sizes.get("model", 1)
    order = sorted(
        (i for i in range(ndim) if dims[i] is None), key=lambda i: -shape[i]
    )
    if not used_data:
        # sequence parallelism: give (pod,data) to the largest divisible dim
        for i in order:
            if shape[i] % dsize == 0 and shape[i] >= dsize:
                dims[i] = daxes
                used_data = True
                break
        order = [i for i in order if dims[i] is None]
    for i in order:
        if shape[i] % msize == 0 and shape[i] >= msize:
            dims[i] = "model"
            break
    return P(*dims)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


_EXPERT_LEAVES = {"w_gate", "w_up", "w_down"}


def _expert_parallel_enabled() -> bool:
    return os.environ.get("REPRO_EP", "1") not in ("0", "false")


def expert_param_spec(shape, mesh) -> P | None:
    """EP sharding for (..., E, d, ff) expert stacks: experts over "model",
    d over "data" (FSDP).  Keeps the MoE dispatch all-reduce restricted to
    each device's expert slice.  Returns None when E does not divide the
    model axis (e.g. mixtral's 8)."""
    sizes = mesh_axes(mesh)
    msize = sizes.get("model", 1)
    dsize = sizes.get("data", 1)
    if len(shape) < 3 or shape[-3] % msize or shape[-2] % dsize:
        return None
    dims: list = [None] * len(shape)
    dims[-3] = "model"
    dims[-2] = "data"
    return P(*dims)


def _leaf_param_spec(name: str, shape, mesh) -> P:
    """``repro``'s ``state_shardings`` rule for a leaf called ``name``."""
    if name in _EXPERT_LEAVES and _expert_parallel_enabled():
        spec = expert_param_spec(shape, mesh)
        if spec is not None:
            return spec
    return param_spec(shape, mesh)


def _cache_spec(shape, mesh) -> P:
    """``repro``'s ``cache_shardings`` rule (``P()`` is replicated)."""
    if len(shape) < 2:
        return P()
    return act_spec(shape, mesh)


def _stacked(rule, shape, count: int | None, mesh) -> P:
    """``rule`` on ``(count, *shape)`` less the leading entry, as ``repro``
    resolves the stacked leaf; on ``shape`` itself where ``repro`` places a
    mesh axis on the layer axis (or where there is no stack)."""
    if count is not None:
        spec = rule((count, *shape), mesh)
        if len(spec) == 0:
            return spec
        if spec[0] is None:
            return P(*spec[1:])
    return rule(tuple(shape), mesh)


def layer_stacks(cfg) -> list[int | None]:
    """For each layer in model order, the length of the ``scan`` segment
    that holds it in ``repro`` (its stack axis), or ``None`` for a layer of
    a ``plain`` segment."""
    out: list = []
    for seg in plan_segments(cfg):
        stack = seg.count if seg.kind == "scan" else None
        out.extend([stack] * (seg.count * len(seg.specs)))
    return out


def _param_tree_shardings(params: dict, cfg, mesh) -> dict:
    """``{name: NamedSharding}`` for ``{port parameter name: tensor}``."""
    stacks = layer_stacks(cfg)
    out = {}
    for name, t in params.items():
        parts = name.split(".")
        count = stacks[int(parts[1])] if parts[0] == "layers" else None
        rule = lambda s, m, leaf=parts[-1]: _leaf_param_spec(leaf, s, m)
        out[name] = NamedSharding(mesh, _stacked(rule, tuple(t.shape), count, mesh))
    return out


def state_shardings(state, mesh, cfg=None):
    """The placement tree of a train state or of parameters.

    * a ``TrainState``: ``{"params": {name: ...}, "opt": {"m": {...},
      "v": {...}}, "step": replicated}`` (the checkpoint's tree), the
      moments following their parameters;
    * a ``Model``: ``{name: ...}`` over its parameters;
    * a ``{name: tensor}`` dict of the port's parameter names, with ``cfg``.
    """
    from repro_torch.training.train_step import TrainState

    if isinstance(state, TrainState):
        cfg = state.model.cfg
        params = _param_tree_shardings(state.params, cfg, mesh)
        return {"params": params,
                "opt": {k: _param_tree_shardings(state.opt[k], cfg, mesh)
                        for k in ("m", "v")},
                "step": replicated(mesh)}
    if isinstance(state, torch.nn.Module):
        return _param_tree_shardings(dict(state.named_parameters()), state.cfg, mesh)
    if cfg is None:
        raise ValueError("state_shardings of a parameter dict needs its cfg")
    return _param_tree_shardings(state, cfg, mesh)


def batch_shardings(batch: dict, mesh) -> dict:
    """``act_spec`` (batch dim 0) for every array of a batch."""
    return {k: NamedSharding(mesh, act_spec(tuple(v.shape), mesh))
            for k, v in batch.items()}


def cache_shardings(caches: list, mesh, cfg) -> list:
    """The placements of the port's caches (one dict a layer, model order),
    each leaf resolved as ``repro`` resolves its stacked cache."""
    stacks = layer_stacks(cfg)
    return [{k: NamedSharding(mesh, _stacked(_cache_spec, tuple(t.shape), stacks[i], mesh))
             for k, t in layer.items()}
            for i, layer in enumerate(caches)]


def zero_caches(cfg, B: int, T: int, mesh, device) -> list:
    """Zero caches placed as ``cache_shardings`` places them, of which this
    rank allocates only its shards: the global caches are never made, not
    even on ``meta``, where the dry run would count them."""
    stacks = layer_stacks(cfg)
    return [{k: NamedSharding(mesh, _stacked(_cache_spec, shape, stacks[i], mesh))
             .zeros(shape, dt, device) for k, (shape, dt) in layer.items()}
            for i, layer in enumerate(cache_layout(cfg, B, T))]


def distribute(tree, shardings):
    """Place every tensor of ``tree`` (nested dicts and lists) by the
    matching ``NamedSharding`` of ``shardings``."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute(v, s) for v, s in zip(tree, shardings)]
    return shardings.place(torch.as_tensor(tree))


def set_parameter(model: torch.nn.Module, name: str, value: torch.Tensor):
    """Replace the parameter ``name`` (dotted) of ``model`` by ``value``."""
    mod_name, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    setattr(mod, leaf, torch.nn.Parameter(value, requires_grad=True))


def place_state(state, shardings: dict):
    """Place a ``TrainState`` by ``state_shardings``' tree, in place: each
    parameter of its model becomes a ``DTensor`` parameter, each moment a
    ``DTensor`` of its parameter's placement.  Returns the state."""
    with torch.no_grad():
        for name, p in state.params.items():
            set_parameter(state.model, name, shardings["params"][name].place(p.detach()))
        for k in ("m", "v"):
            state.opt[k] = {n: shardings["opt"][k][n].place(t)
                            for n, t in state.opt[k].items()}
    return state
