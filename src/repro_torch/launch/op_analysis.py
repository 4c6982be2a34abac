"""Per-device cost of one step from the ops it issues (the dry run's
"profiler"; the counterpart of ``repro.launch.hlo_analysis``).

``repro`` parses the post-SPMD HLO of one compiled step.  The port has no
HLO: ``analyze_step(fn, *args)`` runs ``fn`` once, on ``meta`` tensors (or
``DTensor``s over ``meta`` shards) under a fake process group, and records
every aten op and ``_c10d_functional`` collective that *this rank* issues on
its local shards.  A ``TorchDispatchMode`` entered outside a ``DTensor``
program sees each op first with the global shapes; the recorder hands such
an op back to ``DTensor`` (``NotImplemented``) and counts the local ops and
the collectives that ``DTensor`` issues for it instead, so every count is
per device, as ``repro``'s post-SPMD counts are.

  * ``flops``        — 2*M*N*K per matmul or convolution (the ops of
                        ``torch.utils.flop_counter``'s table), as
                        ``analyze_hlo`` counts dots
  * ``traffic``      — operand plus output bytes of every op that computes
                        (eager mode runs every op at top level, so every op
                        touches memory at its boundary; views move nothing)
  * ``collectives``  — ring-cost bytes moved per collective op, grouped by
                        op, with ``repro``'s formulas
  * ``peak_bytes``   — the most bytes that ops of ``fn`` allocated and that
                        were alive at once (storages tracked until freed)

Python loops unroll, so every layer, chunk and recomputed block is counted
where it runs: there is no ``while`` body and no trip count to recover,
and ``repro``'s ``unknown_trip_counts`` has no counterpart.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCost", "analyze_step", "coll_moved"]


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    traffic: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    events: list = dataclasses.field(default_factory=list)  # (op, out_bytes, n)
    peak_bytes: int = 0
    ops: int = 0
    result: object = dataclasses.field(default=None, repr=False)


def coll_moved(op: str, out_bytes: int, n: int) -> float:
    """Ring-algorithm bytes one device moves (``repro``'s formulas)."""
    n = max(n, 2)
    if op == "all-gather":
        return out_bytes * (n - 1) / n
    if op == "all-reduce":
        return out_bytes * 2 * (n - 1) / n
    if op == "reduce-scatter":
        return out_bytes * (n - 1)
    if op == "all-to-all":
        return out_bytes * (n - 1) / n
    return float(out_bytes)  # collective-permute


# collective op (``_c10d_functional``, and ``DTensor``'s own shard-to-shard
# all-to-all) -> ``repro``'s name
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


class _Recorder(TorchDispatchMode):
    def __init__(self, group_sizes: dict):
        super().__init__()
        self.cost = OpCost()
        self.group_sizes = group_sizes
        self.live = 0

    def _free(self, n: int):
        self.live -= n

    def _collective(self, name: str, args, out: torch.Tensor):
        op = _COLLECTIVES[name]
        if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
            n = int(args[1] if name == "all_gather_into_tensor" else args[2])
        else:   # the group's name is the last argument
            n = self.group_sizes[str(args[-1])]
        out_bytes = _nbytes(out)
        moved = coll_moved(op, out_bytes, n)
        c = self.cost
        c.events.append((op, out_bytes, n))
        c.collective_bytes += moved
        d = c.collectives.setdefault(op, {"count": 0, "moved_bytes": 0.0})
        d["count"] += 1
        d["moved_bytes"] += moved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor = _dtensor_type()
        if dtensor is not None and dtensor in types:
            return NotImplemented   # let DTensor issue its local ops and collectives
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if types or any(type(t) is not torch.Tensor for t in outs):
            return out   # DTensor's shape propagation on fake tensors: no device work
        c = self.cost
        c.ops += 1
        packet = func._overloadpacket
        if func.namespace in ("_c10d_functional", "_dtensor") and packet.__name__ in _COLLECTIVES:
            self._collective(packet.__name__, args, outs[0])
        if packet in flop_registry:
            c.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        returns = func._schema.returns
        fresh = [t for t, r in zip(outs, returns) if r.alias_info is None]
        if fresh:
            c.traffic += sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in _tensors(list(args) + list(kwargs.values())))
        for t in fresh:
            storage = t.untyped_storage()
            n = storage.nbytes()
            self.live += n
            c.peak_bytes = max(c.peak_bytes, self.live)
            weakref.finalize(storage, self._free, n)
        return out


def _dtensor_type():
    import sys

    mod = sys.modules.get("torch.distributed.tensor")
    return mod.DTensor if mod is not None else None


def analyze_step(fn, *args, mesh=None, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` once and return this rank's ``OpCost``.

    ``mesh`` (a ``DeviceMesh``) names the groups of its collectives, so an
    all-reduce or all-to-all knows its group size.  The result of ``fn``
    is kept on ``OpCost.result``."""
    group_sizes = {}
    if mesh is not None:
        for i in range(mesh.ndim):
            group_sizes[mesh.get_group(i).group_name] = mesh.size(i)
    rec = _Recorder(group_sizes)
    with rec:
        result = fn(*args, **kwargs)
    rec.cost.result = result
    return rec.cost
