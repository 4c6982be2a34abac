"""Multi-pod dry run: trace every (arch x shape x mesh) cell (the port of
``repro.launch.dryrun``).

For each cell this shows, without a card:
  * the placements are coherent: every parameter, moment, batch and cache
    leaf is a ``DTensor`` placed by the resolver
    (``repro_torch.distributed.sharding``), and one train step, prefill or
    decode step runs through them, every activation constraint included;
  * the program fits: one rank's argument, output, temporary and aliased
    bytes (``memory_stats``);
  * the roofline inputs: per-device FLOPs, bytes and collective bytes of
    that step (``launch/op_analysis.py``).

``repro`` lowers and compiles each cell for 512 placeholder CPU devices.
The port traces it once on the ``meta`` device under a fake process group
(``torch.testing``'s ``FakeStore``, backend ``"fake"``) of the mesh's world
size, as rank 0: no tensor holds data, nothing is computed on any device,
and every collective returns at once.  The group is set up only here, as
``repro`` sets its placeholder fleet up only in its dry run.

Results append incrementally to a JSON file consumed by
``benchmarks/roofline.py``; a record keeps ``repro``'s keys, with one
``trace_s`` for ``lower_s`` and ``compile_s``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape decode_32k --mesh single --mesh-shape 2x4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_results.json
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.sharding import (
    batch_shardings,
    cache_shardings,
    distribute,
    place_state,
    set_parameter,
    state_shardings,
)
from repro_torch.launch.op_analysis import analyze_step, coll_moved
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, TrainState, init_train_state, make_train_step

__all__ = ["SHAPES", "SUBQUADRATIC", "plan_cells", "collective_stats", "memory_stats",
           "make_mesh", "build_step", "run_cell", "main"]

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, mode="train"),
    "prefill_32k": dict(seq=32768, batch=32, mode="prefill"),
    "decode_32k": dict(seq=32768, batch=128, mode="decode"),
    "long_500k": dict(seq=524288, batch=1, mode="decode"),
}

# long_500k needs sub-quadratic attention: SWA (mixtral), RG-LRU hybrid,
# linear-attention RWKV.  Pure full-attention archs skip it.
SUBQUADRATIC = {"mixtral-8x22b", "recurrentgemma-2b", "rwkv6-1.6b"}


def plan_cells() -> list[tuple[str, str, str | None]]:
    """(arch, shape, skip_reason|None) for all 40 nominal cells."""
    cells = []
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in SHAPES:
            skip = None
            if cfg.family == "encoder" and shape in ("decode_32k", "long_500k"):
                skip = "encoder-only: no decode step"
            elif shape == "long_500k" and arch not in SUBQUADRATIC:
                skip = "full quadratic attention at 500k"
            cells.append((arch, shape, skip))
    return cells


# ---------------------------------------------------------------------------
# collective accounting
# ---------------------------------------------------------------------------

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")


def _coll_bytes(op: str, out_bytes: int, n: int) -> float:
    """Ring-algorithm bytes moved (``repro``'s ``_coll_bytes``):
    all-gather out*(n-1)/n, all-reduce out*2(n-1)/n, reduce-scatter
    out*(n-1), all-to-all out*(n-1)/n, collective-permute out."""
    return coll_moved(op, out_bytes, n)


def collective_stats(events) -> dict:
    """``repro``'s per-op dict (``count``, ``out_bytes``, ``moved_bytes``)
    and ``total_factored_bytes`` over ``(op, out_bytes, n)`` events, one a
    collective that rank 0 issued."""
    stats: dict[str, dict] = {
        op: {"count": 0, "out_bytes": 0, "moved_bytes": 0.0} for op in _COLL_OPS
    }
    for op, out_bytes, n in events:
        stats[op]["count"] += 1
        stats[op]["out_bytes"] += out_bytes
        stats[op]["moved_bytes"] += _coll_bytes(op, out_bytes, n)
    stats["total_factored_bytes"] = sum(
        s["moved_bytes"] for s in stats.values() if isinstance(s, dict)
    )
    return stats


def _local_bytes(tree) -> int:
    """Bytes this rank holds of every tensor in ``tree`` (a ``DTensor``
    counts its local shard)."""
    if isinstance(tree, TrainState):
        return _local_bytes({"params": tree.params, "opt": tree.opt})
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    return 0


def memory_stats(step: dict, cost) -> dict:
    """One rank's bytes, under ``repro``'s ``memory_analysis`` names:
    arguments (the placed inputs' local shards), outputs (what the step
    returns), aliases (the donated inputs it updates in place and returns)
    and temporaries (the peak of bytes the step allocated and held at
    once, less the outputs it allocated)."""
    args = _local_bytes(step["inputs"])
    out = _local_bytes(cost.result)
    alias = _local_bytes(step["donated"])
    return {
        "argument_size_in_bytes": args,
        "output_size_in_bytes": out,
        "temp_size_in_bytes": max(cost.peak_bytes - (out - alias), 0),
        "alias_size_in_bytes": alias,
    }


# ---------------------------------------------------------------------------
# the fake process group and the mesh
# ---------------------------------------------------------------------------

def _fake_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0 (a group
    of another size is torn down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized() and (dist.get_backend() != "fake"
                                  or dist.get_world_size() != world):
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs its own fake process group; "
                               f"a {dist.get_backend()} group is up")
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake process group
    of its world size.  Its device type is the card's, ``cuda``, so
    ``DTensor`` picks the collectives it picks there (on a ``cpu`` mesh it
    replaces every all-to-all by an all-gather); the tensors stay on
    ``meta``, so no card is touched."""
    from torch.distributed.device_mesh import init_device_mesh

    _fake_group(math.prod(shape))
    return init_device_mesh("cuda", tuple(shape), mesh_dim_names=tuple(axes))


def _production_mesh(mesh_kind: str):
    """``launch/mesh.py``'s production mesh over a fake group of its size."""
    from repro_torch.launch.mesh import MULTI_POD_SHAPE, POD_SHAPE, make_production_mesh

    multi_pod = mesh_kind == "pod"
    _fake_group(math.prod(MULTI_POD_SHAPE if multi_pod else POD_SHAPE))
    return make_production_mesh(multi_pod=multi_pod)


# ---------------------------------------------------------------------------
# cell tracing
# ---------------------------------------------------------------------------

def _place_params(model, mesh):
    with torch.no_grad():
        for name, sh in state_shardings(model, mesh).items():
            set_parameter(model, name, sh.place(model.get_parameter(name).detach()))


def build_step(arch: str, shape_name: str, mesh, cfg=None, info=None) -> dict:
    """The counterpart of ``repro``'s ``build_lowered``: the cell's model on
    ``meta`` with its mesh, its state (or weights), batch and caches placed
    by the resolver.  Returns ``{"fn", "inputs", "donated"}``: ``fn()`` runs
    the train step, prefill or decode step once.  ``info`` (``SHAPES``'
    form) cuts the cell's batch and sequence."""
    cfg = cfg or get_config(arch)
    model = build_model(cfg, device="meta", mesh=mesh)
    info = info or SHAPES[shape_name]
    S, B, mode = info["seq"], info["batch"], info["mode"]

    if mode == "train":
        state = init_train_state(model)
        place_state(state, state_shardings(state, mesh))
        batch = model.input_specs(B, S, "train")
        batch = distribute(batch, batch_shardings(batch, mesh))
        step = make_train_step(model, AdamWConfig())
        return {"fn": lambda: step(state, batch), "inputs": (state, batch),
                "donated": state}

    _place_params(model, mesh)
    if mode == "prefill":
        batch = model.input_specs(B, S, "prefill")
        batch = distribute(batch, batch_shardings(batch, mesh))
        return {"fn": lambda: model.prefill(batch, S), "inputs": (model.state_dict(), batch),
                "donated": None}

    # decode: one token against a seq_len-deep cache, written at position 0
    # (held by rank 0, which the trace follows)
    specs = model.input_specs(B, S, "decode")
    caches = distribute(specs["caches"], cache_shardings(specs["caches"], mesh, cfg))
    token = distribute({"token": specs["token"]},
                       batch_shardings({"token": specs["token"]}, mesh))["token"]
    return {"fn": lambda: model.decode_step(caches, token, 0),
            "inputs": (model.state_dict(), caches, token), "donated": caches}


def run_cell(arch: str, shape_name: str, mesh_kind: str, mesh=None, cfg=None,
             info=None) -> dict:
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    cfg = cfg or get_config(arch)
    info = info or SHAPES[shape_name]
    n_total, n_active = cfg.params_estimate()
    tokens = info["batch"] * (info["seq"] if info["mode"] != "decode" else 1)
    flops_per_tok = 6 if info["mode"] == "train" else 2
    rec.update(
        params_total=n_total,
        params_active=n_active,
        model_flops=float(flops_per_tok * n_active * tokens),
        mode=info["mode"],
    )
    try:
        if mesh is None:
            mesh = _production_mesh(mesh_kind)
        t0 = time.time()
        step = build_step(arch, shape_name, mesh, cfg=cfg, info=info)
        cost = analyze_step(step["fn"], mesh=mesh)
        rec["trace_s"] = round(time.time() - t0, 2)
        rec["memory"] = memory_stats(step, cost)
        rec["collectives"] = collective_stats(cost.events)
        rec["analysis"] = {
            "flops": cost.flops,
            "traffic_bytes": cost.traffic,
            "collective_bytes": cost.collective_bytes,
            "collectives": cost.collectives,
        }
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


# ---------------------------------------------------------------------------
# CLI driver
# ---------------------------------------------------------------------------

def _load(out):
    if os.path.exists(out):
        with open(out) as f:
            return json.load(f)
    return []


def _save(out, records):
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(records, f, indent=1)
    os.replace(tmp, out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "pod", "both"), default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--mesh-shape", help="override, e.g. 2x4 (tests)")
    ap.add_argument("--mesh-axes", help="override, e.g. data,model (tests)")
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape, skip in plan_cells():
            print(f"{arch:22s} {shape:12s} {'SKIP: ' + skip if skip else 'run'}")
        return

    mesh_override = None
    if args.mesh_shape:
        shape = tuple(int(x) for x in args.mesh_shape.split("x"))
        axes = tuple(args.mesh_axes.split(",")) if args.mesh_axes else (
            ("data", "model") if len(shape) == 2 else ("pod", "data", "model"))
        mesh_override = make_mesh(shape, axes)

    records = _load(args.out)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in records if r.get("ok")}

    cells = plan_cells()
    if not args.all:
        cells = [
            (a, s, sk) for a, s, sk in cells
            if (args.arch is None or a == args.arch)
            and (args.shape is None or s == args.shape)
        ]
    meshes = ["single", "pod"] if args.mesh == "both" else [args.mesh]

    for arch, shape, skip in cells:
        for mesh_kind in meshes:
            key = (arch, shape, mesh_kind)
            if skip:
                if not any(
                    r["arch"] == arch and r["shape"] == shape
                    and r["mesh"] == mesh_kind for r in records
                ):
                    records.append({
                        "arch": arch, "shape": shape, "mesh": mesh_kind,
                        "ok": True, "skipped": skip,
                    })
                    _save(args.out, records)
                print(f"SKIP {arch} {shape} {mesh_kind}: {skip}", flush=True)
                continue
            if key in done and not args.force:
                print(f"done {arch} {shape} {mesh_kind} (cached)", flush=True)
                continue
            print(f"RUN  {arch} {shape} {mesh_kind} ...", flush=True)
            rec = run_cell(arch, shape, mesh_kind, mesh=mesh_override)
            records = [
                r for r in records
                if (r["arch"], r["shape"], r["mesh"]) != key
            ] + [rec]
            _save(args.out, records)
            status = "OK" if rec.get("ok") else f"FAIL {rec.get('error')}"
            print(
                f"  -> {status} trace={rec.get('trace_s')}s "
                f"flops={rec.get('analysis', {}).get('flops')}",
                flush=True,
            )


if __name__ == "__main__":
    main()
