"""The port's dry run against ``repro``'s, cell by cell, on the CPU (a
helper of ``tests/test_torch_dryrun.py``; like the tests, it imports both).

For each architecture's reduced config at one cell (``train_4k``'s mode at
a cut batch and sequence by default) on a small mesh, ``repro`` lowers and
compiles the step for that many host devices on a mesh of Auto axes and
reads ``analyze_hlo``; the port traces the same step on ``meta`` under a
fake process group and reads ``analyze_step``.  One subprocess per
(package, architecture), all started together; prints one JSON object per
architecture and a table of per-device FLOPs, traffic and collective bytes.

    PYTHONPATH=src python tests/dryrun_compare.py \\
        --archs qwen3-4b,rwkv6-1.6b,mixtral-8x22b --mesh 2x2 --batch 8 --seq 64

``--full`` runs the archs' full configs instead of ``reduced()`` (the
port's trace of a full train cell takes minutes on the CPU);
``--no-remat`` turns the three remat switches off in both packages;
``--by-op`` adds each package's FLOPs by matmul shape (``repro``: each
``dot`` of the optimized HLO times its loops' trip counts; the port: each
local ``mm``/``bmm``), the op-by-op comparison.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("flops", "traffic", "collective_bytes")


def _axes(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _config(get_config, arch, full, remat):
    cfg = get_config(arch) if full else get_config(arch).reduced()
    if not remat:
        cfg = dataclasses.replace(cfg, remat=False, attn_chunk_remat=False, moe_remat=False)
    return cfg


def _repro_dots(hlo_text: str) -> dict:
    """``{"out = lhs x rhs": FLOPs}`` over the HLO's dots, each times the
    trip counts of the loops around it (``analyze_hlo``'s arithmetic)."""
    from repro.launch import hlo_analysis as H

    mod = H._Module(hlo_text)
    out: collections.Counter = collections.Counter()

    def walk(comp: str, k: int):
        shapes = {n: t for n, t, _o, _l in mod.comps.get(comp, [])}
        for _name, t, op, line in mod.comps.get(comp, []):
            if op == "dot":
                ops = H._OPERANDS.findall(line.split("dot(", 1)[1].split(")", 1)[0])
                lhs, rhs = (shapes.get(o, "").split("{")[0] for o in (ops + ["", ""])[:2])
                dims = H._ARRAY.search(lhs)
                contract = H._CONTRACT.search(line)
                kk = 1
                if dims and contract:
                    sizes = [int(d) for d in dims.group(2).split(",") if d]
                    for c in (int(c) for c in contract.group(1).split(",") if c):
                        kk *= sizes[c]
                out[f"{t.split('{')[0]} = {lhs} x {rhs}"] += k * 2.0 * H._shape_elems(t) * kk
            elif op in ("fusion", "call") and (m := H._CALLS.search(line)):
                walk(m.group(1), k)
            elif op == "while":
                body, cond = H._CALLS.search(line), H._COND.search(line)
                trips = H._TRIP_RE.search(line)
                n = int(trips.group(1)) if trips else (mod._trip_count(cond.group(1)) or 1)
                walk(body.group(1), k * n)

    walk(mod.entry, 1)
    return dict(out)


def run_repro(arch, shape_name, mesh_shape, info, full, remat=True, by_op=False):
    """``repro``'s per-device counts (this process: ``XLA_FLAGS`` set before
    JAX is imported)."""
    import jax
    from jax.sharding import AxisType

    import repro.launch.dryrun as D
    from repro.configs import get_config
    from repro.launch.hlo_analysis import analyze_hlo

    D.SHAPES[shape_name] = info
    mesh = jax.make_mesh(mesh_shape, _axes(mesh_shape),
                         axis_types=(AxisType.Auto,) * len(mesh_shape))
    cfg = _config(get_config, arch, full, remat)
    t = time.time()
    text = D.build_lowered(arch, shape_name, mesh, cfg=cfg).compile().as_text()
    hc = analyze_hlo(text)
    out = {"flops": hc.flops, "traffic": hc.traffic,
           "collective_bytes": hc.collective_bytes, "seconds": time.time() - t}
    if by_op:
        out["by_op"] = _repro_dots(text)
    return out


def run_port(arch, shape_name, mesh_shape, info, full, remat=True, by_op=False):
    """The port's per-device counts (this process: a fake group of the
    mesh's world size)."""
    import torch

    import repro_torch.launch.op_analysis as OA
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import build_step, make_mesh

    mesh = make_mesh(mesh_shape, _axes(mesh_shape))
    cfg = _config(get_config, arch, full, remat)
    per_op: collections.Counter = collections.Counter()
    if by_op:
        flops_of = dict(OA.flop_registry)

        def counted(packet):
            def count(*args, out_val=None, **kwargs):
                n = flops_of[packet](*args, out_val=out_val, **kwargs)
                shapes = " x ".join(str(tuple(a.shape)) for a in args
                                    if isinstance(a, torch.Tensor))
                per_op[f"{packet.__name__} {shapes}"] += n
                return n
            return count

        OA.flop_registry = {p: counted(p) for p in flops_of}
    t = time.time()
    step = build_step(arch, shape_name, mesh, cfg=cfg, info=info)
    cost = OA.analyze_step(step["fn"], mesh=mesh)
    out = {"flops": cost.flops, "traffic": cost.traffic,
           "collective_bytes": cost.collective_bytes, "seconds": time.time() - t}
    if by_op:
        out["by_op"] = dict(per_op)
    return out


def compare(archs, shape_name="train_4k", mesh_shape=(2, 2), batch=8, seq=64,
            full=False, remat=True, by_op=False, timeout=900) -> dict:
    """``{arch: {"repro": counts, "port": counts}}``, one subprocess a
    (package, arch), all at once."""
    procs = {}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    for arch in archs:
        for side in ("repro", "port"):
            cmd = [sys.executable, os.path.abspath(__file__), "--one", side, "--archs", arch,
                   "--shape", shape_name, "--mesh", "x".join(map(str, mesh_shape)),
                   "--batch", str(batch), "--seq", str(seq)] + (["--full"] if full else []) + (
                   [] if remat else ["--no-remat"]) + (["--by-op"] if by_op else [])
            procs[arch, side] = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True)
    out: dict = {}
    for (arch, side), p in procs.items():
        stdout, stderr = p.communicate(timeout=timeout)
        if p.returncode != 0:
            raise RuntimeError(f"{side} {arch} failed:\n{stderr[-3000:]}")
        out.setdefault(arch, {})[side] = json.loads(stdout.strip().splitlines()[-1])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="qwen3-4b,rwkv6-1.6b,mixtral-8x22b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--by-op", action="store_true")
    ap.add_argument("--one", choices=("repro", "port"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(x) for x in args.mesh.split("x"))
    archs = args.archs.split(",")
    mode = {"train_4k": "train", "prefill_32k": "prefill"}.get(args.shape, "decode")
    info = dict(seq=args.seq, batch=args.batch, mode=mode)
    remat = not args.no_remat
    if args.one == "repro":
        os.environ["REPRO_DRYRUN_FLAGS"] = ("--xla_force_host_platform_device_count="
                                            f"{math.prod(mesh_shape)}")
        print(json.dumps(run_repro(archs[0], args.shape, mesh_shape, info, args.full,
                                   remat, args.by_op)))
        return
    if args.one == "port":
        print(json.dumps(run_port(archs[0], args.shape, mesh_shape, info, args.full,
                                  remat, args.by_op)))
        return
    res = compare(archs, args.shape, mesh_shape, args.batch, args.seq, args.full, remat,
                  args.by_op)
    cell = (f"{args.shape} (batch {args.batch}, sequence {args.seq}), mesh {args.mesh}, "
            f"{'full' if args.full else 'reduced'} configs, remat {'on' if remat else 'off'}")
    print(f"per-device counts, {cell}")
    for arch, r in res.items():
        for side in ("repro", "port"):
            for op, n in sorted(r[side].pop("by_op", {}).items(), key=lambda kv: -kv[1]):
                print(f"  {arch} {side:5s} {n:16.0f}  {op}")
        print(json.dumps({"arch": arch, **r}))
        gaps = "  ".join(f"{k} {r['port'][k]:.6g} vs {r['repro'][k]:.6g} "
                         f"({100 * (r['port'][k] / r['repro'][k] - 1):+.2f}%)"
                         if r["repro"][k] else f"{k} {r['port'][k]:.6g} vs 0"
                         for k in KEYS)
        print(f"{arch:16s} {gaps}  (trace {r['port']['seconds']:.1f} s, "
              f"compile {r['repro']['seconds']:.1f} s)")


if __name__ == "__main__":
    main()
