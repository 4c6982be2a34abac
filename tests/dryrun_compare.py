"""The port's dry run against ``repro``'s, cell by cell, on the CPU (a
helper of ``tests/test_torch_dryrun.py``; like the tests, it imports both).

For each architecture's reduced config at one cell (``train_4k``'s mode at
a cut batch and sequence by default) on a small mesh, ``repro`` lowers and
compiles the step for that many host devices on a mesh of Auto axes and
reads ``analyze_hlo``; the port traces the same step on ``meta`` under a
fake process group and reads ``analyze_step``.  One subprocess per
(package, architecture), all started together; prints one JSON object per
architecture and a table of per-device FLOPs, traffic and collective bytes.

    PYTHONPATH=src python tests/dryrun_compare.py --archs all --mesh 2x2

``--archs`` takes a comma-separated list or ``all`` (the ten families);
``--full`` runs the archs' full configs instead of ``reduced()`` (the
port's trace of a full train cell takes minutes on the CPU; ``--timeout``
gives each process its seconds, 900 by default);
``--no-remat`` turns the three remat switches off in both packages;
``--set k=v,...`` overrides config fields in both (e.g.
``--set moe_group_seq=16,attn_q_chunk=16`` for several MoE and attention
chunks a layer); ``--by-op`` adds each package's FLOPs by matmul shape
(``repro``: each ``dot`` of the optimized HLO times its loops' trip
counts; the port: each local ``mm``/``bmm``) and its collective bytes by
op (``repro``: each collective's kind, output type and group size; the
port: the same), the port's each with the ``repro_torch`` lines that
issued it (``_call_site``): the op-by-op comparison.  The port's side
also counts the RWKV-6 chunks and decode steps that ran on local shards
(``local_heads``: ``rwkv6._local_heads`` by function).
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


def _config(get_config, arch, full, remat, overrides=()):
    cfg = get_config(arch) if full else get_config(arch).reduced()
    if not remat:
        cfg = dataclasses.replace(cfg, remat=False, attn_chunk_remat=False, moe_remat=False)
    return dataclasses.replace(cfg, **dict(overrides))


def _overrides(text: str) -> dict:
    """``"k=v,..."`` -> ``{k: v}``, each value an int, a float, a bool or
    the string as given."""
    out = {}
    for item in filter(None, text.split(",")):
        k, v = item.split("=", 1)
        for conv in (int, float, {"True": True, "False": False}.__getitem__):
            try:
                v = conv(v)
                break
            except (ValueError, KeyError):
                pass
        out[k] = v
    return out


def _repro_by_op(hlo_text: str) -> tuple[dict, dict]:
    """``({"out = lhs x rhs": FLOPs}, {"op out-type n=N": moved bytes})``
    over the HLO's dots and collectives, each times the trip counts of the
    loops around it (``analyze_hlo``'s arithmetic)."""
    from repro.launch import hlo_analysis as H

    mod = H._Module(hlo_text)
    out: collections.Counter = collections.Counter()
    colls: collections.Counter = collections.Counter()

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
            elif op in H._COLL_OPS or (op.endswith("-start") and op[:-6] in H._COLL_OPS):
                base = op[:-6] if op.endswith("-start") else op
                gm, gb = H._GROUPS_RE.search(line), H._GROUPS_BRACE_RE.search(line)
                n = int(gm.group(2)) if gm else len(gb.group(1).split(",")) if gb else 2
                colls[f"{base} {t.split('{')[0]} n={n}"] += k * H._coll_moved(
                    base, H._shape_bytes(t), n)
            elif op in ("fusion", "call") and (m := H._CALLS.search(line)):
                walk(m.group(1), k)
            elif op == "while":
                body, cond = H._CALLS.search(line), H._COND.search(line)
                trips = H._TRIP_RE.search(line)
                n = int(trips.group(1)) if trips else (mod._trip_count(cond.group(1)) or 1)
                walk(body.group(1), k * n)

    walk(mod.entry, 1)
    return dict(out), dict(colls)


def run_repro(arch, shape_name, mesh_shape, info, full, remat=True, by_op=False,
              overrides=()):
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
    cfg = _config(get_config, arch, full, remat, overrides)
    t = time.time()
    text = D.build_lowered(arch, shape_name, mesh, cfg=cfg).compile().as_text()
    hc = analyze_hlo(text)
    out = {"flops": hc.flops, "traffic": hc.traffic,
           "collective_bytes": hc.collective_bytes, "seconds": time.time() - t}
    if by_op:
        out["by_op"], out["collectives_by_op"] = _repro_by_op(text)
    return out


def _call_site() -> str:
    """The three innermost ``repro_torch`` frames below the analyzer
    (``file:line function``, outer first), after ``backward`` when the
    backward issued the op (a recompute's frames follow it)."""
    import traceback

    import torch

    frames = [f"{os.path.basename(fr.filename)}:{fr.lineno} {fr.name}"
              for fr in traceback.extract_stack()
              if f"{os.sep}repro_torch{os.sep}" in fr.filename
              and "op_analysis" not in fr.filename]
    bwd = torch._C._current_graph_task_id() != -1
    return " > ".join((["backward"] if bwd else []) + frames[-3:])


def run_port(arch, shape_name, mesh_shape, info, full, remat=True, by_op=False,
             overrides=()):
    """The port's per-device counts (this process: a fake group of the
    mesh's world size)."""
    import torch

    import repro_torch.launch.op_analysis as OA
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import build_step, make_mesh

    mesh = make_mesh(mesh_shape, _axes(mesh_shape))
    cfg = _config(get_config, arch, full, remat, overrides)
    per_op: collections.Counter = collections.Counter()
    per_coll: collections.Counter = collections.Counter()
    if by_op:
        flops_of = dict(OA.flop_registry)

        def counted(packet):
            def count(*args, out_val=None, **kwargs):
                n = flops_of[packet](*args, out_val=out_val, **kwargs)
                shapes = " x ".join(str(tuple(a.shape)) for a in args
                                    if isinstance(a, torch.Tensor))
                per_op[f"{packet.__name__} {shapes}  {_call_site()}"] += n
                return n
            return count

        OA.flop_registry = {p: counted(p) for p in flops_of}
        record = OA._Recorder._collective

        def collective(self, name, args, out):
            before = self.cost.collective_bytes
            record(self, name, args, out)
            op, _nb, n = self.cost.events[-1]
            per_coll[f"{op} {str(out.dtype).split('.')[-1]}{list(out.shape)} n={n}  "
                     f"{_call_site()}"] += self.cost.collective_bytes - before

        OA._Recorder._collective = collective
    import repro_torch.models.rwkv6 as rwkv6

    local = rwkv6._local_heads
    on_shards = collections.Counter()

    def counted_local(fn, *args):
        out = local(fn, *args)
        on_shards[fn.__name__] += out is not None
        return out

    rwkv6._local_heads = counted_local
    t = time.time()
    try:
        step = build_step(arch, shape_name, mesh, cfg=cfg, info=info)
        cost = OA.analyze_step(step["fn"], mesh=mesh)
    finally:
        rwkv6._local_heads = local
    out = {"flops": cost.flops, "traffic": cost.traffic,
           "collective_bytes": cost.collective_bytes, "seconds": time.time() - t,
           "local_heads": dict(on_shards)}
    if by_op:
        out["by_op"], out["collectives_by_op"] = dict(per_op), dict(per_coll)
    return out


def start_cells(cells: dict, processes: int = 4) -> list:
    """``cells`` (``{name: dict(arch=, shape=, mesh=, batch=8, seq=64,
    remat=True, overrides="", full=False, by_op=False)}``) run in
    ``processes`` processes a package, each cell in one of them, all
    started at once (a process compiles or traces its cells in turn, so
    JAX, torch and a compile's setup load once a process, not once a
    cell): handles for ``finish_cells``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    # the largest meshes first, each to the process with the fewest cells
    # so far (a cell's time grows with its mesh, but far slower than its
    # device count: 16x16 cells at full width take seconds)
    parts = [{} for _ in range(min(processes, len(cells)))]
    load = [0] * len(parts)
    for n in sorted(cells, key=lambda n: -math.prod(cells[n]["mesh"])):
        i = load.index(min(load))
        parts[i][n] = cells[n]
        load[i] += 1
    procs = []
    for side in ("repro", "port"):
        for part in parts:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", side,
                   "--cells", json.dumps(part)]
            procs.append((side, subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True)))
    return procs


def finish_cells(procs: list, timeout=900) -> dict:
    """``{name: {"repro": counts, "port": counts}}`` from ``start_cells``."""
    out: dict = {}
    for side, p in procs:
        stdout, stderr = p.communicate(timeout=timeout)
        if p.returncode != 0:
            raise RuntimeError(f"{side} cells failed:\n{stderr[-3000:]}")
        for name, counts in json.loads(stdout.strip().splitlines()[-1]).items():
            out.setdefault(name, {})[side] = counts
    return out


def _run_cells(side: str, cells: dict) -> dict:
    """This process's ``--cells``, one after another."""
    if side == "repro":
        os.environ["REPRO_DRYRUN_FLAGS"] = ("--xla_force_host_platform_device_count="
                                            f"{max(math.prod(c['mesh']) for c in cells.values())}")
    run = run_repro if side == "repro" else run_port
    out = {}
    for name, c in cells.items():
        mode = {"train_4k": "train", "prefill_32k": "prefill"}.get(c["shape"], "decode")
        out[name] = run(c["arch"], c["shape"], tuple(c["mesh"]),
                        dict(seq=c.get("seq", 64), batch=c.get("batch", 8), mode=mode),
                        c.get("full", False), c.get("remat", True), c.get("by_op", False),
                        _overrides(c.get("overrides", "")))
    return out


def compare(archs, shape_name="train_4k", mesh_shape=(2, 2), batch=8, seq=64,
            full=False, remat=True, by_op=False, overrides="", timeout=900) -> dict:
    """``{arch: {"repro": counts, "port": counts}}``, one process a
    (package, arch), all at once."""
    cells = {arch: dict(arch=arch, shape=shape_name, mesh=mesh_shape, batch=batch, seq=seq,
                        full=full, remat=remat, by_op=by_op, overrides=overrides)
             for arch in archs}
    return finish_cells(start_cells(cells, processes=len(archs)), timeout)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="all")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--by-op", action="store_true")
    ap.add_argument("--set", default="", metavar="K=V,...")
    ap.add_argument("--timeout", type=float, default=900,
                    help="seconds each comparison process may take")
    ap.add_argument("--one", choices=("repro", "port"), help=argparse.SUPPRESS)
    ap.add_argument("--cells", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cells:
        print(json.dumps(_run_cells(args.one, json.loads(args.cells))))
        return
    mesh_shape = tuple(int(x) for x in args.mesh.split("x"))
    if args.archs == "all":
        sys.path.insert(0, os.path.join(ROOT, "src"))
        from repro_torch.configs import list_archs

        archs = list_archs()
    else:
        archs = args.archs.split(",")
    overrides = _overrides(args.set)
    mode = {"train_4k": "train", "prefill_32k": "prefill"}.get(args.shape, "decode")
    info = dict(seq=args.seq, batch=args.batch, mode=mode)
    remat = not args.no_remat
    if args.one == "repro":
        os.environ["REPRO_DRYRUN_FLAGS"] = ("--xla_force_host_platform_device_count="
                                            f"{math.prod(mesh_shape)}")
        print(json.dumps(run_repro(archs[0], args.shape, mesh_shape, info, args.full,
                                   remat, args.by_op, overrides)))
        return
    if args.one == "port":
        print(json.dumps(run_port(archs[0], args.shape, mesh_shape, info, args.full,
                                  remat, args.by_op, overrides)))
        return
    res = compare(archs, args.shape, mesh_shape, args.batch, args.seq, args.full, remat,
                  args.by_op, args.set, args.timeout)
    cell = (f"{args.shape} (batch {args.batch}, sequence {args.seq}), mesh {args.mesh}, "
            f"{'full' if args.full else 'reduced'} configs, remat {'on' if remat else 'off'}"
            + (f", {args.set}" if args.set else ""))
    print(f"per-device counts, {cell}")
    for arch, r in res.items():
        for side in ("repro", "port"):
            for op, n in sorted(r[side].pop("by_op", {}).items(), key=lambda kv: -kv[1]):
                print(f"  {arch} {side:5s} {n:16.0f}  {op}")
        for side in ("repro", "port"):
            for op, n in sorted(r[side].pop("collectives_by_op", {}).items(),
                                key=lambda kv: -kv[1]):
                print(f"  {arch} {side:5s} {n:16.0f} B  {op}")
        print(json.dumps({"arch": arch, **r}))
        gaps = "  ".join(f"{k} {r['port'][k]:.6g} vs {r['repro'][k]:.6g} "
                         f"({100 * (r['port'][k] / r['repro'][k] - 1):+.2f}%)"
                         if r["repro"][k] else f"{k} {r['port'][k]:.6g} vs 0"
                         for k in KEYS)
        print(f"{arch:16s} {gaps}  (trace {r['port']['seconds']:.1f} s, "
              f"compile {r['repro']['seconds']:.1f} s)")


if __name__ == "__main__":
    main()
