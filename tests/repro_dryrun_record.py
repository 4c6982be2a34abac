"""``repro``'s per-device counts on the dry run's full-size cells, kept in
``tests/data/repro_dryrun_fullsize.json`` so that the port's trace can be
held to them where JAX is not installed (the card's host).

Each entry is one cell: ``repro``'s ``train_4k``, ``prefill_32k``,
``decode_32k`` and ``long_500k`` at their published batch and sequence
(``SHAPES``), for every architecture, on ``single`` (16x16) and ``pod``
(2x16x16), and the reduced cases the tests pin (``REDUCED``).  It holds
the per-device FLOPs, traffic and collective bytes of ``repro``'s compiled
step (JAX's ``analyze_hlo``, on a mesh of Auto axes as
``tests/dryrun_compare.py`` makes it), and the seconds it took; a cell
that ``plan_cells`` skips is listed with its reason.

Write the record (needs JAX; a cell a process, ``--jobs`` at a time,
``--only`` for some keys, which are merged into the file):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/repro_dryrun_record.py --jobs 3

Trace the port through the same cells and compare (no JAX; prints one line
a cell, port against record, and exits 1 if a trace fails or a cell falls
outside what ``differs`` holds it to):

    PYTHONPATH=src python tests/repro_dryrun_record.py --check-port --jobs 5
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RECORD = Path(__file__).resolve().parent / "data" / "repro_dryrun_fullsize.json"
COMPARE = Path(__file__).resolve().parent / "dryrun_compare.py"
KEYS = ("flops", "traffic", "collective_bytes")
MESHES = {"single": (16, 16), "pod": (2, 16, 16)}
# seconds a cell's trace may take (rwkv6's prefill_32k: about 6 min on a CPU)
TIMEOUT = 3000.0
# tests/test_torch_dryrun.py's bounds: per-device FLOPs within FLOPS_BOUND of
# repro's (its BOUNDS), collective bytes at most COLLECTIVE_BOUND x repro's
FLOPS_BOUND = 0.02
COLLECTIVE_BOUND = 1.15
# reduced cases that tests/test_torch_dryrun.py and chip_smoke.py hold: at
# full width, depth cut (F17: one token on 16x16, the families' decode
# at batch 1), and F18's dense projections on a 1x4 mesh
REDUCED = {
    "F17 rwkv6-1.6b long_500k 2 layers": dict(
        arch="rwkv6-1.6b", shape="long_500k", mesh=(16, 16), batch=1, seq=524288,
        full=True, overrides="n_layers=2"),
    "F17 recurrentgemma-2b long_500k 3 layers": dict(
        arch="recurrentgemma-2b", shape="long_500k", mesh=(16, 16), batch=1, seq=524288,
        full=True, overrides="n_layers=3"),
    "F17 mixtral-8x22b long_500k 2 layers": dict(
        arch="mixtral-8x22b", shape="long_500k", mesh=(16, 16), batch=1, seq=524288,
        full=True, overrides="n_layers=2"),
    "F18 qwen3-4b 1x4 d_model 640": dict(
        arch="qwen3-4b", shape="train_4k", mesh=(1, 4), batch=8, seq=64,
        overrides="d_model=640,n_heads=10,head_dim=64"),
    "F18 recurrentgemma-2b 1x4 d_model 640": dict(
        arch="recurrentgemma-2b", shape="train_4k", mesh=(1, 4), batch=8, seq=64,
        overrides="d_model=640,n_heads=10,head_dim=64"),
}


def _rwkv6_gap(batch: int, seq: int, train: bool) -> int:
    """rwkv6-1.6b at full size (24 layers, 32 heads of 64, WKV chunks of
    32; "model" 16) at a per-device ``batch``: XLA splits a head's channels
    and runs A.v for all 32 heads on every device (``f32[b,32,32,64] =
    f32[b,32,32,32] x f32[b,32,32,64]`` a chunk), the port splits the heads
    and runs 2 (``bmm (2b, 32, 32) x (2b, 32, 64)``).  A train step runs
    that kind four times (forward, remat, the backward's two) and XLA's
    scan its dead state products, autograd the bonus term's two batched
    products (``tests/test_torch_dryrun.py::rwkv6_gap`` at full size)."""
    layers, heads, L, K, chunks, local = 24, 32, 32, 64, seq // 32, 2
    av = layers * 2 * batch * chunks * (heads - local) * L * L * K
    if not train:
        return av
    dead = layers * 3 * 2 * batch * L * K * K * local
    bonus = layers * chunks * 2 * 2 * batch * L * K * local
    return 4 * av + dead - bonus


# F13: recurrentgemma-2b's local attention backward, a q-chunk (32 a layer
# stack) at a per-device batch of 16: XLA re-splits f32[16,10,256,4096] =
# f32[16,10,256,256] x f32[16,10,256,4096] over the q-chunk with the whole
# head dim, the port runs bmm (160,1024,16) x (160,16,4096)
_F13 = 2 * 16 * 10 * 256 * 256 * 4096 - 2 * 160 * 1024 * 16 * 4096
# F18: ten heads on 1x4; XLA's backward runs one attention product more
# than the port a q-chunk of an attention layer (tests/test_torch_dryrun.py's
# XLA_RESPLIT): 2 x B x H x 32 x 64 x 16
_F18 = 2 * 8 * 10 * 32 * 64 * 16
# repro's per-device FLOPs less the port's, exactly, where the two differ by
# work accounted for by shape (ROADMAP "Not faults"); every other cell
# equals repro's but for NEAR
GAPS = {
    "rwkv6-1.6b train_4k single": _rwkv6_gap(16, 4096, True),
    "rwkv6-1.6b train_4k pod": _rwkv6_gap(8, 4096, True),
    "rwkv6-1.6b prefill_32k single": _rwkv6_gap(2, 32768, False),
    "rwkv6-1.6b prefill_32k pod": _rwkv6_gap(1, 32768, False),
    "recurrentgemma-2b train_4k single": 32 * _F13,
    "recurrentgemma-2b train_4k pod": 16 * _F13,
    # long_500k on pod: the token comes split over ("pod", "data"), the
    # weights' rows over "data" alone; XLA gathers each weight's rows over
    # "data" and runs it whole over d on every device of a model group (16
    # x the port's product, which keeps the weight as on single): rwkv6's
    # d x d, Ck, Cv and logits products; recurrentgemma's recurrent
    # projections, MLP, KV and q/o; mixtral's every product
    "rwkv6-1.6b long_500k pod": 15 * (4_718_592 + 2_752_512 + 2_752_512 + 1_048_576),
    "recurrentgemma-2b long_500k pod": 69_120_000 + 2 * 59_904_000 + 1_228_800 + 1_331_200,
    "mixtral-8x22b long_500k pod": 15 * 1_097_072_640,
    # qwen3-4b decode_32k on pod: XLA runs each KV projection with its
    # columns whole, f32[8,1024] = f32[8,160] x f32[160,1024], twice the
    # port's mm (4, 2560) x (2560, 64), in 36 layers
    "qwen3-4b decode_32k pod": 36 * (2 * 8 * 160 * 1024 - 2 * 4 * 2560 * 64),
    "F18 qwen3-4b 1x4 d_model 640": 4 * _F18,
    "F18 recurrentgemma-2b 1x4 d_model 640": 2 * _F18,
}
# the decode cells on pod whose gap is not accounted for by shape yet
# (PERF.md §7): per-device FLOPs within FLOPS_BOUND of repro's
NEAR = {f"{arch} decode_32k pod" for arch in (
    "deepseek-v2-236b", "granite-3-8b", "internvl2-26b", "mixtral-8x22b", "starcoder2-15b")}
# F17's cells and the reduced cases: collective bytes at most
# COLLECTIVE_BOUND x repro's
COLLECTIVE_HELD = {f"{arch} {shape} {mesh}" for arch in ("rwkv6-1.6b", "recurrentgemma-2b")
                   for shape in ("decode_32k", "long_500k") for mesh in MESHES} | set(REDUCED)


def differs(key: str, got: dict, want: dict) -> str | None:
    """How the port's counts ``got`` of the cell ``key`` differ from what
    they are held to against ``repro``'s ``want`` (its record entry):
    per-device FLOPs equal to ``repro``'s less ``GAPS``' gap, or within
    ``FLOPS_BOUND`` on ``NEAR``; collective bytes within
    ``COLLECTIVE_BOUND`` on ``COLLECTIVE_HELD``.  None where they hold."""
    port, repro = got["flops"], want["flops"]
    if key in NEAR:
        if not abs(port / repro - 1) <= FLOPS_BOUND:
            return f"FLOPs {port:.0f} not within {FLOPS_BOUND:.0%} of repro's {repro:.0f}"
    elif repro - port != GAPS.get(key, 0):
        return (f"FLOPs {port:.0f}: repro's {repro:.0f} less {repro - port:.0f}, "
                f"not the accounted {GAPS.get(key, 0)}")
    if key in COLLECTIVE_HELD and not (
            0 < got["collective_bytes"] <= COLLECTIVE_BOUND * want["collective_bytes"]):
        return (f"collective bytes {got['collective_bytes']:.0f} past {COLLECTIVE_BOUND} x "
                f"repro's {want['collective_bytes']:.0f}")
    return None


def cells() -> dict:
    """``{key: cell}`` for every full-size cell and reduced case: a cell
    is ``tests/dryrun_compare.py``'s ``--cells`` entry, or ``{"reason":
    ...}`` for one ``plan_cells`` skips."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.dryrun import SHAPES, plan_cells

    out: dict = {}
    for arch, shape, skip in plan_cells():
        for mesh in MESHES:
            info = SHAPES[shape]
            out[f"{arch} {shape} {mesh}"] = ({"reason": skip} if skip else dict(
                arch=arch, shape=shape, mesh=MESHES[mesh], batch=info["batch"],
                seq=info["seq"], full=True))
    return out | REDUCED


def load(path=RECORD) -> dict:
    return json.loads(Path(path).read_text())


def trace_command(side: str, key: str, cell: dict) -> tuple:
    """``(argv, env)`` of a process that traces one cell from ``side``
    (``tests/dryrun_compare.py --one``) and prints ``{key: counts}`` as
    its last line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return ([sys.executable, str(COMPARE), "--one", side, "--cells", json.dumps({key: cell})],
            env)


def trace(side: str, key: str, cell: dict) -> dict:
    """One cell's counts from ``side`` in a process of its own, or
    ``{"error": ...}``."""
    argv, env = trace_command(side, key, cell)
    t = time.time()
    try:
        r = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        return {"error": f"over {TIMEOUT:.0f} s"}
    if r.returncode != 0:
        return {"error": r.stderr.strip().splitlines()[-1][:300] if r.stderr else "failed"}
    got = json.loads(r.stdout.strip().splitlines()[-1])[key]
    return {k: got[k] for k in KEYS} | {"seconds": round(time.time() - t, 1)}


def _runnable(keys) -> dict:
    every = cells()
    chosen = {k: every[k] for k in (keys or every)}
    # the largest meshes and the slowest cells first
    return dict(sorted(chosen.items(), key=lambda kv: (
        "reason" in kv[1], -math.prod(kv[1].get("mesh", (1,))),
        kv[1].get("shape") != "train_4k")))


def write_record(keys: list, jobs: int):
    import jax

    record = load() if RECORD.exists() else {}
    todo = _runnable(keys)
    with ThreadPoolExecutor(jobs) as pool:
        futs = {k: pool.submit(trace, "repro", k, c) for k, c in todo.items()
                if "reason" not in c}
        for k, c in todo.items():
            entry = {"reason": c["reason"]} if "reason" in c else {
                **{f: c[f] for f in ("arch", "shape", "batch", "seq") if f in c},
                "mesh": "x".join(map(str, c["mesh"])),
                "overrides": c.get("overrides", ""), "full": c.get("full", False),
                **futs[k].result()}
            record[k] = entry
            print(k, json.dumps(entry), flush=True)
    order = list(cells())
    record = {k: record[k] for k in order if k in record}
    record["_about"] = {"jax": jax.__version__, "written": time.strftime("%Y-%m-%d"),
                        "note": "per-device counts of repro's compiled step, "
                                "tests/dryrun_compare.py's mesh of Auto axes"}
    RECORD.parent.mkdir(exist_ok=True)
    RECORD.write_text(json.dumps(record, indent=1) + "\n")


def check_port(keys: list, jobs: int) -> int:
    import torch

    record = load()
    todo = {k: c for k, c in _runnable(keys).items() if "reason" not in c}
    bad = 0
    print(f"torch {torch.__version__}; port against repro's record "
          "(FLOPs, collective bytes, trace seconds)", flush=True)
    with ThreadPoolExecutor(jobs) as pool:
        futs = {k: pool.submit(trace, "port", k, c) for k, c in todo.items()}
        for k in todo:
            got, want = futs[k].result(), record.get(k, {})
            if "error" in got or "flops" not in want:
                bad += 1
                print(f"{k:48s} {got.get('error') or 'no entry in the record'} "
                      f"{json.dumps(got)}", flush=True)
                continue
            f = got["flops"] / want["flops"] - 1
            c = got["collective_bytes"] / want["collective_bytes"] \
                if want["collective_bytes"] else float("nan")
            why = differs(k, got, want)
            bad += why is not None
            print(f"{k:48s} flops {got['flops']:.0f} vs {want['flops']:.0f} ({100 * f:+.2f}%)  "
                  f"collective {got['collective_bytes']:.4g} vs {want['collective_bytes']:.4g} "
                  f"({c:.3f}x)  trace {got['seconds']} s{'  ' + why if why else ''}", flush=True)
    print(f"{len(todo)} cells, {bad} failed or not held")
    return 1 if bad else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check-port", action="store_true")
    ap.add_argument("--only", default="", help="comma-separated keys (default: all)")
    ap.add_argument("--jobs", type=int, default=3)
    args = ap.parse_args(argv)
    keys = [k for k in args.only.split(",") if k]
    if args.check_port:
        return check_port(keys, args.jobs)
    write_record(keys, args.jobs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
