#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. device  — needs ``torch.cuda.is_available()``; prints the card.
2. build   — compiles every CUDA source (one ``nvcc`` each, in parallel)
             and prints the ``-Xptxas -v`` register / shared-memory lines.
3. K1      — the superstep kernel against its plain version, bit for bit,
             over class widths 1..4096, both heuristics, sentinel-padded
             worklists of odd lengths.
4. K2      — the serial-tail kernel against its plain version, bit for bit.
5. slice   — every SUITE graph at scale 0.25 through ``color`` on the card
             and on the CPU: every ``ColoringResult`` field equal.
6. full    — the paper's three 1M-vertex graphs (rmat-er, rmat-g, thermal2)
             on the card: valid colorings, K1 and K2 launch counts above 0,
             rmat-er's colors equal to the serial-greedy oracle; times,
             per-kernel times from CUDA events, peak memory.

The line before the last is the kernels' JSON record, and the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import color  # noqa: E402
from repro_torch.core.coloring import _resolve_classes, order_tail  # noqa: E402
from repro_torch.core.csr import DeviceCSR, csr_from_edges  # noqa: E402
from repro_torch.core.serial import greedy_serial  # noqa: E402
from repro_torch.core.validate import is_valid_coloring  # noqa: E402
from repro_torch.graphs import RMAT_ER, RMAT_G, SUITE, build_graph, grid2d, rmat  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.superstep.csr_kernel import (  # noqa: E402
    serial_tail_csr,
    serial_tail_csr_ref,
    superstep_csr,
    superstep_csr_ref,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
RESULT_FIELDS = ("iterations", "work_items", "padded_work", "class_cells",
                 "converged")
KERNELS = (superstep_csr, serial_tail_csr)


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def event_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(deg_ext: np.ndarray, wl: np.ndarray, W: int) -> float:
    """Least time to move the bytes K1 or K2 must move, over HBM's rate.

    Both move 20 B per worklist entry (K1: wl, R[v], packed[v] in, new
    color and need out; K2: wl, starts, degs in, the clear and the color
    out) and 8 B per neighbour read (C and the neighbour's packed word or
    color), counting each row up to the class width W.
    """
    nbytes = int(wl.size) * 20 + int(np.minimum(deg_ext[wl], W).sum()) * 8
    return nbytes / HBM_BYTES_PER_S * 1e3


# --------------------------------------------------------------------------
# phase 3-4 inputs
# --------------------------------------------------------------------------

def k1_graph(W: int, rng, n: int | None = None):
    """Random graph with rows up to ~0.9 W wide (a few hubs) plus a sparse
    random background, so one class width W covers ragged rows."""
    n = n or max(4 * W, 2000)
    m = int(n * min(6.0, max(0.5 * W, 0.5)) / 2)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    if W > 16:
        hubs = rng.choice(n, 6, replace=False)
        k = int(0.9 * W) - 10
        src = np.concatenate([src, np.repeat(hubs, k)])
        dst = np.concatenate([dst, rng.integers(0, n, 6 * k)])
    return csr_from_edges(n, src, dst)


def k1_cases(rng):
    """(label, W, graph, worklist, colors) inputs for the K1 check.

    Per width: a ragged random graph with random colours in [0, W+1] and
    with low colours in [0, 40] (a hub's first bitset word fills up); and
    for W >= 32 a (W+1)-clique holding a permutation of 1..W+1 whose
    cleared or conflicting vertices all hold colours above 32, so every
    refit takes the shared-bitset path, its answer at or past the first
    word boundary.
    """
    for W in (1, 8, 26, 31, 32, 33, 63, 64, 376, 4096):
        g = k1_graph(W, rng)
        deg = g.degrees
        ok_ids = np.flatnonzero(deg <= W).astype(np.int32)
        hubs = ok_ids[np.argsort(-deg[ok_ids], kind="stable")[:6]]
        pick = rng.choice(ok_ids, min(ok_ids.size, 3001), replace=False)
        wl = np.concatenate([hubs, pick, np.full(7, g.n, np.int32)]).astype(np.int32)
        rng.shuffle(wl)
        for mode, hi in (("random", W + 1), ("low", min(W + 1, 40))):
            colors = rng.integers(0, hi + 1, g.n + 1).astype(np.int32)
            colors[g.n] = 0
            yield mode, W, g, wl, colors
        if 32 <= W <= 376:
            src, dst = np.triu_indices(W + 1, 1)
            g = csr_from_edges(W + 1, src, dst)
            colors = np.concatenate([rng.permutation(W + 1) + 1, [0]]).astype(np.int32)
            high = rng.permutation(np.flatnonzero(colors > 32))
            colors[high[:2]] = 0  # refit while every colour in 1..32 is taken
            if high.size >= 4:
                colors[high[2]] = colors[high[3]]  # a conflict above 32
            wl = np.concatenate([rng.permutation(W + 1),
                                 np.full(5, W + 1)]).astype(np.int32)
            yield "clique", W, g, wl, colors


def check_k1(dev_cuda):
    cases = 0
    for mode, W, g, wl, colors in k1_cases(np.random.default_rng(11)):
        cpu = DeviceCSR.from_csr(g, "cpu")
        gpu = DeviceCSR.from_csr(g, dev_cuda)
        packed = torch.from_numpy(colors) + (cpu.deg_ext << 16)
        for heuristic in ("id", "degree"):
            want_c, want_n = superstep_csr_ref(
                cpu.row_starts, cpu.col_padded, packed, torch.from_numpy(wl),
                W, heuristic)
            got_c, got_n = superstep_csr(
                gpu.row_starts, gpu.col_padded, packed.to(dev_cuda),
                torch.from_numpy(wl).to(dev_cuda), W, heuristic)
            torch.cuda.synchronize()
            if not (torch.equal(want_c, got_c.cpu())
                    and torch.equal(want_n, got_n.cpu())):
                bad = (want_c != got_c.cpu()).nonzero().flatten()[:5].tolist()
                fail(f"K1 differs from its plain version: W={W} {mode} "
                     f"{heuristic} w={wl.size}, first rows {bad}")
            cases += 1
    print(f"K1 == plain on {cases} cases (W from 1 to 4096, both heuristics, "
          "random, low and clique colors, sentinels)", flush=True)


def check_k2(dev_cuda):
    rng = np.random.default_rng(13)
    graphs = {8: grid2d(80, 80, diagonals=True),
              376: k1_graph(376, rng, n=6000)}
    cases = 0
    for W, g in graphs.items():
        if g.max_degree > W:
            fail(f"K2 test graph has max degree {g.max_degree} > W={W}")
        cpu = DeviceCSR.from_csr(g, "cpu")
        gpu = DeviceCSR.from_csr(g, dev_cuda)
        # the widest rows always join the worklist; "low" colours 1..32 on
        # the vertices outside it fill a hub's first bitset word, so K2's
        # shared-bitset path (all of 1..32 taken) runs too
        hubs = np.argsort(-g.degrees, kind="stable")[:6].astype(np.int32)
        rest = np.setdiff1d(np.arange(g.n, dtype=np.int32), hubs)
        modes = [("random", 0, W + 1)] + ([("low", 1, 32)] if W >= 32 else [])
        for T, (mode, lo, hi) in ((T, m) for T in (1, 37, 1024, 4096) for m in modes):
            s = min(7, T // 8)
            k = min(len(hubs), T - s)
            ids = np.concatenate([hubs[:k], rng.choice(rest, T - s - k, replace=False)])
            wl = order_tail(torch.from_numpy(
                np.concatenate([ids, np.full(s, g.n, np.int32)]).astype(np.int32)),
                cpu.deg_ext)
            colors = rng.integers(lo, hi + 1, g.n + 1).astype(np.int32)
            colors[g.n] = 0
            want = serial_tail_csr_ref(cpu.row_starts, cpu.col_padded, cpu.deg_ext,
                                       torch.from_numpy(colors.copy()), wl, W)
            got = serial_tail_csr(gpu.row_starts, gpu.col_padded, gpu.deg_ext,
                                  torch.from_numpy(colors).to(dev_cuda),
                                  wl.to(dev_cuda), W)
            torch.cuda.synchronize()
            if not torch.equal(want, got.cpu()):
                bad = (want != got.cpu()).nonzero().flatten()[:5].tolist()
                fail(f"K2 differs from its plain version: W={W} T={T} {mode}, "
                     f"first slots {bad}")
            cases += 1
    print(f"K2 == plain on {cases} cases (T in 1, 37, 1024, 4096; W in 8, 376; "
          "random and low colors; sentinels)", flush=True)


def check_slice(dev_cuda):
    for name in SUITE:
        g = build_graph(name, 0.25)
        a = color(g, device=dev_cuda)
        b = color(g, device="cpu")
        same = np.array_equal(a.colors, b.colors) and all(
            getattr(a, f) == getattr(b, f) for f in RESULT_FIELDS)
        if not same:
            diff = [(f, getattr(a, f), getattr(b, f)) for f in RESULT_FIELDS
                    if getattr(a, f) != getattr(b, f)]
            fail(f"slice parity: {name} card != cpu: "
                 f"{int((a.colors != b.colors).sum())} colors differ, {diff}")
        if not is_valid_coloring(g, a.colors):
            fail(f"slice parity: {name} coloring is not valid")
        print(f"slice {name:14s} n={g.n:6d} iters={a.iterations} "
              f"colors={a.num_colors} card == cpu", flush=True)


# --------------------------------------------------------------------------
# phase 6: the paper's sizes
# --------------------------------------------------------------------------

FULL = {
    "rmat-er": lambda: rmat(1 << 20, 10.0, RMAT_ER, seed=2),
    "rmat-g": lambda: rmat(1 << 20, 10.0, RMAT_G, seed=3),
    "thermal2": lambda: grid2d(3125, 384, diagonals=True),
}


def kernel_times(g, dev_cuda, plain: bool) -> dict:
    """K1 per class at the first real superstep's inputs (every vertex
    colored 1, after the bootstrap identity), and K2 at the stall tail's
    inputs (all n vertices in ``order_tail`` order): CUDA-event times,
    byte bounds and, with ``plain``, the plain versions' CPU times and a
    bit-for-bit check at these shapes."""
    gpu = DeviceCSR.from_csr(g, dev_cuda)
    deg_np = np.concatenate([g.degrees, [0]]).astype(np.int64)
    colors = torch.ones(g.n + 1, dtype=torch.int32, device=dev_cuda)
    colors[g.n] = 0
    packed = colors + (gpu.deg_ext << 16)
    classes, widths = _resolve_classes(g.degrees, (), "auto")
    k1 = []
    for cls, W in zip(classes, widths):
        wl = torch.from_numpy(cls).to(dev_cuda)
        ms = event_ms(lambda: superstep_csr(gpu.row_starts, gpu.col_padded,
                                            packed, wl, W), reps=10, warm=2)
        rec = {"W": W, "w": int(cls.size), "ms": ms,
               "bound_ms": bound_ms(deg_np, cls, W)}
        if plain:
            got = superstep_csr(gpu.row_starts, gpu.col_padded, packed, wl, W)
            t = time.perf_counter()
            want = superstep_csr_ref(gpu.row_starts.cpu(), gpu.col_padded.cpu(),
                                     packed.cpu(), wl.cpu(), W)
            rec["plain_ms"] = (time.perf_counter() - t) * 1e3
            rec["max_abs_err"] = max(
                int((want[0] - got[0].cpu()).abs().max()),
                int((want[1].int() - got[1].cpu().int()).abs().max()))
            if rec["max_abs_err"]:
                fail(f"K1 differs from its plain version at W={W}, w={cls.size}")
        k1.append(rec)
    tail = order_tail(torch.arange(g.n, dtype=torch.int32, device=dev_cuda),
                      gpu.deg_ext)
    W = max(g.max_degree, 1)
    work = colors.clone()
    k2 = {"W": W, "T": g.n,
          "ms": event_ms(lambda: serial_tail_csr(
              gpu.row_starts, gpu.col_padded, gpu.deg_ext, work, tail, W),
              reps=3, warm=1),
          "bound_ms": bound_ms(deg_np, tail.cpu().numpy(), W)}
    if plain:
        got = serial_tail_csr(gpu.row_starts, gpu.col_padded, gpu.deg_ext,
                              colors.clone(), tail, W)
        t = time.perf_counter()
        want = serial_tail_csr_ref(gpu.row_starts.cpu(), gpu.col_padded.cpu(),
                                   gpu.deg_ext.cpu(), colors.cpu(), tail.cpu(), W)
        k2["plain_ms"] = (time.perf_counter() - t) * 1e3
        k2["max_abs_err"] = int((want - got.cpu()).abs().max())
        if k2["max_abs_err"]:
            fail(f"K2 differs from its plain version at T={g.n}, W={W}")
    return {"k1": k1, "k2": k2}


def device_us(event) -> float:
    """A profiler row's own device time (the name changed across torch
    versions)."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def profile_color(g, dev_cuda):
    """Device time by kernel for one ``color()`` call, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        color(g, device=dev_cuda)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = [(e.key, device_us(e) / 1e3, e.count)
            for e in prof.key_averages() if device_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if not rows:
        print("  profiler: no device time recorded (not measured)")
        return
    print(f"  profiler: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), top kernels:")
    for key, ms, count in rows[:8]:
        print(f"    {ms:10.3f} ms  x{count:<5d} {key[:90]}")


def check_full(dev_cuda) -> dict:
    totals = {k.__name__: 0 for k in KERNELS}
    times = {}
    for name, make in FULL.items():
        t = time.perf_counter()
        g = make()
        gen_s = time.perf_counter() - t
        reset_counts()
        r = color(g, device=dev_cuda)  # the main path's counted run
        counts = {k.__name__: k.launches for k in KERNELS}
        for k, c in counts.items():
            totals[k] += c
            if c == 0:
                fail(f"full {name}: kernel {k} was not launched on the main path")
        if not is_valid_coloring(g, r.colors):
            fail(f"full {name}: coloring is not valid")
        if name == "rmat-er":
            ids = np.arange(g.n)
            want = greedy_serial(g, order=np.lexsort((ids, -g.degrees)))
            if not np.array_equal(want, r.colors):
                fail(f"full {name}: colors differ from the serial-greedy oracle "
                     f"in {int((want != r.colors).sum())} vertices")
        walls, peaks = [], []
        for _ in range(3):
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            again = color(g, device=dev_cuda)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated())
            if not np.array_equal(again.colors, r.colors):
                fail(f"full {name}: a repeated run gave other colors")
        kt = kernel_times(g, dev_cuda, plain=(name == "rmat-er"))
        times[name] = kt
        print(f"full {name}: n={g.n} nnz={g.m} dmax={g.max_degree} "
              f"(built in {gen_s:.1f} s) iters={r.iterations} "
              f"colors={r.num_colors} class_cells={r.class_cells}", flush=True)
        print(f"  color(): median {statistics.median(walls):.3f} ms of "
              f"{[round(w, 3) for w in walls]}, peak device memory "
              f"{max(peaks) / 2**20:.1f} MiB, launches {counts}")
        for rec in kt["k1"]:
            print(f"  K1 W={rec['W']:4d} w={rec['w']:8d}: {rec['ms']:.4f} ms "
                  f"(bound {rec['bound_ms']:.4f} ms)"
                  + (f", plain {rec['plain_ms']:.1f} ms" if "plain_ms" in rec else ""))
        k2 = kt["k2"]
        print(f"  K2 W={k2['W']} T={k2['T']}: {k2['ms']:.3f} ms "
              f"({1e6 * k2['ms'] / k2['T']:.1f} ns/vertex; byte bound "
              f"{k2['bound_ms']:.4f} ms)"
              + (f", plain {k2['plain_ms']:.1f} ms" if "plain_ms" in k2 else ""),
              flush=True)
        profile_color(g, dev_cuda)
    return {"launches": totals, "times": times}


def kernels_record(full: dict) -> list:
    """The kernels' JSON record: launches from the main path's runs, times
    and bounds at rmat-er's shapes (K1: mean per launch over the first
    superstep's classes; K2: the stall tail over all n vertices)."""
    er = full["times"]["rmat-er"]
    k1 = er["k1"]
    return [
        {"name": "superstep_csr", "route": "cuda",
         "source": "src/repro_torch/csrc/superstep_csr.cu",
         "replaces": "src/repro/kernels/superstep/csr_kernel.py:62",
         "launches": full["launches"]["superstep_csr"],
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "ms": statistics.fmean(r["ms"] for r in k1),
         "plain_ms": statistics.fmean(r["plain_ms"] for r in k1),
         "bound_ms": statistics.fmean(r["bound_ms"] for r in k1),
         "bound_by": "bytes", "library_ms": None},
        {"name": "serial_tail_csr", "route": "cuda",
         "source": "src/repro_torch/csrc/superstep_csr.cu",
         "replaces": "src/repro/kernels/superstep/csr_kernel.py:223",
         "launches": full["launches"]["serial_tail_csr"],
         "max_abs_err": er["k2"]["max_abs_err"],
         "ms": er["k2"]["ms"], "plain_ms": er["k2"]["plain_ms"],
         "bound_ms": er["k2"]["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
    ]


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    dev_cuda = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"nvidia-smi: {card}", flush=True)

    t = time.perf_counter()
    logs = build.build()
    print(f"build: {', '.join(logs)} in {time.perf_counter() - t:.1f} s")
    for name, log in logs.items():  # the -Xptxas -v report, per kernel
        for line in log.splitlines():
            if any(key in line for key in ("Compiling entry", "registers",
                                           "spill", "smem")):
                print(f"  {name}: {line.split('ptxas info    :')[-1].strip()}")

    check_k1(dev_cuda)
    check_k2(dev_cuda)
    check_slice(dev_cuda)
    full = check_full(dev_cuda)

    kernels = kernels_record(full)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
