#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. device  — needs ``torch.cuda.is_available()``; prints the card and the
             host CPU.
2. build   — compiles every CUDA source (one ``nvcc`` each, in parallel)
             and prints the ``-Xptxas -v`` register / shared-memory lines.
3. K1      — the superstep over packed CSR words against its plain
             version, bit for bit, over class widths 1..4096, both
             heuristics, sentinel-padded worklists of odd lengths, in each
             layout (1, 4, 8, 16, 32 lanes a row).
4. K2      — the serial-tail kernel against its plain version, bit for bit,
             through its wrappers and in each layout (a thread or a warp an
             entry): CSR tails of 1..4096 entries at W = 8 and 376, a
             100,000-vertex path in id order (a chain as deep as the tail),
             ``grid2d(300, 300)`` in ``order_tail`` order, rows laid out by
             hand (asymmetric, self, duplicate and sentinel lanes, colours
             past 32) and composed two-hop rows at W = 702.
5. K3-K5   — K3 over each of its row sources (the gathered tiles, a
             column-sliced table read by id up to each degree, the same
             rows as CSR, composed two-hop rows with and without the hop-1
             lanes and over a shard's slice of the first hop, CSR rows at
             kkt_power's W = 144,504), and K4 and K5 over each of theirs (a
             table by id, a gathered id tile with self, duplicate and
             sentinel lanes, gathered tiles), in each layout whose bitsets
             fit (1, 4, 8, 16, 32 lanes a row), against their plain
             versions, bit for bit: widths 1..5000, both heuristics,
             sentinel rows, rows whose colours 1..32 are all taken.
6. K6      — the two-tile distance-2 FirstFit against its plain version,
             bit for bit: W1 in 1..33, W2 in 1..4096, w in 1, 37, 1000,
             random rows and rows holding every colour 1..W1+W2.
7. latency — a dependent-load chain (``csrc/latency_probe.cu``) times one
             L1 hit and one L2 hit: K2's depth bound is depth L2 hits; and
             the rate of random 4-byte reads from a table held in L2, what
             the row kernels' colour and degree reads are.
8. slice   — every SUITE graph at scale 0.25 through ``color`` on the card
             and on the CPU: every ``ColoringResult`` field equal; then the
             classic, padded, chunked and fused options on rmat-er, rmat-g
             and thermal2 at 0.25, and the packed-overflow star, the same.
             Then distance-2: ``distance2`` on SUITE at 0.005 (both
             strategies, both modes), ``bipartite`` on two Jacobian
             patterns (both strategies), and ``d2_sgr_step`` to convergence
             on rmat-er at 0.05 (with and without the hop-1 neighbours):
             card == CPU.  Then the paper's baselines on rmat-er, rmat-g
             and thermal2 at 0.25: ``serial``, ``topology`` (both
             heuristics; K4 and K5 over the dense table, ``gather_rows``
             made to raise), ``jp``, ``multihash`` (1 and 2 hashes) and
             ``threestep`` (``serial_tail`` too); traced ragged, classic
             and distance-2 runs (``trace.steps`` too); and
             ``ensure_valid=True`` on unconverged runs (``degradations``
             too): card == CPU.  Then ``color_batch`` on
             ``serving_mix(8, 0.5)``, fused and distance-2, both
             heuristics, traced (every result field and trace row), and a
             durable session on rmat-g at 0.25 through three churn rounds
             (results, frontier, ``metrics()`` and the journal's records):
             card == CPU.
9. full    — the main paths at full size, each run once with the launch
             counts set to 0 just before and read just after, then timed:
             the default ragged path, the classic engine and the padded
             engine on the paper's three 1M-vertex graphs (rmat-er, rmat-g,
             thermal2); the default path on kkt_power at the paper's size
             (scale 21.4: degrees past the packed word, K3 in every class,
             K2 at W = 144,504); chunked (coarsen_lanes=65536) and fused
             ragged runs on rmat-er. Valid colorings, launch counts above 0
             for the kernels each path runs, rmat-er's default colors equal
             to the serial-greedy oracle; times, per-kernel times from CUDA
             events at the main paths' shapes (each kernel held against its
             plain version there; K1 in each layout and beside K3 over the
             same CSR rows; K2 also in each layout, with its tail's
             dependency depth, computed on the host, and the bound max(bytes,
             depth x L2)), peak memory, allocator counts, a profiler line.
             Every counted run goes with no tile gathered: the classic
             engine's with ``gather_rows`` made to raise, the others with
             the superstep's ``provider.rows`` made to raise (K1 and K3 read
             rows in place). K3 is timed per class in place beside its
             bound, the random gathers at the probe's rate and the old path
             (the gathers, then the tile entry point in the warp layout)
             where its tiles fit; K4 and K5 at the classic engine's first
             step on each graph and at thermal2's step 101, through the
             wrapper and in each layout forced, beside their bound, the old
             path and the gathers at the probe's rate.
10. full distance-2 — ``distance2`` on rmat-er and thermal2 (``auto``
             composes the two hops on the fly: K3 over composed rows read
             in place, timed at the first step; K2 over composed rows),
             ``distance2`` precomputed on thermal2 (K1 over G², K2; the
             host G² build timed apart), ``bipartite`` on
             ``jacobian_band(1<<20, 3)`` (K3, K2; optimum 7 colours, and
             ``compress_jacobian_pattern`` into 7 groups) and
             ``d2_sgr_step`` to convergence on rmat-er (K6, K5): valid
             colourings, launches, times; K6 at rmat-er's and thermal2's
             first-step shapes and the composed-row tails of rmat-er (W =
             702), thermal2 (W = 72) and the banded Jacobian (W = 49, a
             chain as deep as the tail), each layout, against their bounds
             and plain versions; K5 over ``d2_sgr_step``'s first-step
             composed rows (W = 702), each layout.
11. comparison — the paper's comparison on rmat-er, rmat-g and thermal2,
             uncut: ``serial`` (one run on the host), ``topology``,
             ``jp``, ``multihash`` and ``threestep`` beside phase 9's
             default ``data_driven``, each counted (topology and threestep
             launch K4 and K5 and gather no tile), timed as in phase 9
             (threestep, seconds of host fix-up a run: its one counted run)
             and valid; colours against serial's and data_driven's speedup over
             each; the traced default path against the untraced one on
             rmat-er (same colours, ``check()`` passes, both walls); and
             ``ensure_valid=True, max_iters=1`` on rmat-er (the rungs
             taken).
12. serving — the batched engine and sessions at full size: a batch of
             four rmat-er graphs at 2^20 (seeds 2, 12, 22, 32, one width
             bucket), ``serving_mix(16, 40)`` (five buckets) and batched
             distance-2 on ``serving_mix(8, 10)`` (host G^2 built apart),
             each counted (one K3 launch a global step, at most one K2
             launch a bucket, no tile gathered, valid) and timed packed
             against the loop of single fused calls; sessions on rmat-g
             and thermal2 under four 1% churn rounds (frontier, host
             snapshot rebuild, recolor against the cold fused call, engine
             keys, validity, device memory flat); a ``SessionBatch`` over
             the four rmat-er graphs in which only the two dirty sessions
             launch.  The host graphs of the phase are built side by side
             in a process pool.
13. service — ``ColoringService`` on the card: a fixed synchronous
             sequence on ``serving_mix(8, 0.5)`` (colours under both
             heuristics, a distance-2 bucket, a slow-path request, two
             sessions spilling and restoring through a pool of one) through
             a card and a CPU service, every output and ``metrics()`` apart
             from its timing field equal; ``serving_mix(16, 40)`` as one
             async burst (``max_batch`` 16): every colouring valid and equal
             to the direct fused call, one K3 launch a global step of every
             micro-batch, at most one K2 launch a micro-batch, no tile
             gathered; pooled 2^20 sessions (rmat-g and thermal2 under 1%
             churn, rmat-er's open spilling the LRU one, a touch restoring
             it, ``pool_size=2``): colours equal to sessions run outside the
             service, spill and restore ms printed; a flood past
             ``queue_limit=4``: ``Overloaded``, the queue bounded, every
             admitted ticket finished, one deliberate failure.  Every
             worker is stopped before the last line.
14. sharded — the sharded engine (one shard per entry of ``devices=``,
             the halo exchange a super-step, the coordinated tail) at small
             scale on k = 2 and 3 shards of the card and of the CPU, every
             field, the halo bytes and trace rows equal: distance-1 on
             rmat-er, rmat-g (n < 2^15: the packed halo word) and thermal2
             (n >= 2^15: (id, colour) pairs) at 0.25, both heuristics and
             the tail off; distance-2 and bipartite in both strategies;
             ``color_batch`` with B >= and < the shard count.  Then four
             shards of the card at full size: rmat-er (colours, iterations
             and work items == the card's ragged fused call), distance-2 on
             the fly on rmat-er and bipartite on the fly on
             ``jacobian_band(1<<20, 3)`` (colours == the single-device
             call), each counted (one K3 launch a shard a class a
             speculative step, K2 for the tail, no tile gathered, no K1) and
             timed as in phase 9; and K3 over shard 0's rows read in place
             at rmat-er's first step against its plain version.
15. lm     — the LM stack's serving path (``repro_torch.models``,
             ``launch/serve_lm.py``; plain PyTorch ops, no kernel of its
             own): (a) each of the ten reduced configs in float32 with
             TF32 off, the port's init on a seeded CPU generator copied to
             the card: forward logits (S = 64, q-chunked), ``loss``,
             ``ce``, ``lb_loss``, ``z_loss`` and prefill + 4 decode steps,
             card == CPU within the printed tolerances; (b) ``serve_batch``
             on qwen3-4b at full width and depth in bfloat16 (batch 4,
             prompt 64, 16 generated), then the warm loop timed (prefill ms,
             decode ms a step and tokens/s beside the weight-read bound),
             one decode step under the profiler (device launches, busy),
             peak memory, and the teacher-forced prefill + decode logits
             against the forward; (c) rwkv6-1.6b and recurrentgemma-2b
             whole, mixtral-8x22b and deepseek-v2-236b at published width
             cut to 2 layers and run drop-free (capacity ``E / top_k``;
             their forward at the published capacity factor too): prefill
             + 4 decode steps against the forward.  The bfloat16 checks
             hold max |dlogit| to 1/8 of the largest |logit|.
16. training — the LM stack's training path (``repro_torch.training``,
             ``launch/train.py``, ``distributed/fault_tolerance.py``; plain
             PyTorch, no kernel of its own): (a) seven families' reduced
             configs in float32 with TF32 off, the port's init on a seeded
             CPU generator copied to the card: step-0 gradients per leaf;
             three AdamW steps, each step's loss and ``grad_norm`` against
             the CPU's at the card's parameters of that step, and the
             parameters after three steps against the CPU's own three-step
             run, within the printed tolerances; then a checkpointed 12-step
             run on the card that crashes at step 8 and is resumed by
             ``run_with_restarts``, ending within 1e-3 of the uninterrupted
             run's loss; (b) qwen3-4b at full width and depth, step 0 (batch
             2, sequence 256) in float32 against the same weights cast to
             bfloat16: the loss within 1%, the gradient norm within 10%;
             (c) ``train_loop`` on qwen3-4b at full size in bfloat16 (remat
             on, batch 2, sequence 256, 8 steps): every loss finite; then
             the same 8 steps through ``init_train_state`` and
             ``make_train_step``, each timed: every loss and ``grad_norm``
             finite; per warm step the median ms, tokens a second, peak
             MiB, one step's launches and busy share under the profiler,
             the model FLOP rate against the bf16 dense peak, and the loss
             with its backward and ``adamw_update`` timed apart.
17. mesh   — the LM stack's mesh half (``distributed/sharding.py``,
             ``launch/dryrun.py``, ``launch/op_analysis.py``; ``DeviceMesh``
             and ``DTensor``, no kernel of its own) on an NCCL group of
             world size 1 and a ("data", "model") mesh of shape (1, 1):
             (a) ``train_loop(mesh=)`` on qwen3-4b at full size in bfloat16
             with phase 16's settings, step 0's loss and gradient norm
             within 1e-4 of phase 16's ``train_loop``, every step finite;
             steps 0-3 through ``make_train_step`` on a placed state, the
             warm median ms beside phase 16's; (b) a checkpoint at step 4,
             ``reshard_state`` onto a freshly built (1, 1) mesh (every leaf
             a ``DTensor`` of the resolver's placement), steps 4-7 within
             1e-3 of (a)'s losses; (c) the dry run of that step
             (``op_analysis`` on meta under a fake group, in a subprocess):
             per-device FLOPs and argument plus temporary bytes within 20%
             of phase 16's model FLOPs plus recompute and its peak less
             what earlier phases hold.

The line before the last is the kernels' JSON record, and the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import gc
import json
import multiprocessing
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import repro_torch.core.coloring as core_coloring  # noqa: E402
from repro_torch import color, color_batch, open_session  # noqa: E402
from repro_torch.core.batch import (  # noqa: E402
    GraphBatch,
    _width_key,
    color_batch_fused,
    open_session_batch,
)
from repro_torch.core.coloring import (  # noqa: E402
    ColoringResult,
    DenseRows,
    sgr_step,
    TAIL_SEGMENT_CELLS,
    _composed_tail,
    _resolve_classes,
    gather_rows,
    order_tail,
    run_workefficient_loop,
)
from repro_torch.core.csr import (  # noqa: E402
    DeviceCSR,
    PartitionedCSR,
    csr_from_edges,
    next_pow2,
)
from repro_torch.core.distributed import ShardRows  # noqa: E402
from repro_torch.core.serial import greedy_serial  # noqa: E402
from repro_torch.core.validate import is_valid_coloring  # noqa: E402
from repro_torch.d2 import (  # noqa: E402
    compress_jacobian_pattern,
    d2_sgr_step,
    validate_bipartite,
    validate_d2,
)
from repro_torch.d2.coloring import (  # noqa: E402
    DEFAULT_D2_BUDGET,
    TwoHopRows,
    resolve_d2_strategy,
)
from repro_torch.dynamic import churn_delta  # noqa: E402
from repro_torch.dynamic.journal import SessionJournal  # noqa: E402
from repro_torch.errors import Overloaded  # noqa: E402
from repro_torch.graphs import (  # noqa: E402
    RMAT_ER,
    RMAT_G,
    SUITE,
    build_graph,
    grid2d,
    jacobian_band,
    jacobian_tall_skinny,
    rmat,
    serving_mix,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.conflict.kernel import (  # noqa: E402
    conflict_rows,
    conflict_rows_ref,
    conflict_tile,
    conflict_tile_ref,
)
from repro_torch.kernels.cuda import (  # noqa: E402
    ROW_LANES,
    CsrRows,
    TableRows,
    TwoHopLanes,
    check,
    row_lanes,
    stream,
)
from repro_torch.kernels.d2.kernel import d2_firstfit, d2_firstfit_ref  # noqa: E402
from repro_torch.kernels.firstfit.kernel import (  # noqa: E402
    firstfit_rows,
    firstfit_rows_ref,
    firstfit_tile,
    firstfit_tile_ref,
)
from repro_torch.kernels.superstep.csr_kernel import (  # noqa: E402
    _launch_tail,
    serial_tail_csr,
    serial_tail_csr_ref,
    serial_tail_rows,
    serial_tail_rows_ref,
    superstep_csr,
    superstep_csr_ref,
    tail_ranks,
)
from repro_torch.kernels.superstep.kernel import (  # noqa: E402
    source_tile,
    superstep_rows,
    superstep_rows_ref,
    superstep_tile,
    superstep_tile_ref,
)
import repro_torch.launch.train as train_launcher  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.distributed.fault_tolerance import run_with_restarts  # noqa: E402
from repro_torch.launch.coloring_service import ColoringService  # noqa: E402
from repro_torch.launch.serve_lm import generate, serve_batch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import AdamWConfig, init_train_state, make_train_step  # noqa: E402
from repro_torch.training.data import SyntheticData  # noqa: E402
from repro_torch.training.optimizer import _global_norm, adamw_update  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
BF16_DENSE_FLOPS = 989e12  # H100 SXM bf16 dense tensor-core peak, same sheet
RESULT_FIELDS = ("iterations", "work_items", "padded_work", "class_cells",
                 "converged")
KERNELS = (superstep_csr, serial_tail_csr, superstep_tile, firstfit_tile,
           conflict_tile, d2_firstfit, firstfit_rows, conflict_rows)
HEURISTICS = ("id", "degree")


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
    """Least time to move the bytes K2 must move, over HBM's rate: 20 B per
    worklist entry (wl, starts, degs in, the clear and the color out) and
    8 B per neighbour read (C and the neighbour's color), counting each row
    up to the width W."""
    nbytes = int(wl.size) * 20 + int(np.minimum(deg_ext[wl], W).sum()) * 8
    return nbytes / HBM_BYTES_PER_S * 1e3


def tail_depth(src: np.ndarray, dst: np.ndarray, T: int) -> tuple[int, int]:
    """``(depth, widest level)`` of K2's dependency DAG over T tail entries,
    in which entry ``dst`` waits for entry ``src < dst`` (edges may repeat):
    Kahn's layering on the host in numpy, one round per level."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    targets = dst[np.argsort(src, kind="stable")]
    ptr = np.zeros(T + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=T), out=ptr[1:])
    indeg = np.bincount(dst, minlength=T)
    frontier = np.flatnonzero(indeg == 0)
    depth = widest = 0
    while frontier.size:
        depth += 1
        widest = max(widest, int(frontier.size))
        lo = ptr[frontier]
        cnt = ptr[frontier + 1] - lo
        total = int(cnt.sum())
        if not total:
            break
        idx = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt) + np.arange(total)
        hit, times = np.unique(targets[idx], return_counts=True)
        indeg[hit] -= times
        frontier = hit[indeg[hit] == 0]
    return depth, widest


def csr_tail_depth(g, tail: np.ndarray) -> tuple[int, int]:
    """``tail_depth`` of a CSR tail (real ids, distinct, in K2's order):
    entry rank[v] waits for each neighbour u of v in the tail with
    rank[u] < rank[v]."""
    rank = np.full(g.n, -1, np.int64)
    rank[tail] = np.arange(tail.size)
    rv = rank[np.repeat(np.arange(g.n), g.degrees)]
    ru = rank[g.col_indices]
    keep = (ru >= 0) & (rv >= 0) & (ru < rv)
    return tail_depth(ru[keep], rv[keep], int(tail.size))


def k2_bound(bytes_ms: float, depth: int, lat: dict) -> dict:
    """K2's bound: the larger of its bytes over HBM's rate and its depth
    times one L2 round trip (``csrc/latency_probe.cu``)."""
    chain_ms = depth * lat["l2_ns"] / 1e6
    return {"bytes_bound_ms": bytes_ms, "depth_bound_ms": chain_ms,
            "bound_ms": max(bytes_ms, chain_ms),
            "bound_by": "bytes" if bytes_ms >= chain_ms else "depth"}


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
            for lanes in ROW_LANES:
                got_c, got_n = superstep_csr(
                    gpu.row_starts, gpu.col_padded, packed.to(dev_cuda),
                    torch.from_numpy(wl).to(dev_cuda), W, heuristic, lanes=lanes)
                torch.cuda.synchronize()
                if not (torch.equal(want_c, got_c.cpu())
                        and torch.equal(want_n, got_n.cpu())):
                    bad = (want_c != got_c.cpu()).nonzero().flatten()[:5].tolist()
                    fail(f"K1 differs from its plain version: W={W} {mode} "
                         f"{heuristic} w={wl.size} lanes={lanes}, first rows {bad}")
                cases += 1
    print(f"K1 == plain on {cases} cases (W from 1 to 4096, both heuristics, "
          f"random, low and clique colors, sentinels, layouts of {ROW_LANES} lanes "
          "a row)", flush=True)


def csr_tail(g, wl, colors):
    """K2's row form of the CSR tail ``wl``: ``(starts, degs, col, colors,
    wl)`` CPU tensors, as ``serial_tail_csr`` lays them out."""
    cpu = DeviceCSR.from_csr(g, "cpu")
    wl = torch.as_tensor(wl, dtype=torch.int32)
    return (cpu.row_starts[wl.clamp(0, max(g.n - 1, 0)).long()],
            cpu.deg_ext[wl.clamp(0, g.n).long()], cpu.col_padded,
            torch.from_numpy(colors), wl)


def hand_rows(rng, n: int, T: int, W: int):
    """Rows laid out by hand for ``serial_tail_rows``: each of T entries (a
    random subset of n, nine sentinel entries spread among them) reads up to
    W random ids of the whole graph (earlier and later entries, so rows are
    not symmetric, and outside vertices), some lanes turned into the entry
    itself, copies of another lane or the sentinel n. Outside colours run to
    80; every fourth row reads outside vertices holding 1..W one each, so
    FirstFit answers past 32 (W + 1 or the colour a self or sentinel lane
    knocked out)."""
    ids = rng.choice(n, T - 9, replace=False).astype(np.int32)
    wl = np.insert(ids, rng.integers(0, T - 9, 9), n).astype(np.int32)
    degs = rng.integers(0, W + 1, T).astype(np.int32)
    degs[::4] = W
    starts = np.concatenate([[0], np.cumsum(degs[:-1] + 3)]).astype(np.int32)
    col = rng.integers(0, n + 1, int(starts[-1]) + W + 3).astype(np.int32)
    colors = rng.integers(0, 81, n + 1).astype(np.int32)
    outside = np.setdiff1d(np.arange(n), ids)
    pool = rng.choice(outside, W, replace=False)
    colors[pool] = np.arange(1, W + 1)
    colors[n] = 0
    for i in range(T):
        s, d = starts[i], degs[i]
        if i % 4 == 0:
            col[s:s + d] = rng.permutation(pool)[:d]
        lanes = rng.random(d)
        row = col[s:s + d]
        row[lanes < 0.05] = wl[i]  # self lanes (a sentinel entry: n)
        if d:
            row[(lanes >= 0.05) & (lanes < 0.1)] = row[0]  # duplicates
        row[(lanes >= 0.1) & (lanes < 0.13)] = n
    return (torch.from_numpy(starts), torch.from_numpy(degs), torch.from_numpy(col),
            torch.from_numpy(colors), torch.from_numpy(wl))


def k2_cases(rng):
    """(label, W, (starts, degs, col, colors, wl), CSR graph or None) CPU
    inputs for the K2 check. The CSR cases go through ``serial_tail_csr``
    too."""
    graphs = {8: grid2d(80, 80, diagonals=True),
              376: k1_graph(376, rng, n=6000)}
    for W, g in graphs.items():
        if g.max_degree > W:
            fail(f"K2 test graph has max degree {g.max_degree} > W={W}")
        deg_ext = torch.from_numpy(np.concatenate([g.degrees, [0]]).astype(np.int32))
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
                deg_ext)
            colors = rng.integers(lo, hi + 1, g.n + 1).astype(np.int32)
            colors[g.n] = 0
            yield f"T={T} {mode}", W, csr_tail(g, wl, colors), g
    # a chain as deep as the tail: a path in id order (entry i waits on i-1)
    n = 100_000
    path = csr_from_edges(n, np.arange(n - 1), np.arange(1, n))
    colors = np.zeros(n + 1, np.int32)
    for W in (2, 64):
        yield "path 100000 in id order", W, csr_tail(path, np.arange(n), colors), path
    grid = grid2d(300, 300, diagonals=True)
    wl = order_tail(torch.arange(grid.n, dtype=torch.int32), torch.from_numpy(
        np.concatenate([grid.degrees, [0]]).astype(np.int32)))
    colors = np.zeros(grid.n + 1, np.int32)
    for W in (8, 40):
        yield "grid2d(300, 300) order_tail", W, csr_tail(grid, wl, colors), grid
    for W in (24, 100):
        yield "hand rows", W, hand_rows(rng, 20_000, 4096, W), None
    # composed two-hop rows at W = 26 * 26 + 26 = 702, as distance-2 on the
    # fly lays them out over rmat-er (the table padded to rmat-er's dmax 26)
    g = rmat(1 << 12, 10.0, RMAT_ER, seed=2)
    adj = torch.from_numpy(g.padded_adjacency())
    adj = torch.cat([adj, torch.full((g.n, 26 - adj.shape[1]), g.n, dtype=torch.int32)], 1)
    prov = TwoHopRows(adj, adj)
    W = prov.width
    deg_ext = torch.from_numpy(np.concatenate([g.degrees, [0]]).astype(np.int32))
    wl = order_tail(torch.arange(g.n, dtype=torch.int32), deg_ext)
    colors = rng.integers(0, 40, g.n + 1).astype(np.int32)
    colors[g.n] = 0
    yield "composed rows (rmat 4096)", W, (
        torch.arange(0, g.n * W, W, dtype=torch.int32),
        torch.full((g.n,), W, dtype=torch.int32), prov.rows(wl).reshape(-1),
        torch.from_numpy(colors), wl), None


def check_k2(dev_cuda):
    """K2 against its plain version, bit for bit, on every case of
    ``k2_cases``: through ``serial_tail_rows`` (and ``serial_tail_csr`` for
    CSR cases), and in each layout forced (``_launch_tail``)."""
    cases = 0
    labels = []
    for label, W, (starts, degs, col, colors, wl), g in k2_cases(np.random.default_rng(13)):
        want = serial_tail_rows_ref(starts, degs, col, colors.clone(), wl, W)
        gpu = [t.to(dev_cuda) for t in (starts, degs, col, colors, wl)]
        runs = {"rows": lambda: serial_tail_rows(*gpu[:3], gpu[3].clone(), gpu[4], W),
                "thread": lambda: _launch_tail(*gpu[:3], gpu[3].clone(), gpu[4], W, True),
                "warp": lambda: _launch_tail(*gpu[:3], gpu[3].clone(), gpu[4], W, False)}
        if g is not None:
            csr = DeviceCSR.from_csr(g, dev_cuda)
            runs["csr"] = lambda: serial_tail_csr(csr.row_starts, csr.col_padded,
                                                  csr.deg_ext, gpu[3].clone(), gpu[4], W)
        for how, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(want, got.cpu()):
                bad = (want != got.cpu()).nonzero().flatten()[:5].tolist()
                fail(f"K2 differs from its plain version: {label} W={W} via {how}, "
                     f"first slots {bad}")
            cases += 1
        if label not in labels:
            labels.append(label)
    print(f"K2 == plain on {cases} runs (both layouts and the wrappers; "
          f"{'; '.join(labels)})", flush=True)


# --------------------------------------------------------------------------
# phase 5: K3, K4 and K5 against their plain versions
# --------------------------------------------------------------------------

def tile_case(rng, W: int, w: int, n: int, mode: str):
    """``(ids, nid, my_c, nc, my_d, nd)`` int32 arrays for one tile.

    Rows are ragged (lanes past a random degree hold the sentinel ``n``,
    colour 0, degree 0) and the last seven are sentinel rows.  ``random``
    draws colours from [0, W+1], ``low`` from [0, min(W+1, 40)] (a wide
    row's first bitset word fills up), and ``full`` gives half the rows a
    permutation of 1..W, so for W >= 32 every colour 1..32 is taken and
    FirstFit runs the shared-bitset path (answer W + 1, or a colour the row
    beats and clears).
    """
    hi = {"random": W + 1, "low": min(W + 1, 40), "full": W + 1}[mode]
    ids = rng.integers(0, n, w).astype(np.int32)
    nid = rng.integers(0, n, (w, W)).astype(np.int32)
    nc = rng.integers(0, hi + 1, (w, W)).astype(np.int32)
    nd = rng.integers(0, 9, (w, W)).astype(np.int32)
    deg = rng.integers(0, W + 1, w)
    my_c = rng.integers(0, hi + 1, w).astype(np.int32)
    my_d = rng.integers(0, 9, w).astype(np.int32)
    if mode == "full":
        half = w // 2
        nc[:half] = np.argsort(rng.random((half, W)), axis=1) + 1
        deg[:half] = W
    pad = np.arange(W)[None, :] >= deg[:, None]
    pad[-7:] = True
    nid[pad], nc[pad], nd[pad] = n, 0, 0
    ids[-7:] = n
    my_c[-7:] = my_d[-7:] = 0
    return ids, nid, my_c, nc, my_d, nd


def row_case(rng, W: int, w: int, mode: str):
    """``(table, deg_ext, colors_ext, ids, rows)`` int32 arrays for the
    row-resident K4 and K5.

    ``table`` is ``(n, W + 3)``, to be sliced to its first W columns (stride
    W + 3 != W): row v holds ``deg_ext[v]`` random neighbour ids, the
    sentinel ``n`` in the rest of the slice and junk past it. ``rows`` is a
    ``(w, W)`` id tile with self, duplicate and sentinel lanes. ``ids``
    holds seven sentinel entries. Colours by ``mode`` as ``tile_case``; in
    ``full`` half the rows of both sources hold a pool of W vertices
    coloured 1..W, one each (answer W + 1 through the shared-bitset path
    for W >= 32, or a colour the row's vertex holds and loses).
    """
    n = max(2 * w, 1000, 2 * W + 8)
    hi = {"random": W + 1, "low": min(W + 1, 40), "full": W + 1}[mode]
    colors = rng.integers(0, hi + 1, n + 1).astype(np.int32)
    deg = rng.integers(0, W + 1, n + 1).astype(np.int32)
    deg[rng.random(n + 1) < 0.2] = W
    table = rng.integers(0, n, (n, W + 3)).astype(np.int32)
    table[:, :W][np.arange(W)[None, :] >= deg[:n, None]] = n
    ids = rng.integers(0, n, w).astype(np.int32)
    ids[rng.choice(w, 7, replace=False)] = n
    rows = rng.integers(0, n + 1, (w, W)).astype(np.int32)
    lanes = rng.random((w, W))
    rows[lanes < 0.05] = np.broadcast_to(ids[:, None], (w, W))[lanes < 0.05]
    rows[(lanes >= 0.05) & (lanes < 0.1)] = np.broadcast_to(
        rows[:, :1], (w, W))[(lanes >= 0.05) & (lanes < 0.1)]
    rows[(lanes >= 0.1) & (lanes < 0.13)] = n
    if mode == "full":
        pool = rng.choice(n, W, replace=False)
        colors[pool] = np.arange(1, W + 1)
        for i in range(w // 2):
            rows[i] = rng.permutation(pool)
            if ids[i] < n:
                deg[ids[i]] = W
                table[ids[i], :W] = rng.permutation(pool)
    colors[n] = 0
    deg[n] = 0
    return table, deg, colors, ids, rows


def check_tiles(dev_cuda):
    """K3 over gathered tiles, and K4 and K5 over all three of their lane
    sources (a table by id, read to each degree; a gathered id tile; the
    gathered tiles of K3) in each layout, against their plain versions, bit
    for bit."""
    rng = np.random.default_rng(17)
    cases = {"K3": 0, "K4": 0, "K5": 0}
    widths = (1, 2, 8, 16, 26, 31, 32, 33, 63, 64, 100, 376, 1000, 4096, 5000)
    for W in widths:
        w = max(64, min(3001, 4_000_000 // W))
        for mode in ("random", "low", "full"):
            cpu = [torch.from_numpy(a) for a in tile_case(rng, W, w, 100_000, mode)]
            gpu = [a.to(dev_cuda) for a in cpu]
            table, deg, colors, ids, rows = (torch.from_numpy(a) for a in
                                             row_case(rng, W, min(w, 1000), mode))
            table_g, deg_g, colors_g, ids_g, rows_g = (
                a.to(dev_cuda) for a in (table, deg, colors, ids, rows))
            k4 = {"tile": (firstfit_tile_ref(cpu[3]),
                           lambda k: firstfit_tile(gpu[3], lanes=k)),
                  "table": (firstfit_rows_ref(colors, ids, table=table[:, :W]),
                            lambda k: firstfit_rows(colors_g, ids_g, table=table_g[:, :W],
                                                    deg_ext=deg_g, lanes=k)),
                  "rows": (firstfit_rows_ref(colors, ids, rows=rows),
                           lambda k: firstfit_rows(colors_g, ids_g, rows=rows_g, lanes=k))}
            k5 = {}
            for h in HEURISTICS:
                k5[h, "tile"] = (conflict_tile_ref(*cpu, h),
                                 lambda k, h=h: conflict_tile(*gpu, h, lanes=k))
                k5[h, "table"] = (
                    conflict_rows_ref(colors, deg, ids, h, table=table[:, :W]),
                    lambda k, h=h: conflict_rows(colors_g, deg_g, ids_g, h,
                                                 table=table_g[:, :W], lanes=k))
                k5[h, "rows"] = (
                    conflict_rows_ref(colors, deg, ids, h, rows=rows),
                    lambda k, h=h: conflict_rows(colors_g, deg_g, ids_g, h, rows=rows_g,
                                                 lanes=k))
            for name, runs in (("K4", k4), ("K5", k5)):
                for label, (want, run) in runs.items():
                    for lanes in ROW_LANES:
                        if not torch.equal(want, run(lanes).cpu()):
                            fail(f"{name} differs from its plain version: W={W} {mode} "
                                 f"{label} lanes={lanes}")
                        cases[name] += 1
            cases["K3"] += check_k3_sources(
                f"W={W} {mode}", W, dev_cuda,
                {"tile": (tuple(cpu), lambda h, k: superstep_tile(*gpu, h, lanes=k)),
                 **row_sources(table, deg, colors, ids, W)})
    print(f"K4, K5 == plain on {cases} cases (W in {widths}; random, low "
          "and full rows; both heuristics; sentinel rows; K4 and K5 over a "
          "column-sliced table read to each degree, a gathered id tile with "
          f"self, duplicate and sentinel lanes, and gathered tiles, in each "
          f"layout of {ROW_LANES} lanes a row; K3 over the tiles, the table "
          "and its CSR rows)", flush=True)
    n3 = check_k3_wide(dev_cuda, rng)
    print(f"K3 == plain on {n3} more cases: composed two-hop rows (W1, W2) in "
          f"{TWO_HOP_SHAPES} (hop-1 lanes or not, a shard's slice of the first hop), "
          "random, low and full colours; CSR rows at W = 144,504 (kkt_power's "
          "widest class) with rows holding 1..W one each; each layout whose "
          "bitsets fit", flush=True)


def table_csr(table: torch.Tensor, deg: torch.Tensor, W: int):
    """``(R, C)`` of the rows of ``table`` (row v's first ``deg[v]`` ids),
    with W slack words of the sentinel n after C, as ``DeviceCSR`` pads."""
    n = table.shape[0]
    d = deg[:n].long()
    R = torch.cat([torch.zeros(1, dtype=torch.long), torch.cumsum(d, 0)]).int()
    keep = torch.arange(table.shape[1])[None, :] < d[:, None]
    return R, torch.cat([table[keep], torch.full((W,), n, dtype=torch.int32)])


def row_sources(table, deg, colors, ids, W: int) -> dict:
    """K3 over source (a), the table read by id up to each degree, and (d),
    its rows as CSR: ``{label: (plain result fn, card run fn(h, lanes))}``."""
    dev = torch.device("cuda", 0)
    table_g, deg_g, colors_g, ids_g = (a.to(dev) for a in (table, deg, colors, ids))
    R, C = table_csr(table, deg, W)
    srcs = {"table": (TableRows(table[:, :W]), TableRows(table_g[:, :W])),
            "csr": (CsrRows(R, C), CsrRows(R.to(dev), C.to(dev)))}
    return {label: ((colors, deg, ids, cpu_src),
                    lambda h, k, src=gpu_src: superstep_rows(
                        colors_g, deg_g, ids_g, h, source=src, W=W, lanes=k))
            for label, (cpu_src, gpu_src) in srcs.items()}


def check_k3_sources(label: str, W: int, dev_cuda, runs: dict) -> int:
    """K3 over each source of ``runs`` (``{name: (plain args, run(h, lanes))}``;
    the tile entry point's plain args are its tiles, the others' ``(read,
    deg_ext, ids, source)``), both heuristics, each layout whose bitsets
    fit, against the plain version bit for bit. Returns the launches
    checked."""
    cases = 0
    for name, (args, run) in runs.items():
        for h in HEURISTICS:
            if name == "tile":
                want = superstep_tile_ref(*args, h)
            else:
                read, deg, ids, src = args
                want = superstep_rows_ref(read, deg, ids, h, source=src, W=W)
            for lanes in ROW_LANES:
                try:
                    row_lanes(W, lanes, full=name == "tile")
                except ValueError:
                    continue  # this layout's bitsets do not fit a block
                got = run(h, lanes)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b.cpu()) for a, b in zip(want, got)):
                    bad = (want[0] != got[0].cpu()).nonzero().flatten()[:5].tolist()
                    fail(f"K3 differs from its plain version: {label} {name} {h} "
                         f"lanes={lanes}, first rows {bad}")
                cases += 1
    return cases


# (W1, W2, hop-1 lanes, start): composed two-hop shapes phase 5 checks;
# (26, 26) is distance-2 on rmat-er, (7, 7) the banded Jacobian's bipartite
# rows, the last two pass W = 4096
TWO_HOP_SHAPES = ((1, 1, True, 0), (3, 10, True, 0), (8, 16, True, 300),
                  (26, 26, True, 0), (7, 7, False, 0), (33, 130, True, 0),
                  (40, 120, False, 0))


def two_hop_case(rng, W1: int, W2: int, first_hop: bool, start: int, mode: str):
    """``(source, W, deg_ext, colors_ext, ids)`` CPU inputs for K3 over
    composed two-hop rows: random tables padded past random degrees with
    their sentinels (n_mid, n), ids with sentinels and, for ``start > 0``,
    ids below and past the first hop's slice; colours by ``mode`` as
    ``tile_case``, ``full`` giving the row with the most distinct lanes
    1, 2, ... one each and its vertex 0."""
    n = 1500
    n_mid = n if first_hop else 1100
    n_rows = n - 2 * start if start else n
    deg_a = torch.from_numpy(rng.integers(0, W1 + 1, n_rows).astype(np.int32))
    deg_b = torch.from_numpy(rng.integers(0, W2 + 1, n_mid).astype(np.int32))
    adj_a = torch.from_numpy(rng.integers(0, n_mid, (n_rows, W1)).astype(np.int32))
    adj_b = torch.from_numpy(rng.integers(0, n, (n_mid, W2)).astype(np.int32))
    adj_a[torch.arange(W1)[None, :] >= deg_a[:, None]] = n_mid
    adj_b[torch.arange(W2)[None, :] >= deg_b[:, None]] = n
    src = TwoHopLanes(adj_a, adj_b, deg_a, deg_b, first_hop, start, n)
    W = src.width
    ids = torch.from_numpy(np.concatenate([rng.integers(0, n, 600), [n] * 5]).astype(np.int32))
    deg = torch.from_numpy(rng.integers(0, 9, n + 1).astype(np.int32))
    hi = {"random": W + 1, "low": min(W + 1, 40), "full": 5}[mode]
    colors = torch.from_numpy(rng.integers(0, hi + 1, n + 1).astype(np.int32))
    if mode == "full":
        tile = source_tile(src, ids, n, W)
        real = [torch.unique(r[(r < n) & (r != v)]) for r, v in zip(tile, ids)]
        i = max(range(len(real)), key=lambda k: real[k].numel())
        colors[real[i].long()] = torch.randperm(real[i].numel(), dtype=torch.int32) + 1
        colors[ids[i]] = 0
    colors[n] = deg[n] = 0
    return src, W, deg, colors, ids


def wide_csr_case(rng, W: int, mode: str):
    """``(source, W, deg_ext, colors_ext, ids)``: CSR rows up to W lanes, as
    kkt_power's widest class has them: eight hubs of degree W - 100 .. W
    whose lanes are a pool of W vertices coloured 1..W one each (``full``;
    ``random``: colours in [0, W + 1]), 56 rows of degree up to 8, three
    sentinel ids; the hubs' own colours 0 (they refit past colour 32)."""
    n = W + 20_000
    deg = rng.integers(0, 9, n + 1).astype(np.int64)
    hubs = rng.choice(n, 8, replace=False)
    deg[hubs] = rng.integers(W - 100, W + 1, 8)
    deg[n] = 0
    pool = rng.choice(n, W, replace=False)
    R = np.concatenate([[0], np.cumsum(deg[:n])])
    C = rng.integers(0, n, int(R[-1]) + W).astype(np.int32)
    colors = rng.integers(0, W + 2, n + 1).astype(np.int32)
    if mode == "full":
        colors[pool] = np.arange(1, W + 1)
    for v in hubs:
        C[R[v]:R[v] + deg[v]] = rng.permutation(pool)[:deg[v]]
    colors[hubs] = 0
    colors[n] = 0
    C[int(R[-1]):] = n
    ids = np.concatenate([hubs, rng.choice(n, 56, replace=False), [n] * 3]).astype(np.int32)
    src = CsrRows(torch.from_numpy(R.astype(np.int32)), torch.from_numpy(C))
    return (src, W, torch.from_numpy(deg.astype(np.int32)), torch.from_numpy(colors),
            torch.from_numpy(ids))


def to_device(source, device):
    """A row source with its tensors on ``device``."""
    return dataclasses.replace(source, **{
        f.name: getattr(source, f.name).to(device) for f in dataclasses.fields(source)
        if isinstance(getattr(source, f.name), torch.Tensor)})


def check_k3_wide(dev_cuda, rng) -> int:
    """K3 over composed two-hop rows (``TWO_HOP_SHAPES``) and CSR rows at
    kkt_power's widest class, against the plain version."""
    cases = 0
    inputs = [(f"two-hop {shape} {mode}", two_hop_case(rng, *shape, mode))
              for shape in TWO_HOP_SHAPES for mode in ("random", "low", "full")]
    inputs += [(f"csr W=144504 {mode}", wide_csr_case(rng, 144_504, mode))
               for mode in ("random", "full")]
    for label, (src, W, deg, colors, ids) in inputs:
        gpu_src = to_device(src, dev_cuda)
        read_g, deg_g, ids_g = (a.to(dev_cuda) for a in (colors, deg, ids))
        cases += check_k3_sources(label, W, dev_cuda, {label.split()[0]: (
            (colors, deg, ids, src),
            lambda h, k: superstep_rows(read_g, deg_g, ids_g, h, source=gpu_src, W=W,
                                        lanes=k))})
    return cases


def d2_tiles(rng, w: int, W1: int, W2: int, mode: str):
    """Hop-1 ``(w, W1)`` and hop-2 ``(w, W2)`` int32 colour tiles for K6.

    ``random`` draws colours from [0, W1+W2+3] (zeros and colours past the
    bound included); ``full`` gives every row but the last a permutation of
    1..W1+W2 spread over both tiles (answer W1 + W2 + 1; for W1 + W2 >= 32
    through the shared-bitset path, colours 1..32 all taken) with one
    colour knocked out of every third row (the answer is that colour).
    """
    hi = W1 + W2 + 3
    nc1 = rng.integers(0, hi + 1, (w, W1)).astype(np.int32)
    nc2 = rng.integers(0, hi + 1, (w, W2)).astype(np.int32)
    if mode == "full":
        perm = np.argsort(rng.random((w, W1 + W2)), axis=1).astype(np.int32) + 1
        perm[::3, 0] = 0
        nc1, nc2 = perm[:, :W1].copy(), perm[:, W1:].copy()
        nc2[-1:] = 0
    return torch.from_numpy(nc1), torch.from_numpy(nc2)


def check_k6(dev_cuda):
    rng = np.random.default_rng(19)
    cases = 0
    for W1 in (1, 8, 26, 32, 33):
        for W2 in (1, 31, 64, 676, 4096):
            for w in (1, 37, 1000):
                for mode in ("random", "full"):
                    nc1, nc2 = d2_tiles(rng, w, W1, W2, mode)
                    got = d2_firstfit(nc1.to(dev_cuda), nc2.to(dev_cuda)).cpu()
                    if not torch.equal(d2_firstfit_ref(nc1, nc2), got):
                        fail(f"K6 differs from its plain version: W1={W1} "
                             f"W2={W2} w={w} {mode}")
                    cases += 1
    print(f"K6 == plain on {cases} cases (W1 in 1, 8, 26, 32, 33; W2 in 1, 31, "
          "64, 676, 4096; w in 1, 37, 1000; random and full rows)", flush=True)


# --------------------------------------------------------------------------
# phase 7: dependent-load latency (K2's depth bound)
# --------------------------------------------------------------------------

def chase_ns(dev_cuda, nwords: int, level: int, steps: int) -> float:
    """ns per step of a random pointer chain of ``nwords`` int32 words,
    loaded through L1 (``level`` 1) or L2 only (2), after a warm pass."""
    lib = build.load("latency_probe")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.repro_chase.argtypes = [ptr, i32, i32, i32, ptr, ptr]
    lib.repro_chase.restype = i32
    rng = np.random.default_rng(nwords)
    perm = rng.permutation(nwords)
    nxt = np.empty(nwords, np.int32)
    nxt[perm] = np.roll(perm, -1)  # one cycle through every word
    table = torch.from_numpy(nxt).to(dev_cuda)
    out = torch.empty(1, dtype=torch.int32, device=dev_cuda)

    def run(k):
        check(lib, lib.repro_chase(table.data_ptr(), 0, k, level, out.data_ptr(),
                                   stream(dev_cuda)), "chase")

    run(nwords)  # warm: every word once
    ms = event_ms(lambda: run(steps), reps=3, warm=0)
    return ms * 1e6 / steps


def gather_rate(dev_cuda, log2: int, level: int, reads: int = 512) -> float:
    """Random 4-byte reads a second from a 2^log2-word table, every thread
    of a full grid reading ``reads`` words (``csrc/latency_probe.cu``),
    through the read-only path (``level`` 1) or L2 only (2), after a warm
    pass."""
    lib = build.load("latency_probe")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.repro_gather.argtypes = [ptr, i32, i32, i32, i32, ptr, ptr]
    lib.repro_gather.restype = i32
    table = torch.ones(1 << log2, dtype=torch.int32, device=dev_cuda)
    out = torch.zeros(1, dtype=torch.int32, device=dev_cuda)
    blocks = 8 * torch.cuda.get_device_properties(dev_cuda).multi_processor_count

    def run():
        check(lib, lib.repro_gather(table.data_ptr(), log2, reads, level, blocks,
                                    out.data_ptr(), stream(dev_cuda)), "gather")

    ms = event_ms(run, reps=5, warm=2)
    return blocks * 256 * reads / (ms / 1e3)


def check_latency(dev_cuda) -> dict:
    lat = {"l1_ns": chase_ns(dev_cuda, 2048, 1, 200_000),
           "l2_ns": chase_ns(dev_cuda, 1 << 21, 2, 200_000),
           "gather_per_s": gather_rate(dev_cuda, 20, 1),
           "gather_l2_per_s": gather_rate(dev_cuda, 20, 2),
           "gather_16mb_per_s": gather_rate(dev_cuda, 22, 1)}
    print(f"dependent-load latency: L1 hit {lat['l1_ns']:.1f} ns (8 KB chain), "
          f"L2 hit {lat['l2_ns']:.1f} ns (8 MB chain, L1 bypassed)", flush=True)
    print(f"random 4-byte gathers: {lat['gather_per_s'] / 1e9:.1f} G/s from a 4 MB table "
          f"through the read-only path ({lat['gather_l2_per_s'] / 1e9:.1f} G/s L2 only; "
          f"{lat['gather_16mb_per_s'] / 1e9:.1f} G/s from 16 MB)", flush=True)
    return lat


# --------------------------------------------------------------------------
# phase 8: card == CPU at small scale
# --------------------------------------------------------------------------

def same_result(a, b) -> list:
    """The fields in which two ``ColoringResult``s differ ([] if none)."""
    diff = [(f, getattr(a, f), getattr(b, f)) for f in RESULT_FIELDS
            if getattr(a, f) != getattr(b, f)]
    if not np.array_equal(a.colors, b.colors):
        diff.append(("colors", int((a.colors != b.colors).sum()), "differ"))
    return diff


def overflow_star():
    n = 32769  # the hub's degree 2^15 passes the packed gather word
    return csr_from_edges(n, np.zeros(n - 1, np.int64), np.arange(1, n))


# options checked card == CPU at small scale.  Chunking lanes scale with the
# graph: the full runs chunk 1M vertices by 65536, these 16k by 1024.
SMALL_OPTIONS = {
    "classic": dict(engine="classic"),
    "classic-fused": dict(engine="classic", mode="fused"),
    "padded": dict(engine="padded"),
    "padded-fused": dict(engine="padded", mode="fused"),
    "chunked": dict(coarsen_lanes=1024),
    "fused": dict(mode="fused"),
}


def check_slice(dev_cuda):
    for name in SUITE:
        g = build_graph(name, 0.25)
        a = color(g, device=dev_cuda)
        b = color(g, device="cpu")
        diff = same_result(a, b)
        if diff:
            fail(f"slice parity: {name} card != cpu: {diff}")
        if not is_valid_coloring(g, a.colors):
            fail(f"slice parity: {name} coloring is not valid")
        print(f"slice {name:14s} n={g.n:6d} iters={a.iterations} "
              f"colors={a.num_colors} card == cpu", flush=True)
    runs = [(name, label) for name in ("rmat-er", "rmat-g", "thermal2")
            for label in SMALL_OPTIONS]
    for name, label in runs:
        g = build_graph(name, 0.25)
        a = color(g, device=dev_cuda, **SMALL_OPTIONS[label])
        diff = same_result(a, color(g, device="cpu", **SMALL_OPTIONS[label]))
        if diff or not is_valid_coloring(g, a.colors):
            fail(f"slice parity: {name} {label} card != cpu or invalid: {diff}")
    print(f"slice options {list(SMALL_OPTIONS)} on rmat-er, rmat-g, thermal2 "
          "at 0.25: card == cpu, valid", flush=True)
    g = overflow_star()
    for opts in ({}, dict(mode="fused")):
        reset_counts()
        a = color(g, device=dev_cuda, **opts)
        if superstep_tile.launches == 0:
            fail("overflow star: K3 was not launched")
        diff = same_result(a, color(g, device="cpu", **opts))
        if diff or not is_valid_coloring(g, a.colors):
            fail(f"overflow star {opts}: card != cpu or invalid: {diff}")
    print(f"slice overflow star n={g.n} dmax={g.max_degree} (K3 in every "
          "class, both modes): card == cpu", flush=True)


def d2_classic(g, device, include_first_hop: bool = True,
               max_iters: int = 1000) -> ColoringResult:
    """``d2_sgr_step`` driven by ``run_workefficient_loop`` from the
    all-zero start over every vertex, as a ``ColoringResult``."""
    adj = torch.from_numpy(g.padded_adjacency()).to(device)
    deg = torch.from_numpy(np.concatenate([g.degrees, [0]]).astype(np.int32)).to(device)

    def step(colors, wl):
        return d2_sgr_step(adj, adj, deg, colors, wl,
                           include_first_hop=include_first_hop)

    colors, iters, work, padded, converged = run_workefficient_loop(
        step, torch.zeros(g.n + 1, dtype=torch.int32, device=device),
        torch.arange(g.n, dtype=torch.int32, device=device), g.n, max_iters)
    return ColoringResult(colors[:g.n].cpu().numpy(), iters, work, padded,
                          converged, algorithm="d2_sgr_step")


def check_d2_slice(dev_cuda):
    reset_counts()
    for name in SUITE:
        g = build_graph(name, 0.005)
        for strategy in ("precomputed", "onthefly"):
            for mode in ("workefficient", "fused"):
                opts = dict(strategy=strategy, mode=mode)
                a = color(g, "distance2", device=dev_cuda, **opts)
                diff = same_result(a, color(g, "distance2", device="cpu", **opts))
                if diff or not validate_d2(g, a.colors):
                    fail(f"d2 slice: {name} {opts} card != cpu or invalid: {diff}")
    print("d2 slice: distance2 on SUITE at 0.005, both strategies, both modes: "
          "card == cpu, valid", flush=True)
    for label, bg in (("jacobian_band(4096, 3)", jacobian_band(4096, band=3)),
                      ("jacobian_tall_skinny(20000, 256, 4)",
                       jacobian_tall_skinny(20000, 256, 4))):
        for strategy in ("precomputed", "onthefly"):
            a = color(bg, "bipartite", device=dev_cuda, strategy=strategy)
            diff = same_result(a, color(bg, "bipartite", device="cpu",
                                        strategy=strategy))
            if diff or not validate_bipartite(bg, a.colors):
                fail(f"d2 slice: bipartite {label} {strategy}: card != cpu "
                     f"or invalid: {diff}")
        want = compress_jacobian_pattern(bg, device="cpu")
        got = compress_jacobian_pattern(bg, device=dev_cuda)
        if not (np.array_equal(want.seed_matrix(), got.seed_matrix())
                and all(np.array_equal(x, y) for x, y in zip(want.groups, got.groups))):
            fail(f"d2 slice: compress_jacobian_pattern {label}: card != cpu")
        print(f"d2 slice: bipartite {label}: {a.num_colors} colors, both "
              "strategies and compress_jacobian_pattern card == cpu", flush=True)
    g = build_graph("rmat-er", 0.05)
    for include_first_hop in (True, False):
        a = d2_classic(g, dev_cuda, include_first_hop)
        diff = same_result(a, d2_classic(g, "cpu", include_first_hop))
        if diff or not a.converged:
            fail(f"d2 slice: d2_sgr_step include_first_hop={include_first_hop} "
                 f"card != cpu or unconverged: {diff}")
        if include_first_hop and not validate_d2(g, a.colors):
            fail("d2 slice: d2_sgr_step coloring is not distance-2 valid")
        print(f"d2 slice: d2_sgr_step on rmat-er at 0.05 (n={g.n}), "
              f"include_first_hop={include_first_hop}: {a.iterations} steps, "
              f"{a.num_colors} colors, card == cpu", flush=True)
    counts = {k.__name__: k.launches for k in KERNELS}
    for k in (superstep_csr, serial_tail_csr, superstep_tile, firstfit_rows,
              conflict_rows, d2_firstfit):
        if counts[k.__name__] == 0:
            fail(f"d2 slice: kernel {k.__name__} was not launched")
    print(f"d2 slice launches: {counts}", flush=True)


# the paper's baselines checked card == CPU at small scale
SMALL_BASELINES = [
    ("serial", {}),
    ("topology", dict(heuristic="id")),
    ("topology", dict(heuristic="degree")),
    ("jp", {}),
    ("multihash", dict(nhash=1)),
    ("multihash", dict(nhash=2)),
    ("threestep", {}),
]


def check_baselines_slice(dev_cuda):
    """The baselines, traced runs and the ladder: card == CPU port."""
    reset_counts()
    for name in PAPER:
        g = build_graph(name, 0.25)
        for algorithm, opts in SMALL_BASELINES:
            with no_tile_gathers():  # K4 and K5 read the dense table in place
                a = color(g, algorithm, device=dev_cuda, **opts)
            b = color(g, algorithm, device="cpu", **opts)
            diff = same_result(a, b)
            if a.algorithm != b.algorithm:
                diff.append(("algorithm", a.algorithm, b.algorithm))
            if getattr(a, "serial_tail", None) != getattr(b, "serial_tail", None):
                diff.append(("serial_tail", a.serial_tail, b.serial_tail))
            if diff or not is_valid_coloring(g, a.colors):
                fail(f"baselines slice: {name} {algorithm} {opts}: card != cpu "
                     f"or invalid: {diff}")
            print(f"baselines slice {name:9s} n={g.n} {algorithm:9s} {opts}: "
                  f"iters={a.iterations} colors={a.num_colors}"
                  + (f" serial_tail={a.serial_tail}" if algorithm == "threestep"
                     else "") + ": card == cpu", flush=True)
    if firstfit_rows.launches == 0 or conflict_rows.launches == 0:
        fail("baselines slice: topology and threestep did not launch K4 and K5")
    print(f"baselines slice launches: K4 {firstfit_rows.launches}, K5 "
          f"{conflict_rows.launches}", flush=True)
    g = build_graph("rmat-g", 0.25)
    traced = [(g, "data_driven", {}), (g, "data_driven", dict(engine="classic")),
              (build_graph("rmat-er", 0.05), "distance2", {})]
    for graph, algorithm, opts in traced:
        a = color(graph, algorithm, device=dev_cuda, trace=True, **opts)
        b = color(graph, algorithm, device="cpu", trace=True, **opts)
        diff = same_result(a, b)
        if (diff or not np.array_equal(a.trace.steps, b.trace.steps)
                or a.trace.check(a) or a.trace.iterations != b.trace.iterations):
            fail(f"baselines slice: traced {algorithm} {opts}: card != cpu: "
                 f"{diff} {a.trace.check(a)}")
        print(f"traced {algorithm} {opts} n={graph.n}: {a.trace.steps.shape[0]} "
              "rows, card == cpu", flush=True)
    for opts in (dict(max_iters=1), dict(engine="classic", max_iters=1,
                                         tail_serial=False)):
        a = color(g, device=dev_cuda, ensure_valid=True, **opts)
        b = color(g, device="cpu", ensure_valid=True, **opts)
        if (same_result(a, b) or a.degradations != b.degradations
                or not a.degradations or not is_valid_coloring(g, a.colors)):
            fail(f"baselines slice: ensure_valid {opts}: card != cpu: "
                 f"{a.degradations} {b.degradations}")
        print(f"ensure_valid {opts}: rungs {[d['rung'] for d in a.degradations]}, "
              "card == cpu", flush=True)


def same_batch(a_list, b_list) -> list:
    """``same_result`` over two result lists, with the algorithm and the
    trace rows ([] if none differ)."""
    diff = []
    for i, (a, b) in enumerate(zip(a_list, b_list)):
        d = same_result(a, b)
        if a.algorithm != b.algorithm or a.degradations != b.degradations:
            d.append(("algorithm/degradations", a.algorithm, b.algorithm))
        if (a.trace is None) != (b.trace is None) or (
                a.trace is not None and not np.array_equal(a.trace.steps, b.trace.steps)):
            d.append(("trace", "rows differ"))
        if d:
            diff.append((i, d))
    if len(a_list) != len(b_list):
        diff.append(("length", len(a_list), len(b_list)))
    return diff


def check_batch_slice(dev_cuda):
    """``color_batch`` (fused and distance-2, both heuristics, traced) on
    ``serving_mix(8, 0.5)``: card == CPU, valid, K3 launched."""
    graphs = serving_mix(8, 0.5)
    for algorithm in ("fused", "distance2"):
        valid = validate_d2 if algorithm == "distance2" else is_valid_coloring
        for heuristic in HEURISTICS:
            reset_counts()
            a = color_batch(graphs, algorithm, heuristic=heuristic, trace=True,
                            device=dev_cuda)
            k3 = superstep_tile.launches
            b = color_batch(graphs, algorithm, heuristic=heuristic, trace=True,
                            device="cpu")
            diff = same_batch(a, b)
            if diff or k3 == 0 or not all(valid(g, r.colors)
                                          for g, r in zip(graphs, a)):
                fail(f"batch slice: {algorithm} {heuristic}: card != cpu, invalid "
                     f"or K3 not launched ({k3}): {diff}")
            print(f"batch slice {algorithm} {heuristic} on serving_mix(8, 0.5) "
                  f"(n {[g.n for g in graphs]}): iters "
                  f"{[r.iterations for r in a]}, colors {[r.num_colors for r in a]}, "
                  f"K3 {k3} K2 {serial_tail_csr.launches}: card == cpu", flush=True)


def check_session_slice(dev_cuda):
    """A durable session on SUITE rmat-g at 0.25, three churn rounds on the
    card and on the CPU: results, frontier, metrics() and the journal's
    records equal."""
    g = build_graph("rmat-g", 0.25)
    with tempfile.TemporaryDirectory() as tmp:
        a = open_session(g, device=dev_cuda, trace=True,
                         durable_dir=f"{tmp}/card", snapshot_every=4)
        b = open_session(g, device="cpu", trace=True,
                         durable_dir=f"{tmp}/cpu", snapshot_every=4)
        if same_batch([a.result], [b.result]):
            fail("session slice: cold colouring card != cpu")
        rngs = (np.random.default_rng(14), np.random.default_rng(14))
        for r in range(3):
            for s, rng in zip((a, b), rngs):
                rem, add = churn_delta(s.graph, 0.01, rng)
                s.apply_delta(remove_edges=rem, add_edges=add)
            frontier, frontier_cpu = a.frontier(), b.frontier()
            reset_counts()
            with no_superstep_gathers():
                ra = a.recolor()
            counts = {k.__name__: k.launches for k in KERNELS if k.launches}
            rb = b.recolor()
            diff = same_batch([ra], [rb])
            if (diff or not np.array_equal(frontier, frontier_cpu)
                    or a.metrics() != b.metrics() or not a.validate()
                    or superstep_csr.launches + superstep_tile.launches == 0):
                fail(f"session slice round {r}: card != cpu or invalid: {diff} "
                     f"{a.metrics()} {b.metrics()} {counts}")
            print(f"session slice rmat-g at 0.25 round {r}: frontier {frontier.size}, "
                  f"iters {ra.iterations}, work {ra.work_items}, launches {counts}: "
                  "card == cpu", flush=True)
        ja = list(SessionJournal(f"{tmp}/card").records())
        jb = list(SessionJournal(f"{tmp}/cpu").records())
        if ja != jb or a.metrics() != b.metrics():
            fail("session slice: journal records or metrics() card != cpu")
        print(f"session slice: {len(ja)} journal records and metrics() "
              f"{a.metrics()} card == cpu", flush=True)


# --------------------------------------------------------------------------
# phase 9-10: the main paths at full size
# --------------------------------------------------------------------------

PAPER = ("rmat-er", "rmat-g", "thermal2")
FULL = {
    "rmat-er": lambda: rmat(1 << 20, 10.0, RMAT_ER, seed=2),
    "rmat-g": lambda: rmat(1 << 20, 10.0, RMAT_G, seed=3),
    "thermal2": lambda: grid2d(3125, 384, diagonals=True),
    # kkt_power at the paper's size: dmax 144,504 passes the packed gather
    # word, so every class runs K3 over CSR rows read in place
    "kkt_power": lambda: build_graph("kkt_power", 21.4),
}
# (label, graph, options, the kernels this path must launch)
# the classic step on thermal2 timed mid-cascade: the one after the first
# 100 (of 1,755)
CLASSIC_MID_STEP = 101
FULL_RUNS = [
    *((f"ragged {g}", g, {}, (superstep_csr, serial_tail_csr)) for g in PAPER),
    *((f"classic {g}", g, dict(engine="classic"), (firstfit_rows, conflict_rows))
      for g in PAPER),
    *((f"padded {g}", g, dict(engine="padded"), (superstep_tile, serial_tail_csr))
      for g in PAPER),
    ("ragged kkt_power", "kkt_power", {}, (superstep_tile, serial_tail_csr)),
    ("chunked rmat-er", "rmat-er", dict(coarsen_lanes=65536), (superstep_tile,)),
    ("fused rmat-er", "rmat-er", dict(mode="fused"), (superstep_csr,)),
]


def kernel_times(g, dev_cuda, lat: dict, plain: bool) -> dict:
    """K1 per class at the first real superstep's inputs (every vertex
    colored 1, after the bootstrap identity), and K2 at the stall tail's
    inputs (all n vertices in ``order_tail`` order): CUDA-event times,
    byte bounds (K1: counted as ``k3_words`` does, one packed word a
    vertex; K2: also its depth and depth bound, and each layout forced)
    and, with ``plain``, the plain versions' CPU times and a bit-for-bit
    check at these shapes. K1 is also timed in each layout forced and
    beside K3 over the same CSR rows with colours and degrees apart
    (source (d)), all bit-identical."""
    gpu = DeviceCSR.from_csr(g, dev_cuda)
    deg_np = np.concatenate([g.degrees, [0]]).astype(np.int64)
    colors = torch.ones(g.n + 1, dtype=torch.int32, device=dev_cuda)
    colors[g.n] = 0
    packed = colors + (gpu.deg_ext << 16)
    classes, widths = _resolve_classes(g.degrees, (), "auto")
    k1 = []
    for cls, W in zip(classes, widths):
        wl = torch.from_numpy(cls).to(dev_cuda)
        source, _ = gpu.lane_source(W)

        def run(lanes=None):
            return superstep_csr(gpu.row_starts, gpu.col_padded, packed, wl, W,
                                 lanes=lanes)

        def run_d(lanes=None):
            return superstep_rows(colors, gpu.deg_ext, wl, source=source, W=W, lanes=lanes)

        want = run()
        words = k3_words(source, wl, colors, gpu.deg_ext, W)
        rec = {"W": W, "w": int(cls.size), "lanes": row_lanes(W),
               "ms": event_ms(run, reps=10, warm=2),
               # K1 reads one packed word a vertex: no degree words apart
               "bound_ms": 4 * (words["total"] - words["degrees"] - int(cls.size))
               / HBM_BYTES_PER_S * 1e3,
               "gather_ms": words["lanes"] / lat["gather_per_s"] * 1e3,
               "csr_ms": event_ms(run_d, reps=10, warm=2), "words": words}
        if not all(torch.equal(a, b) for a, b in zip(run_d(), want)):
            fail(f"K1 over packed words differs from K3 over CSR rows at W={W}")
        for lanes in ROW_LANES:
            rec[f"lanes{lanes}_ms"] = event_ms(lambda: run(lanes), reps=5, warm=1)
            if not all(torch.equal(a, b) for a, b in zip(run(lanes), want)):
                fail(f"K1 lanes={lanes} differs from the default layout at W={W}")
        if plain:
            t = time.perf_counter()
            ref = superstep_csr_ref(gpu.row_starts.cpu(), gpu.col_padded.cpu(),
                                    packed.cpu(), wl.cpu(), W)
            rec["plain_ms"] = (time.perf_counter() - t) * 1e3
            rec["max_abs_err"] = max(
                int((ref[0] - want[0].cpu()).abs().max()),
                int((ref[1].int() - want[1].cpu().int()).abs().max()))
            if rec["max_abs_err"]:
                fail(f"K1 differs from its plain version at W={W}, w={cls.size}")
        k1.append(rec)
    tail = order_tail(torch.arange(g.n, dtype=torch.int32, device=dev_cuda),
                      gpu.deg_ext)
    W = max(g.max_degree, 1)
    tail_np = tail.cpu().numpy()
    depth, widest = csr_tail_depth(g, tail_np)
    work = colors.clone()
    k2 = {"W": W, "T": g.n, "depth": depth, "widest": widest,
          "ms": event_ms(lambda: serial_tail_csr(
              gpu.row_starts, gpu.col_padded, gpu.deg_ext, work, tail, W),
              reps=3, warm=1),
          **k2_bound(bound_ms(deg_np, tail_np, W), depth, lat)}
    # each layout forced, at the same inputs: they must agree
    starts = gpu.row_starts[tail.clamp(0, g.n - 1)]
    degs = gpu.deg_ext[tail]
    for layout in ("thread", "warp"):
        out = colors.clone()
        k2[f"{layout}_ms"] = event_ms(lambda: _launch_tail(
            starts, degs, gpu.col_padded, out, tail, W, layout == "thread"),
            reps=3, warm=1)
        if not torch.equal(out, work):
            fail(f"K2's {layout} layout differs from the wrapper's at T={g.n}, W={W}")
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


def tile_bound_ms(w: int, W: int, same_lanes: int | None = None,
                  outs: int = 1) -> float:
    """Least time to move a tile kernel's bytes over HBM's rate.

    K4 (``same_lanes`` None) reads the (w, W) int32 colour tile and writes
    ``outs`` (w,) vectors.  K3 and K5 also read the three (w,) row vectors,
    and the neighbour ids and degrees only on the ``same_lanes`` lanes that
    hold their row's nonzero colour: no other lane's id or degree decides
    anything, so this run's data needs no more.
    """
    words = w * W + outs * w
    if same_lanes is not None:
        words += 3 * w + 2 * same_lanes
    return 4 * words / HBM_BYTES_PER_S * 1e3


def plain_check(name: str, want, got, shape) -> tuple[float, int]:
    """(plain ms, max |kernel - plain|) with the plain result computed by
    ``want()``; fails unless they are equal."""
    t = time.perf_counter()
    want = want()
    plain_ms = (time.perf_counter() - t) * 1e3
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    err = max(int((a.int() - b.cpu().int()).abs().max()) if a.numel() else 0
              for a, b in zip(want, got))
    if err:
        fail(f"{name} differs from its plain version at {shape}")
    return plain_ms, err


def lanes_read(source, ids, deg_ext, n: int, W: int):
    """``(row, lane, table_words)``: for each lane K3 reads over ``source``
    (each row up to its degree, each hop up to its own), its row's index in
    ``ids`` and its neighbour id, both int64 on the card, and the words of
    the table, R and C, or both hops' ids and degrees those reads take."""
    w = ids.shape[0]
    real = ids < n
    safe = ids.clamp(0, max(n - 1, 0)).long()

    def expand(length):
        rows = torch.repeat_interleave(torch.arange(w, device=ids.device), length)
        starts = torch.cumsum(length, 0) - length
        return rows, torch.arange(rows.numel(), device=ids.device) - starts[rows]

    if isinstance(source, TableRows):
        length = torch.where(real, deg_ext[safe].long().clamp(max=W), 0)
        rows, j = expand(length)
        return rows, source.table[safe[rows], j].long(), int(length.sum())
    if isinstance(source, CsrRows):
        s = source.row_starts[safe].long()
        length = torch.where(real, (source.row_starts[safe + 1].long() - s).clamp(max=W), 0)
        rows, j = expand(length)
        return rows, source.col[s[rows] + j].long(), int(length.sum()) + 2 * w
    a, b = source.adj_a, source.adj_b
    n_rows, n_mid, W1, W2 = a.shape[0], b.shape[0], a.shape[1], b.shape[1]
    lidx = ids.long() - source.start
    row = lidx.clamp(0, n_rows - 1)
    length = torch.where(real & (lidx < n_rows), source.deg_a[row].long().clamp(max=W1), 0)
    rows1, j1 = expand(length)
    mids = a[row[rows1], j1].long()
    len2 = torch.where(mids < n_mid, source.deg_b[mids.clamp(max=n_mid - 1)].long()
                       .clamp(max=W2), 0)
    rep = torch.repeat_interleave(torch.arange(mids.numel(), device=ids.device), len2)
    j2 = torch.arange(rep.numel(), device=ids.device) - (torch.cumsum(len2, 0) - len2)[rep]
    lanes2 = b[mids[rep], j2].long()
    words = 2 * int(mids.numel()) + int(rep.numel()) + w  # hop-1 ids and deg_b, deg_a
    if source.include_first_hop:
        return torch.cat([rows1, rows1[rep]]), torch.cat([mids, lanes2]), words
    return rows1[rep], lanes2, words


def k3_words(source, ids, colors, deg_ext, W: int) -> dict:
    """The int32 words K3 must move over ``source`` at these inputs, each
    read once: the ids, their colours and degrees, the table (or R and C,
    or both hops' ids and degrees) words it reads, the colour of each
    distinct neighbour on them, the degree of each distinct neighbour on a
    lane that holds its row's nonzero colour, and two outputs a row.
    Counted on the card. ``lanes`` and ``match`` (lanes read, lanes that
    match) give the random reads at the gather probe's rate."""
    n = colors.shape[0] - 1
    w = int(ids.shape[0])
    rows, lane, table_words = lanes_read(source, ids, deg_ext, n, W)
    my_c = colors[ids.long()][rows]
    match = (colors[lane] == my_c) & (my_c > 0)
    out = {"lanes": int(lane.numel()), "match": int(match.sum()),
           "colours": int(torch.unique(lane[lane < n]).numel()),
           "degrees": int(torch.unique(lane[match]).numel()),
           "table": table_words}
    out["total"] = 3 * w + table_words + out["colours"] + out["degrees"] + 2 * w
    return out


def k3_times(provider, deg_ext, classes, widths, dev_cuda, lat: dict, plain: bool,
             plain_cells: int = 2**26, old_cells: int = 2**30) -> list:
    """K3 per class, rows read in place (``superstep_rows`` over
    ``provider.lane_source``), at the first real superstep's inputs (every
    vertex colored 1, after the bootstrap identity): CUDA-event time, the
    bound (``k3_words``), the lanes' random reads at the probe's rate;
    where the class's tile has at most ``old_cells`` cells the old path
    (``provider.rows`` and the four gathers, then the tile entry point in
    the warp layout), its kernel alone, both checked equal; with ``plain``
    the plain version's CPU time and a bit-for-bit check on the first rows
    of the class whose tile has at most ``plain_cells`` cells."""
    n = deg_ext.shape[0] - 1
    colors = torch.ones(n + 1, dtype=torch.int32, device=dev_cuda)
    colors[n] = 0
    out = []
    for cls, width in zip(classes, widths):
        ids = torch.from_numpy(cls).to(dev_cuda)
        source, W = provider.lane_source(width)
        w = int(cls.size)

        def run():
            return superstep_rows(colors, deg_ext, ids, source=source, W=W)

        want = run()
        words = k3_words(source, ids, colors, deg_ext, W)
        rec = {"W": W, "w": w, "lanes": row_lanes(W),
               "ms": event_ms(run, reps=10, warm=2),
               "bound_ms": 4 * words["total"] / HBM_BYTES_PER_S * 1e3,
               "gather_ms": (words["lanes"] + words["match"]) / lat["gather_per_s"] * 1e3,
               "words": words}
        if w * W <= old_cells:
            def old():
                rows = provider.rows(ids, width)
                idx, ridx = ids.long(), rows.long()
                return superstep_tile(ids, rows, colors[idx], colors[ridx], deg_ext[idx],
                                      deg_ext[ridx], lanes=32)

            if not all(torch.equal(a, b) for a, b in zip(old(), want)):
                fail(f"K3 in place differs from the old path at W={W}, w={w}")
            rec["tile_ms"] = event_ms(old, reps=3, warm=1)
            rows = provider.rows(ids, width)
            idx, ridx = ids.long(), rows.long()
            args = (ids, rows, colors[idx], colors[ridx], deg_ext[idx], deg_ext[ridx])
            del ridx
            rec["tile_kernel_ms"] = event_ms(lambda: superstep_tile(*args, lanes=32), reps=3)
            del args, rows
            torch.cuda.empty_cache()
        if plain:
            k = max(1, min(w, plain_cells // W))
            cpu_src = to_device(source, "cpu")
            rec["plain_ms"], rec["max_abs_err"] = plain_check(
                "K3", lambda: superstep_rows_ref(colors.cpu(), deg_ext.cpu(), ids[:k].cpu(),
                                                 source=cpu_src, W=W),
                tuple(x[:k] for x in want), (k, W))
            rec["plain_rows"] = k
            del cpu_src
        out.append(rec)
    return out


def row_bounds(dense, deg_ext, colors4, colors5, ids) -> dict:
    """Least time for K4 and K5 over source (a) at these inputs: each word
    they need read once and each output written once, over HBM's rate.

    K4: the ids, the table lanes up to each degree, the colour of each
    distinct neighbour on them, the outputs. K5 (degree rule): the ids,
    their colours and degrees, the lanes of rows of nonzero colour (a row
    of colour 0 cannot lose), the colour of each distinct neighbour on them
    and the degree of each distinct neighbour on a lane that holds its
    row's colour, the outputs. Counted on the card from the gathered rows.
    """
    n, W = dense.shape
    w = int(ids.shape[0])
    rows = gather_rows(dense, ids)
    length = torch.where(ids < n, deg_ext[ids.clamp(max=n).long()].clamp(max=W), 0)
    read = torch.arange(W, device=ids.device)[None, :] < length[:, None]
    my_c = colors5[ids.long()]
    read5 = read & (my_c > 0)[:, None]
    match = read5 & (colors5[rows.long()] == my_c[:, None])
    words = {"lanes": int(read.sum()), "colours": int(torch.unique(rows[read]).numel()),
             "lanes5": int(read5.sum()), "colours5": int(torch.unique(rows[read5]).numel()),
             "match5": int(match.sum()), "degrees5": int(torch.unique(rows[match]).numel())}
    k4 = 2 * w + words["lanes"] + words["colours"]
    k5 = 4 * w + words["lanes5"] + words["colours5"] + words["degrees5"]
    return {"K4": 4 * k4 / HBM_BYTES_PER_S * 1e3, "K5": 4 * k5 / HBM_BYTES_PER_S * 1e3,
            "words": words}


def k45_at(dense, deg_ext, colors4, colors5, ids, dense_cpu, plain_rows: int,
           gather_per_s: float) -> dict:
    """K4 at ``colors4`` and K5 (degree rule) at ``colors5`` over the rows
    ``ids`` of the table ``dense`` (source (a)), as the classic engine
    launches them: CUDA-event times through the wrappers and in each layout
    forced (all must agree), the bound (``row_bounds``) beside the old tile
    bound, the old path at the same inputs (``gather_rows`` and the colour
    and degree gathers, then the kernel over the gathered tiles in the warp
    layout, one warp a row as the tile kernel had it) with its kernel alone,
    the plain versions' CPU time on the first ``plain_rows`` rows and a
    bit-for-bit check there. ``gather_ms`` is the time the lanes' random
    colour reads (and K5's degree reads on matching lanes) take at the
    probe's random-gather rate ``gather_per_s``, each a read of its own."""
    n, W = dense.shape
    w = int(ids.shape[0])
    idx = ids.long()

    def k4(lanes=None):
        return firstfit_rows(colors4, ids, table=dense, deg_ext=deg_ext, lanes=lanes)

    def k5(lanes=None):
        return conflict_rows(colors5, deg_ext, ids, "degree", table=dense, lanes=lanes)

    def tile4():
        return firstfit_tile(colors4[gather_rows(dense, ids).long()], lanes=32)

    def tile5():
        rows = gather_rows(dense, ids)
        idx, ridx = ids.long(), rows.long()
        return conflict_tile(ids, rows, colors5[idx], colors5[ridx], deg_ext[idx],
                             deg_ext[ridx], "degree", lanes=32)

    bounds = row_bounds(dense, deg_ext, colors4, colors5, ids)
    rec = {}
    k = min(w, plain_rows)
    plain = {"K4": lambda: firstfit_rows_ref(colors4.cpu(), ids[:k].cpu(), table=dense_cpu),
             "K5": lambda: conflict_rows_ref(colors5.cpu(), deg_ext.cpu(), ids[:k].cpu(),
                                             "degree", table=dense_cpu)}
    for name, run, tile in (("K4", k4, tile4), ("K5", k5, tile5)):
        want = run()
        gathers = (bounds["words"]["lanes"] if name == "K4" else
                   bounds["words"]["lanes5"] + bounds["words"]["match5"])
        r = {"W": W, "w": w, "lanes": row_lanes(W), "bound_ms": bounds[name],
             "gather_ms": gathers / gather_per_s * 1e3,
             "tile_bound_ms": (tile_bound_ms(w, W) if name == "K4" else
                               tile_bound_ms(w, W, int(bounds["words"]["lanes5"]))),
             "ms": event_ms(run, reps=10, warm=2)}
        for lanes in ROW_LANES:
            r[f"lanes{lanes}_ms"] = event_ms(lambda: run(lanes), reps=10, warm=1)
            if not torch.equal(run(lanes), want):
                fail(f"{name} lanes={lanes} differs from the default layout at w={w}, W={W}")
        if not torch.equal(tile(), want):
            fail(f"{name} differs from the tile kernel over gathered tiles at w={w}, W={W}")
        r["tile_ms"] = event_ms(tile, reps=10, warm=1)
        r["plain_ms"], r["max_abs_err"] = plain_check(name, plain[name], want[:k], (k, W))
        r["plain_rows"] = k
        rec[name] = r
    rows = gather_rows(dense, ids)
    nc = colors4[rows.long()]
    rec["K4"]["tile_kernel_ms"] = event_ms(lambda: firstfit_tile(nc, lanes=32), reps=10)
    ridx = rows.long()
    args = (ids, rows, colors5[idx], colors5[ridx], deg_ext[idx], deg_ext[ridx])
    rec["K5"]["tile_kernel_ms"] = event_ms(
        lambda: conflict_tile(*args, "degree", lanes=32), reps=10)
    rec["words"] = bounds["words"]
    return rec


def classic_state(dense, deg_ext, steps: int):
    """The classic engine's state after ``steps`` steps of one full-width
    class from the all-zero start (``_color_classic``'s loop): the colours
    and the next step's worklist slice."""
    n = dense.shape[0]
    colors = torch.zeros(n + 1, dtype=torch.int32, device=dense.device)
    wl = torch.arange(n, dtype=torch.int32, device=dense.device)
    count = n
    for _ in range(steps):
        cap = min(next_pow2(count), wl.shape[0])
        colors, wl, cnt = sgr_step(dense, deg_ext, colors, wl[:cap])
        count = int(cnt)
    return colors, wl[:min(next_pow2(count), wl.shape[0])], count


def k4_k5_times(g, dev_cuda, lat: dict, plain_rows: int,
                mid_step: int | None = None) -> dict:
    """K4 and K5 as the classic engine launches them (``k45_at``): at its
    first step, every vertex in one class over the dense table (w = n, W =
    Δmax; K4 FirstFits against the all-zero start, K5 then tests the
    all-ones colouring it produced), and with ``mid_step`` at that step of
    the cascade, replayed from the state the steps before it leave."""
    dense = torch.from_numpy(g.padded_adjacency()).to(dev_cuda)
    dense_cpu = dense.cpu()
    deg_ext = torch.from_numpy(
        np.concatenate([g.degrees, [0]]).astype(np.int32)).to(dev_cuda)
    n = g.n
    ids = torch.arange(n, dtype=torch.int32, device=dev_cuda)
    zeros = torch.zeros((n + 1,), dtype=torch.int32, device=dev_cuda)
    ones = torch.ones_like(zeros)
    ones[n] = 0
    rate = lat["gather_per_s"]
    out = {"first": k45_at(dense, deg_ext, zeros, ones, ids, dense_cpu, plain_rows, rate)}
    if mid_step:
        colors, wl, count = classic_state(dense, deg_ext, mid_step - 1)
        c = firstfit_rows(colors, wl, table=dense, deg_ext=deg_ext)
        after = colors.clone()
        after[wl.long()] = torch.where(wl < n, c, 0)
        out["mid"] = k45_at(dense, deg_ext, colors, after, wl, dense_cpu, plain_rows, rate)
        out["mid"]["step"], out["mid"]["live"] = mid_step, count
    return out


def print_k45(label: str, rec: dict):
    for name in ("K4", "K5"):
        r = rec[name]
        layouts = " / ".join(f"{r[f'lanes{k}_ms']:.4f}" for k in ROW_LANES)
        print(f"  {name} {label} W={r['W']} w={r['w']}: {r['ms']:.4f} ms (lanes "
              f"{r['lanes']}; forced {'/'.join(map(str, ROW_LANES))}: {layouts}), bound "
              f"{r['bound_ms']:.4f} ms (tile bound {r['tile_bound_ms']:.4f}; random "
              f"gathers at the probe's rate {r['gather_ms']:.4f}); old path "
              f"(gathers + tile kernel, warp layout) {r['tile_ms']:.4f} ms, its kernel "
              f"{r['tile_kernel_ms']:.4f} ms; plain {r['plain_ms']:.1f} ms on the first "
              f"{r['plain_rows']} rows", flush=True)
    print(f"  words counted for the bounds: {rec['words']}", flush=True)


def device_us(event) -> float:
    """A profiler row's own device time (the name changed across torch
    versions)."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def profile_call(call):
    """Device time by kernel for one call, from torch.profiler; returns
    what the call returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    # device rows only: an aten:: op's row repeats its kernels' device time
    rows = [(e.key, device_us(e) / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if not rows:
        print("  profiler: no device time recorded (not measured)")
        return out
    print(f"  profiler: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), top kernels:")
    for key, ms, count in rows[:8]:
        print(f"    {ms:10.3f} ms  x{count:<5d} {key[:90]}")
    return out


def no_tile_gathers():
    """A context in which ``core.coloring.gather_rows`` raises: the classic
    engine on the card reads its rows in place and gathers no tile."""
    def refuse(*args, **kwargs):
        raise AssertionError("the classic step gathered a (w, W) tile on the card")
    return mock.patch.object(core_coloring, "gather_rows", refuse)


@contextlib.contextmanager
def no_superstep_gathers():
    """A context in which every ``ragged_superstep`` call makes its
    provider's ``rows`` and ``core.coloring.gather_rows`` raise: on the card
    K1 and K3 read the rows in place. The composed tail's K2 segments
    (outside the superstep) may still gather."""
    real = core_coloring.ragged_superstep

    def refuse(*args, **kwargs):
        raise AssertionError("the superstep gathered a (w, W) tile on the card")

    def guarded(provider, *args, **kwargs):
        with mock.patch.object(provider, "rows", refuse), \
                mock.patch.object(core_coloring, "gather_rows", refuse):
            return real(provider, *args, **kwargs)

    with mock.patch.object(core_coloring, "ragged_superstep", guarded):
        yield


def run_full(label, call, kernels, valid, reps: int = 3, what: str = "",
             guard=no_superstep_gathers, profile: bool = True) -> dict:
    """One main path at full size: the counted run of ``call()`` inside
    ``guard()`` (no tile gathered), then ``reps`` timed runs (after the
    counted one, which warms up) and a profiled one. Prints the allocator's
    allocations and retries over the timed runs (``torch.cuda.memory_stats``).
    Returns the counted run's result, its launch counts, the median wall
    (ms) and the own peak (MiB above what was held before the call)."""
    reset_counts()
    with guard():
        r = call()  # the main path's counted run
    counts = {k.__name__: k.launches for k in KERNELS}
    for k in kernels:
        if counts[k.__name__] == 0:
            fail(f"full {label}: kernel {k.__name__} was not launched on its path")
    if not valid(r.colors):
        fail(f"full {label}: coloring is not valid")
    walls, peaks, held = [], [], torch.cuda.memory_allocated()
    before = torch.cuda.memory_stats()
    for _ in range(reps):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        again = call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated())
        if not np.array_equal(again.colors, r.colors):
            fail(f"full {label}: a repeated run gave other colors")
    after = torch.cuda.memory_stats()
    allocs = (after.get("allocation.all.allocated", 0)
              - before.get("allocation.all.allocated", 0)) / reps
    retries = after.get("num_alloc_retries", 0) - before.get("num_alloc_retries", 0)
    print(f"full {label} {what}: iters={r.iterations} colors={r.num_colors} "
          f"converged={r.converged} class_cells={r.class_cells}", flush=True)
    print(f"  call: median {statistics.median(walls):.3f} ms of "
          f"{[round(w, 3) for w in walls]}, peak device memory "
          f"{max(peaks) / 2**20:.1f} MiB ({(max(peaks) - held) / 2**20:.1f} MiB above the "
          f"{held / 2**20:.1f} MiB held before the call), launches "
          f"{ {k: c for k, c in counts.items() if c} }; allocations a call {allocs:.0f}, "
          f"allocator retries {retries}")
    if profile:
        profile_call(call)
    return {"result": r, "counts": counts, "ms": statistics.median(walls),
            "own_peak_mib": (max(peaks) - held) / 2**20}


def print_tile_recs(name: str, recs: list):
    for rec in recs:
        extra = ""
        if "csr_ms" in rec:
            layouts = " / ".join(f"{rec[f'lanes{k}_ms']:.4f}" for k in ROW_LANES)
            extra += (f"; forced {'/'.join(map(str, ROW_LANES))}: {layouts}; K3 over "
                      f"the same CSR rows, colours and degrees apart {rec['csr_ms']:.4f}")
        if "tile_ms" in rec:
            extra += (f"; old path (gathers + tile kernel, warp layout) "
                      f"{rec['tile_ms']:.4f} ms, its kernel {rec['tile_kernel_ms']:.4f}")
        if "plain_ms" in rec:
            extra += f"; plain {rec['plain_ms']:.1f} ms" + (
                f" on the first {rec['plain_rows']} rows" if "plain_rows" in rec else "")
        print(f"  {name} W={rec['W']:6d} w={rec['w']:8d}: {rec['ms']:.4f} ms (lanes "
              f"{rec['lanes']}), bound {rec['bound_ms']:.4f} ms (random gathers at the "
              f"probe's rate {rec['gather_ms']:.4f}){extra}", flush=True)
        print(f"    words counted for the bound: {rec['words']}", flush=True)


def check_full(dev_cuda, lat: dict) -> dict:
    totals = {k.__name__: 0 for k in KERNELS}
    times = {}
    graphs = {}
    ragged = {}  # the default path's median wall and result, for phase 11
    for name, make in FULL.items():
        t = time.perf_counter()
        graphs[name] = g = make()
        print(f"graph {name}: n={g.n} nnz={g.m} dmax={g.max_degree} "
              f"(built in {time.perf_counter() - t:.1f} s)", flush=True)
    for label, name, opts, kernels in FULL_RUNS:
        g = graphs[name]
        out = run_full(label, lambda: color(g, device=dev_cuda, **opts), kernels,
                       lambda c: is_valid_coloring(g, c), what=str(opts),
                       guard=(no_tile_gathers if label.startswith("classic")
                              else no_superstep_gathers))
        for k, c in out["counts"].items():
            totals[k] += c
        r = out["result"]
        if label == f"ragged {name}":
            ragged[name] = out
        if label == "ragged rmat-er":
            ids = np.arange(g.n)
            t = time.perf_counter()
            want = greedy_serial(g, order=np.lexsort((ids, -g.degrees)))
            out["oracle_ms"] = (time.perf_counter() - t) * 1e3
            print(f"  serial-greedy oracle (largest degree first, host): "
                  f"{out['oracle_ms']:.3f} ms, {int(want.max())} colors", flush=True)
            if not np.array_equal(want, r.colors):
                fail(f"full {label}: colors differ from the serial-greedy "
                     f"oracle in {int((want != r.colors).sum())} vertices")
        plain = name in ("rmat-er", "kkt_power")
        if label.startswith("ragged") and name in PAPER:
            kt = kernel_times(g, dev_cuda, lat, plain=plain)
            times[label] = kt
            print_tile_recs("K1", kt["k1"])
            k2 = kt["k2"]
            print(f"  K2 W={k2['W']} T={k2['T']} depth={k2['depth']} (widest level "
                  f"{k2['widest']}): {k2['ms']:.4f} ms; thread layout "
                  f"{k2['thread_ms']:.4f} ms, warp layout {k2['warp_ms']:.4f} ms; "
                  f"bound {k2['bound_ms']:.4f} ms by {k2['bound_by']} (bytes "
                  f"{k2['bytes_bound_ms']:.4f}, depth x L2 {k2['depth_bound_ms']:.4f})"
                  + (f", plain {k2['plain_ms']:.1f} ms" if "plain_ms" in k2 else ""),
                  flush=True)
        elif label.startswith("classic"):
            times[label] = kt = k4_k5_times(
                g, dev_cuda, lat, plain_rows=g.n if name == "rmat-er" else 65536,
                mid_step=CLASSIC_MID_STEP if name == "thermal2" else None)
            print_k45("classic first step", kt["first"])
            if "mid" in kt:
                print_k45(f"classic step {kt['mid']['step']} (live {kt['mid']['live']})",
                          kt["mid"])
        elif label.startswith("padded") or name == "kkt_power":
            classes, widths = _resolve_classes(g.degrees, (), "auto")
            csr = DeviceCSR.from_csr(g, dev_cuda)
            if label.startswith("padded"):
                provider = DenseRows(
                    torch.from_numpy(g.padded_adjacency()).to(dev_cuda), csr)
            else:
                provider = csr
            times[label] = recs = k3_times(provider, csr.deg_ext, classes,
                                           widths, dev_cuda, lat, plain=plain)
            print_tile_recs("K3", recs)
            del provider
        torch.cuda.empty_cache()
    return {"launches": totals, "times": times, "graphs": graphs, "ragged": ragged}


# (label, graph, options, the kernels this path must launch); the graphs of
# the distance-2 runs have G^2 too large for the 256 MiB budget, so ``auto``
# composes the two hops on the fly (K3 over (n, Δ²+Δ) tiles, K2 tail)
D2_FULL_RUNS = [
    ("distance2 rmat-er", "rmat-er", {}, (superstep_tile, serial_tail_csr)),
    ("distance2 thermal2", "thermal2", {}, (superstep_tile, serial_tail_csr)),
    ("distance2 precomputed thermal2", "thermal2", dict(strategy="precomputed"),
     (superstep_csr, serial_tail_csr)),
    ("bipartite jacobian_band", "jacobian_band", {}, (superstep_tile, serial_tail_csr)),
]


def two_hop_colors(g, dev_cuda, colors):
    """The hop-1 ``(n, Δ)`` and hop-2 ``(n, Δ²)`` colour tiles of every
    vertex, as ``d2_sgr_step``'s FirstFit reads them."""
    adj = torch.from_numpy(g.padded_adjacency()).to(dev_cuda)
    rows1 = gather_rows(adj, torch.arange(g.n, dtype=torch.int32, device=dev_cuda))
    rows2 = gather_rows(adj, rows1.reshape(-1), sentinel=g.n).reshape(g.n, -1)
    return colors[rows1.long()], colors[rows2.long()]


def k6_times(g, dev_cuda, plain_rows: int) -> dict:
    """K6 at the first step's shape (w = n, W1 = Δ, W2 = Δ²) on the colours
    one ``d2_sgr_step`` from the all-zero start leaves: CUDA-event time, the
    byte bound (each tile word read once, the colours written once) and the
    plain version's CPU time and a bit-for-bit check on the first
    ``plain_rows`` rows."""
    n = g.n
    adj = torch.from_numpy(g.padded_adjacency()).to(dev_cuda)
    deg = torch.from_numpy(np.concatenate([g.degrees, [0]]).astype(np.int32)).to(dev_cuda)
    colors, _, _ = d2_sgr_step(adj, adj, deg, torch.zeros(n + 1, dtype=torch.int32,
                                                          device=dev_cuda),
                               torch.arange(n, dtype=torch.int32, device=dev_cuda))
    del adj
    nc1, nc2 = two_hop_colors(g, dev_cuda, colors)
    W1, W2 = nc1.shape[1], nc2.shape[1]
    rec = {"w": n, "W1": W1, "W2": W2,
           "ms": event_ms(lambda: d2_firstfit(nc1, nc2), reps=10, warm=2),
           "bound_ms": 4 * n * (W1 + W2 + 1) / HBM_BYTES_PER_S * 1e3,
           "plain_rows": plain_rows}
    got = d2_firstfit(nc1, nc2)[:plain_rows]
    c1, c2 = nc1[:plain_rows].cpu(), nc2[:plain_rows].cpu()
    rec["plain_ms"], rec["max_abs_err"] = plain_check(
        "K6", lambda: d2_firstfit_ref(c1, c2), got, (plain_rows, W1, W2))
    print(f"  K6 w={n} W1={W1} W2={W2}: {rec['ms']:.4f} ms (bound "
          f"{rec['bound_ms']:.4f} ms), plain {rec['plain_ms']:.1f} ms on the "
          f"first {plain_rows} rows", flush=True)
    return rec


def d2_k5_times(g, dev_cuda, lat: dict, plain_rows: int) -> dict:
    """K5 (degree rule) over source (b) at ``d2_sgr_step``'s first step:
    every vertex's composed hop-1 and hop-2 id rows (W = Δ + Δ², self,
    duplicate and sentinel lanes included), after the first FirstFit gave
    every vertex colour 1. CUDA-event times through the wrapper and in each
    layout forced (all must agree), the byte bound (the ids, their colours
    and degrees, every lane of the id rows, each distinct neighbour's colour
    and the degree of each distinct neighbour on a matching lane, the
    outputs), the random gathers at the probe's rate, the old path (the
    colour and degree tiles gathered, then the kernel over them in the warp
    layout), and the plain version's CPU time on the first ``plain_rows``
    rows with a bit-for-bit check."""
    n = g.n
    adj = torch.from_numpy(g.padded_adjacency()).to(dev_cuda)
    deg = torch.from_numpy(np.concatenate([g.degrees, [0]]).astype(np.int32)).to(dev_cuda)
    ids = torch.arange(n, dtype=torch.int32, device=dev_cuda)
    rows1 = gather_rows(adj, ids)
    rows2 = gather_rows(adj, rows1.reshape(-1), sentinel=n).reshape(n, -1)
    rows = torch.cat([rows1, rows2], dim=1)
    del adj, rows1, rows2
    W = int(rows.shape[1])
    colors = torch.ones(n + 1, dtype=torch.int32, device=dev_cuda)
    colors[n] = 0

    def run(lanes=None):
        return conflict_rows(colors, deg, ids, "degree", rows=rows, lanes=lanes)

    want = run()
    rec = {"W": W, "w": n, "lanes": row_lanes(W, bitset=False, full=True),
           "ms": event_ms(run, reps=5, warm=1)}
    for lanes in ROW_LANES:
        rec[f"lanes{lanes}_ms"] = event_ms(lambda: run(lanes), reps=3, warm=1)
        if not torch.equal(run(lanes), want):
            fail(f"K5 lanes={lanes} differs from the default layout over composed rows")
    ridx = rows.long()
    match = colors[ridx] == 1
    distinct = int(torch.unique(rows).numel()) - int((rows == n).any())
    degrees = int(torch.unique(rows[match]).numel())
    rec["bound_ms"] = 4 * (4 * n + n * W + distinct + degrees) / HBM_BYTES_PER_S * 1e3
    rec["gather_ms"] = (n * W + int(match.sum())) / lat["gather_per_s"] * 1e3
    del match

    def tile():
        idx, r = ids.long(), rows.long()
        return conflict_tile(ids, rows, colors[idx], colors[r], deg[idx], deg[r], "degree",
                             lanes=32)

    del ridx
    if not torch.equal(tile(), want):
        fail("K5 over composed rows differs from the tile kernel over gathered tiles")
    rec["tile_ms"] = event_ms(tile, reps=3, warm=1)
    k = min(n, plain_rows)
    rec["plain_ms"], rec["max_abs_err"] = plain_check(
        "K5 (composed rows)", lambda: conflict_rows_ref(
            colors.cpu(), deg.cpu(), ids[:k].cpu(), "degree", rows=rows[:k].cpu()),
        want[:k], (k, W))
    rec["plain_rows"] = k
    layouts = " / ".join(f"{rec[f'lanes{k}_ms']:.4f}" for k in ROW_LANES)
    print(f"  K5 d2_sgr_step first step, composed rows W={W} w={n}: {rec['ms']:.4f} ms "
          f"(lanes {rec['lanes']}; forced {'/'.join(map(str, ROW_LANES))}: {layouts}), "
          f"bound {rec['bound_ms']:.4f} ms (random gathers at the probe's rate "
          f"{rec['gather_ms']:.4f}); old path (colour and degree tiles gathered + tile "
          f"kernel, warp layout) {rec['tile_ms']:.4f} ms; plain {rec['plain_ms']:.1f} ms on "
          f"the first {k} rows", flush=True)
    return rec


def composed_depths(segs, rank: torch.Tensor, W: int) -> tuple[int, int]:
    """Depth of the composed-row tail: over the whole tail as one DAG (what
    the function needs) and summed over the segments' launches, which run
    one after another (what K2's launches can reach). Each segment's edges
    are found on the card, deduplicated, and layered on the host
    (``tail_depth``)."""
    src, dst, seg_depth, lo = [], [], 0, 0
    for starts, degs, rows, ids in segs:
        k = int(ids.shape[0])
        rn = rank[rows.long()].view(k, W).long()
        r = torch.arange(lo, lo + k, device=rows.device)[:, None]
        mask = (rn >= 0) & (rn < r)
        key = torch.unique((r.expand(k, W)[mask] << 32) | rn[mask])
        s_, d_ = (key & 0xFFFFFFFF).cpu().numpy(), (key >> 32).cpu().numpy()
        inside = s_ >= lo
        seg_depth += tail_depth(s_[inside] - lo, d_[inside] - lo, k)[0]
        src.append(s_)
        dst.append(d_)
        lo += k
        del rn, mask, key
    return tail_depth(np.concatenate(src), np.concatenate(dst), lo)[0], seg_depth


def composed_tail_times(prov, degrees: np.ndarray, dev_cuda, lat: dict,
                        check_rows: int = 2048) -> dict:
    """The serial tail over the composed rows of ``prov`` (a ``TwoHopRows``),
    all n = ``degrees.size`` vertices in ``order_tail`` order by
    ``degrees`` (the stall tail of ``distance2`` or ``bipartite`` on the
    fly): the whole tail (segments materialized, then K2 on each) and its
    K2 launches alone, through the wrapper and in each layout forced, by
    CUDA events; the depth, the bound; K2 over the first ``check_rows``
    entries against its plain version."""
    W = prov.width
    n = int(degrees.size)
    deg = torch.from_numpy(np.concatenate([degrees, [0]]).astype(np.int32)).to(dev_cuda)
    tail = order_tail(torch.arange(n, dtype=torch.int32, device=dev_cuda), deg)
    colors = torch.ones(n + 1, dtype=torch.int32, device=dev_cuda)
    colors[n] = 0
    whole_ms = event_ms(lambda: _composed_tail(prov, colors.clone(), tail, W),
                        reps=1, warm=1)
    seg = TAIL_SEGMENT_CELLS // W
    segs = []
    for lo in range(0, n, seg):
        ids = tail[lo:lo + seg]
        k = int(ids.shape[0])
        segs.append((torch.arange(0, k * W, W, dtype=torch.int32, device=dev_cuda),
                     torch.full((k,), W, dtype=torch.int32, device=dev_cuda),
                     prov.rows(ids).reshape(-1), ids))
    del prov
    outs = {}

    def k2_only(layout):
        work = colors.clone()
        work[tail.long()] = 0
        for starts, degs, rows, ids in segs:
            if layout == "wrapper":
                serial_tail_rows(starts, degs, rows, work, ids, W)
            else:
                _launch_tail(starts, degs, rows, work, ids, W, layout == "thread")
        outs[layout] = work

    times = {layout: event_ms(lambda: k2_only(layout), reps=1, warm=1)
             for layout in ("wrapper", "thread", "warp")}
    if not (torch.equal(outs["thread"], outs["wrapper"])
            and torch.equal(outs["warp"], outs["wrapper"])):
        fail(f"K2's layouts differ over composed rows at W={W}")
    depth, seg_depth = composed_depths(segs, tail_ranks(tail, n), W)
    starts, degs, rows, ids = segs[0]
    k = check_rows
    got = serial_tail_rows(starts[:k], degs[:k], rows[:k * W], colors.clone(),
                           ids[:k], W)
    plain_ms, err = plain_check(
        "K2 (composed rows)", lambda: serial_tail_rows_ref(
            starts[:k].cpu(), degs[:k].cpu(), rows[:k * W].cpu(),
            colors.cpu().clone(), ids[:k].cpu(), W), got, (k, W))
    rec = {"W": W, "T": n, "segments": len(segs), "whole_ms": whole_ms,
           "ms": times["wrapper"], "thread_ms": times["thread"], "warp_ms": times["warp"],
           "ns_per_vertex": times["wrapper"] * 1e6 / n, "depth": depth,
           "segment_depth": seg_depth,
           **k2_bound((n * 20 + n * W * 8) / HBM_BYTES_PER_S * 1e3, depth, lat),
           "plain_ms": plain_ms, "plain_rows": k, "max_abs_err": err}
    print(f"  K2 composed tail W={W} T={n} in {len(segs)} segments: whole tail "
          f"{whole_ms:.3f} ms, K2 launches {rec['ms']:.3f} ms ({rec['ns_per_vertex']:.1f} "
          f"ns/vertex; thread layout {rec['thread_ms']:.3f} ms, warp layout "
          f"{rec['warp_ms']:.3f} ms); depth {depth} (summed over the segments' "
          f"launches {seg_depth}); bound {rec['bound_ms']:.3f} ms by {rec['bound_by']} "
          f"(bytes {rec['bytes_bound_ms']:.3f}, depth x L2 {rec['depth_bound_ms']:.3f}, "
          f"segments' depth x L2 {seg_depth * lat['l2_ns'] / 1e6:.3f}); plain "
          f"{plain_ms:.1f} ms on the first {k} entries", flush=True)
    return rec


def two_hop_k3_times(g, dev_cuda, lat: dict, plain: bool) -> list:
    """K3 at the first real superstep of ``distance2`` (a ``CSRGraph``) or
    ``bipartite`` (a ``BipartiteGraph``) on the fly: every vertex colored
    1, all in one class, over the composed rows the engine's provider
    reads in place (``k3_times``)."""
    if hasattr(g, "n_cols"):
        c2r, r2c = (torch.from_numpy(a).to(dev_cuda) for a in g.padded_halves())
        deg = torch.from_numpy(np.concatenate([g.col_degrees, [0]]).astype(np.int32))
        deg = deg.to(dev_cuda)
        prov = TwoHopRows(c2r, r2c, False)
        n = g.n_cols
    else:
        adj = torch.from_numpy(g.padded_adjacency()).to(dev_cuda)
        deg = torch.from_numpy(np.concatenate([g.degrees, [0]]).astype(np.int32))
        deg = deg.to(dev_cuda)
        prov = TwoHopRows(adj, adj)
        n = g.n
    return k3_times(prov, deg, [np.arange(n, dtype=np.int32)], [None], dev_cuda, lat,
                    plain=plain)


def check_d2_full(graphs: dict, dev_cuda, lat: dict) -> dict:
    graphs = dict(graphs)
    t = time.perf_counter()
    graphs["jacobian_band"] = jacobian_band(1 << 20, band=3)
    bg = graphs["jacobian_band"]
    print(f"graph jacobian_band(1<<20, band=3): n_cols={bg.n_cols} "
          f"nnz={bg.nnz} (built in {time.perf_counter() - t:.1f} s)", flush=True)
    totals = {k.__name__: 0 for k in KERNELS}
    times = {}
    for label, name, opts, kernels in D2_FULL_RUNS:
        g = graphs[name]
        algorithm = "bipartite" if name == "jacobian_band" else "distance2"
        valid = validate_bipartite if algorithm == "bipartite" else validate_d2
        precomputed = opts.get("strategy") == "precomputed"
        if algorithm == "distance2" and not precomputed:
            t = time.perf_counter()
            strategy = resolve_d2_strategy(g, "auto", DEFAULT_D2_BUDGET)
            print(f"{label}: strategy auto resolves to {strategy} (host time of the "
                  f"pick, inside every call: {(time.perf_counter() - t) * 1e3:.1f} ms)",
                  flush=True)
        if precomputed:
            t = time.perf_counter()
            g2 = g.square()
            print(f"{label}: host G^2 build {time.perf_counter() - t:.1f} s "
                  f"(n={g2.n}, m={g2.m}, dmax={g2.max_degree}); color() below "
                  "includes it", flush=True)
            del g2
        out = run_full(label, lambda: color(g, algorithm, device=dev_cuda, **opts),
                       kernels, lambda c: valid(g, c), reps=1 if precomputed else 3,
                       what=str(opts))
        for k, c in out["counts"].items():
            totals[k] += c
        if not precomputed:
            times[f"k3 {label}"] = recs = two_hop_k3_times(g, dev_cuda, lat,
                                                           plain=name == "rmat-er")
            print_tile_recs("K3 first step, composed rows in place", recs)
            torch.cuda.empty_cache()
        if algorithm == "bipartite":
            t = time.perf_counter()
            cr = compress_jacobian_pattern(g, device=dev_cuda)
            seed = cr.seed_matrix()
            if cr.num_groups != 7 or seed.shape != (g.n_cols, 7) or (seed.sum(1) != 1).any():
                fail(f"full {label}: compress_jacobian_pattern gave {cr.num_groups} "
                     f"groups, seed {seed.shape}")
            print(f"  colors {out['result'].num_colors}, optimum 2*band+1 = 7; "
                  f"compress_jacobian_pattern: {cr.num_groups} groups, seed "
                  f"{seed.shape} in {(time.perf_counter() - t) * 1e3:.1f} ms",
                  flush=True)
        torch.cuda.empty_cache()
    g = graphs["rmat-er"]
    out = run_full("d2_sgr_step rmat-er", lambda: d2_classic(g, dev_cuda),
                   (d2_firstfit, conflict_rows), lambda c: validate_d2(g, c),
                   what="(run_workefficient_loop, include_first_hop=True)")
    for k, c in out["counts"].items():
        totals[k] += c
    torch.cuda.empty_cache()
    times["k6"] = k6_times(g, dev_cuda, plain_rows=65536)
    torch.cuda.empty_cache()
    times["k5 d2"] = d2_k5_times(g, dev_cuda, lat, plain_rows=65536)
    torch.cuda.empty_cache()
    times["k6 thermal2"] = k6_times(graphs["thermal2"], dev_cuda, plain_rows=65536)
    torch.cuda.empty_cache()
    for key, name in (("k2 composed", "rmat-er"), ("k2 composed thermal2", "thermal2")):
        adj = torch.from_numpy(graphs[name].padded_adjacency()).to(dev_cuda)
        times[key] = composed_tail_times(TwoHopRows(adj, adj), graphs[name].degrees,
                                         dev_cuda, lat)
        del adj
        torch.cuda.empty_cache()
    cols2rows, rows2cols = bg.padded_halves()
    times["k2 composed jacobian_band"] = composed_tail_times(
        TwoHopRows(torch.from_numpy(cols2rows).to(dev_cuda),
                   torch.from_numpy(rows2cols).to(dev_cuda), include_first_hop=False),
        bg.col_degrees, dev_cuda, lat)
    torch.cuda.empty_cache()
    return {"launches": totals, "times": times}


# phase 11: the paper's comparison at full size.  (algorithm, options,
# kernels its counted run must launch)
BASELINE_RUNS = [
    ("topology", {}, (firstfit_rows, conflict_rows)),
    ("jp", {}, ()),
    ("multihash", {}, ()),
    ("threestep", {}, (firstfit_rows, conflict_rows)),
]


def host_cpu() -> str:
    """The card machine's host CPU: ``lscpu``'s model name, family, model
    and CPU count (the machine may report its model name as unknown)."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return "not read (no lscpu)"
    fields = dict(line.split(":", 1) for line in out.stdout.splitlines()
                  if ":" in line)
    def field(key):
        return fields.get(key, "?").strip()

    return (f"{field('Vendor ID')} {field('Model name')} (family "
            f"{field('CPU family')}, model {field('Model')}), {field('CPU(s)')} CPUs")


def check_comparison(graphs: dict, ragged: dict, dev_cuda) -> dict:
    """``serial``, ``topology``, ``jp``, ``multihash`` and ``threestep``
    against the default ``data_driven`` path on the paper's three graphs,
    each valid; the traced default path against the untraced one; the
    ladder on an unconverged run."""
    totals = {k.__name__: 0 for k in KERNELS}
    table = {}
    for name in PAPER:
        g = graphs[name]
        dd = ragged[name]
        rows = {"data_driven": (dd["ms"], dd["result"].num_colors)}
        t = time.perf_counter()
        r = color(g, "serial", device=dev_cuda)
        rows["serial"] = ((time.perf_counter() - t) * 1e3, r.num_colors)
        if not is_valid_coloring(g, r.colors):
            fail(f"comparison {name}: serial coloring is not valid")
        print(f"comparison serial {name}: one run on the host, "
              f"{rows['serial'][0]:.3f} ms, colors={r.num_colors}", flush=True)
        for algorithm, opts, kernels in BASELINE_RUNS:
            out = run_full(f"{algorithm} {name}",
                           lambda: color(g, algorithm, device=dev_cuda, **opts),
                           kernels, lambda c: is_valid_coloring(g, c),
                           what=str(opts), guard=no_tile_gathers,
                           # threestep: seconds of host fix-up a run; one timed run
                           reps=1 if algorithm == "threestep" else 3,
                           profile=algorithm != "threestep")
            for k, c in out["counts"].items():
                totals[k] += c
            res = out["result"]
            rows[algorithm] = (out["ms"], res.num_colors)
            if algorithm == "threestep":
                print(f"  serial_tail {res.serial_tail} of {g.n} vertices fixed on "
                      "the host", flush=True)
        table[name] = rows
    serial_ms = {n: table[n]["serial"][0] for n in PAPER}
    print(f"comparison (host CPU of serial: {host_cpu()}): colors / serial's, "
          "data_driven's speedup = that algorithm's ms / data_driven's ms",
          flush=True)
    for name in PAPER:
        rows = table[name]
        dd_ms, serial_colors = rows["data_driven"][0], rows["serial"][1]
        for algorithm, (ms, ncol) in rows.items():
            print(f"  {name:9s} {algorithm:12s} {ms:12.3f} ms {ncol:5d} colors "
                  f"({ncol / serial_colors:.2f}x serial's), data_driven "
                  f"{ms / dd_ms:.2f}x faster", flush=True)
    g = graphs["rmat-er"]
    off = color(g, device=dev_cuda)
    on = color(g, device=dev_cuda, trace=True)
    walls = {"untraced": [], "traced": []}
    for _ in range(3):
        for key, trace in (("untraced", False), ("traced", True)):
            t = time.perf_counter()
            r = color(g, device=dev_cuda, trace=trace)
            torch.cuda.synchronize()
            walls[key].append((time.perf_counter() - t) * 1e3)
            if not np.array_equal(r.colors, off.colors):
                fail("comparison: a traced run gave other colors than untraced")
    if not np.array_equal(on.colors, off.colors) or on.trace.check(on) \
            or any(getattr(on, f) != getattr(off, f) for f in RESULT_FIELDS):
        fail(f"comparison: traced rmat-er differs from untraced: {on.trace.check(on)}")
    print(f"traced rmat-er: {on.trace.iterations} rows {on.trace.steps.tolist()}, "
          f"check() passes; median {statistics.median(walls['traced']):.3f} ms "
          f"traced, {statistics.median(walls['untraced']):.3f} ms untraced (of "
          f"{walls})", flush=True)
    t = time.perf_counter()
    r = color(g, device=dev_cuda, ensure_valid=True, max_iters=1)
    ladder_ms = (time.perf_counter() - t) * 1e3
    if not (r.converged and r.degradations and is_valid_coloring(g, r.colors)):
        fail(f"comparison: ensure_valid on rmat-er gave {r.degradations}")
    print(f"ensure_valid=True, max_iters=1 on rmat-er: {ladder_ms:.3f} ms, rungs "
          f"{[(d['rung'], d['outcome']) for d in r.degradations]}, colors "
          f"{r.num_colors}", flush=True)
    return {"launches": totals, "table": table, "serial_ms": serial_ms}


# --------------------------------------------------------------------------
# phase 12: the batched engine and streaming sessions at full size
# --------------------------------------------------------------------------

BATCH_SEEDS = (2, 12, 22, 32)  # rmat-er at 2^20: phase 9's graph is seed 2
STREAM_ROUNDS = 4
CHURN = 0.01  # benchmarks/dynamic.py's churn fraction and seed
CHURN_SEED = 14


@contextlib.contextmanager
def counted_steps():
    """Count ``ragged_superstep`` calls (a batch's global steps, a
    session's class sub-steps) in a list the context yields."""
    real = core_coloring.ragged_superstep
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    with mock.patch.object(core_coloring, "ragged_superstep", counted):
        yield calls


def median_ms(call, reps: int = 3) -> tuple[float, list]:
    """The median wall of ``reps`` runs of ``call()`` (after the caller's
    warm-up), each ending in ``torch.cuda.synchronize()``."""
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return statistics.median(walls), [round(w, 3) for w in walls]


def counted_batch(label: str, call, graphs, valid, buckets: int) -> dict:
    """The counted run of a batched call: no tile gathered, K3 launches
    equal to the global steps, at most one K2 launch a width bucket, every
    colouring valid.  Returns the launches and the own peak (MiB)."""
    reset_counts()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with no_superstep_gathers(), counted_steps() as steps:
        results = call()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    counts = {k.__name__: k.launches for k in KERNELS}
    if counts["superstep_tile"] != len(steps) or not steps:
        fail(f"{label}: {counts['superstep_tile']} K3 launches for {len(steps)} "
             "global steps")
    if counts["serial_tail_csr"] > buckets:
        fail(f"{label}: {counts['serial_tail_csr']} K2 launches for {buckets} buckets")
    for g, r in zip(graphs, results):
        if not (r.converged and valid(g, r.colors)):
            fail(f"{label}: a colouring is not valid")
    print(f"{label}: counted run: {len(steps)} global steps, launches "
          f"{ {k: c for k, c in counts.items() if c} }, own peak {peak:.1f} MiB; "
          f"iters {[r.iterations for r in results]}, colors "
          f"{[r.num_colors for r in results]}", flush=True)
    return {"counts": counts, "results": results, "peak_mib": peak,
            "steps": len(steps)}


def bucketed(graphs, distance2: bool = False) -> list:
    """``color_batch_fused``'s width buckets: lists of graph indices."""
    by_key: dict = {}
    for i, g in enumerate(graphs):
        by_key.setdefault(_width_key(g, distance2), []).append(i)
    return list(by_key.values())


def time_batch(label: str, graphs, dev_cuda, distance2: bool = False) -> dict:
    """Pack each width bucket once (timed apart, host and upload), then the
    median of 3 batched calls over the packed buckets after a warm-up,
    against the loop of single ``color(g, mode="fused")`` calls.  Distance-2
    takes one run after the counted one (its calls are device-bound and
    seconds long) and no loop (a single distance-2 call squares its graph
    on the host)."""
    t = time.perf_counter()
    batches = [GraphBatch.from_graphs([graphs[i] for i in idx], distance2=distance2,
                                      device=dev_cuda) for idx in bucketed(graphs, distance2)]
    torch.cuda.synchronize()
    pack_ms = (time.perf_counter() - t) * 1e3
    for b in batches:
        print(f"  bucket B={b.B} n_max={b.n_max} W={b.width} table "
              f"{tuple(b.table.shape)} CSR nnz {int(b.csr.col_padded.numel()) - b.width}",
              flush=True)

    def batch_call():
        return [color_batch_fused(b, distance2=distance2) for b in batches]

    if not distance2:
        batch_call()
    ms, walls = median_ms(batch_call, reps=1 if distance2 else 3)
    B = len(graphs)
    line = (f"{label}: pack {pack_ms:.3f} ms (host + upload, apart); batched "
            f"median {ms:.3f} ms of {walls} ({ms / B:.3f} ms a graph)")
    loop_ms = None
    if not distance2:
        def loop_call():
            return [color(g, device=dev_cuda, mode="fused") for g in graphs]

        loop_call()
        loop_ms, loop_walls = median_ms(loop_call)
        line += (f"; loop of {B} single color(g, mode='fused') median "
                 f"{loop_ms:.3f} ms of {loop_walls} ({loop_ms / B:.3f} ms a "
                 f"graph); batch {loop_ms / ms:.2f}x")
    print(f"{line} [{card_line()}]", flush=True)
    profile_call(batch_call)
    return {"pack_ms": pack_ms, "ms": ms, "loop_ms": loop_ms}


def rmat_er(seed: int):
    return rmat(1 << 20, 10.0, RMAT_ER, seed=seed)


def batch_graphs(first, pending: list) -> list:
    """Four rmat-er graphs at the paper's size: phase 9's (seed 2) and seeds
    12, 22, 32 (``pending``: their builds, started in a process pool); a
    seed whose pow2 width bucket differs from the first graph's is replaced
    by the next seed by 10 (the recipe is unchanged)."""
    key = _width_key(first, False)
    graphs = [first]
    for seed, job in zip(BATCH_SEEDS[1:], pending):
        g = job.result()
        for _ in range(5):
            if _width_key(g, False) == key:
                break
            print(f"batch: rmat-er seed {seed} has dmax {g.max_degree}, outside "
                  f"the bucket W <= {key}; taking seed {seed + 10}", flush=True)
            seed += 10
            g = rmat_er(seed)
        print(f"batch graph rmat-er seed {seed}: n={g.n} nnz={g.m} "
              f"dmax={g.max_degree}", flush=True)
        graphs.append(g)
    return graphs


def timed_square(g):
    """``(G², seconds)``: the host build of ``g``'s square, timed where it
    runs (a pool process)."""
    t = time.perf_counter()
    sq = g.square()
    return sq, time.perf_counter() - t


def with_square(g, sq):
    """``g``, its ``square()`` answering ``sq`` (its G², built in the process
    pool), so the batch packs it without squaring it again."""
    object.__setattr__(g, "square", lambda: sq)
    return g


def check_stream(graphs: dict, dev_cuda) -> dict:
    """Sessions on rmat-g and thermal2, 4 churn rounds each: per round the
    frontier, the host snapshot rebuild, the incremental recolor and the
    cold fused call on the mutated graph, work items, engine keys, validity
    and the device memory, which must stay flat round over round."""
    totals = {k.__name__: 0 for k in KERNELS}
    out = {}
    for name in ("rmat-g", "thermal2"):
        g = graphs[name]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        s = open_session(g, device=dev_cuda)
        torch.cuda.synchronize()
        print(f"stream {name}: open_session {(time.perf_counter() - t) * 1e3:.3f} ms "
              f"(cold fused colouring, {s.num_colors} colors) [{card_line()}]",
              flush=True)
        rng = np.random.default_rng(CHURN_SEED)
        mems, rounds = [], []
        for r in range(STREAM_ROUNDS):
            rem, add = churn_delta(s.graph, CHURN, rng)
            s.apply_delta(remove_edges=rem, add_edges=add)
            frontier = int(s.frontier().size)
            t = time.perf_counter()
            snap = s.graph  # the host O(m) overlay merge, timed apart
            rebuild_ms = (time.perf_counter() - t) * 1e3
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with no_superstep_gathers():
                res = s.recolor()
            torch.cuda.synchronize()
            inc_ms = (time.perf_counter() - t) * 1e3
            counts = {k.__name__: k.launches for k in KERNELS if k.launches}
            for k, c in counts.items():
                totals[k] += c
            if not counts.get("superstep_csr", 0) + counts.get("superstep_tile", 0):
                fail(f"stream {name} round {r}: neither K1 nor K3 was launched")
            if not (res.converged and s.validate()):
                fail(f"stream {name} round {r}: the session colouring is not valid")
            cold_work = color(snap, device=dev_cuda, mode="fused").work_items  # warm-up
            cold_ms, _ = median_ms(lambda: color(snap, device=dev_cuda, mode="fused"))
            m = s.metrics()
            del snap
            torch.cuda.synchronize()
            mems.append(torch.cuda.memory_allocated() - base)
            rounds.append({"frontier": frontier, "rebuild_ms": rebuild_ms,
                           "recolor_ms": inc_ms, "cold_ms": cold_ms,
                           "work": res.work_items, "iters": res.iterations})
            print(f"  round {r}: frontier {frontier}, host snapshot rebuild "
                  f"{rebuild_ms:.3f} ms, recolor {inc_ms:.3f} ms ({res.iterations} "
                  f"iters, work {res.work_items}, launches {counts}), cold fused "
                  f"{cold_ms:.3f} ms (work {cold_work}), "
                  f"engine keys hit/miss {m['engine_cache_hits']}/"
                  f"{m['engine_cache_misses']}, valid {s.validate()}, session "
                  f"memory {mems[-1] / 2**20:.1f} MiB [{card_line()}]", flush=True)
        rem, add = churn_delta(s.graph, CHURN, rng)
        s.apply_delta(remove_edges=rem, add_edges=add)
        s.graph  # the snapshot, outside the profiled recolor
        print(f"  round {STREAM_ROUNDS}, profiled: frontier {s.frontier().size}",
              flush=True)
        profile_call(s.recolor)
        # one graph's tables: the session's padded CSR (its high-water column
        # capacity), the cold calls' CSR and three (n + 1) int32 arrays
        table_bytes = (s._ecap_hw + s.graph.m + s.graph.max_degree
                       + 3 * (s.n + 1)) * 4
        if max(mems[1:]) - mems[0] > table_bytes:
            fail(f"stream {name}: session memory grew {mems} past one graph's "
                 f"tables ({table_bytes} B)")
        print(f"stream {name}: memory {[round(x / 2**20, 1) for x in mems]} MiB "
              f"over {STREAM_ROUNDS} rounds: flat", flush=True)
        out[name] = rounds
        del s
        torch.cuda.empty_cache()
    return {"launches": totals, "rounds": out}


def check_session_batch(graphs: list, dev_cuda) -> dict:
    """``open_session_batch`` over the batch graphs; two of them churned and
    one sweep recolors them: only the dirty sessions launch anything."""
    t = time.perf_counter()
    sb = open_session_batch(graphs, device=dev_cuda)
    torch.cuda.synchronize()
    open_ms = (time.perf_counter() - t) * 1e3
    launched = {}
    for b, s in enumerate(sb.sessions):
        def wrapped(*, full=False, b=b, real=s.recolor):
            before = sum(k.launches for k in KERNELS)
            r = real(full=full)
            launched[b] = sum(k.launches for k in KERNELS) - before
            return r
        s.recolor = wrapped
    rng = np.random.default_rng(CHURN_SEED)
    dirty = (1, 3)
    for b in dirty:
        rem, add = churn_delta(sb.sessions[b].graph, CHURN, rng)
        sb.apply_delta(b, remove_edges=rem, add_edges=add)
    for b in dirty:  # the snapshots, outside the sweep (timed in phase 12's streams)
        sb.sessions[b].graph
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with no_superstep_gathers():
        results = profile_call(sb.recolor)
    sweep_ms = (time.perf_counter() - t) * 1e3
    counts = {k.__name__: k.launches for k in KERNELS}
    for b in range(sb.B):
        if (launched[b] > 0) != (b in dirty) or (results[b].work_items > 0) != (b in dirty):
            fail(f"session batch: graph {b} launched {launched[b]} kernels, work "
                 f"{results[b].work_items}; dirty {dirty}")
    if not sb.validate():
        fail("session batch: a colouring is not valid")
    print(f"session batch over {sb.B} rmat-er graphs at 2^20: open {open_ms:.3f} ms; "
          f"dirty {list(dirty)}, sweep {sweep_ms:.3f} ms (profiled), launches per session "
          f"{launched}, work {[r.work_items for r in results]}, metrics "
          f"{sb.metrics()['engine_cache_misses']} misses: only the dirty sessions "
          f"launched [{card_line()}]", flush=True)
    return {"launches": counts, "sweep_ms": sweep_ms}


def check_serving(graphs: dict, dev_cuda) -> dict:
    """Phase 12: the batch of four rmat-er graphs, the serving mix, the
    batched distance-2 path, sessions under churn and a session batch."""
    totals = {k.__name__: 0 for k in KERNELS}

    def add(counts):
        for k, c in counts.items():
            totals[k] += c

    d2mix = serving_mix(8, 10)
    t = time.perf_counter()
    # the host builds run side by side in spawned processes (numpy only)
    with ProcessPoolExecutor(max_workers=6,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        pending = [pool.submit(rmat_er, seed) for seed in BATCH_SEEDS[1:]]
        squares = [pool.submit(timed_square, g) for g in d2mix]
        mix = serving_mix(16, 40)
        four = batch_graphs(graphs["rmat-er"], pending)
        squares = [job.result() for job in squares]
        d2mix = [with_square(g, sq) for g, (sq, _) in zip(d2mix, squares)]
    print(f"phase 12 host graphs (three rmat-er, serving_mix(16, 40), the G^2 of "
          f"serving_mix(8, 10)) built in {time.perf_counter() - t:.1f} s, side by "
          "side in a process pool", flush=True)
    print(f"batch four rmat-er: dmax {[g.max_degree for g in four]}, buckets "
          f"{bucketed(four)}", flush=True)
    out = counted_batch("batch four rmat-er", lambda: color_batch(four, device=dev_cuda),
                        four, is_valid_coloring, len(bucketed(four)))
    add(out["counts"])
    time_batch("batch four rmat-er", four, dev_cuda)
    buckets = bucketed(mix)
    print(f"serving mix (16, 40): n {[g.n for g in mix]}, dmax "
          f"{[g.max_degree for g in mix]}, buckets (B, W key) "
          f"{[(len(i), _width_key(mix[i[0]], False)) for i in buckets]}", flush=True)
    out = counted_batch("serving mix", lambda: color_batch(mix, device=dev_cuda), mix,
                        is_valid_coloring, len(buckets))
    add(out["counts"])
    time_batch("serving mix", mix, dev_cuda)
    d2b = bucketed(d2mix, True)
    secs = [round(sec, 3) for _, sec in squares]
    print(f"batched distance-2 on serving_mix(8, 10): G^2 m "
          f"{[sq.m for sq, _ in squares]}, dmax {[sq.max_degree for sq, _ in squares]}; "
          f"host G^2 build {sum(secs):.3f} s in all ({secs} s each, in the pool "
          f"above); buckets {d2b}", flush=True)
    out = counted_batch("batched distance-2",
                        lambda: color_batch(d2mix, "distance2", device=dev_cuda),
                        d2mix, validate_d2, len(d2b))
    add(out["counts"])
    time_batch("batched distance-2", d2mix, dev_cuda, distance2=True)
    stream = check_stream(graphs, dev_cuda)
    add(stream["launches"])
    sbatch = check_session_batch(four, dev_cuda)
    add(sbatch["launches"])
    return {"launches": totals, "mix": mix}


# --------------------------------------------------------------------------
# phase 13: the coloring service on the card
# --------------------------------------------------------------------------

def service_requests(svc, graphs, deltas) -> list:
    """Phase 13's fixed synchronous sequence: colours under both
    heuristics, one distance-2 bucket, one slow-path request, and open /
    delta / recolor / colours / metrics on two sessions (the pool holds
    one, so each touch spills the other and restores its own)."""
    out = []
    for g in graphs:
        out.append(svc.color(g))
        out.append(svc.color(g, heuristic="id"))
    out.append(svc.color(graphs[0], algorithm="distance2"))
    out.append(svc.color(graphs[1], ensure_valid=True))
    for sid, b in (("s0", 0), ("s1", 1)):
        out.append(svc.open_session(sid, graphs[b]))
    for sid, delta in deltas:
        out.append(svc.apply_delta(sid, **delta))
        out.append(svc.recolor(sid))
        out.append(svc.colors(sid))
        out.append(svc.session_metrics(sid))
    m = svc.metrics()
    m.pop("ewma_request_seconds")  # the one timing field
    out.append(m)
    return out


def same_outputs(a_list, b_list) -> list:
    """Where two service sequences differ ([] if nowhere)."""
    diff = []
    for i, (a, b) in enumerate(zip(a_list, b_list)):
        if isinstance(a, ColoringResult):
            d = same_result(a, b)
        elif isinstance(a, np.ndarray):
            d = [] if np.array_equal(a, b) else ["array"]
        else:
            d = [] if a == b else [(a, b)]
        if d:
            diff.append((i, d))
    if len(a_list) != len(b_list):
        diff.append(("length", len(a_list), len(b_list)))
    return diff


def stopped(svc, label: str):
    """Shut ``svc`` down; fail if its worker is still alive a minute after."""
    svc.shutdown(wait=False)
    svc._worker.join(timeout=60)
    if svc._worker.is_alive():
        fail(f"service {label}: the worker is still alive after shutdown()")


def service_slice(dev_cuda, tmp: str):
    """Card == CPU: the same sequence through a card and a CPU service."""
    graphs = serving_mix(8, 0.5)
    rng = np.random.default_rng(CHURN_SEED)
    deltas = []
    for sid, b in (("s0", 0), ("s1", 1), ("s0", 0)):
        rem, add = churn_delta(graphs[b], 0.02, rng)
        deltas.append((sid, {"remove_edges": rem, "add_edges": add}))
    outs = {}
    for dev in (dev_cuda, "cpu"):
        svc = ColoringService(pool_size=1, queue_limit=16, max_batch=8,
                              spill_dir=f"{tmp}/{torch.device(dev).type}",
                              device=dev)
        try:
            outs[dev] = service_requests(svc, graphs, deltas)
        finally:
            stopped(svc, f"slice {dev}")
    diff = same_outputs(outs[dev_cuda], outs["cpu"])
    m = outs[dev_cuda][-1]
    if diff or m["failed"] or not (m["spills"] and m["restores"]):
        fail(f"service slice: card != cpu or a request failed: {diff[:5]} {m}")
    print(f"service slice on serving_mix(8, 0.5): {len(outs['cpu'])} outputs, "
          f"{m['microbatches']} micro-batches, {m['slow_requests']} slow, "
          f"spills {m['spills']} restores {m['restores']}: card == cpu", flush=True)


def service_burst(mix, dev_cuda) -> dict:
    """``serving_mix(16, 40)`` as one async burst: every served colouring
    valid and equal to the direct fused call; one K3 launch a global step
    of every micro-batch, at most one K2 launch a micro-batch."""
    direct = [color(g, "fused", device=dev_cuda) for g in mix]
    svc = ColoringService(pool_size=2, queue_limit=32, max_batch=16, trace=True,
                          device=dev_cuda)
    try:
        reset_counts()
        t = time.perf_counter()
        with no_superstep_gathers(), counted_steps() as steps:
            tickets = [svc.color(g, wait=False) for g in mix]
            results = [tk.wait(600) for tk in tickets]
        burst_ms = (time.perf_counter() - t) * 1e3
        counts = {k.__name__: k.launches for k in KERNELS}
        m = svc.metrics()
        spans = svc.take_spans()
    finally:
        stopped(svc, "burst")
    mb = [e.meta for e in spans if e.name == "serve_microbatch"]
    if counts["superstep_tile"] != len(steps) or not steps:
        fail(f"service burst: {counts['superstep_tile']} K3 launches for "
             f"{len(steps)} global steps")
    if not 0 < counts["serial_tail_csr"] <= m["microbatches"]:
        fail(f"service burst: {counts['serial_tail_csr']} K2 launches for "
             f"{m['microbatches']} micro-batches")
    for g, r, d in zip(mix, results, direct):
        if not (r.converged and is_valid_coloring(g, r.colors)
                and np.array_equal(r.colors, d.colors)):
            fail("service burst: a served colouring is invalid or differs from "
                 "the direct fused call")
    if m["failed"] or m["completed"] != len(mix):
        fail(f"service burst: {m}")
    share = sum(x["vertices"] for x in mb) / sum(x["slots"] for x in mb)
    print(f"service burst serving_mix(16, 40): {burst_ms:.3f} ms for {len(mix)} "
          f"requests, {m['microbatches']} micro-batches (B {[x['B'] for x in mb]}, "
          f"padded {[x['padded_B'] for x in mb]}), {len(steps)} global steps, "
          f"launches { {k: c for k, c in counts.items() if c} }; real vertices "
          f"{share:.4f} of the padded flat ids; every colouring == direct fused "
          f"[{card_line()}]", flush=True)
    return counts


def service_sessions(graphs: dict, dev_cuda, tmp: str) -> dict:
    """Pooled sessions at 2^20 (rmat-g, thermal2, then rmat-er) with
    ``pool_size=2``: two churn rounds, the third open spills the LRU
    session, a touch restores it, two more rounds; colours equal sessions
    run outside the service on the same deltas. The unserved sessions run
    first, so the launch counts read are the service's alone."""
    names = ("rmat-g", "thermal2")
    refs = {n: open_session(graphs[n], device=dev_cuda) for n in names}
    deltas = {n: [] for n in names}
    for n in names:
        rng = np.random.default_rng(CHURN_SEED)
        for _ in range(4):
            rem, add = churn_delta(refs[n].graph, CHURN, rng)
            deltas[n].append({"remove_edges": rem, "add_edges": add})
            refs[n].apply_delta(**deltas[n][-1])
            refs[n].recolor()
    torch.cuda.synchronize()
    svc = ColoringService(pool_size=2, queue_limit=16, spill_dir=f"{tmp}/spill",
                          trace=True, device=dev_cuda)

    def rounds(first, last):
        for i in range(first, last):
            for n in names:
                svc.apply_delta(n, **deltas[n][i])
                svc.recolor(n)

    try:
        reset_counts()
        t = time.perf_counter()
        for n in names:
            svc.open_session(n, graphs[n])
        rounds(0, 2)
        out = svc.open_session("rmat-er", graphs["rmat-er"])  # spills the LRU
        svc.colors(out["evicted"])                             # restores it
        rounds(2, 4)
        got = {n: svc.colors(n) for n in names}
        m = svc.metrics()
        spans = svc.take_spans()
        wall = time.perf_counter() - t
        counts = {k.__name__: k.launches for k in KERNELS}
    finally:
        stopped(svc, "sessions")
    for n in names:
        if not (np.array_equal(got[n], refs[n].colors) and refs[n].validate()):
            fail(f"service sessions {n}: colours differ from the unserved session")
    if m["spills"] < 1 or m["restores"] < 1 or m["failed"]:
        fail(f"service sessions: spills {m['spills']} restores {m['restores']} "
             f"failed {m['failed']}")
    if not (counts["superstep_csr"] and counts["serial_tail_csr"]):
        fail(f"service sessions: K1 or K2 not launched: {counts}")
    ms = {name: [round(e.duration * 1e3, 3) for e in spans if e.name == name]
          for name in ("serve_spill", "serve_restore")}
    print(f"service sessions at 2^20 (pool 2; rmat-g, thermal2, rmat-er): "
          f"{wall:.1f} s for 3 opens and 4 churn rounds of two sessions; "
          f"evicted {out['evicted']!r}; spill ms {ms['serve_spill']}, restore "
          f"ms {ms['serve_restore']}; spills {m['spills']} restores "
          f"{m['restores']}; launches { {k: c for k, c in counts.items() if c} }; "
          f"colours == the unserved sessions [{card_line()}]", flush=True)
    return counts


def service_overload(mix, dev_cuda):
    """A flood past ``queue_limit=4``: ``Overloaded`` raised, the queue
    bounded, every admitted ticket finished; one deliberate error request
    is the only failure."""
    g = mix[0]
    svc = ColoringService(pool_size=1, queue_limit=4, max_batch=2, device=dev_cuda)
    try:
        try:
            svc.recolor("never-opened")
            fail("service overload: an unknown session did not raise")
        except KeyError:
            pass
        tickets, errors, peak = [], [], 0
        for _ in range(48):
            try:
                tickets.append(svc.color(g, wait=False))
            except Overloaded as e:
                errors.append(e)
            peak = max(peak, svc.metrics()["queue_depth"])
        results = [tk.wait(600) for tk in tickets]
        m = svc.metrics()
    finally:
        stopped(svc, "overload")
    if not errors or peak > 4 or any(e.queue_depth > 4 for e in errors):
        fail(f"service overload: {len(errors)} rejections, queue peak {peak}")
    if m["failed"] != 1 or m["completed"] != len(tickets) \
            or m["rejected"] != len(errors):
        fail(f"service overload: {m}")
    if not all(is_valid_coloring(g, r.colors) for r in results):
        fail("service overload: an admitted colouring is not valid")
    print(f"service overload: 48 requests, {len(tickets)} admitted and finished, "
          f"{len(errors)} Overloaded (payload {errors[0].payload()}), queue peak "
          f"{peak}/4, failed 1 (the deliberate unknown session)", flush=True)


def check_service(graphs: dict, mix, dev_cuda) -> dict:
    """Phase 13: the service at small scale (card == CPU), the serving mix
    as one burst, pooled 2^20 sessions with spill and restore, overload."""
    totals = {k.__name__: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        service_slice(dev_cuda, tmp)
        for counts in (service_burst(mix, dev_cuda),
                       service_sessions(graphs, dev_cuda, tmp)):
            for k, c in counts.items():
                totals[k] += c
        service_overload(mix, dev_cuda)
    return {"launches": totals}


# --------------------------------------------------------------------------
# phase 14: the sharded engine
# --------------------------------------------------------------------------

SHARDS = 4  # shards of the one card at full size


def same_sharded(a, b) -> list:
    """``same_batch`` with the halo bytes ([] if nothing differs)."""
    diff = same_batch([a], [b])
    if a.halo_bytes_per_step != b.halo_bytes_per_step:
        diff.append(("halo_bytes_per_step", a.halo_bytes_per_step,
                     b.halo_bytes_per_step))
    return diff


def sharded_slice(dev_cuda):
    """Card == CPU at small scale: the sharded engine on k in (2, 3) shards
    of the card and of the CPU, every result field, the halo bytes and the
    trace rows: distance-1 on rmat-er and rmat-g at 0.25 (n 16,384: the
    packed halo word) and thermal2 at 0.25 (n 49,152: (id, colour)
    pairs), both heuristics and the tail off on rmat-g; distance-2 and
    bipartite in both strategies; ``color_batch`` in both regimes."""
    g1 = {name: build_graph(name, 0.25) for name in ("rmat-er", "rmat-g", "thermal2")}
    d2g, bg = build_graph("rmat-g", 0.05), jacobian_band(4096, band=3)
    cases = [(f"{name} k={k}", "data_driven", g, k, {})
             for name, g in g1.items() for k in (2, 3)]
    cases += [(f"rmat-g k={k} {label}", "data_driven", g1["rmat-g"], k, opts)
              for k in (2, 3) for label, opts in (
                  ("id traced", dict(heuristic="id", trace=True)),
                  ("no tail", dict(tail_serial=None)))]
    cases += [(f"distance2 {s} k=3", "distance2", d2g, 3, dict(strategy=s, trace=True))
              for s in ("precomputed", "onthefly")]
    cases += [(f"bipartite {s} k=2", "bipartite", bg, 2, dict(strategy=s))
              for s in ("precomputed", "onthefly")]
    for label, algorithm, g, k, opts in cases:
        reset_counts()
        with no_superstep_gathers():
            a = color(g, algorithm, engine="sharded", devices=[dev_cuda] * k, **opts)
        k3 = superstep_tile.launches
        b = color(g, algorithm, engine="sharded", devices=["cpu"] * k, **opts)
        diff = same_sharded(a, b)
        if diff or k3 < k:
            fail(f"sharded slice {label}: card != cpu or K3 not launched ({k3}): {diff}")
        print(f"sharded slice {label} (n {b.colors.size}): iters {a.iterations}, "
              f"colors {a.num_colors}, padded {a.padded_work}, halo "
              f"{a.halo_bytes_per_step} B a step, K3 {k3} K2 "
              f"{serial_tail_csr.launches}: card == cpu", flush=True)
    for label, graphs, k, algorithm in (
            ("B >= ndev", serving_mix(6, 0.5), 2, "fused"),
            ("B >= ndev distance-2", serving_mix(4, 0.5), 2, "distance2"),
            ("B < ndev", serving_mix(2, 0.5), 3, "fused")):
        reset_counts()
        a = color_batch(graphs, algorithm, engine="sharded", devices=[dev_cuda] * k,
                        trace=True)
        k3 = superstep_tile.launches
        b = color_batch(graphs, algorithm, engine="sharded", devices=["cpu"] * k,
                        trace=True)
        diff = same_batch(a, b) + [d for x, y in zip(a, b) for d in same_sharded(x, y)]
        if diff or k3 == 0:
            fail(f"sharded batch {label}: card != cpu or K3 not launched: {diff}")
        print(f"sharded batch {label} {algorithm} k={k}: iters "
              f"{[r.iterations for r in a]}, algorithms {sorted({r.algorithm for r in a})}, "
              f"K3 {k3}: card == cpu", flush=True)


def sharded_full(label, run, single, valid, K: int, same_work: bool) -> dict:
    """One sharded path at full size through ``run_full`` (the counted run
    of ``run()``, then the median of 3 and a profiled run), its
    ``ragged_superstep`` calls counted: one K3 launch each, ``SHARDS × K``
    a speculative step; colours and iterations (with ``same_work`` also
    ``work_items``) equal to the single-device call ``single``; then one
    traced run, its spans' wall by name."""
    steps = []

    @contextlib.contextmanager
    def guard():
        with no_superstep_gathers(), counted_steps() as calls:
            yield
        steps.append(len(calls))

    out = run_full(label, run, (superstep_tile, serial_tail_csr), valid,
                   guard=guard, what=f"({SHARDS} shards of one card)")
    r, counts = out["result"], out["counts"]
    spec = r.iterations - 1 - (counts["serial_tail_csr"] > 0)
    if not (steps[0] == counts["superstep_tile"] == SHARDS * K * spec) or spec < 1:
        fail(f"{label}: {counts['superstep_tile']} K3 launches, {steps[0]} class "
             f"sub-steps for {SHARDS} shards x {K} classes x {spec} steps")
    if counts["superstep_csr"]:
        fail(f"{label}: K1 launched on the sharded path")
    one = single()
    if not (np.array_equal(one.colors, r.colors) and one.iterations == r.iterations
            and (one.work_items == r.work_items or not same_work)):
        fail(f"{label}: colours, iterations or work items differ from the "
             "single-device call")
    print(f"  {label}: padded_work {r.padded_work}, halo {r.halo_bytes_per_step} B "
          f"a step, K3 {counts['superstep_tile']} = {SHARDS} shards x {K} classes x "
          f"{spec} steps, K2 {counts['serial_tail_csr']}; colours and iterations == "
          f"the single-device call, work_items {r.work_items} (single-device "
          f"{one.work_items}) [{card_line()}]", flush=True)
    traced = run(trace=True)
    torch.cuda.synchronize()
    if not np.array_equal(traced.colors, r.colors) or traced.trace.check(traced):
        fail(f"{label}: the traced run differs or its trace is incoherent")
    spans: dict = {}
    for e in traced.trace.spans:
        spans[e.name] = spans.get(e.name, 0.0) + e.duration * 1e3
    print(f"  {label} traced: spans (ms) "
          f"{ {k: round(v, 3) for k, v in spans.items()} }; rows (live, retired, "
          f"conflicts, max colour, cells, tail, halo B, imbalance) "
          f"{traced.trace.steps.tolist()}", flush=True)
    return out


def check_sharded(graphs: dict, dev_cuda, lat: dict) -> dict:
    """Phase 14: the sharded engine card == CPU at small scale, then
    rmat-er (distance-1 and distance-2 on the fly) and the banded Jacobian
    (bipartite on the fly) at full size on ``SHARDS`` shards of the card,
    and K3 over one shard's rows read in place against its plain version
    at rmat-er's first-step shapes."""
    totals = {k.__name__: 0 for k in KERNELS}
    t = time.perf_counter()
    sharded_slice(dev_cuda)
    print(f"sharded slice took {time.perf_counter() - t:.1f} s", flush=True)
    devs = [dev_cuda] * SHARDS
    g = graphs["rmat-er"]
    classes, widths = _resolve_classes(g.degrees, (), "auto")
    t = time.perf_counter()
    bg = jacobian_band(1 << 20, band=3)
    print(f"graph jacobian_band(1<<20, band=3) rebuilt in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    runs = [
        ("sharded rmat-er", lambda **kw: color(g, engine="sharded", devices=devs, **kw),
         lambda: color(g, device=dev_cuda, mode="fused"),
         lambda c: is_valid_coloring(g, c), len(classes), True),
        ("sharded distance2 rmat-er",
         lambda **kw: color(g, "distance2", engine="sharded", devices=devs, **kw),
         lambda: color(g, "distance2", device=dev_cuda),
         lambda c: validate_d2(g, c), 1, False),
        ("sharded bipartite jacobian_band",
         lambda **kw: color(bg, "bipartite", engine="sharded", devices=devs, **kw),
         lambda: color(bg, "bipartite", device=dev_cuda),
         lambda c: validate_bipartite(bg, c), 1, False),
    ]
    for run in runs:
        out = sharded_full(*run)
        for k, c in out["counts"].items():
            totals[k] += c
        torch.cuda.empty_cache()
    # the engine's cached plan and stacked shards of rmat-er
    plan = core_coloring._graph_device_cache(
        g, f"plan{SHARDS}", None, lambda: PartitionedCSR.from_graph(g, SHARDS))
    stacked = core_coloring._graph_device_cache(
        g, f"shards{SHARDS}", None, lambda: plan.stack_shards(g))
    rs, col, deg = (torch.from_numpy(a[0]).to(dev_cuda) for a in stacked)
    shard = ShardRows(rs, col, deg, 0, g.n, plan.n_loc, max(g.max_degree, 1))
    own = [c[c < plan.starts[1]] for c in classes]
    recs = k3_times(shard, DeviceCSR.from_csr(g, dev_cuda).deg_ext, own, widths,
                    dev_cuda, lat, plain=True, old_cells=0)
    print_tile_recs(f"K3 over shard 0 of {SHARDS} (rows read in place, first step)",
                    recs)
    return {"launches": totals, "times": {"k3 shard": recs}}


# --------------------------------------------------------------------------
# phase 15: the LM stack's serving path
# --------------------------------------------------------------------------

LM_F32_TOL = 1e-4       # float32 logits, card against CPU (|logit| < ~5)
LM_LOSS_TOL = 1e-5      # float32 losses, relative and absolute
# bfloat16 prefill + decode against the forward: 1/8 of the largest
# |logit|.  The two paths round every GEMM and the caches differently; on
# the CPU at reduced width RWKV-6 (24 layers) reached 6.6% after 8 steps,
# the attention families <= 1.5%.
LM_BF16_REL = 0.125
LM_SERVE = dict(batch=4, prompt_len=64, gen=16)   # qwen3-4b at full size
# (arch, depth kept, decode steps) at published width; depth None = whole
LM_FAMILIES = (("rwkv6-1.6b", None, 4), ("recurrentgemma-2b", None, 4),
               ("mixtral-8x22b", 2, 4), ("deepseek-v2-236b", 2, 4))


def lm_batch(cfg, B: int, S: int, seed: int) -> dict:
    """numpy inputs from a seed (tokens and labels, VLM patches, or
    encoder frames and frame labels)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encoder":
        return {"frames": rng.standard_normal((B, S, cfg.d_frontend), np.float32),
                "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    s_text = S - (cfg.n_patches if cfg.family == "vlm" else 0)
    tokens = rng.integers(0, cfg.vocab, (B, s_text)).astype(np.int32)
    b = {"tokens": tokens, "labels": tokens.copy()}
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_frontend),
                                           np.float32)
    return b


def lm_steps(model, batch: dict, k: int) -> list:
    """Prefill ``tokens[:, :k]``, then decode the rest teacher-forced: the
    logits of every step on the host (the prefill's last position first)."""
    cfg = model.cfg
    off = cfg.n_patches if cfg.family == "vlm" else 0
    tokens = batch["tokens"]
    pre = {n: v for n, v in batch.items() if n != "labels"}
    pre["tokens"] = tokens[:, :k]
    caches, lg = model.prefill(pre, tokens.shape[1] + off)
    out = [lg.float().cpu()]
    for t in range(k, tokens.shape[1]):
        caches, lg = model.decode_step(caches, tokens[:, t:t + 1], t + off)
        out.append(lg.float().cpu())
    return out


def lm_vs_forward(model, batch: dict, k: int) -> tuple[float, float, float]:
    """``(max |prefill/decode - forward|, max |forward logit|, argmax
    agreement)`` over the real vocabulary, teacher-forced from ``k``."""
    V = model.cfg.vocab
    full = model.forward(batch).float().cpu()[..., :V]
    steps = lm_steps(model, batch, k)
    ref = [full[:, t] for t in range(k - 1, full.shape[1])]
    err = max(float((s[:, :V] - r).abs().max()) for s, r in zip(steps, ref))
    agree = float(np.mean([(s[:, :V].argmax(-1) == r.argmax(-1)).float().mean()
                           for s, r in zip(steps, ref)]))
    return err, float(full.abs().max()), agree


@contextlib.contextmanager
def no_tf32():
    """TF32 off for float32 GEMMs and convolutions inside the context."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def lm_card_vs_cpu(dev_cuda):
    """Phase 15 (a): every reduced config in float32, TF32 off, the port's
    init on a seeded CPU generator then copied to the card: forward logits,
    the losses and prefill + 4 decode steps, card against CPU."""
    with no_tf32():
        for i, arch in enumerate(list_archs()):
            cfg = get_config(arch).reduced()
            cpu = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(i))
            card = copy.deepcopy(cpu).to(dev_cuda)
            batch = lm_batch(cfg, 2, 64, seed=i)   # 64 > attn_q_chunk: q-chunked
            errs = {"logits": float((card.forward(batch).cpu() - cpu.forward(batch))
                                    [..., :cfg.vocab].abs().max())}
            with torch.no_grad():
                (l_card, m_card), (l_cpu, m_cpu) = card.loss(batch), cpu.loss(batch)
            for name, a, b in [("loss", l_card, l_cpu)] + [
                    (n, m_card[n], m_cpu[n]) for n in ("ce", "lb_loss", "z_loss")]:
                a, b = float(a), float(b)
                if not (np.isfinite(a) and abs(a - b) <= LM_LOSS_TOL * (1 + abs(b))):
                    fail(f"lm {arch}: {name} on the card {a!r}, on the CPU {b!r}")
                errs[name] = abs(a - b)
            if cfg.family != "encoder":
                short = dict(batch, tokens=batch["tokens"][:, :16])
                k = short["tokens"].shape[1] - 4
                errs["decode"] = max(float((a - b)[:, :cfg.vocab].abs().max()) for a, b in
                                     zip(lm_steps(card, short, k), lm_steps(cpu, short, k)))
            worst = max(errs["logits"], errs.get("decode", 0.0))
            if not worst <= LM_F32_TOL:
                fail(f"lm {arch}: card against CPU {errs} past {LM_F32_TOL}")
            print(f"  lm {arch:18s} card == CPU: max |dlogit| {worst:.3g} "
                  f"(tolerance {LM_F32_TOL}), |dloss| {errs['loss']:.3g} "
                  f"(tolerance {LM_LOSS_TOL} x (1 + |loss|))", flush=True)
            del cpu, card


def device_profile(call) -> tuple:
    """``call()`` under ``torch.profiler``: ``(what it returned, {the
    device's launches (kernels, copies and fills), busy time, the call's
    wall, the device rows by time})``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(((device_us(e) / 1e3, e.count, e.key) for e in rows), reverse=True)
    return out, {"launches": sum(e.count for e in rows),
                 "busy_ms": sum(device_us(e) for e in rows) / 1e3, "wall_ms": wall,
                 "top": top}


def lm_decode_profile(model, caches, tok, pos: int) -> dict:
    """One decode step under ``torch.profiler``: the device's launches,
    busy time and the step's wall."""
    return device_profile(lambda: model.decode_step(caches, tok, pos))[1]


def lm_serve_full(dev_cuda) -> dict:
    """Phase 15 (b): ``serve_batch`` on qwen3-4b at full width and depth in
    bfloat16, then the same model's teacher-forced prefill + decode
    against its forward."""
    cfg = get_config("qwen3-4b")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    cold = serve_batch(cfg, seed=0, device=dev_cuda, **LM_SERVE)
    cold_s = time.perf_counter() - t
    t = time.perf_counter()
    model = build_model(cfg, dev_cuda,
                        generator=torch.Generator(device=dev_cuda).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prompts = SyntheticData.for_model(cfg, LM_SERVE["batch"], LM_SERVE["prompt_len"],
                                      seed=0).batch(0)["tokens"]
    warm = generate(model, {"tokens": prompts}, prompt_len=LM_SERVE["prompt_len"],
                    gen=LM_SERVE["gen"])
    gen_tok = warm["generated"]
    if not np.array_equal(gen_tok, cold["generated"]):
        print("  note: the warm run's tokens differ from serve_batch's "
              f"({int((gen_tok != cold['generated']).sum())} of {gen_tok.size})")
    step_ms = 1e3 * LM_SERVE["batch"] / warm["decode_tok_s"]
    bound = weight_bytes / HBM_BYTES_PER_S * 1e3

    seq = np.concatenate([prompts, gen_tok], axis=1)
    caches, _ = model.prefill({"tokens": seq[:, :-1]}, seq.shape[1])
    prof = lm_decode_profile(model, caches, seq[:, -1:], seq.shape[1] - 1)
    del caches
    err, scale, agree = lm_vs_forward(model, {"tokens": seq}, LM_SERVE["prompt_len"])
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"  lm qwen3-4b full ({cfg.n_layers} layers, {n_params:,} parameters, "
          f"{weight_bytes / 2**20:.1f} MiB of bf16 weights): init {init_s:.1f} s; "
          f"serve_batch batch {LM_SERVE['batch']}, prompt {LM_SERVE['prompt_len']}, "
          f"gen {LM_SERVE['gen']}: cold call {cold_s:.2f} s (prefill "
          f"{cold['prefill_s'] * 1e3:.3f} ms, {cold['decode_tok_s']:.1f} tok/s)", flush=True)
    print(f"  lm qwen3-4b warm: prefill {warm['prefill_s'] * 1e3:.3f} ms, decode "
          f"{step_ms:.3f} ms/step ({warm['decode_tok_s']:.1f} tok/s) against the "
          f"weight-read bound {bound:.3f} ms ({weight_bytes / 1e9:.2f} GB at 3.35 TB/s); "
          f"one decode step: {prof['launches']} device launches, busy "
          f"{prof['busy_ms']:.3f} of {prof['wall_ms']:.3f} ms; peak "
          f"{peak:.1f} MiB allocated; {card_line()}", flush=True)
    print(f"  lm qwen3-4b prefill + {seq.shape[1] - LM_SERVE['prompt_len']} decode "
          f"steps against forward: max |dlogit| {err:.4g} (tolerance "
          f"{LM_BF16_REL} x max |logit| {scale:.4g} = {LM_BF16_REL * scale:.4g}), "
          f"argmax agreement {agree:.4f}", flush=True)
    if not (np.isfinite(err) and err <= LM_BF16_REL * scale):
        fail(f"lm qwen3-4b: prefill/decode against forward {err} past "
             f"{LM_BF16_REL} x {scale}")
    return {"step_ms": step_ms, "bound_ms": bound, **prof}


def lm_families_full(dev_cuda):
    """Phase 15 (c): RWKV-6 and RecurrentGemma whole, Mixtral and
    DeepSeek-V2 at published width with their depth cut, in bfloat16:
    prefill + decode against the forward.  MoE runs drop-free (capacity
    ``E / top_k``: a group's tokens all fit) so that the two paths route
    alike; the forward at the published capacity factor is run too."""
    for i, (arch, depth, steps) in enumerate(LM_FAMILIES):
        cfg = get_config(arch)
        cuts = []
        if depth is not None:
            cuts.append(f"n_layers {cfg.n_layers} -> {depth}")
            cfg = dataclasses.replace(cfg, n_layers=depth)
        if cfg.n_experts:
            drop_free = cfg.n_experts / cfg.top_k
            cuts.append(f"capacity_factor {cfg.capacity_factor} -> {drop_free:g}")
        t = time.perf_counter()
        model = build_model(cfg, dev_cuda,
                            generator=torch.Generator(device=dev_cuda).manual_seed(i))
        n_params = sum(p.numel() for p in model.parameters())
        batch = lm_batch(cfg, 2, 32 + steps, seed=i)
        published = None
        if cfg.n_experts:
            published = model.forward(batch)
            model.cfg = dataclasses.replace(cfg, capacity_factor=drop_free)
        err, scale, agree = lm_vs_forward(model, batch, 32)
        moved = ("" if published is None else
                 f"; the forward at capacity_factor {cfg.capacity_factor} is finite: "
                 f"{bool(torch.isfinite(published[..., :cfg.vocab]).all())}")
        print(f"  lm {arch} ({', '.join(cuts) or 'uncut'}; {n_params:,} parameters): "
              f"prefill 32 + {steps} decode steps against forward: max |dlogit| "
              f"{err:.4g} (tolerance {LM_BF16_REL * scale:.4g}), argmax agreement "
              f"{agree:.4f}{moved}; {time.perf_counter() - t:.1f} s", flush=True)
        if not (np.isfinite(err) and err <= LM_BF16_REL * scale):
            fail(f"lm {arch}: prefill/decode against forward {err} past "
                 f"{LM_BF16_REL} x {scale}")
        if published is not None and not torch.isfinite(published[..., :cfg.vocab]).all():
            fail(f"lm {arch}: non-finite logits at the published capacity factor")
        del model, published
        torch.cuda.empty_cache()


def check_lm(dev_cuda) -> dict:
    """Phase 15: the LM stack's serving path on the card (no kernel of its
    own: plain PyTorch ops)."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 15 starts with {torch.cuda.memory_allocated() / 2**20:.1f} MiB "
          f"allocated", flush=True)
    t = time.perf_counter()
    lm_card_vs_cpu(dev_cuda)
    print(f"lm card == CPU took {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    served = lm_serve_full(dev_cuda)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"lm qwen3-4b took {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    lm_families_full(dev_cuda)
    print(f"lm families took {time.perf_counter() - t:.1f} s", flush=True)
    return served


# --------------------------------------------------------------------------
# phase 16: the LM stack's training path
# --------------------------------------------------------------------------

# every family of the LM stack: dense, MoE, MLA + MoE, RWKV-6, RG-LRU hybrid,
# VLM, encoder (reduced configs, float32)
TRAIN_FAMILIES = ("qwen3-4b", "mixtral-8x22b", "deepseek-v2-236b", "rwkv6-1.6b",
                  "recurrentgemma-2b", "internvl2-26b", "hubert-xlarge")
TRAIN_LR, TRAIN_STEPS = 1e-3, 3
TRAIN_TOL = 1e-4   # loss and grad_norm relative; step-0 gradients per leaf
# AdamW turns a gradient's sign into a step of lr: parameters after k steps
# within 2 lr k, their mean |difference| within 1e-3 lr k.  The moved
# parameters move the later gradients too, so each step's loss and
# grad_norm are held against the CPU's at the card's parameters of that
# step; against the CPU's own run they are read, and only the loss gated.
TRAIN_MEAN_TOL = 1e-3 * TRAIN_LR * TRAIN_STEPS
TRAIN_RESTART_TOL = 1e-3   # tests/test_checkpoint.py's bound on repro
# qwen3-4b at full size, step 0 in bfloat16 against float32 (relative); a
# CPU reading at reduced width gave 6e-5 and 0.3%
BF16_LOSS_REL, BF16_GNORM_REL = 0.01, 0.10
TRAIN_FULL = dict(steps=8, batch_size=2, seq_len=256)
TRAIN_FULL_LR = 3e-4   # train_loop's default
TRAIN_PROFILED = 2   # the warm step run under the profiler (not in the median)


def loss_grads(model, batch) -> tuple[float, dict]:
    """``Model.loss`` and its backward: the loss and each gradient on the
    host (a leaf the loss does not reach fails)."""
    loss, _ = model.loss(batch)
    loss.backward()
    grads = {}
    for n, p in model.named_parameters():
        if p.grad is None:
            fail(f"train {model.cfg.name}: no gradient for {n}")
        grads[n] = p.grad.float().cpu()
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def train_card_vs_cpu(dev_cuda):
    """Phase 16 (a): each family's reduced config in float32, TF32 off, the
    port's init on a seeded CPU generator copied to the card: step-0
    gradients per leaf, then three AdamW steps on the card, each held
    against the CPU's loss and gradient norm at the card's parameters of
    that step, and the parameters after them against the CPU's own run."""
    with no_tf32():
        for i, arch in enumerate(TRAIN_FAMILIES):
            cfg = get_config(arch).reduced()
            cpu = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(i))
            card = copy.deepcopy(cpu).to(dev_cuda)
            here = copy.deepcopy(cpu)   # the card's parameters, step by step
            data = SyntheticData.for_model(cfg, 2, 64, seed=i)   # q-chunked, 2 scan chunks
            batches = [data.batch(s) for s in range(TRAIN_STEPS)]
            (l_cpu, g_cpu), (l_card, g_card) = (loss_grads(m, batches[0]) for m in (cpu, card))
            grad_err = max(float((g_card[n] - g_cpu[n]).abs().max())
                           / max(float(g_cpu[n].abs().max()), 1e-30) for n in g_cpu)
            if not (np.isfinite(l_card) and abs(l_card - l_cpu) <= TRAIN_TOL * abs(l_cpu)):
                fail(f"train {arch}: step-0 loss on the card {l_card!r}, on the CPU {l_cpu!r}")
            if not grad_err <= TRAIN_TOL:
                fail(f"train {arch}: step-0 gradients card against CPU {grad_err:.3g} "
                     f"of a leaf's largest |g|, past {TRAIN_TOL}")
            opt = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=0, total_steps=TRAIN_STEPS)
            states = [init_train_state(m) for m in (cpu, card)]
            steps = [make_train_step(m, opt) for m in (cpu, card)]
            worst = {"loss": 0.0, "grad_norm": 0.0}
            drift = {"loss": 0.0, "grad_norm": 0.0}
            for b in batches:   # the states are updated in place
                with torch.no_grad():
                    for ph, pc in zip(here.parameters(), card.parameters()):
                        ph.copy_(pc)
                l_here, g_here = loss_grads(here, b)
                ref = {"loss": l_here, "grad_norm": float(_global_norm(list(g_here.values())))}
                _, m_cpu = steps[0](states[0], b)
                _, m_card = steps[1](states[1], b)
                for key in ("loss", "grad_norm"):
                    a = float(m_card[key])
                    err = abs(a - ref[key]) / abs(ref[key])
                    if not (np.isfinite(a) and err <= TRAIN_TOL):
                        fail(f"train {arch}: {key} on the card {a!r}, on the CPU at the "
                             f"same parameters {ref[key]!r} (relative {err:.3g}, "
                             f"tolerance {TRAIN_TOL})")
                    worst[key] = max(worst[key], err)
                    r = float(m_cpu[key])
                    drift[key] = max(drift[key], abs(a - r) / abs(r))
                if not drift["loss"] <= TRAIN_TOL:
                    fail(f"train {arch}: loss on the card {float(m_card['loss'])!r}, in the "
                         f"CPU's run {float(m_cpu['loss'])!r} (tolerance {TRAIN_TOL})")
            diffs = torch.cat([(pc.detach().cpu() - pp.detach()).abs().flatten()
                               for pc, pp in zip(card.parameters(), cpu.parameters())])
            dmax, dmean = float(diffs.max()), float(diffs.mean())
            if not (dmax <= 2 * TRAIN_LR * TRAIN_STEPS and dmean <= TRAIN_MEAN_TOL):
                fail(f"train {arch}: parameters after {TRAIN_STEPS} steps differ by max "
                     f"{dmax:.3g} (allowance {2 * TRAIN_LR * TRAIN_STEPS:.3g}), mean "
                     f"{dmean:.3g} (allowance {TRAIN_MEAN_TOL:.3g})")
            print(f"  train {arch:18s} card == CPU: step-0 grads {grad_err:.3g} of a leaf's "
                  f"max |g|; {TRAIN_STEPS} steps at the same parameters: |dloss| rel "
                  f"{worst['loss']:.3g}, |dgnorm| rel {worst['grad_norm']:.3g} (tolerance "
                  f"{TRAIN_TOL}); against the CPU's run: |dloss| rel {drift['loss']:.3g}, "
                  f"|dgnorm| rel {drift['grad_norm']:.3g}, params max {dmax:.3g} / mean "
                  f"{dmean:.3g} (allowance {2 * TRAIN_LR * TRAIN_STEPS:.3g} / "
                  f"{TRAIN_MEAN_TOL:.3g})", flush=True)
            del cpu, card, here, states, steps


def train_restart(dev_cuda):
    """Phase 16 (a): a checkpointed run on the card that dies at step 8 and
    is resumed by ``run_with_restarts`` against the uninterrupted run."""
    cfg = get_config("qwen3-4b").reduced()
    kw = dict(steps=12, batch_size=4, seq_len=16, lr=1e-3, log_every=4, seed=3,
              device=dev_cuda)
    calls = []
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "ck")
        ref = train_launcher.train_loop(cfg, ckpt_dir=str(Path(tmp) / "ref"),
                                        ckpt_every=100, **kw)

        def run(start):
            calls.append(start)
            return train_launcher.train_loop(
                cfg, ckpt_dir=ck, ckpt_every=4, resume=start > 0,
                fail_at_step=8 if len(calls) == 1 else None, **kw)

        out = run_with_restarts(run, ckpt_dir=ck, max_restarts=1)
    err = abs(out["final_loss"] - ref["final_loss"])
    print(f"  train restart on the card: attempts from steps {calls}, {out['steps']} "
          f"steps after the restart, final loss {out['final_loss']:.6f} against "
          f"{ref['final_loss']:.6f} uninterrupted (|d| {err:.3g}, tolerance "
          f"{TRAIN_RESTART_TOL})", flush=True)
    if not (calls == [0, 8] and out["steps"] == 4 and err < TRAIN_RESTART_TOL):
        fail(f"train restart: attempts {calls}, {out['steps']} steps, |dloss| {err}")


def train_bf16_step0(dev_cuda) -> dict:
    """Phase 16 (b): qwen3-4b at full width and depth, step 0 in float32
    (TF32 off), then in bfloat16 from the same weights cast down."""
    cfg = get_config("qwen3-4b")
    f32 = dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")
    batch = SyntheticData.for_model(cfg, TRAIN_FULL["batch_size"], TRAIN_FULL["seq_len"],
                                    seed=0).batch(0)
    out = {}
    with no_tf32():
        t = time.perf_counter()
        m32 = build_model(f32, dev_cuda,
                          generator=torch.Generator(device=dev_cuda).manual_seed(0))
        loss, _ = m32.loss(batch)
        loss.backward()
        out["f32"] = (loss.item(), float(_global_norm([p.grad for p in m32.parameters()])))
        m32.zero_grad(set_to_none=True)
        m16 = build_model(cfg, "meta").to_empty(device=dev_cuda)
        with torch.no_grad():
            for p, q in zip(m32.parameters(), m16.parameters()):
                q.copy_(p)
        del m32
        torch.cuda.empty_cache()
        loss, _ = m16.loss(batch)
        loss.backward()
        out["bf16"] = (loss.item(), float(_global_norm([p.grad for p in m16.parameters()])))
        del m16, loss
    gc.collect()
    torch.cuda.empty_cache()
    (l32, g32), (l16, g16) = out["f32"], out["bf16"]
    dl, dg = abs(l16 - l32) / abs(l32), abs(g16 - g32) / abs(g32)
    print(f"  train qwen3-4b full, step 0 (batch {TRAIN_FULL['batch_size']}, sequence "
          f"{TRAIN_FULL['seq_len']}): float32 loss {l32:.6f} grad norm {g32:.6f}; bfloat16 "
          f"loss {l16:.6f} grad norm {g16:.6f}; relative {dl:.3g} (tolerance "
          f"{BF16_LOSS_REL}) and {dg:.3g} (tolerance {BF16_GNORM_REL}); "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if not (np.isfinite([l32, g32, l16, g16]).all() and dl <= BF16_LOSS_REL
            and dg <= BF16_GNORM_REL):
        fail(f"train qwen3-4b: bfloat16 step 0 against float32: loss {dl}, grad norm {dg}")
    return {"loss_rel": dl, "gnorm_rel": dg}


def step_flops(cfg, B: int, S: int) -> tuple[float, float]:
    """``(model FLOPs of one train step, the remat recompute's)``: 2 FLOPs a
    multiply-add over the layers' weight matrices for every token, the
    LM head for every scored position, and the attention scores and their
    weighting over the full (S, S) square the einsums compute; the backward
    twice the forward; the recompute one more forward of the layers."""
    model = build_model(cfg, "meta")
    layer_mm = sum(p.numel() for n, p in model.named_parameters()
                   if n.startswith("layers.") and p.dim() >= 2)
    head = cfg.d_model * cfg.padded_vocab
    attn = 4 * B * S * S * cfg.n_heads * cfg.head_dim * cfg.n_layers
    layers_fwd = 2 * B * S * layer_mm + attn
    fwd = layers_fwd + 2 * B * (S - 1) * head
    return 3 * fwd, layers_fwd


def train_full(dev_cuda) -> dict:
    """Phase 16 (c): ``train_loop`` on qwen3-4b at full size in bfloat16;
    then the same steps through ``init_train_state`` and ``make_train_step``
    (what ``train_loop`` runs), each timed on the host's clock ending in a
    synchronise, one warm step under the profiler; then one more loss with
    its backward and one ``adamw_update``, timed apart by CUDA events."""
    cfg = get_config("qwen3-4b")
    B, S, steps = TRAIN_FULL["batch_size"], TRAIN_FULL["seq_len"], TRAIN_FULL["steps"]
    t = time.perf_counter()
    summary = train_launcher.train_loop(cfg, device=dev_cuda, log_every=1,
                                        lr=TRAIN_FULL_LR, **TRAIN_FULL)
    loop_s = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    if not (summary["steps"] == steps and len(summary["losses"]) == steps
            and np.isfinite(summary["losses"]).all()):
        fail(f"train qwen3-4b: train_loop ran {summary['steps']} steps, losses "
             f"{summary['losses']}")

    model = build_model(cfg, dev_cuda, generator=torch.Generator(device=dev_cuda).manual_seed(0))
    opt_cfg = AdamWConfig(peak_lr=TRAIN_FULL_LR, warmup_steps=min(50, steps // 10 + 1),
                          total_steps=steps)
    data = SyntheticData.for_model(cfg, B, S, seed=0)
    state, step = init_train_state(model), make_train_step(model, opt_cfg)
    recs = []
    for i in range(steps):
        batch = data.batch(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        if i == TRAIN_PROFILED:
            (state, m), prof = device_profile(lambda: step(state, batch))
        else:
            state, m = step(state, batch)
        torch.cuda.synchronize()
        recs.append({"ms": (time.perf_counter() - t) * 1e3,
                     "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "peak": torch.cuda.max_memory_allocated() / 2**20})
    bad = [i for i, r in enumerate(recs) if not np.isfinite([r["loss"], r["grad_norm"]]).all()]
    if bad:
        fail(f"train qwen3-4b: non-finite loss or grad_norm at steps {bad}")
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    loss, _ = model.loss(data.batch(steps))
    loss.backward()
    events[1].record()
    params = state.params
    adamw_update(params, {n: p.grad for n, p in params.items()}, state.opt, state.step, opt_cfg)
    events[2].record()
    torch.cuda.synchronize()
    fwd_bwd_ms, opt_ms = events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2])
    n_params = sum(p.numel() for p in model.parameters())
    del model, state, step, params, loss
    gc.collect()
    torch.cuda.empty_cache()

    warm = [r["ms"] for i, r in enumerate(recs) if i >= 1 and i != TRAIN_PROFILED]
    ms = statistics.median(warm)
    flops, recompute = step_flops(cfg, B, S)
    rate = flops / (ms / 1e3)
    print(f"  train qwen3-4b full ({cfg.n_layers} layers, {n_params:,} parameters, bf16, "
          f"remat {cfg.remat}, batch {B}, sequence {S}): train_loop of {steps} steps "
          f"{loop_s:.1f} s (build included), losses {[round(x, 4) for x in summary['losses']]}",
          flush=True)
    print(f"  train qwen3-4b through make_train_step: cold step {recs[0]['ms']:.1f} ms; warm "
          f"steps median {ms:.3f} ms ({len(warm)} steps, {min(warm):.3f}-{max(warm):.3f}), "
          f"{B * S / (ms / 1e3):.1f} tokens/s, peak {max(r['peak'] for r in recs):.1f} MiB "
          f"allocated; one step profiled: {prof['launches']} device launches, busy "
          f"{prof['busy_ms']:.3f} of {prof['wall_ms']:.3f} ms "
          f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%)", flush=True)
    print(f"  train qwen3-4b one more step on the device's timeline (CUDA events): loss and "
          f"backward {fwd_bwd_ms:.3f} ms, adamw_update {opt_ms:.3f} ms", flush=True)
    if not prof["launches"]:
        print("  profiler: no device time recorded (launches and busy share not measured)")
    for dev_ms, count, key in prof["top"][:8]:
        print(f"    {dev_ms:10.3f} ms  x{count:<6d} {key[:90]}")
    print(f"  train qwen3-4b model FLOPs a step {flops:.4g} (+ remat recompute "
          f"{recompute:.4g}): {rate / 1e12:.2f} TFLOP/s, {100 * rate / BF16_DENSE_FLOPS:.2f}% "
          f"of the bf16 dense peak {BF16_DENSE_FLOPS / 1e12:.0f} TFLOP/s (with the recompute "
          f"{(flops + recompute) / (ms / 1e3) / 1e12:.2f}); {card_line()}", flush=True)
    print(f"  train qwen3-4b losses {[round(r['loss'], 4) for r in recs]}, grad norms "
          f"{[round(r['grad_norm'], 3) for r in recs]}; first {recs[0]['loss']:.4f}, "
          f"last {recs[-1]['loss']:.4f}", flush=True)
    return {"ms": ms, **{k: prof[k] for k in ("launches", "busy_ms", "wall_ms")},
            "losses": summary["losses"], "grad_norms": summary["grad_norms"],
            "flops": flops, "recompute": recompute,
            "peak_mib": max(r["peak"] for r in recs)}


def check_training(dev_cuda) -> dict:
    """Phase 16: the LM stack's training path on the card (no kernel of its
    own: plain PyTorch ops)."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**20
    print(f"phase 16 starts with {held:.1f} MiB allocated", flush=True)
    t = time.perf_counter()
    train_card_vs_cpu(dev_cuda)
    train_restart(dev_cuda)
    print(f"train card == CPU and restart took {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    train_bf16_step0(dev_cuda)
    print(f"train bf16 step 0 took {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    out = train_full(dev_cuda)
    print(f"train qwen3-4b full took {time.perf_counter() - t:.1f} s", flush=True)
    return {**out, "held_mib": held}


# --------------------------------------------------------------------------
# phase 17: the LM stack's mesh half (DeviceMesh, DTensor, the dry run)
# --------------------------------------------------------------------------

MESH_STEP0_TOL = 1e-4    # phase 17 (a) against phase 16's train_loop, step 0
MESH_RESUME_AT = 4       # phase 17 (b): the checkpoint's step
DRYRUN_TOL = 0.20        # phase 17 (c): the dry run against phase 16's readings
# the dry run of phase 16's step, on meta under a fake group of one (its own
# process: a process group is global to a process)
DRYRUN_PROBE = """
import json, sys
sys.path.insert(0, "src")
from repro_torch.launch.dryrun import make_mesh, run_cell
mesh = make_mesh((1, 1), ("data", "model"))
rec = run_cell("qwen3-4b", "train_4k", "single", mesh=mesh,
               info=dict(seq={seq}, batch={batch}, mode="train"))
rec.pop("traceback", None)
print(json.dumps(rec))
"""


def nccl_group(dev_cuda):
    """An NCCL process group of world size 1 on this card."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=dev_cuda)


def mesh_steps(state, opt_cfg, data, first: int, last: int, timed: bool) -> list:
    """Steps ``first``..``last - 1`` of ``make_train_step`` on a placed
    state, each batch placed by ``batch_shardings``; ``(ms, loss,
    grad_norm)`` each, the ms on the host's clock ending in a synchronise."""
    from repro_torch.distributed.sharding import batch_shardings, distribute

    leaf = next(iter(state.params.values()))
    mesh, dev = leaf.device_mesh, leaf.device
    step = make_train_step(state.model, opt_cfg)
    sh = batch_shardings(data.batch(first), mesh)
    out = []
    for i in range(first, last):
        batch = distribute({k: torch.as_tensor(v, device=dev) for k, v in data.batch(i).items()},
                           sh)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        loss, gnorm = (float(m[k].full_tensor()) for k in ("loss", "grad_norm"))
        torch.cuda.synchronize()
        out.append(((time.perf_counter() - t) * 1e3 if timed else None, loss, gnorm))
    return out


def check_mesh(dev_cuda, phase16: dict) -> dict:
    """Phase 17: the LM stack's mesh half on a one-card mesh (an NCCL group
    of world size 1, a ("data", "model") mesh of shape (1, 1)): (a)
    ``train_loop(mesh=)`` on qwen3-4b at full size in bfloat16 with phase
    16's settings, step 0 against phase 16's ``train_loop``; then its steps
    0-3 through ``make_train_step`` on a placed state, timed, and a
    checkpoint at step 4; (b) ``reshard_state`` of that checkpoint onto a
    freshly built (1, 1) mesh (every leaf a ``DTensor`` of the resolver's
    placement), then steps 4-7 against (a)'s; (c) the dry run of the same
    step (``op_analysis`` on meta, a subprocess started after (a)'s timed
    steps) against phase 16's model FLOPs and peak memory."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.fault_tolerance import reshard_state
    from repro_torch.distributed.sharding import place_state, state_shardings
    from repro_torch.training.checkpoint import save_checkpoint

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 17 starts with {torch.cuda.memory_allocated() / 2**20:.1f} MiB "
          f"allocated", flush=True)
    cfg = get_config("qwen3-4b")
    B, S, steps = TRAIN_FULL["batch_size"], TRAIN_FULL["seq_len"], TRAIN_FULL["steps"]
    probe = None
    nccl_group(dev_cuda)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        t = time.perf_counter()
        summary = train_launcher.train_loop(cfg, device=dev_cuda, mesh=mesh, log_every=1,
                                            lr=TRAIN_FULL_LR, **TRAIN_FULL)
        loop_s = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        losses, gnorms = summary["losses"], summary["grad_norms"]
        ref_l, ref_g = phase16["losses"][0], phase16["grad_norms"][0]
        dl, dg = abs(losses[0] - ref_l) / abs(ref_l), abs(gnorms[0] - ref_g) / abs(ref_g)
        print(f"  mesh train_loop qwen3-4b full on a (1, 1) mesh, {steps} steps in "
              f"{loop_s:.1f} s (build included): losses {[round(x, 4) for x in losses]}, "
              f"grad norms {[round(x, 3) for x in gnorms]}; step 0 against phase 16's "
              f"train_loop: loss {losses[0]:.6f} vs {ref_l:.6f} (relative {dl:.3g}), grad "
              f"norm {gnorms[0]:.6f} vs {ref_g:.6f} (relative {dg:.3g}; tolerance "
              f"{MESH_STEP0_TOL})", flush=True)
        if not (len(losses) == steps and np.isfinite(losses + gnorms).all()
                and dl <= MESH_STEP0_TOL and dg <= MESH_STEP0_TOL):
            fail(f"mesh train_loop: step 0 against phase 16: loss {dl}, grad norm {dg}; "
                 f"losses {losses}")

        opt_cfg = AdamWConfig(peak_lr=TRAIN_FULL_LR, warmup_steps=min(50, steps // 10 + 1),
                              total_steps=steps)
        data = SyntheticData.for_model(cfg, B, S, seed=0)
        model = build_model(cfg, dev_cuda, generator=torch.Generator(device=dev_cuda).manual_seed(0))
        state = init_train_state(model)
        place_state(state, state_shardings(state, mesh))
        torch.cuda.reset_peak_memory_stats()
        first = mesh_steps(state, opt_cfg, data, 0, MESH_RESUME_AT, timed=True)
        peak = torch.cuda.max_memory_allocated() / 2**20
        ms = statistics.median(r[0] for r in first[1:])
        print(f"  mesh steps 0-{MESH_RESUME_AT - 1} through make_train_step: cold "
              f"{first[0][0]:.1f} ms, warm median {ms:.3f} ms against phase 16's "
              f"{phase16['ms']:.3f} ms without a mesh (x{ms / phase16['ms']:.3f}: the host "
              f"cost of DTensor dispatch), peak {peak:.1f} MiB; {card_line()}", flush=True)
        # (c)'s trace takes the host's cores for 15-25 s: started after the
        # timed steps, beside the checkpoint's I/O
        probe = subprocess.Popen([sys.executable, "-c", DRYRUN_PROBE.format(seq=S, batch=B)],
                                 cwd=str(Path(__file__).resolve().parent),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            save_checkpoint(tmp, MESH_RESUME_AT, state)
            save_s = time.perf_counter() - t
            del model, state
            gc.collect()
            torch.cuda.empty_cache()
            fresh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            t = time.perf_counter()
            like = init_train_state(build_model(cfg, "meta"))
            state = reshard_state(tmp, MESH_RESUME_AT, like, fresh)
            restore_s = time.perf_counter() - t
        want = state_shardings(state, fresh)
        leaves = [(p, want["params"][n]) for n, p in state.params.items()] + [
            (v, want["opt"][k][n]) for k in ("m", "v") for n, v in state.opt[k].items()]
        misplaced = [i for i, (v, sh) in enumerate(leaves)
                     if not (isinstance(v, DTensor) and v.device_mesh == fresh
                             and tuple(v.placements) == sh.placements
                             and v.device.type == fresh.device_type)]
        resumed = mesh_steps(state, opt_cfg, data, MESH_RESUME_AT, steps, timed=False)
        err = max(abs(r[1] - want_l) for r, want_l in zip(resumed, losses[MESH_RESUME_AT:]))
        print(f"  mesh checkpoint at step {MESH_RESUME_AT}: saved in {save_s:.1f} s, "
              f"reshard_state onto a fresh (1, 1) mesh in {restore_s:.1f} s, {len(leaves)} "
              f"leaves, {len(misplaced)} not DTensors of the resolver's placement; steps "
              f"{MESH_RESUME_AT}-{steps - 1} losses {[round(r[1], 4) for r in resumed]} "
              f"against (a)'s {[round(x, 4) for x in losses[MESH_RESUME_AT:]]} "
              f"(|d| {err:.3g}, tolerance {TRAIN_RESTART_TOL})", flush=True)
        if misplaced or not err <= TRAIN_RESTART_TOL:
            fail(f"mesh reshard_state: {len(misplaced)} leaves misplaced, |dloss| {err}")
        del state, like
        gc.collect()
        torch.cuda.empty_cache()
    except BaseException:
        if probe is not None:
            probe.kill()
        raise
    finally:
        dist.destroy_process_group()

    stdout, stderr = probe.communicate(timeout=600)
    if probe.returncode != 0:
        fail(f"mesh dry run: exit {probe.returncode}: {stderr[-2000:]}")
    rec = json.loads(stdout.strip().splitlines()[-1])
    if not rec.get("ok"):
        fail(f"mesh dry run: {rec.get('error')}")
    flops, mem = rec["analysis"]["flops"], rec["memory"]
    dry_mib = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 2**20
    card_flops = phase16["flops"] + phase16["recompute"]
    card_mib = phase16["peak_mib"] - phase16["held_mib"]
    df, dm = abs(flops / card_flops - 1), abs(dry_mib / card_mib - 1)
    print(f"  mesh dry run of phase 16's step (op_analysis on meta, trace "
          f"{rec['trace_s']} s): per-device FLOPs {flops:.4g} against phase 16's model "
          f"FLOPs plus recompute {card_flops:.4g} (relative {df:.3g}); arguments "
          f"{mem['argument_size_in_bytes'] / 2**20:.1f} MiB + temporaries "
          f"{mem['temp_size_in_bytes'] / 2**20:.1f} MiB = {dry_mib:.1f} MiB against phase "
          f"16's peak {phase16['peak_mib']:.1f} MiB less {phase16['held_mib']:.1f} MiB held "
          f"by earlier phases = {card_mib:.1f} MiB (relative {dm:.3g}; tolerance "
          f"{DRYRUN_TOL})", flush=True)
    if not (df <= DRYRUN_TOL and dm <= DRYRUN_TOL):
        fail(f"mesh dry run against the card: FLOPs {df}, memory {dm}")
    return {"ms": ms, "flops": flops, "dry_mib": dry_mib}


def kernels_record(full: dict) -> list:
    """The kernels' JSON record: launches summed over the main paths'
    counted runs (distance-1, distance-2, the comparison, phase 12's
    batched and session paths, phase 13's service and phase 14's sharded
    runs), times and bounds at their
    shapes on rmat-er (K1: mean per launch over the first superstep's
    classes; K2: the stall tail over all n vertices; K3: mean per launch
    over the padded engine's first-superstep classes, rows read in place;
    K4 and K5: the classic engine's first step, rows read in place; K6:
    ``d2_sgr_step``'s FirstFit over all n after one step)."""
    t = full["times"]
    k1, k2 = t["ragged rmat-er"]["k1"], t["ragged rmat-er"]["k2"]
    k3 = t["padded rmat-er"]
    k4, k5 = t["classic rmat-er"]["first"]["K4"], t["classic rmat-er"]["first"]["K5"]

    def entry(name, source, replaces, recs):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": full["launches"][name],
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": statistics.fmean(r["ms"] for r in recs),
                "plain_ms": statistics.fmean(r["plain_ms"] for r in recs),
                # bytes or operations: K2's depth bound is printed beside it
                "bound_ms": statistics.fmean(r.get("bytes_bound_ms", r["bound_ms"])
                                             for r in recs),
                "bound_by": "bytes", "library_ms": None}

    csr_src = "src/repro_torch/csrc/superstep_csr.cu"
    tile_src = "src/repro_torch/csrc/tile_kernels.cu"
    d2_src = "src/repro_torch/csrc/d2_kernels.cu"
    return [
        entry("superstep_csr", tile_src,
              "src/repro/kernels/superstep/csr_kernel.py:62", k1),
        entry("serial_tail_csr", csr_src,
              "src/repro/kernels/superstep/csr_kernel.py:223", [k2]),
        entry("superstep_tile", tile_src,
              "src/repro/kernels/superstep/kernel.py:39", k3),
        entry("firstfit_rows", tile_src,
              "src/repro/kernels/firstfit/kernel.py:28", [k4]),
        entry("conflict_rows", tile_src,
              "src/repro/kernels/conflict/kernel.py:23", [k5]),
        entry("d2_firstfit", d2_src, "src/repro/kernels/d2/kernel.py:44",
              [t["k6"]]),
    ]


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    t_start = time.perf_counter()
    dev_cuda = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"host CPU {host_cpu()}")
    print(f"nvidia-smi: {card}", flush=True)

    t = time.perf_counter()
    logs = build.build((*build.SOURCES, "latency_probe"))
    print(f"build: {', '.join(logs)} in {time.perf_counter() - t:.1f} s")
    for name, log in logs.items():  # the -Xptxas -v report, per kernel
        for line in log.splitlines():
            if any(key in line for key in ("Compiling entry", "registers",
                                           "spill", "smem")):
                print(f"  {name}: {line.split('ptxas info    :')[-1].strip()}")

    t0 = time.perf_counter()
    check_k1(dev_cuda)
    check_k2(dev_cuda)
    check_tiles(dev_cuda)
    check_k6(dev_cuda)
    lat = check_latency(dev_cuda)
    print(f"checks took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    check_slice(dev_cuda)
    check_d2_slice(dev_cuda)
    check_baselines_slice(dev_cuda)
    check_batch_slice(dev_cuda)
    check_session_slice(dev_cuda)
    print(f"slice took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    full = check_full(dev_cuda, lat)
    print(f"full took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    d2 = check_d2_full(full["graphs"], dev_cuda, lat)
    for k, c in d2["launches"].items():
        full["launches"][k] += c
    full["times"].update(d2["times"])
    print(f"full distance-2 took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    comparison = check_comparison(full["graphs"], full["ragged"], dev_cuda)
    for k, c in comparison["launches"].items():
        full["launches"][k] += c
    print(f"comparison took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    serving = check_serving(full["graphs"], dev_cuda)
    for k, c in serving["launches"].items():
        full["launches"][k] += c
    print(f"batch and stream took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    service = check_service(full["graphs"], serving["mix"], dev_cuda)
    for k, c in service["launches"].items():
        full["launches"][k] += c
    print(f"service took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    sharded = check_sharded(full["graphs"], dev_cuda, lat)
    for k, c in sharded["launches"].items():
        full["launches"][k] += c
    print(f"sharded took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    check_lm(dev_cuda)
    print(f"lm took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    training = check_training(dev_cuda)
    print(f"training took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    check_mesh(dev_cuda, training)
    print(f"mesh took {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = kernels_record(full)
    print(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
